"""The port's SAM2 fine-tuning loop (atlaspatch_tpu_torch/models/train/) against
the JAX package's (atlaspatch_tpu/models/train/), on the CPU: the norms-only
mask, the learning-rate schedule and the optimizer, the attention's
gradient, the loop (resume, refusals, batches and flips, a save error) and
the synthetic corpus. The loss, gradient and AdamW-step parity, which share
one jitted JAX ``value_and_grad``, are in ``tests/test_torch_train.py``.

Both packages start from one Flax tree at the miniature config
(``shared_flax_params(0)``). The learning rate equals optax's schedule to
1e-7; a resumed run equals the uninterrupted one bit for bit; the batches,
flips and refusals are JAX's; the corpus equals the JAX one pixel for pixel.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlaspatch_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from atlaspatch_tpu.models.sam2.model import init_params as jax_init_params
from atlaspatch_tpu.models.train import finetune as jax_ft
from atlaspatch_tpu.models.train import loop as jax_loop
from atlaspatch_tpu.tools import synthetic_corpus as jax_corpus
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.sam2.convert import flax_key_map
from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel
from atlaspatch_tpu_torch.models.train import checkpoints, finetune, loop
from atlaspatch_tpu_torch.ops import attention as A
from atlaspatch_tpu_torch.parallel import mesh
from atlaspatch_tpu_torch.parallel.mesh import LocalMesh
from atlaspatch_tpu_torch.tools import synthetic_corpus
from torch_port_helpers import CFG, JAX_CFG, free_tmp_path, port_model, shared_flax_params  # noqa: F401


@pytest.fixture(scope="module")
def init():
    return shared_flax_params(0)


def _flat(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()}


def _jax_norm_keys(cfg) -> set[str]:
    mask = jax_ft.norm_param_mask(jax.eval_shape(lambda: jax_init_params(cfg, 0)))
    return {k for k, v in _flatten(mask).items() if bool(v)}


# --------------------------------------------------------------- the norms-only mask
@pytest.mark.parametrize("size", ["test_tiny", "tiny"])
def test_norm_param_mask_selects_the_jax_tensors(size):
    """The mask over the port's names, read through the converter's key map,
    marks exactly the Flax leaves the JAX norm_param_mask marks; the "all"
    set is every Flax leaf, one tensor each (the tied Fourier projection
    once, the unused mask prompt encoder never)."""
    cfg, jax_cfg = getattr(SAM2Config, size)(), getattr(JaxSAM2Config, size)()
    with torch.device("meta"):
        model = SAM2ImageModel(cfg)
    keys = flax_key_map(model)
    mask = finetune.norm_param_mask(model)
    jax_leaves = set(_flatten(jax.eval_shape(lambda: jax_init_params(jax_cfg, 0))))
    want = _jax_norm_keys(jax_cfg)
    assert sorted(keys.values()) == sorted(jax_leaves)  # one to one
    assert {keys[k] for k, on in mask.items() if on} == want
    assert len(want) == 4 * sum(cfg.blocks_per_stage) + 8 * cfg.decoder_num_layers + 4  # 2 per LayerNorm
    assert not any(on for k, on in mask.items() if "mask_embed" in k or k not in keys)
    assert set(finetune.trainable_parameters(model, "norms")) == want
    assert set(finetune.trainable_parameters(model, "all")) == jax_leaves
    assert {n for n, p in model.named_parameters() if p.requires_grad} < set(keys)
    with pytest.raises(ValueError, match="'norms' or 'all'"):
        finetune.trainable_parameters(model, "decoder")


def test_no_dropout_or_batch_statistics_and_no_inference_tensors():
    """The train step runs the eval graph: the model has no module whose
    forward depends on training mode; a model built under inference_mode is
    refused before training."""
    model = SAM2ImageModel(CFG)
    assert not [m for m in model.modules() if isinstance(m, (torch.nn.Dropout, torch.nn.modules.batchnorm._NormBase))]
    with torch.inference_mode():
        frozen = SAM2ImageModel(CFG)
    with pytest.raises(RuntimeError, match="inference tensors"):
        finetune.trainable_parameters(frozen)




SCHEDULES = [
    dict(schedule="constant"),
    dict(schedule="constant", warmup_steps=5),
    dict(schedule="cosine", total_steps=10),
    dict(schedule="cosine", warmup_steps=3, total_steps=10),
    dict(schedule="cosine", warmup_steps=4),  # total_steps None: decays over warmup + 1
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_lr_schedule_equals_optax(kw):
    """lr(count), the count of updates already applied, equals the rate the
    JAX optimizer applies at that update: with a zero gradient its AdamW
    update of a unit parameter is -0.01·lr (decoupled decay only)."""
    peak = 1e-2
    optimizer = jax_ft.make_optimizer(peak, **kw)
    _, lr = finetune.make_optimizer([torch.zeros(1, requires_grad=True)], peak, **kw)
    params = {"w": jnp.ones((1,))}
    state = optimizer.init(params)
    for count in range(16):
        updates, state = optimizer.update({"w": jnp.zeros((1,))}, state, params)
        assert abs(lr(count) - float(-updates["w"][0] / 0.01)) <= 1e-7, count
    if kw.get("warmup_steps"):
        assert lr(0) == 0.0


def test_optimizer_is_optax_adamw():
    param = torch.zeros(3, requires_grad=True)
    optimizer, _ = finetune.make_optimizer([param])
    group = optimizer.param_groups[0]
    assert isinstance(optimizer, torch.optim.AdamW)
    assert (group["betas"], group["eps"], group["weight_decay"], group["amsgrad"]) == ((0.9, 0.999), 1e-8, 0.01, False)
    with pytest.raises(ValueError, match="unknown LR schedule"):
        finetune.make_optimizer([param], schedule="linear")
    # the data-parallel step (tests/test_torch_parallel_finetune.py) starts from the model on the mesh's first device
    with pytest.raises(ValueError, match="the mesh's first device is meta"):
        finetune.shard_train_step(port_model(shared_flax_params()), optimizer, None, LocalMesh([["meta"]]))


def test_attention_gradient_equals_jax_reference():
    """attention() under autograd runs the plain products, counted in
    attention.plain_grad_calls; its gradients equal jax.grad of the JAX
    reference_attention. Without a gradient it is not counted."""
    from atlaspatch_tpu.ops.attention import reference_attention as jax_reference

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 3, t, 16)).astype(np.float32) for t in (9, 13, 13))
    w = rng.normal(size=(2, 3, 9, 16)).astype(np.float32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    A.reset_launch_counts()
    (A.attention(tq, tk, tv, 0.3) * torch.from_numpy(w)).sum().backward()
    assert A.attention.plain_grad_calls == 1
    want = jax.grad(lambda q, k, v: (jax_reference(q, k, v, 0.3) * w).sum(), argnums=(0, 1, 2))(q, k, v)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        A.attention(tq, tk, tv)
    A.attention(tq.detach(), tk.detach(), tv.detach())
    assert A.attention.plain_grad_calls == 1


# --------------------------------------------------------------- the loop
def _corpus(root: Path, n: int):
    return synthetic_corpus.generate_corpus(root / "corpus", n=n, width=256, height=192)


def _npz(root: Path, init) -> Path:
    path = root / "init.npz"
    np.savez(path, **_flatten(init))
    return path


@pytest.fixture
def tiny_models(monkeypatch):
    monkeypatch.setattr(JaxSAM2Config, "tiny", JaxSAM2Config.test_tiny)
    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, init, tiny_models):
    images, masks = _corpus(tmp_path, 5)
    common = dict(batch_size=2, checkpoint=_npz(tmp_path, init), device="cpu", seed=1, val_fraction=0.2,
                  warmup_steps=1, augment=True, save_every=1)
    full = loop.finetune_sam2(images, masks, tmp_path / "full", epochs=2, **common)
    loop.finetune_sam2(images, masks, tmp_path / "res", epochs=1, **common)
    resumed = loop.finetune_sam2(images, masks, tmp_path / "res", epochs=2, resume=True, **common)
    assert (full["steps"], resumed["steps"], resumed["resumed_at"], resumed["steps_this_run"]) == (4, 4, 2, 2)
    assert resumed["final_loss"] == full["final_loss"] and resumed["val_loss"] == full["val_loss"]
    a, b = _arrays(full["checkpoint"]), _arrays(resumed["checkpoint"])
    assert a.keys() == b.keys() and all(a[k].tobytes() == b[k].tobytes() for k in a)
    step_a = _arrays(tmp_path / "full" / "checkpoints" / "step_00000004.npz")
    step_b = _arrays(tmp_path / "res" / "checkpoints" / "step_00000004.npz")
    assert step_a.keys() == step_b.keys() and all(step_a[k].tobytes() == step_b[k].tobytes() for k in step_a)
    # the step file: every JAX parameter, the norms' moments in the JAX layout, the step
    norms = _jax_norm_keys(JAX_CFG)
    assert {k[len("params/"):] for k in step_a if k.startswith("params/")} == set(_flat(init))
    for name in ("exp_avg", "exp_avg_sq"):
        moments = {k.split("/", 1)[1]: v for k, v in step_a.items() if k.startswith(name + "/")}
        assert set(moments) == norms
        assert all(v.shape == step_a[f"params/{k}"].shape and v.dtype == np.float32 for k, v in moments.items())
    assert int(step_a["step"]) == 4
    assert sorted(p.name for p in (tmp_path / "res" / "checkpoints").iterdir()) == [
        "meta.json", "step_00000002.npz", "step_00000004.npz"]
    again = loop.finetune_sam2(images, masks, tmp_path / "res", epochs=2, resume=True, **common)
    assert again["steps"] == 4 and again["first_loss"] is None and again["val_loss"] == full["val_loss"]


def _both_raise(exc, call) -> str:
    messages = []
    for module in (jax_loop, loop):
        with pytest.raises(exc) as err:
            call(module)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    return messages[1]


def test_resume_guards_raise_the_jax_messages(tmp_path, init, tiny_models):
    images, masks = _corpus(tmp_path, 4)
    ckpt = _npz(tmp_path, init)
    common = dict(epochs=1, batch_size=2, checkpoint=ckpt, device="cpu", save_every=1, resume=True)
    assert "no checkpoints" in _both_raise(
        FileNotFoundError, lambda m: m.finetune_sam2(images, masks, tmp_path / "empty", **common))

    # a recorded setting that differs: both refuse before reading the step file
    run = tmp_path / "run" / "checkpoints"
    run.mkdir(parents=True)
    (run / "step_00000002.npz").write_bytes(b"")
    meta = {"n_pairs": 4, "n_val_pairs": 0, "batch_size": 4, "seed": 0, "image_size": 128,
            "lr_schedule": "constant", "warmup_steps": 0, "augment": False, "trainable": "norms",
            "learning_rate": 1e-4}
    (run / "meta.json").write_text(json.dumps(meta))
    assert "configuration differs" in _both_raise(
        ValueError, lambda m: m.finetune_sam2(images, masks, tmp_path / "run", **common))

    # the JAX package's checkpoints: an orbax step directory and a multi-host .npz are refused by name
    meta["batch_size"] = 2
    (run / "meta.json").write_text(json.dumps(meta))
    (run / "step_00000002.npz").unlink()
    (run / "step_00000002").mkdir()
    with pytest.raises(ValueError, match="orbax checkpoint directory"):
        loop.finetune_sam2(images, masks, tmp_path / "run", **common)
    (run / "step_00000002").rmdir()
    np.savez(run / "step_00000002.npz", p0=np.zeros(1), o0=np.zeros(1))
    with pytest.raises(ValueError, match="multi-host checkpoints are not read"):
        loop.finetune_sam2(images, masks, tmp_path / "run", **common)

    # a real checkpoint whose step is not a whole number of epochs at the new
    # batch size (no meta.json to catch it first): the JAX message
    fresh = dict(common, resume=False)
    loop.finetune_sam2(images, masks, tmp_path / "real", **fresh)
    (tmp_path / "real" / "checkpoints" / "meta.json").unlink()
    with pytest.raises(ValueError) as err:
        loop.finetune_sam2(images, masks, tmp_path / "real", **dict(common, batch_size=1, epochs=2))
    assert str(err.value) == ("--resume: checkpoint step 2 is not a whole number of epochs at 4 steps/epoch — "
                              "the run configuration changed since the checkpoint was written")


def _record_jax_batches(monkeypatch) -> list:
    seen = []

    def make_train_step(cfg, optimizer, *, trainable="norms"):
        def step(params, opt_state, images_u8, targets):
            jax.debug.callback(lambda i, t: seen.append((np.asarray(i), np.asarray(t))), images_u8, targets,
                               ordered=True)
            return params, opt_state, jnp.float32(0.0)
        return step

    monkeypatch.setattr(jax_ft, "make_train_step", make_train_step)
    return seen


def _record_port_batches(monkeypatch) -> list:
    seen = []

    def make_train_step(model, optimizer, lr):
        def step(images_u8, targets):
            seen.append((np.asarray(images_u8), np.asarray(targets)))
            return torch.tensor(0.0)
        return step

    monkeypatch.setattr(finetune, "make_train_step", make_train_step)
    return seen


@pytest.mark.parametrize("augment", [False, True])
def test_batches_and_flips_equal_jax(tmp_path, init, tiny_models, monkeypatch, augment):
    """The same shuffle, wrap-modulo batches and (seed, step) flips: every
    batch each package's train step is handed, over 3 epochs of 5 pairs at
    batch 2 (2 steps per epoch, the fifth pair never in an epoch's batches)."""
    images, masks = _corpus(tmp_path, 5)
    common = dict(epochs=3, batch_size=2, checkpoint=_npz(tmp_path, init), device="cpu", seed=4, augment=augment)
    jax_seen = _record_jax_batches(monkeypatch)
    jax_loop.finetune_sam2(images, masks, tmp_path / "jax", **common)
    jax.effects_barrier()
    port_seen = _record_port_batches(monkeypatch)
    loop.finetune_sam2(images, masks, tmp_path / "port", **common)
    assert len(port_seen) == len(jax_seen) == 6
    for (pi, pt), (ji, jt) in zip(port_seen, jax_seen):
        assert pi.dtype == ji.dtype == np.uint8 and pi.tobytes() == ji.tobytes()
        assert pt.dtype == jt.dtype == np.float32 and pt.tobytes() == jt.tobytes()


def test_multi_device_refusals(tmp_path, init, tiny_models, monkeypatch):
    """The JAX loop's errors: --data-parallel needs that many devices, and a
    batch it divides. ATLASPATCH_NUM_HOSTS alone no longer refuses: as in the
    JAX loop, it does not make training multi-process."""
    images, masks = _corpus(tmp_path, 2)
    common = dict(checkpoint=_npz(tmp_path, init), device="cpu")
    with pytest.raises(RuntimeError, match=r"--data-parallel 2 needs that many devices; 1 visible"):
        loop.finetune_sam2(images, masks, tmp_path / "o", data_parallel=2, **common)
    monkeypatch.setattr(mesh, "local_devices", lambda kind="cuda": [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="batch size must divide evenly over data_parallel"):
        loop.finetune_sam2(images, masks, tmp_path / "o", data_parallel=2, batch_size=3, **common)
    assert not (tmp_path / "o").exists()
    monkeypatch.setenv("ATLASPATCH_NUM_HOSTS", "2")
    assert loop.finetune_sam2(images, masks, tmp_path / "o", **common)["steps"] == 1


def test_a_save_error_propagates_chained(tmp_path, init, tiny_models, monkeypatch):
    images, masks = _corpus(tmp_path, 2)

    def full_disk(*_a, **_k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(checkpoints, "save_checkpoint", full_disk)
    with pytest.raises(RuntimeError, match="saving the step 1 checkpoint") as err:
        loop.finetune_sam2(images, masks, tmp_path / "o", checkpoint=_npz(tmp_path, init), device="cpu",
                           save_every=1)
    assert isinstance(err.value.__cause__, OSError) and err.value.__cause__.errno == 28


# --------------------------------------------------------------- the corpus
@pytest.mark.parametrize("seed", range(4))
def test_synthetic_corpus_pixels_equal_jax(seed):
    img, mask = synthetic_corpus.make_annotated_thumbnail(256, 192, seed=seed)
    want_img, want_mask = jax_corpus.make_annotated_thumbnail(256, 192, seed=seed)
    assert img.dtype == want_img.dtype == np.uint8 and img.shape == (192, 256, 3)
    assert img.tobytes() == want_img.tobytes() and mask.tobytes() == want_mask.tobytes()


def test_synthetic_corpus_command_writes_the_jax_files(tmp_path, monkeypatch, capsys):
    import sys

    for module, out in ((jax_corpus, tmp_path / "jax"), (synthetic_corpus, tmp_path / "port")):
        monkeypatch.setattr(sys, "argv", ["synthetic_corpus", str(out), "--n", "2", "--width", "96",
                                          "--height", "64", "--seed", "9", "--prefix", "s"])
        module.main()
        assert capsys.readouterr().out == f"2 pairs: {out / 'images'} | {out / 'masks'}\n"
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert [str(p) for p in files] == ["images/s0000.png", "images/s0001.png", "masks/s0000_mask.png",
                                       "masks/s0001_mask.png"]
    assert all((tmp_path / "jax" / p).read_bytes() == (tmp_path / "port" / p).read_bytes() for p in files)
