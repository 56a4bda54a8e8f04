"""The port's local meshes (atlaspatch_tpu_torch/parallel/) against the JAX
package's, one process.

The JAX side runs on the conftest's 8 virtual CPU devices; the port on
meshes that name the ``cpu`` device several times, which is how a mesh of
2–8 replicas is built without that many cards. Both packages run the same
inputs, made from a numpy seed, with the same weights:

  * ``shard_batch`` splits a batch as ``P("data")``'s addressable shards lie,
    in device order; ``embedding_mesh`` has JAX's shape and refusal;
  * data-parallel segmentation (the sharded step, and the mesh predictor's
    three paths on 4 replicas, a batch of 3 that 4 does not divide) gives
    the one-device predictor's packed bits, and the JAX mesh predictor's,
    except where the logit lies within 1e-4 of the threshold (float32;
    tests/test_train_and_parallel.py:187-244); in bfloat16 (:270) the mesh
    equals one device at that bar, and JAX's mesh except within 2^-5 of the
    largest |logit| (four bfloat16 ulps) of the threshold;
  * the tensor-parallel plan shards the axis ``vit_tp_shardings`` shards,
    for every float and int8 parameter, and ``shard_vit`` slices the int8
    buffers so; the TP forward on a (4, 2) mesh is within rtol 2e-4 / atol
    2e-5 of JAX's mesh forward and of the replicated one
    (tests/test_train_and_parallel.py:325); the TP int8 forward equals the
    port's one-device int8 bit for bit and is within 1e-3 of the largest
    |feature| of JAX's int8 mesh forward (``test_torch_int8.py``'s bar);
  * the engine's DP and TP ``extract_batch`` equal one device's
    (tests/test_engine_mesh.py:35-62), in int8 too;
  * ``process --seg-data-parallel --feature-parallel tensor`` on 8 CPU
    "devices" (``local_devices`` patched) gives one device's coordinates
    byte for byte and features at cosine > 0.9999
    (tests/test_cli_mesh_process.py:66-91, vit_l_32 at depth 2), and
    ``--feature-parallel tensor --feature-precision int8`` one device's
    int8 features bit for bit;
  * ``finetune_sam2(data_parallel=2)`` over two CPU replicas follows the
    one-device loop at rtol 2e-3.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from atlaspatch_tpu.core.config import SegmentationConfig as JaxSegmentationConfig
from atlaspatch_tpu.models.encoders.vit import ViT as JaxViT
from atlaspatch_tpu.models.encoders.vit import ViTSpec as JaxViTSpec
from atlaspatch_tpu.models.encoders.vit import quantize_vit_params
from atlaspatch_tpu.models.sam2 import model as jax_model
from atlaspatch_tpu.parallel import mesh as jax_mesh
from atlaspatch_tpu.parallel.sharding import vit_tp_shardings
from atlaspatch_tpu.services.segmentation import SAM2Predictor as JaxPredictor
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.core.config import SegmentationConfig
from atlaspatch_tpu_torch.models.encoders.engine import PreprocessSpec, TorchFeatureExtractor
from atlaspatch_tpu_torch.models.encoders.vit import ViT, ViTSpec, flax_tree_to_torch
from atlaspatch_tpu_torch.models.sam2 import model
from atlaspatch_tpu_torch.parallel import mesh
from atlaspatch_tpu_torch.parallel.sharding import shard_vit, vit_flax_key_map, vit_tp_plan
from atlaspatch_tpu_torch.services.segmentation import SAM2Predictor
from torch_port_helpers import CFG, JAX_CFG, free_tmp_path, port_model, shared_flax_params, shared_vit_params  # noqa: F401

NEAR = 1e-4
BF16_NEAR = 2.0**-5  # of the largest |logit|: four bfloat16 ulps (2^-7 relative spacing)
THRESHOLD = 0.0


def _jax_mesh(data: int, model_parallel: int = 1) -> Mesh:
    devices = np.asarray(jax.devices()[: data * model_parallel]).reshape(data, model_parallel)
    return Mesh(devices, axis_names=("data", "model"))


def _cpus(n: int) -> list:
    return [torch.device("cpu")] * n


# ------------------------------------------------------------------ mesh helpers
def test_shard_batch_and_embedding_mesh_equal_jax():
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for model_parallel in (1, 2, 4):
        want_mesh = jax_mesh.embedding_mesh(model_parallel=model_parallel, devices=jax.devices()[:8])
        got_mesh = mesh.embedding_mesh(model_parallel=model_parallel, devices=_cpus(8))
        assert got_mesh.shape == dict(want_mesh.shape)
        sharded = jax_mesh.shard_batch(want_mesh, batch)
        by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
        got = mesh.shard_batch(got_mesh, batch)
        assert len(got) == 8 // model_parallel
        for g, row in zip(got, want_mesh.devices):  # one per data row, in row order
            for d in row:  # P("data") repeats the row's rows on each of its model devices
                np.testing.assert_array_equal(g.numpy(), by_device[d])
    module = torch.nn.Linear(4, 4)
    replicas = mesh.replicate(mesh.embedding_mesh(2, _cpus(4)), module)
    assert len(replicas) == 2 and replicas[0] is module and replicas[1] is not module
    torch.testing.assert_close(replicas[1].weight, module.weight, rtol=0, atol=0)
    assert replicas[1].weight.data_ptr() != module.weight.data_ptr()
    for bad in (3, 0):
        with pytest.raises(ValueError, match="must divide device count 8"):
            mesh.embedding_mesh(model_parallel=bad, devices=_cpus(8))
    with pytest.raises(ValueError):
        jax_mesh.embedding_mesh(model_parallel=3, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="does not divide over 4"):
        mesh.shard_batch(mesh.embedding_mesh(1, _cpus(4)), batch[:3])


def test_local_devices_lists_distinct_cards(monkeypatch):
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.local_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert mesh.local_devices("cuda:1") == [torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.local_devices("cuda") == []


def test_process_group_settings(monkeypatch):
    """maybe_init_distributed's rule: nothing without WORLD_SIZE > 1; a
    refusal naming the torchrun variables it lacks; gloo on the CPU or when
    local ranks outnumber the cards (two ranks sharing one), else nccl.
    host_identity keeps the JAX order: ATLASPATCH_NUM_HOSTS before a group."""
    from atlaspatch_tpu_torch.parallel import multihost

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "ATLASPATCH_NUM_HOSTS"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_init_distributed("cpu") is False and multihost.live_group() is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.maybe_init_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT unset"):
        multihost.maybe_init_distributed("cpu")
    assert multihost.choose_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.choose_backend(2, "cuda") == "gloo"  # two ranks share the card: NCCL refuses that
    assert multihost.choose_backend(1, "cuda:0") == "nccl"
    assert multihost.choose_backend(1, "cpu") == "gloo"
    assert multihost.host_identity() == (0, 1)
    monkeypatch.setenv("ATLASPATCH_NUM_HOSTS", "3")
    monkeypatch.setenv("ATLASPATCH_HOST_ID", "2")
    assert multihost.host_identity() == (2, 3)
    multihost.barrier("no group: a no-op")


# ------------------------------------------------------------ data-parallel SAM2
@pytest.fixture(scope="module")
def seg_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("sam2") / "sam2.npz"
    np.savez(path, **_flatten(shared_flax_params(3)))
    yield path
    path.unlink()


def _predictors(path, precision: str):
    jax_cfg = JaxSegmentationConfig(device="cpu", batch_size=4, precision=precision, checkpoint_path=path)
    cfg = SegmentationConfig(device="cpu", batch_size=4, precision=precision, checkpoint_path=path)
    return (JaxPredictor(jax_cfg, JAX_CFG, mesh=_jax_mesh(4)),
            SAM2Predictor(cfg, CFG),
            SAM2Predictor(cfg, CFG, mesh=mesh.embedding_mesh(1, _cpus(4))))


def _assert_bits(got, want, logits, what, near=NEAR):
    differ = got != want
    near = np.abs(logits - THRESHOLD) < near
    assert not (differ & ~near).any(), f"{what}: {int((differ & ~near).sum())} bits differ away from the threshold"
    assert 0 < got.mean() < 1, what


def test_sharded_segment_step_matches_jax():
    params = shared_flax_params(3)
    port = port_model(params)
    thumbs = np.random.default_rng(11).integers(0, 256, (4, 64, 80, 3), dtype=np.uint8)
    jmesh = _jax_mesh(4)
    step = jax_model.make_sharded_segment_step(JAX_CFG, jmesh, from_thumbs=True)
    rep = NamedSharding(jmesh, P())
    want = np.asarray(step(jax.device_put(jax.tree.map(jnp.asarray, params), rep), jnp.asarray(thumbs),
                           jnp.float32(THRESHOLD)))
    sharded = model.make_sharded_segment_step(port, mesh.embedding_mesh(1, _cpus(4)), from_thumbs=True)
    got = sharded(torch.from_numpy(thumbs), THRESHOLD).numpy()
    single = model.segment_step_packed_from_thumbs(port, torch.from_numpy(thumbs), THRESHOLD).numpy()
    np.testing.assert_array_equal(got, single)
    logits = model.thumbs_to_logits(port, torch.from_numpy(thumbs)).numpy()
    _assert_bits(np.unpackbits(got, axis=-1), np.unpackbits(want, axis=-1), logits, "sharded step")
    with pytest.raises(ValueError, match="does not divide over 4"):
        sharded(torch.from_numpy(thumbs[:3]), THRESHOLD)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_mesh_predictor_matches_jax(seg_weights, precision):
    """The three device paths of the mesh predictor on 3 thumbnails (4
    replicas: one padded row): grouped with the on-device resample to the
    thumbnail shape, grouped at the model size, and model-size images."""
    jax_pred, single, sharded = _predictors(seg_weights, precision)
    assert len(sharded._replicas.replicas) == 4
    assert all(p.dtype == getattr(torch, precision) for r in sharded._replicas.replicas for p in r.parameters())
    rng = np.random.default_rng(7)
    thumbs = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(3)]
    S = CFG.image_size
    imgs = rng.integers(0, 256, (3, S, S, 3), dtype=np.uint8)
    assert sharded._replicas.replicas[0] is sharded.model
    with torch.inference_mode():
        up = model.thumbs_to_logits(single.model, torch.from_numpy(np.stack(thumbs))).numpy()
        rows, cols = model.pil_nearest_index(48, S), model.pil_nearest_index(64, S)
        cases = {
            "to_shape": (lambda p: p.predict_masks_grouped_async(thumbs, targets=[(48, 64)] * 3)(),
                         up[:, rows][:, :, cols]),
            "from_thumbs": (lambda p: p.predict_masks_grouped_async(thumbs)(), up),
            "packed": (lambda p: p.fetch_masks(p.predict_masks_async(imgs)),
                       model.segment_step(single.model, torch.from_numpy(imgs)).numpy()),
        }
    for name, (run, logits) in cases.items():
        got, one, want = (np.stack(run(p)) for p in (sharded, single, jax_pred))
        assert got.shape == one.shape == want.shape and len(got) == 3, name
        _assert_bits(got, one, logits, f"{name} mesh vs one device")
        # bfloat16 keeps 8 significant bits, so two frameworks' logits drift by a few of its
        # ulps of the largest logit: bits may differ within BF16_NEAR of it from the threshold
        near = NEAR if precision == "float32" else BF16_NEAR * np.abs(logits).max()
        _assert_bits(got, want, logits, f"{name} port vs JAX mesh", near)


# ------------------------------------------------------------- tensor parallelism
_TP_SPECS = {
    "gated_layerscale": dict(img_size=32, patch_size=8, dim=64, depth=1, heads=4, mlp_hidden=128,
                             gated_mlp=True, layerscale=True),
    "swiglu_map": dict(img_size=32, patch_size=8, dim=64, depth=2, heads=4, mlp_hidden=64, swiglu=True,
                       act="silu", pool="map"),
    "rope_registers": dict(img_size=32, patch_size=8, dim=64, depth=2, heads=4, pos_mode="rope", reg_tokens=2,
                           class_token=True),
    # virchow's block: a SwiGLU-packed MLP over a half-width no multiple of 16 (44: a shard's fc2 K is
    # 22, and shard 1's columns start at byte 22 of a row), LayerScale, register tokens, CLS + mean
    # pooling; its gate ReLU, not SiLU: the CPU's SiLU rounds a row's vector tail otherwise than its
    # body, and a shard's rows of 22 and the whole rows of 44 end in other tails
    "swiglu_ragged": dict(img_size=32, patch_size=8, dim=64, depth=2, heads=4, mlp_hidden=44, swiglu=True,
                          act="relu", layerscale=True, reg_tokens=4, pool="cls_mean_concat"),
}


def _port_vit(kw: dict, params: dict, quant: bool = False) -> ViT:
    vit = ViT(ViTSpec(**kw, quant_int8=quant))
    vit.load_state_dict(flax_tree_to_torch(params), strict=True)
    return vit.eval()


@pytest.mark.parametrize("quant", [False, True])
def test_tp_plan_shards_the_axes_of_vit_tp_shardings(quant):
    kw = _TP_SPECS["gated_layerscale"]
    spec = JaxViTSpec(**kw)
    params = shared_vit_params(spec, seed=2)
    if quant:
        params = quantize_vit_params(params)
    vit = _port_vit(kw, params, quant)
    want = {"/".join(p.key for p in path): tuple(sh.spec)
            for path, sh in jax.tree_util.tree_leaves_with_path(vit_tp_shardings(params, _jax_mesh(4, 2)))}
    keys = vit_flax_key_map(vit)
    assert sorted(keys) == sorted(flax_tree_to_torch(params)) == sorted(vit.state_dict())
    assert sorted(keys.values()) == sorted(want)
    assert vit_tp_plan(vit) == want
    sharded = {k: v for k, v in want.items() if v}
    assert {k.split("/", 1)[1] for k in sharded} == (
        {"attn/qkv/kernel_q", "attn/qkv/qscale", "attn/qkv/bias", "attn/proj/kernel_q", "mlp/fc_gate/kernel_q",
         "mlp/fc_gate/qscale", "mlp/fc_gate/bias", "mlp/fc_up/kernel_q", "mlp/fc_up/qscale", "mlp/fc_up/bias",
         "mlp/fc2/kernel_q"} if quant else
        {"attn/qkv/kernel", "attn/qkv/bias", "attn/proj/kernel", "mlp/fc_gate/kernel", "mlp/fc_gate/bias",
         "mlp/fc_up/kernel", "mlp/fc_up/bias", "mlp/fc2/kernel"})
    # shard_vit splits those axes: by head columns, hidden units and input columns; the row-parallel
    # layers' int8 qscale whole on every shard, as the plan replicates it
    replicas = shard_vit(vit, mesh.embedding_mesh(2, _cpus(8)))
    weight = "weight_q" if quant else "weight"
    sd = vit.state_dict()
    for replica in replicas:
        attn, mlp = replica.blocks[0].attn, replica.blocks[0].mlp
        assert attn.quantized == mlp.quantized == quant
        qkv = torch.cat([getattr(sh.qkv, weight) for sh in attn.shards]).reshape(2, 3, 2, 16, 64)
        torch.testing.assert_close(qkv.transpose(0, 1).reshape(3 * 64, 64), sd[f"blocks.0.attn.qkv.{weight}"],
                                   rtol=0, atol=0)
        for owner, layer, dim in (("attn", "proj", 1), ("mlp", "fc_gate", 0), ("mlp", "fc_up", 0), ("mlp", "fc2", 1)):
            got = torch.cat([getattr(getattr(sh, layer), weight) for sh in (attn if owner == "attn" else mlp).shards],
                            dim=dim)
            torch.testing.assert_close(got, sd[f"blocks.0.{owner}.{layer}.{weight}"], rtol=0, atol=0)
        if quant:
            qkv_scale = torch.cat([sh.qkv.qscale for sh in attn.shards]).reshape(2, 3, 2, 16).permute(1, 0, 2, 3)
            torch.testing.assert_close(qkv_scale.reshape(-1), sd["blocks.0.attn.qkv.qscale"], rtol=0, atol=0)
            for sh in attn.shards:
                torch.testing.assert_close(sh.proj.qscale, sd["blocks.0.attn.proj.qscale"], rtol=0, atol=0)
            for sh in mlp.shards:
                torch.testing.assert_close(sh.fc2.qscale, sd["blocks.0.mlp.fc2.qscale"], rtol=0, atol=0)
        assert all(sh.proj.bias is None for sh in attn.shards) and all(sh.fc2.bias is None for sh in mlp.shards)


@pytest.mark.parametrize("name", sorted(_TP_SPECS))
def test_tp_forward_matches_jax_mesh_and_replicated(name):
    kw = _TP_SPECS[name]
    spec = JaxViTSpec(**kw)
    params = shared_vit_params(spec, seed=4)
    jvit = JaxViT(spec)
    imgs = np.random.default_rng(0).uniform(size=(8, 32, 32, 3)).astype(np.float32)
    jmesh = _jax_mesh(4, 2)
    replicated = np.asarray(jvit.apply({"params": params}, jnp.asarray(imgs)))
    sp = jax.tree.map(jax.device_put, params, vit_tp_shardings(params, jmesh))
    with jmesh:
        want = np.asarray(jax.jit(lambda p, x: jvit.apply({"params": p}, x))(
            sp, jax.device_put(jnp.asarray(imgs), NamedSharding(jmesh, P("data")))))

    vit = _port_vit(kw, params)
    replicas = shard_vit(vit, mesh.embedding_mesh(2, _cpus(8)))
    assert len(replicas) == 4
    with torch.inference_mode():
        got = torch.cat([r(torch.from_numpy(imgs[2 * i: 2 * i + 2])) for i, r in enumerate(replicas)]).numpy()
        one = vit(torch.from_numpy(imgs)).numpy()
    for ref in (want, replicated):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, one, rtol=2e-4, atol=2e-5)
    # the shards hold whole heads and hidden units, half each
    block = replicas[0].blocks[0]
    assert [s.heads for s in block.attn.shards] == [2, 2] and block.attn.shards[0].proj.bias is None
    assert block.mlp.shards[0].fc2.weight.shape[1] == spec.hidden_dim // 2


@pytest.mark.parametrize("name,int8_attn", [*((name, False) for name in sorted(_TP_SPECS)),
                                            ("rope_registers", True)])
def test_tp_int8_forward_matches_one_device_and_jax_mesh(name, int8_attn, monkeypatch):
    """Tensor-parallel int8 on a (4, 2) mesh: each replica's rows equal the
    one-device int8 model's on the same rows bit for bit (the row-parallel
    quantizers take the row's abs-max across the shards, the int32 partials
    are summed before one dequantization), and the whole is within
    test_torch_int8.py's bar of JAX's int8 forward under vit_tp_shardings."""
    from atlaspatch_tpu_torch.models.encoders.vit import RowParallel
    from atlaspatch_tpu_torch.ops import int8 as I

    kw = dict(_TP_SPECS[name], quant_int8_attn=int8_attn)
    spec = JaxViTSpec(**kw, quant_int8=True)
    qtree = quantize_vit_params(shared_vit_params(JaxViTSpec(**_TP_SPECS[name]), seed=5))
    jvit = JaxViT(spec)
    imgs = np.random.default_rng(1).uniform(size=(8, 32, 32, 3)).astype(np.float32)
    jmesh = _jax_mesh(4, 2)
    sp = jax.tree.map(jax.device_put, qtree, vit_tp_shardings(qtree, jmesh))
    with jmesh:
        want = np.asarray(jax.jit(lambda p, x: jvit.apply({"params": p}, x))(
            sp, jax.device_put(jnp.asarray(imgs), NamedSharding(jmesh, P("data")))))

    vit = ViT(ViTSpec(**kw, quant_int8=True))
    vit.load_state_dict(flax_tree_to_torch(qtree), strict=True)
    vit.eval()
    replicas = shard_vit(vit, mesh.embedding_mesh(2, _cpus(8)))
    amaxes, plain = [], I.row_amax_plain
    monkeypatch.setattr(I, "row_amax_plain", lambda rows: amaxes.append(rows.shape) or plain(rows))
    with torch.inference_mode():
        got = [r(torch.from_numpy(imgs[2 * i: 2 * i + 2])).numpy() for i, r in enumerate(replicas)]
        assert len(amaxes) == 4 * spec.depth * 2 * 2  # replicas x blocks x (attn, mlp) x shards
        one = [vit(torch.from_numpy(imgs[2 * i: 2 * i + 2])).numpy() for i in range(4)]
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g, o)
    got = np.concatenate(got)
    err = np.abs(got - want).max()
    print(f"{name} (int8 attention {int8_attn}): TP int8 vs JAX's mesh max-abs {err:.3g} of {np.abs(want).max():.3g}")
    assert got.shape == want.shape and err <= 1e-3 * np.abs(want).max()
    block = replicas[0].blocks[0]
    assert isinstance(block.attn, RowParallel) and block.attn.quantized and block.mlp.quantized
    assert [s.heads for s in block.attn.shards] == [2, 2] and block.attn.shards[0].proj.bias is None
    if spec.pool == "map":  # the MAP head's MLP stays float, and whole: one device's result
        assert not isinstance(replicas[0].head.mlp, RowParallel)


def test_shard_vit_pitches_the_int8_shards():
    """Every int8 shard's weight_q lies at the 16-byte row pitch on its
    device (``pitch16(K)`` bytes a row, a 16-byte base): fc2's K 22 a
    shard, shard 1's a copy of its own (its columns start at byte 22 of the
    whole weight's rows), with the values of its slice."""
    from atlaspatch_tpu_torch.models.encoders.vit import Int8Linear
    from atlaspatch_tpu_torch.ops.int8 import pitch16

    kw = _TP_SPECS["swiglu_ragged"]
    vit = _port_vit(kw, quantize_vit_params(shared_vit_params(JaxViTSpec(**kw), seed=6)), quant=True)
    whole = vit.blocks[1].mlp.fc2.weight_q
    replicas = shard_vit(vit, mesh.embedding_mesh(2, _cpus(8)))
    for replica in replicas:
        linears = [m for m in replica.modules() if isinstance(m, Int8Linear)]
        assert len(linears) == 2 * 2 * 4  # blocks x shards x (qkv, proj, fc1, fc2)
        for m in linears:
            w = m.weight_q
            assert w.stride() == (pitch16(w.shape[1]), 1) and w.data_ptr() % 16 == 0, (w.shape, w.stride())
        shards = replica.blocks[1].mlp.shards
        assert [s.fc2.weight_q.stride(0) for s in shards] == [32, 32]
        for i, s in enumerate(shards):
            assert torch.equal(s.fc2.weight_q, whole[:, 22 * i: 22 * (i + 1)])
            assert s.fc2.weight_q.untyped_storage().data_ptr() != whole.untyped_storage().data_ptr()


def test_tp_refuses_a_model_axis_that_does_not_divide():
    vit = _port_vit(_TP_SPECS["gated_layerscale"], shared_vit_params(JaxViTSpec(**_TP_SPECS["gated_layerscale"])))
    with pytest.raises(ValueError, match=r"heads \(4\) and the MLP hidden width \(128\)"):
        shard_vit(vit, mesh.embedding_mesh(8, _cpus(8)))
    with pytest.raises(ValueError, match=r"heads \(4\) and the MLP hidden width \(128\)"):
        shard_vit(vit, mesh.embedding_mesh(3, _cpus(3)))


# ---------------------------------------------------------------------- the engine
def _toy_extractor(vit: ViT, **kw) -> TorchFeatureExtractor:
    import copy

    return TorchFeatureExtractor(
        name="toy-vit", embedding_dim=32,
        spec=PreprocessSpec(crop=16, resize=16, mode="square", mean=(0, 0, 0), std=(1, 1, 1)),
        model=copy.deepcopy(vit), device="cpu", max_batch=8, prep_workers=2, **kw)


@pytest.mark.parametrize("compute_dtype", ["float32", "int8"])
def test_engine_dp_and_tp_match_single_device(compute_dtype):
    from atlaspatch_tpu_torch.models.encoders.vit import quantize_vit_state_dict

    kw = dict(img_size=16, patch_size=8, dim=32, depth=1, heads=4, pool="cls")
    params = shared_vit_params(JaxViTSpec(**kw), seed=6)
    vit = _port_vit(kw, params)
    if compute_dtype == "int8":
        state = quantize_vit_state_dict(vit.state_dict())
        vit = ViT(ViTSpec(**kw, quant_int8=True))
        vit.load_state_dict(state)
    rng = np.random.default_rng(0)
    patches = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(13)]
    single = _toy_extractor(vit, compute_dtype=compute_dtype).extract_batch(patches, batch_size=8)
    dp = _toy_extractor(vit, compute_dtype=compute_dtype, mesh=mesh.embedding_mesh(1, _cpus(8)))
    assert len(dp.replicas) == 8 and len({id(r) for r in dp.replicas}) == 8
    got = dp.extract_batch(patches, batch_size=8)
    assert got.shape == (13, 32)
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-5)
    tp = _toy_extractor(vit, compute_dtype=compute_dtype, mesh=mesh.embedding_mesh(2, _cpus(8)),
                        tensor_parallel=True)
    assert tp.replicas[0].blocks[0].attn.quantized == (compute_dtype == "int8")
    np.testing.assert_allclose(tp.extract_batch(patches[:8], batch_size=8), single[:8], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.extract_batch(patches, batch_size=4), single, rtol=1e-5, atol=1e-5)
    if compute_dtype == "int8":  # qscale kept float32 through the cast, the rest bfloat16, on every shard
        shard = tp.replicas[0].blocks[0].mlp.shards[1]
        assert shard.fc2.qscale.dtype == torch.float32 and shard.fc1.bias.dtype == torch.bfloat16
        np.testing.assert_array_equal(tp.extract_batch(patches, batch_size=4), single)


# ---------------------------------------------------------------- the command line
@pytest.fixture
def mesh_cli(tmp_path, monkeypatch):
    """The port's CLI with test_tiny SAM2 (random weights) and vit_l_32 cut
    to depth 2 (full width: 16 heads split 8 ways)."""
    from atlaspatch_tpu_torch.models.encoders import zoo
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from torch_port_helpers import write_png_slides

    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    entry = zoo.ENTRIES["vit_l_32"]
    monkeypatch.setitem(zoo.ENTRIES, "vit_l_32", dataclasses.replace(entry, spec=dataclasses.replace(entry.spec,
                                                                                                      depth=2)))
    return write_png_slides(tmp_path, {"s0": 0, "s1": 1}, {"s0": 0.5, "s1": 0.5})


def _process(slides, csv, out, *extra):
    from torch_port_helpers import invoke_cli

    return invoke_cli("atlaspatch_tpu_torch", [
        "process", slides, "--output", out, "--patch-size", "64", "--target-mag", "20", "--device", "cpu",
        "--seg-batch-size", "8", "--feature-extractors", "vit_l_32", "--feature-batch-size", "16",
        "--mpp-csv", csv, "--verbose", *extra])


def test_process_on_an_8_device_mesh_matches_one_device(mesh_cli, tmp_path, monkeypatch):
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    slides, csv = mesh_cli
    result = _process(slides, csv, tmp_path / "single")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    built = []
    init = SAM2SegmentationService.__init__

    def record(self, cfg, *a, mesh=None, **kw):
        built.append(mesh)
        init(self, cfg, *a, mesh=mesh, **kw)

    monkeypatch.setattr(SAM2SegmentationService, "__init__", record)
    monkeypatch.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(8))
    result = _process(slides, csv, tmp_path / "mesh", "--seg-data-parallel", "--feature-parallel", "tensor")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    assert built[0].shape == {"data": 8, "model": 1}
    for stem in ("s0", "s1"):
        a = read_h5(tmp_path / "single" / "patches" / f"{stem}.h5")[0]
        b = read_h5(tmp_path / "mesh" / "patches" / f"{stem}.h5")[0]
        ca, cb = a["coords"], b["coords"]
        assert ca.shape[0] > 0 and ca.tobytes() == cb.tobytes()
        fa, fb = a["features/vit_l_32"], b["features/vit_l_32"]
        assert fa.shape == fb.shape == (ca.shape[0], 1024)
        assert np.isfinite(fa).all() and np.isfinite(fb).all()
        cos = np.sum(fa * fb, -1) / (np.linalg.norm(fa, axis=-1) * np.linalg.norm(fb, axis=-1))
        assert cos.min() > 0.9999, f"{stem}: min cosine {cos.min()}"


def test_tensor_parallel_int8_is_refused_before_any_slide(mesh_cli, tmp_path, monkeypatch):
    """Named when tensor-parallel int8 was refused: ``process --feature-parallel
    tensor --feature-precision int8`` on 8 CPU "devices" (one (1, 8) mesh)
    gives one device's coordinates byte for byte and its int8 features bit
    for bit. On the CPU ``int8`` resolves to float32, as in the JAX package;
    here it is held at int8 so the W8A8 shards run (their plain versions)."""
    from atlaspatch_tpu_torch.models.encoders.vit import RowParallel
    from atlaspatch_tpu_torch.services import feature_embedding
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    slides, csv = mesh_cli
    monkeypatch.setattr(feature_embedding, "resolve_feature_dtype", lambda device, precision: precision)
    result = _process(slides, csv, tmp_path / "one", "--feature-precision", "int8")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    built = []
    shard = RowParallel._int8_forward

    def record(self, x):
        built.append(len(self.shards))
        return shard(self, x)

    monkeypatch.setattr(RowParallel, "_int8_forward", record)
    monkeypatch.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(8))
    result = _process(slides, csv, tmp_path / "o", "--feature-parallel", "tensor", "--feature-precision", "int8")
    assert result.exit_code == 0 and "failures: 0" in result.output, result.output
    assert built and set(built) == {8}
    for stem in ("s0", "s1"):
        a = read_h5(tmp_path / "one" / "patches" / f"{stem}.h5")[0]
        b = read_h5(tmp_path / "o" / "patches" / f"{stem}.h5")[0]
        assert a["coords"].shape[0] > 0 and a["coords"].tobytes() == b["coords"].tobytes()
        fa, fb = a["features/vit_l_32"], b["features/vit_l_32"]
        assert fa.shape == (a["coords"].shape[0], 1024) and np.isfinite(fa).all()
        np.testing.assert_array_equal(fb, fa)


# ------------------------------------------------------------------- fine-tuning
FT_COMMON = dict(epochs=2, batch_size=2, device="cpu", seed=1, val_fraction=0.2, augment=True, trainable="all",
                 learning_rate=1e-3)


def _finetune(images, masks, out, **kw):
    from atlaspatch_tpu_torch.models.train import loop

    losses = []
    summary = loop.finetune_sam2(images, masks, out, on_step=lambda s, loss: losses.append(loss), **kw)
    return losses, summary


def _weights(summary) -> dict:
    with np.load(summary["checkpoint"]) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def dp_finetunes(tmp_path_factory):
    """One corpus and init archive; the one-device run and the uninterrupted
    ``--data-parallel 2`` run over two CPU replicas (losses, summary,
    final weights)."""
    import shutil

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.train import loop
    from atlaspatch_tpu_torch.tools import synthetic_corpus

    tmp = tmp_path_factory.mktemp("dp_finetune")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
        images, masks = synthetic_corpus.generate_corpus(tmp / "corpus", n=5, width=256, height=192)
        init = tmp / "init.npz"
        np.savez(init, **_flatten(shared_flax_params(0)))
        common = dict(FT_COMMON, checkpoint=init)
        one = _finetune(images, masks, tmp / "one", **common)
        with pytest.raises(RuntimeError, match="--data-parallel 2 needs that many devices; 1 visible"):
            loop.finetune_sam2(images, masks, tmp / "refused", data_parallel=2, **common)
        mp.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(2))
        dp = _finetune(images, masks, tmp / "dp", data_parallel=2, **common)
        runs = {"one": (*one, _weights(one[1])), "dp": (*dp, _weights(dp[1]))}
    yield images, masks, common, tmp, runs
    shutil.rmtree(tmp, ignore_errors=True)


def test_data_parallel_finetune_follows_one_device(dp_finetunes):
    *_, runs = dp_finetunes
    (one, s1, w1), (dp, s2, w2) = runs["one"], runs["dp"]
    assert len(one) == len(dp) == 4
    np.testing.assert_allclose(dp, one, rtol=2e-3)
    np.testing.assert_allclose([s2["val_loss"], s2["val_iou"]], [s1["val_loss"], s1["val_iou"]], rtol=2e-3)
    # The weights after four updates, each element held to 1e-4 of its
    # tensor's largest. On this corpus the replicas' summation order moves
    # them by at most 7.5e-6 of it, and a step that drops the second
    # replica's gradient moves 201 of the 219 tensors, by up to 3 times it.
    # Left out are the key biases: softmax over the keys does not change
    # when one vector is added to every key, so their exact gradient is
    # zero, what backward gives is rounding noise, and AdamW turns noise of
    # either sign into a step of the learning rate.
    assert sorted(w1) == sorted(w2)
    worst, worst_key = 0.0, None
    for k in w1:
        keep = ~_key_bias(k, w1[k].shape)
        if keep.any():
            rel = float(np.abs(w2[k] - w1[k])[keep].max()) / max(float(np.abs(w1[k])[keep].max()), 1e-30)
            worst, worst_key = max((worst, worst_key), (rel, k))
    assert worst < 1e-4, f"--data-parallel 2 weights differ from one device's by {worst} of {worst_key}'s largest"


def _key_bias(key: str, shape: tuple) -> np.ndarray:
    """The elements of a Flax SAM2 tensor that are a key bias: all of a
    ``k_proj`` bias, the middle third of a Hiera ``qkv`` bias."""
    mask = np.zeros(shape, bool)
    if key.endswith("k_proj/bias"):
        mask[:] = True
    elif key.endswith("qkv/bias"):
        n = shape[-1] // 3
        mask[..., n : 2 * n] = True
    return mask


def test_data_parallel_resume_reproduces_the_uninterrupted_run(dp_finetunes, monkeypatch):
    """Replicas are made after the checkpoint is restored, and each step
    starts from the trainable tensors the update applies to."""
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config

    images, masks, common, tmp, runs = dp_finetunes
    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    monkeypatch.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(2))
    full_losses, _, full_w = runs["dp"]
    out = tmp / "dp_resume"
    _finetune(images, masks, out, data_parallel=2, save_every=1, **dict(common, epochs=1))
    losses, summary = _finetune(images, masks, out, data_parallel=2, save_every=1, resume=True, **common)
    assert summary["resumed_at"] == 2 and summary["steps"] == 4
    np.testing.assert_allclose(losses, full_losses[2:], rtol=1e-5)
    w = _weights(summary)
    worst = max(float(np.max(np.abs(w[k] - full_w[k]))) for k in full_w)
    assert worst < 1e-6, f"--data-parallel 2 resume diverged by {worst}"
