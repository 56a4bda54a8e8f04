"""The port's local meshes (atlaspatch_tpu_torch/parallel/) against the JAX
package's, one process. This file holds the mesh helpers and the mesh
predictor; the sharded step, tensor parallelism and the engine are in
``test_torch_parallel_tp.py``, the command line in
``test_torch_parallel_cli.py``, fine-tuning in
``test_torch_parallel_finetune.py``.

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

import jax
import numpy as np
import pytest
import torch

from atlaspatch_tpu.core.config import SegmentationConfig as JaxSegmentationConfig
from atlaspatch_tpu.parallel import mesh as jax_mesh
from atlaspatch_tpu.services.segmentation import SAM2Predictor as JaxPredictor
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.core.config import SegmentationConfig
from atlaspatch_tpu_torch.models.sam2 import model
from atlaspatch_tpu_torch.parallel import mesh
from atlaspatch_tpu_torch.services.segmentation import SAM2Predictor
from torch_parallel_helpers import BF16_NEAR, NEAR, _assert_bits, _cpus, _jax_mesh
from torch_port_helpers import CFG, JAX_CFG, free_tmp_path, shared_flax_params  # noqa: F401


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
