"""The port's sharded SAM2 step, tensor-parallel plan and forward, and the
engine's data- and tensor-parallel ``extract_batch``, against the JAX
package's, one process (see ``tests/test_torch_parallel.py`` for the setting
and the bars).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from atlaspatch_tpu.models.encoders.vit import ViT as JaxViT
from atlaspatch_tpu.models.encoders.vit import ViTSpec as JaxViTSpec
from atlaspatch_tpu.models.encoders.vit import quantize_vit_params
from atlaspatch_tpu.models.sam2 import model as jax_model
from atlaspatch_tpu.parallel.sharding import vit_tp_shardings
from atlaspatch_tpu_torch.models.encoders.engine import PreprocessSpec, TorchFeatureExtractor
from atlaspatch_tpu_torch.models.encoders.vit import ViT, ViTSpec, flax_tree_to_torch
from atlaspatch_tpu_torch.models.sam2 import model
from atlaspatch_tpu_torch.parallel import mesh
from atlaspatch_tpu_torch.parallel.sharding import shard_vit, vit_flax_key_map, vit_tp_plan
from torch_parallel_helpers import THRESHOLD, _assert_bits, _cpus, _jax_mesh
from torch_port_helpers import JAX_CFG, free_tmp_path, port_model, shared_flax_params, shared_vit_params  # noqa: F401


# ------------------------------------------------------------ data-parallel SAM2
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
