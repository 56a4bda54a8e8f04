"""The port's CUDA attention kernel on the card (skips without one).

Imports neither JAX nor the JAX package, so it also runs where only the port
is installed. Run it on a machine with an H100 and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) Each kernel body is
held against the plain version on the same inputs, computed in float32 on the
card (TF32 off): for float32 inputs max-abs 1e-4 and, element by element,
``f32_error_limit`` (the 3xTF32 body's split products; the FMA and
small-window bodies round only in float32); for bfloat16 max-abs
2e-2 and, element by element, ``bf16_error_limit`` (the kernel rounds p and
its float32 result to bfloat16; inputs are unit-normal). The cases that
name a body assert which one launched, by the wrapper's per-variant counts.
"""

import pytest
import torch

from atlaspatch_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(card, b, h, tq, tk, d, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, h, tq, d, device=card, generator=gen).to(dtype)
    k = torch.randn(b, h, tk, d, device=card, generator=gen).to(dtype)
    v = torch.randn(b, h, tk, d, device=card, generator=gen).to(dtype)
    return q, k, v


def _assert_close(got, q, k, v, sm_scale=None):
    """got against the plain version in float32, as the docstring says."""
    error_limit = A.f32_error_limit if got.dtype == torch.float32 else A.bf16_error_limit
    want, limit = error_limit(q, k, v, sm_scale)
    err = (got.float() - want).abs()
    assert err.max().item() <= TOL[got.dtype]
    assert (err <= limit).all(), f"max err/limit {(err / limit).max().item()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (2, 1, 64, 64, 96),  # stage-0 window
        (2, 4, 4, 16, 96),  # q-pool from 4x4 windows
        (4, 2, 16, 64, 96),  # q-pool from 8x8 windows
        (1, 3, 9, 200, 24),  # one-warp Q tile over several ragged K/V tiles
        (2, 4, 49, 196, 96),  # q-pool from 14x14 windows
        (2, 1, 196, 196, 96),  # ragged window
        (1, 4, 300, 300, 96),  # ragged global
        (1, 2, 130, 70, 8),
        (1, 2, 65, 129, 40),
        (1, 1, 128, 128, 128),
    ],
)
def test_kernel_matches_plain(card, dtype, shape):
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, dtype)
    got = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, q, k, v)


def _launched(fn):
    """The result of fn() and the variant it launched, by the wrapper's counts."""
    before = dict(A.flash_attention.variant_launches)
    out = fn()
    after = dict(A.flash_attention.variant_launches)
    (variant,) = [k for k in after if after[k] != before.get(k, 0)]
    return out, variant


WGMMA_CASES = [
    ((1, 4, 2304, 2304, 96), "wgmma_m192"),  # the global block at small B*H
    *[((1, 2, tq, tk, 96), v) for tq, v in ((63, "wgmma_m64"), (64, "wgmma_m64"), (65, "wgmma_m128"),
                                            (129, "wgmma_m192")) for tk in (127, 128, 129)],  # tile edges
    ((2, 4, 49, 49, 96), "wgmma_m64"),  # stage-3 window: ragged 49-row tiles
    ((2, 4, 196, 196, 96), "wgmma_m128"),  # stage-2 window: 196 = 128 + 68 keys
    ((2, 4, 49, 196, 96), "wgmma_m64"),  # q-pool from 14x14 windows
    ((1, 2, 200, 300, 64), "wgmma_m128"),
    ((1, 2, 384, 300, 64), "wgmma_m192"),
    ((1, 2, 200, 300, 128), "wgmma_m128"),
    ((2, 2, 40, 100, 64), "wgmma_m64"),
    ((2, 2, 40, 100, 128), "wgmma_m64"),
]


@pytest.mark.parametrize("shape,variant", WGMMA_CASES)
def test_wgmma_body_matches_plain(card, shape, variant):
    """bfloat16 with D in {64, 96, 128} and T_q > 16 launches the wgmma body."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.bfloat16)
    got, launched = _launched(lambda: A.flash_attention(q, k, v))
    torch.cuda.synchronize()
    assert launched == variant
    _assert_close(got, q, k, v)


@pytest.mark.parametrize("variant", ["mma", "wgmma_m64", "wgmma_m128", "wgmma_m192"])
@pytest.mark.parametrize("shape", [(2, 4, 64, 64, 96), (2, 4, 196, 196, 96), (1, 1, 17, 300, 64)])
def test_every_bf16_body_agrees(card, shape, variant):
    """Launched on any body that fits the inputs, the result is the same function."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.bfloat16, seed=3)
    got, launched = _launched(lambda: A._launch(variant, q, k, v))
    torch.cuda.synchronize()
    assert launched == variant
    _assert_close(got, q, k, v)


@pytest.mark.parametrize("variant", ["mma", "wgmma_m64", "wgmma_m128", "wgmma_m192"])
@pytest.mark.parametrize("shape", [(1, 2, 196, 196, 96), (2, 2, 49, 300, 64)])
def test_negative_scale(card, shape, variant):
    """A negative scale reverses the order of the scores; on ragged K/V tiles
    the masked keys must still get no weight (the wgmma body applies the scale
    before the mask)."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.bfloat16, seed=4)
    got, launched = _launched(lambda: A._launch(variant, q, k, v, -0.125))
    torch.cuda.synchronize()
    assert launched == variant and torch.isfinite(got).all()
    _assert_close(got, q, k, v, -0.125)


TF32X3_SHAPES = [(2, 4, 64, 64, 96), (2, 4, 196, 196, 96), (1, 1, 17, 300, 64)]


@pytest.mark.parametrize("sm_scale", [None, -0.125])
@pytest.mark.parametrize("shape", TF32X3_SHAPES)
def test_tf32x3_body_matches_plain(card, shape, sm_scale):
    """float32 with D in {64, 96}, T_q > 16 and a window past 64 rows launches
    the 3xTF32 body (the 64/64 window, which f32_win takes, forces it); a
    negative scale reverses the scores, and the masked keys of a ragged tile
    must still get no weight."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=5)
    if A.kernel_variant(torch.float32, tq, tk, d) == "tf32x3":
        got, launched = _launched(lambda: A.flash_attention(q, k, v, sm_scale))
    else:
        got, launched = _launched(lambda: A._launch("tf32x3", q, k, v, sm_scale))
    torch.cuda.synchronize()
    assert launched == "tf32x3" and torch.isfinite(got).all()
    _assert_close(got, q, k, v, sm_scale)


@pytest.mark.parametrize("shape", TF32X3_SHAPES)
def test_float32_bodies_agree(card, shape):
    """The FMA and the 3xTF32 body, forced on the same inputs, agree."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=6)
    fma, fma_variant = _launched(lambda: A._launch("f32", q, k, v))
    tc, tc_variant = _launched(lambda: A._launch("tf32x3", q, k, v))
    torch.cuda.synchronize()
    assert (fma_variant, tc_variant) == ("f32", "tf32x3")
    assert (fma - tc).abs().max().item() <= TOL[torch.float32]
    _assert_close(fma, q, k, v)
    _assert_close(tc, q, k, v)


@pytest.mark.parametrize(
    "dtype,d,variant,error",
    [
        (torch.bfloat16, 72, "wgmma_m128", RuntimeError),  # the library builds D 64/96/128
        (torch.bfloat16, 128, "wgmma_m192", RuntimeError),  # and 192 rows only to D = 96
        (torch.float32, 96, "wgmma_m64", ValueError),
        (torch.float32, 96, "mma", ValueError),
        (torch.bfloat16, 96, "tf32x3", ValueError),
        (torch.float32, 128, "tf32x3", RuntimeError),  # built for D = 64 and 96 only
        (torch.bfloat16, 96, "f32_win", ValueError),
        (torch.float32, 96, "f32_win", ValueError),  # T_q = T_kv = 128 > 64
    ],
)
def test_forced_variant_refused(card, dtype, d, variant, error):
    q, k, v = _qkv(card, 1, 1, 128, 128, d, dtype)
    with pytest.raises(error, match="variant|cudaError 1"):
        A._launch(variant, q, k, v)


def test_launch_count_and_non_contiguous_inputs(card):
    q, k, v = _qkv(card, 1, 2, 70, 70, 32, torch.float32)
    before = A.flash_attention.launches
    got = A.attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert A.flash_attention.launches == before + 1
    _assert_close(got, q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("misaligned", [False, True])
def test_strided_views_of_a_fused_projection(card, dtype, misaligned):
    """q, k, v as the trunk hands them over: views of one (B, T, 3, H, D)
    projection, read in place; a view whose rows are not on 16 bytes is
    copied first. The output is a (B, H, T, D) view of (B, T, H, D)."""
    b, t, h, d = 3, 130, 2, 96
    gen = torch.Generator(device=card).manual_seed(1)
    wide = torch.randn(b, t, 3 * h * d + 8, device=card, generator=gen).to(dtype)
    start = 1 if misaligned else 0
    qkv = wide[..., start : start + 3 * h * d].unflatten(-1, (3, h, d))
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    got, variant = _launched(lambda: A.flash_attention(q, k, v))
    torch.cuda.synchronize()
    assert variant == ("wgmma_m192" if dtype == torch.bfloat16 else "tf32x3")
    assert got.shape == (b, h, t, d) and got.transpose(1, 2).is_contiguous()
    _assert_close(got, q, k, v)


# (B, H, T_q, T_kv, D): the float32 default's five window shapes at small B*H,
# ragged T_q and T_kv, and head dims off the Hiera width.
F32WIN_SHAPES = [
    (2, 1, 64, 64, 96),  # stage-0 window
    (2, 2, 16, 64, 96),  # q-pool from 8x8 windows
    (2, 2, 16, 16, 96),  # stage-1 window
    (2, 4, 4, 16, 96),  # q-pool from 4x4 windows
    (2, 4, 49, 49, 96),  # stage-3 window
    *[(1, 3, tq, tk, 96) for tq in (1, 9, 49) for tk in (1, 17, 63, 64)],
    *[(2, 2, 33, 40, d) for d in (8, 40, 128)],
    (67, 3, 4, 16, 96),  # more heads than a stage's units, a ragged last group
]


@pytest.mark.parametrize("sm_scale", [None, -0.125])
@pytest.mark.parametrize("shape", F32WIN_SHAPES)
def test_f32win_body_matches_plain(card, shape, sm_scale):
    """float32 with T_q and T_kv up to 64, where the 3xTF32 body does not take
    it, launches the small-window body (the other shapes force it); a negative
    scale reverses the scores, and the keys past T_kv must still get no
    weight."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=7)
    if A.kernel_variant(torch.float32, tq, tk, d) == "f32_win":
        got, launched = _launched(lambda: A.flash_attention(q, k, v, sm_scale))
    else:
        got, launched = _launched(lambda: A._launch("f32_win", q, k, v, sm_scale))
    torch.cuda.synchronize()
    assert launched == "f32_win" and torch.isfinite(got).all()
    _assert_close(got, q, k, v, sm_scale)


@pytest.mark.parametrize(
    "shape", [(2, 4, 64, 64, 96), (2, 4, 49, 49, 96), (2, 2, 16, 64, 96), (1, 2, 33, 40, 64),
              (2, 2, 20, 64, 128)]
)
def test_f32win_agrees_with_the_other_float32_bodies(card, shape):
    """f32_win, the FMA body and (D 64/96, T_q > 16) the 3xTF32 body, forced
    on the same inputs, agree."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32, seed=8)
    bodies = ["f32_win", "f32"] + (["tf32x3"] if d in A.TF32X3_HEAD_DIMS and tq > 16 else [])
    outs = {}
    for body in bodies:
        outs[body], launched = _launched(lambda: A._launch(body, q, k, v))
        assert launched == body
    torch.cuda.synchronize()
    for body in bodies[1:]:
        assert (outs["f32_win"] - outs[body]).abs().max().item() <= TOL[torch.float32]
    for out in outs.values():
        _assert_close(out, q, k, v)


@pytest.mark.parametrize("tq,tk", [(16, 65), (65, 16), (65, 65)])
def test_f32win_refuses_longer_windows(card, tq, tk):
    q, k, v = _qkv(card, 1, 2, tq, tk, 96, torch.float32)
    with pytest.raises(ValueError, match="f32_win"):
        A._launch("f32_win", q, k, v)


@pytest.mark.parametrize("tq", [4, 16])
def test_f32win_reads_a_fused_projection_in_place(card, tq):
    """q, k, v as a window of the trunk hands them over (the stage-1 window:
    16 rows): views of one (B, T, 3, H, D) projection, rows 3 H D floats
    apart, read without a copy."""
    b, h, d = 3, 2, 96
    gen = torch.Generator(device=card).manual_seed(2)
    qkv = torch.randn(b, tq, 3, h, d, device=card, generator=gen)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    assert all(A._kernel_readable(t) is t for t in (q, k, v))
    got, variant = _launched(lambda: A.flash_attention(q, k, v))
    torch.cuda.synchronize()
    assert variant == "f32_win"
    assert got.shape == (b, h, tq, d) and got.transpose(1, 2).is_contiguous()
    _assert_close(got, q, k, v)


@pytest.mark.parametrize(
    "kind", ["head_dim_100", "head_dim_136", "float16", "mixed_dtype", "cpu_key", "requires_grad"]
)
def test_kernel_refuses(card, kind):
    d = {"head_dim_100": 100, "head_dim_136": 136}.get(kind, 64)
    dtype = torch.float16 if kind == "float16" else torch.float32
    q, k, v = _qkv(card, 1, 1, 16, 16, d, dtype)
    if kind == "mixed_dtype":
        k = k.to(torch.bfloat16)
    if kind == "cpu_key":
        k = k.cpu()
    if kind == "requires_grad":
        v.requires_grad_(True)
    A.reset_launch_counts()
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v)
    assert A.flash_attention.launches == 0


@pytest.mark.parametrize("shape", [(2, 1, 64, 64, 96), (2, 4, 49, 196, 96), (1, 4, 300, 300, 96)])
def test_attention_under_autograd_matches_the_cpu_gradient(card, shape):
    """attention() on CUDA tensors that require grad runs the plain products
    (no launch, one plain_grad_call) and its gradients equal the CPU's; the
    same call without a gradient launches the kernel."""
    b, h, tq, tk, d = shape
    q, k, v = _qkv(card, b, h, tq, tk, d, torch.float32)
    w = torch.randn(b, h, tq, d, device=card, generator=torch.Generator(device=card).manual_seed(1))
    grads = {}
    A.reset_launch_counts()
    for device in (card, torch.device("cpu")):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (q, k, v)]
        (A.attention(*leaves) * w.to(device)).sum().backward()
        grads[device.type] = [t.grad.cpu() for t in leaves]
    assert A.flash_attention.launches == 0 and A.attention.plain_grad_calls == 2
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4 * max(want.abs().max().item(), 1.0)
    with torch.no_grad():
        A.attention(*(t.requires_grad_(True) for t in (q, k, v)))
    assert A.flash_attention.launches == 1 and A.attention.plain_grad_calls == 2


def test_train_step_on_the_card_matches_the_cpu(card):
    """One norms-only AdamW step of the miniature SAM2 from the same weights
    and batch: loss within 1e-4 relative, each norm gradient within 1e-4 of
    its largest CPU value, a bound that the same step with TF32 switched on
    after it was built must exceed; no kernel launch in the step, one per
    trunk attention in the eval forward that follows."""
    import numpy as np

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.model import init_params
    from atlaspatch_tpu_torch.models.train import finetune

    cfg = SAM2Config.test_tiny()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    targets = (rng.random((2, cfg.image_size, cfg.image_size)) > 0.5).astype(np.float32)
    out = {}
    for run in ("cpu", "cuda", "cuda+tf32"):
        device = run.split("+")[0]
        model = init_params(cfg, seed=3).to(device)
        params = finetune.trainable_parameters(model, "norms")
        optimizer, lr = finetune.make_optimizer(params.values(), 1e-3)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        step = finetune.make_train_step(model, optimizer, lr)  # built on the card, it turns TF32 off
        assert device == "cpu" or not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = run.endswith("tf32")
        A.reset_launch_counts()
        try:
            loss = float(step(images, targets))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        assert A.flash_attention.launches == 0
        assert A.attention.plain_grad_calls == sum(cfg.blocks_per_stage)
        out[run] = loss, {k: t.grad.cpu() for k, t in params.items()}
        finetune.make_eval_step(model)(images, targets)
        assert A.flash_attention.launches == (sum(cfg.blocks_per_stage) if device == "cuda" else 0)
    cpu_loss, cpu_grads = out["cpu"]

    def grad_rel(grads):
        return max((grads[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30) for k, g in cpu_grads.items())

    card_loss, card_grads = out["cuda"]
    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    print(f"card vs CPU norm gradients {grad_rel(card_grads):.3g}, with TF32 {grad_rel(out['cuda+tf32'][1]):.3g}")
    assert grad_rel(card_grads) <= 1e-4
    assert grad_rel(out["cuda+tf32"][1]) > 1e-4


def test_runner_on_the_card(card, tmp_path, monkeypatch):
    """One ProcessingRunner run of 8 synthetic slides through the --fast
    SAM2 service on the card (random weights; extraction gets the thumbnail
    thresholded at < 220, as chip_smoke.py's runner phase does): 12 kernel
    launches in the one forward, and each H5 read back by ``read_h5`` holds
    the coordinates extraction yields for its mask."""
    import numpy as np

    from atlaspatch_tpu_torch.core.config import (
        AppConfig, ExtractionConfig, OutputConfig, ProcessingConfig, SegmentationConfig,
    )
    from atlaspatch_tpu_torch.core.models import Mask
    from atlaspatch_tpu_torch.io.synthetic_wsi import SyntheticWSI
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no-hf"))
    monkeypatch.delenv("ATLASPATCH_SAM2_CHECKPOINT", raising=False)
    monkeypatch.delenv("ATLASPATCH_WEIGHTS_DIR", raising=False)

    class Thresholding(SAM2SegmentationService):
        def segment_thumbnails_async(self, thumbs):
            device_resolve = super().segment_thumbnails_async(thumbs)

            def resolve():
                device_resolve()
                tissue = [(np.asarray(t.convert("L"), np.float32) < 220).astype(np.float32) for t in thumbs]
                return [Mask(data=m, source_shape=m.shape) for m in tissue]

            return resolve

    wsis = {f"s{i}": SyntheticWSI(path=f"/virtual/s{i}.svs", mpp=0.5, size=(2048, 1536), seed=i)
            for i in range(8)}
    masks = {}

    class Recording(PatchExtractionService):
        def extract(self, wsi, mask, *, slide):
            masks[slide.stem] = mask
            return super().extract(wsi, mask, slide=slide)

    class Loader:
        def open(self, slide):
            return wsis[slide.stem]

    class NoMpp:
        def resolve(self, slide):
            return None

    in_dir = tmp_path / "slides"
    in_dir.mkdir()
    for stem in wsis:
        (in_dir / f"{stem}.svs").touch()
    seg_cfg = SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
    cfg = AppConfig(
        processing=ProcessingConfig(input_path=in_dir), segmentation=seg_cfg,
        extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
        output=OutputConfig(output_root=tmp_path / "out"), device="cuda",
    )
    extraction = Recording(cfg.extraction, cfg.output)
    runner = ProcessingRunner(config=cfg, segmentation=Thresholding(seg_cfg), extractor=extraction,
                              visualizer=None, mpp_resolver=NoMpp(), wsi_loader=Loader())
    A.reset_launch_counts()
    results, failures = runner.run()
    torch.cuda.synchronize()
    assert failures == [] and len(results) == 8
    assert A.flash_attention.launches == 12  # one forward of 8 thumbnails
    total = 0
    for res in results:
        wsi = wsis[res.slide.stem]
        datasets, attrs = read_h5(res.h5_path)
        entries = extraction._iter_patch_entries(
            wsi, *extraction._prepare_contours(masks[res.slide.stem], wsi), include_patch=False
        )
        want = np.asarray([e[:5] for e in entries], dtype=np.int32).reshape(-1, 5)
        assert datasets["coords"].tobytes() == want.tobytes()
        assert attrs["num_patches"] == res.num_patches == want.shape[0]
        total += res.num_patches
    assert total > 0
    assert sorted(p.name for p in (tmp_path / "out" / "patches").iterdir()) == [f"s{i}.h5" for i in range(8)]


# --- the embedding engine (vit_b_16's width, depth cut to 2) --------------------------
def _vit_entry(depth: int = 2):
    import dataclasses

    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES

    entry = ENTRIES["vit_b_16"]
    return dataclasses.replace(entry, spec=dataclasses.replace(entry.spec, depth=depth))


def _extractor(monkeypatch, tmp_path, **kw):
    from atlaspatch_tpu_torch.models.encoders.zoo import build_extractor

    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no-hf"))
    monkeypatch.delenv("ATLASPATCH_WEIGHTS_DIR", raising=False)
    return build_extractor(_vit_entry(), **kw)


def _patches(n, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(n)]


def test_bf16_extractor_params_are_bfloat16_on_the_card(card, monkeypatch, tmp_path):
    ext = _extractor(monkeypatch, tmp_path, device="cuda", compute_dtype="bfloat16")
    params = list(ext.model.parameters())
    assert params and all(p.dtype == torch.bfloat16 and p.is_cuda for p in params)
    out = ext.extract_batch(_patches(5), batch_size=4)
    assert out.shape == (5, 768) and out.dtype.name == "float32"


def test_float32_extractor_turns_tf32_off_and_matches_the_cpu(card, monkeypatch, tmp_path):
    import copy

    import numpy as np

    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    cpu = _extractor(monkeypatch, tmp_path, device="cpu")
    gpu = TorchFeatureExtractor(name="vit_b_16", embedding_dim=768, spec=cpu.spec,
                                model=copy.deepcopy(cpu.model), device="cuda")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    patches = _patches(4, seed=1)
    got, want = gpu.extract_batch(patches), cpu.extract_batch(patches)
    assert np.abs(got - want).max() <= 1e-4


def test_deferred_and_blocking_fetches_agree_at_a_ragged_size(card, monkeypatch, tmp_path):
    import numpy as np

    ext = _extractor(monkeypatch, tmp_path, device="cuda", compute_dtype="bfloat16")
    patches = _patches(37, seed=2)
    monkeypatch.setenv("ATLASPATCH_DEFERRED_MAX_CHUNKS", "2")
    deferred = ext.extract_batch(patches, batch_size=8)
    monkeypatch.setenv("ATLASPATCH_DEFERRED_FETCH", "0")
    blocking = ext.extract_batch(patches, batch_size=8)
    assert deferred.shape == (37, 768)
    np.testing.assert_array_equal(deferred, blocking)


def test_embed_all_on_the_card(card, monkeypatch, tmp_path):
    """4 synthetic slides: coordinates by the runner (thumbnail thresholded
    on the host), then embed_all with vit_b_16 at depth 2 in bfloat16 on the
    card; read_h5 returns features/vit_b_16 of (num_patches, 768)."""
    import numpy as np

    from atlaspatch_tpu_torch.core.config import (
        AppConfig, ExtractionConfig, FeatureExtractionConfig, OutputConfig, ProcessingConfig,
        SegmentationConfig,
    )
    from atlaspatch_tpu_torch.core.models import Mask
    from atlaspatch_tpu_torch.io.synthetic_wsi import SyntheticWSI
    from atlaspatch_tpu_torch.models.encoders.registry import PatchFeatureExtractorRegistry
    from atlaspatch_tpu_torch.models.encoders.zoo import build_extractor
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
    from atlaspatch_tpu_torch.utils.h5 import read_h5_tree

    monkeypatch.setenv("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no-hf"))
    monkeypatch.delenv("ATLASPATCH_WEIGHTS_DIR", raising=False)
    wsis = {f"s{i}": SyntheticWSI(path=f"/virtual/s{i}.svs", mpp=0.5, size=(2048, 1536), seed=i)
            for i in range(4)}

    class Thresholding:
        def segment_thumbnail(self, wsi):
            arr = np.asarray(wsi.get_thumb((256, 256)).convert("L"), np.float32)
            m = (arr < 220).astype(np.float32)
            return Mask(data=m, source_shape=m.shape)

        def segment_batch(self, batch):
            return [self.segment_thumbnail(w) for w in batch]

    class Loader:
        def open(self, slide):
            return wsis[slide.stem]

    class NoMpp:
        def resolve(self, slide):
            return None

    in_dir = tmp_path / "slides"
    in_dir.mkdir()
    for stem in wsis:
        (in_dir / f"{stem}.svs").touch()
    features = FeatureExtractionConfig(extractors=["vit_b_16"], batch_size=32, device="cuda",
                                       precision="bfloat16")
    cfg = AppConfig(
        processing=ProcessingConfig(input_path=in_dir),
        segmentation=SegmentationConfig(device="cuda", batch_size=4),
        extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
        output=OutputConfig(output_root=tmp_path / "out"), features=features, device="cuda",
    )
    runner = ProcessingRunner(config=cfg, segmentation=Thresholding(),
                              extractor=PatchExtractionService(cfg.extraction, cfg.output),
                              visualizer=None, mpp_resolver=NoMpp(), wsi_loader=Loader())
    results, failures = runner.run()
    assert failures == [] and len(results) == 4
    registry = PatchFeatureExtractorRegistry()
    registry.register("vit_b_16", lambda: build_extractor(_vit_entry(), device="cuda",
                                                          compute_dtype="bfloat16"))
    svc = PatchFeatureEmbeddingService(cfg.extraction, cfg.output, features, registry=registry)
    assert svc.embed_all(results, wsi_loader=Loader()) == []
    for res in results:
        tree = read_h5_tree(res.h5_path)
        feats = tree.datasets["features/vit_b_16"]
        assert feats.shape == (res.num_patches, 768) and feats.dtype.name == "float32"
        assert np.isfinite(feats).all()
        assert tree.dataset_attrs["features/vit_b_16"] == {"name": "vit_b_16", "embedding_dim": 768}
        assert res.metadata["feature_sets"] == ["vit_b_16"]


# --- the int8 serving mode's kernels (csrc/int8_linear.cu) -------------------------------
INT8_SHAPES = [  # (M, N, K): ragged M (5, 37) and K (48, 4304; 3416, 44 and 45 take the 8-, 4- and 1-byte copies)
    (5, 40, 48), (37, 130, 48), (5, 1152, 4304), (37, 4304, 1152), (37, 72, 4304), (130, 24, 3416),
    (17, 8, 44), (33, 17, 45),
]


def _int8_operands(card, m, n, k, seed=0):
    from atlaspatch_tpu_torch.ops import int8 as I

    gen = torch.Generator(device=card).manual_seed(seed + m + n + k)
    x = torch.randn(m, k, device=card, generator=gen) * 3
    xq, s_x = I.quantize_rows_plain(x)
    w = torch.randint(-127, 128, (n, k), device=card, generator=gen, dtype=torch.int32).to(torch.int8)
    qscale = (torch.rand(n, device=card, generator=gen) + 0.5) / 127.0
    bias = torch.randn(n, device=card, generator=gen)
    return xq, s_x, w, qscale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(5, 48), (37, 48), (5, 4304), (37, 4304), (9, 45)])
def test_quantize_rows_kernel_matches_plain(card, dtype, m, k):
    from atlaspatch_tpu_torch.ops import int8 as I

    gen = torch.Generator(device=card).manual_seed(m + k)
    x = (torch.randn(m, k, device=card, generator=gen) * 3).to(dtype)
    x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])  # amax 127 -> s = 1: ties to 127, 2, -4, 0
    x[0, 4:] = 0
    x[1] = 0  # an all-zero row: s = 1e-8 / 127
    before = I.quantize_rows.launches
    xq, s_x = I.quantize_rows(x)
    torch.cuda.synchronize()
    assert I.quantize_rows.launches == before + 1
    assert xq.dtype == torch.int8 and s_x.dtype == torch.float32 and s_x.shape == (m,)
    assert xq[0, :4].tolist() == [127, 2, -4, 0]
    for want_xq, want_s in (I.quantize_rows_plain(x), I.quantize_rows_plain(x.cpu())):
        assert torch.equal(xq.cpu(), want_xq.cpu()) and torch.equal(s_x.cpu(), want_s.cpu())
    # an unaligned view (the scalar path of the same kernel)
    view = torch.empty(m, k + 1, dtype=dtype, device=card)[:, 1:]
    view.copy_(x)
    got = I.quantize_rows(view)
    assert torch.equal(got[0], xq) and torch.equal(got[1], s_x)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", INT8_SHAPES)
def test_int8_linear_kernel_matches_plain(card, m, n, k, out_dtype, bias_dtype):
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, m, n, k)
    bias = None if bias_dtype is None else bias.to(bias_dtype)
    before = I.int8_linear.launches
    got = I.int8_linear(xq, s_x, w, qscale, bias, out_dtype)
    torch.cuda.synchronize()
    assert I.int8_linear.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    want = I.int8_linear_plain(xq, s_x, w, qscale, bias, out_dtype)
    cpu = I.int8_linear_plain(*(None if t is None else t.cpu() for t in (xq, s_x, w, qscale, bias)), out_dtype)
    assert (got.float() - want.float()).abs().max().item() == 0
    assert torch.equal(got.cpu(), cpu)


def test_int8_linear_on_the_card_never_falls_back(card, monkeypatch):
    """A CUDA Int8Linear launches both kernels: it never reaches torch._int_mm
    or a plain version."""
    from atlaspatch_tpu_torch.models.encoders.vit import Int8Linear
    from atlaspatch_tpu_torch.ops import int8 as I

    def refuse(*a, **k):
        raise AssertionError("a fallback ran")

    cases = []
    for k, variant in ((4304, "wgmma"), (3416, "mma")):
        xq, s_x, w, qscale, bias = _int8_operands(card, 37, 72, k)
        want = I.int8_linear_plain(xq, s_x, w, qscale, bias.bfloat16(), torch.bfloat16)
        layer = Int8Linear(k, 72).to(card)
        layer.weight_q.copy_(w)
        layer.qscale.copy_(qscale)
        layer.bias.data = bias.bfloat16()
        x = (torch.randn(37, k, device=card) * 3).bfloat16()
        want_layer = I.int8_linear_plain(*I.quantize_rows_plain(x), w, qscale, bias.bfloat16(), torch.bfloat16)
        cases.append((variant, layer, x, (xq, s_x, w, qscale, bias.bfloat16()), want, want_layer))
    for name in ("int8_linear_plain", "quantize_rows_plain", "int_product", "quantize_plain"):
        monkeypatch.setattr(I, name, refuse)
    monkeypatch.setattr(torch, "_int_mm", refuse)
    for variant, layer, x, operands, want, want_layer in cases:
        I.reset_launch_counts()
        with torch.no_grad():
            got = layer(x[None])[0]
        got_direct = I.int8_linear(*operands, torch.bfloat16)
        torch.cuda.synchronize()
        assert (I.quantize_rows.launches, I.int8_linear.launches) == (1, 2)
        assert I.int8_linear.variant_launches == {variant: 2}
        assert torch.equal(got, want_layer) and torch.equal(got_direct, want)


class _FailingLibrary:
    """An int8 library whose wgmma body reports a tensor map that would not
    encode and whose mma body must not run."""

    def atlas_int8_linear_s8_wgmma(self, *args):
        return 1_000_000 + 1  # CUDA_ERROR_INVALID_VALUE

    def atlas_int8_linear_s8(self, *args):
        raise AssertionError("the mma body ran after the wgmma body failed")


def test_a_failed_wgmma_encode_raises_and_never_retries(card, monkeypatch):
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, 37, 72, 4304)
    monkeypatch.setattr(I, "load_int8_library", lambda: _FailingLibrary())
    I.reset_launch_counts()
    with pytest.raises(RuntimeError, match="encode failed: CUresult 1"):
        I.int8_linear(xq, s_x, w, qscale, bias, torch.bfloat16)
    assert I.int8_linear.launches == 0 and not I.int8_linear.variant_launches


def test_int8_kernels_refuse_what_they_do_not_take(card):
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, 5, 40, 48)
    with pytest.raises(ValueError, match="one device"):
        I.int8_linear(xq, s_x, w.cpu(), qscale, bias, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        I.int8_linear(xq, s_x, w, qscale, bias, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        I.quantize_rows(torch.zeros(4, 8, dtype=torch.float16, device=card))


# --- int8_linear_s8's two bodies (csrc/int8_linear_wgmma.cu and csrc/int8_linear.cu) ------
BODY_SHAPES = [  # (M, N, K): vit_l_16's four linears at batch 32; ragged N (130: mma only); K % 16 == 0 but not
    # % 128; M 1, 5, 37
    (6304, 3072, 1024), (6304, 1024, 1024), (6304, 4096, 1024), (6304, 1024, 4096),
    (37, 4304, 1152), (5, 1152, 4304), (1, 72, 4304), (37, 72, 1040), (5, 40, 48), (6304, 1152, 48),
    (1, 4304, 1040), (37, 130, 48),
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", BODY_SHAPES)
def test_int8_linear_bodies_match_plain_and_each_other(card, m, n, k, out_dtype, bias_dtype):
    """Every body the shape admits (mma, and for bfloat16 out with N a
    multiple of 8 wgmma in 128- and 256-column tiles), forced, equals the
    plain version and the others at max-abs 0; the routed call launches the
    wgmma body where it applies, else the mma body, and a forced wgmma body
    is refused where it does not."""
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, m, n, k)
    bias = None if bias_dtype is None else bias.to(bias_dtype)
    want = I.int8_linear_plain(xq, s_x, w, qscale, bias, out_dtype)
    routed = "wgmma" if out_dtype == torch.bfloat16 and n % 8 == 0 else "mma"
    assert I.linear_variant(m, n, k, out_dtype, xq.data_ptr(), w.data_ptr()) == routed
    bodies = (("mma", None), ("wgmma", 128), ("wgmma", 256)) if routed == "wgmma" else (("mma", None),)
    if routed == "mma":
        with pytest.raises(ValueError, match="writes bfloat16 with N a multiple of 8"):
            I._launch_linear("wgmma", xq, s_x, w, qscale, bias, out_dtype)
    got = {}
    for variant, block_n in bodies:
        I.reset_launch_counts()
        got[variant, block_n] = I._launch_linear(variant, xq, s_x, w, qscale, bias, out_dtype, block_n)
        torch.cuda.synchronize()
        assert I.int8_linear.variant_launches == {variant: 1}
    I.reset_launch_counts()
    got["routed", None] = I.int8_linear(xq, s_x, w, qscale, bias, out_dtype)
    torch.cuda.synchronize()
    assert I.int8_linear.variant_launches == {routed: 1} and I.int8_linear.launches == 1
    for key, y in got.items():
        assert y.dtype == out_dtype and y.shape == (m, n), key
        assert (y.float() - want.float()).abs().max().item() == 0, key
        assert torch.equal(y, got["mma", None]), key


@pytest.mark.parametrize("m,n,k", [(130, 24, 3416), (33, 17, 45), (37, 72, 4308)])
def test_int8_linear_routes_other_depths_to_mma(card, m, n, k):
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, m, n, k)
    I.reset_launch_counts()
    got = I.int8_linear(xq, s_x, w, qscale, bias, torch.bfloat16)
    torch.cuda.synchronize()
    assert I.int8_linear.variant_launches == {"mma": 1}
    assert torch.equal(got, I.int8_linear_plain(xq, s_x, w, qscale, bias, torch.bfloat16))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one byte past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return buf.view(t.shape).copy_(t)


def test_forced_wgmma_refused_where_it_does_not_apply(card):
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, 37, 72, 3416)
    I.reset_launch_counts()
    with pytest.raises(ValueError, match="variant 'wgmma' takes row pitches of a multiple of 16 bytes"):
        I._launch_linear("wgmma", xq, s_x, w, qscale, bias, torch.bfloat16)  # packed rows of K 3,416
    xq, s_x, w, qscale, bias = _int8_operands(card, 37, 72, 1024)
    for a, b in ((_misaligned(xq), w), (xq, _misaligned(w))):
        with pytest.raises(ValueError, match="operands on 16 bytes"):
            I._launch_linear("wgmma", a, s_x, b, qscale, bias, torch.bfloat16)
        assert I.linear_variant(37, 72, 1024, torch.bfloat16, a.data_ptr(), b.data_ptr()) == "mma"
        got = I.int8_linear(a, s_x, b, qscale, bias, torch.bfloat16)  # routed to the mma body
        assert torch.equal(got, I.int8_linear_plain(xq, s_x, w, qscale, bias, torch.bfloat16))
    with pytest.raises(ValueError, match="writes bfloat16 with N a multiple of 8"):
        I._launch_linear("wgmma", xq, s_x, w, qscale, bias, torch.float32)
    with pytest.raises(ValueError, match="tiles are"):
        I._launch_linear("wgmma", xq, s_x, w, qscale, bias, torch.bfloat16, block_n=64)
    with pytest.raises(ValueError, match="no body"):
        I._launch_linear("wgmma_m64", xq, s_x, w, qscale, bias, torch.bfloat16)
    torch.cuda.synchronize()
    assert I.int8_linear.variant_launches == {"mma": 2} and I.int8_linear.launches == 2


# --- the 16-byte row pitch ------------------------------------------------------------------
# (K, N): virchow's fc2 (the SwiGLU half-width 3,416), medsiglip's and virchow's TP (1, 2) fc2 shards
# (2,152 and 1,708), a K short of one 128-byte box (45), one 4 past a multiple of 16 (4,308)
PITCHED_KN = [(3416, 1280), (2152, 1152), (1708, 1280), (45, 72), (4308, 72)]
PAD = 0x7F  # the pad bytes' value: a product that read them would differ from the plain version


def _pad(t: torch.Tensor) -> torch.Tensor:
    """The pad bytes of a pitched (rows, K) view: columns K to its pitch of the buffer under it."""
    from atlaspatch_tpu_torch.ops import int8 as I

    rows, k = t.shape
    return t.as_strided((rows, I.pitch16(k)), (I.pitch16(k), 1))[:, k:]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("m", [5, 37, 8224])
@pytest.mark.parametrize("k,n", PITCHED_KN)
def test_wgmma_body_on_pitched_operands_matches_plain_and_mma(card, k, n, m, out_dtype):
    """Operands at the 16-byte row pitch, their pad bytes set to 0x7f (the
    TMA maps' K extent is K: the last box is zero-filled past K and never
    reads the pad), route to the wgmma body; routed, and forced in both tile
    widths, it equals the plain version on the packed operands and the mma
    body on the pitched and on the packed operands, at max-abs 0. The packed
    operands route to the mma body."""
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, m, n, k)
    px, pw = I.pitched(xq), I.pitched(w)
    assert px.stride(0) == pw.stride(0) == I.pitch16(k) != k
    _pad(px).fill_(PAD)
    _pad(pw).fill_(PAD)
    assert I.linear_variant(m, n, k, out_dtype, px.data_ptr(), pw.data_ptr(), px.stride(0), pw.stride(0)) == "wgmma"
    s32 = out_dtype == torch.int32
    if s32:
        want = I.int8_linear_s32_plain(xq, w)

        def routed(a, b):
            return I.int8_linear_s32(a, b)

        def forced(variant, a, b, block_n=None):
            return I._launch_linear(variant, a, None, b, None, None, torch.int32, block_n)
    else:
        want = I.int8_linear_plain(xq, s_x, w, qscale, bias, out_dtype)

        def routed(a, b):
            return I.int8_linear(a, s_x, b, qscale, bias, out_dtype)

        def forced(variant, a, b, block_n=None):
            return I._launch_linear(variant, a, s_x, b, qscale, bias, out_dtype, block_n)
    got = {}
    for name, a, b, body in (("routed pitched", px, pw, "wgmma"), ("routed packed", xq, w, "mma")):
        I.reset_launch_counts()
        got[name] = routed(a, b)
        torch.cuda.synchronize()
        assert I.int8_linear.variant_launches == {body: 1}, name
    for block_n in I.WGMMA_BLOCK_NS:
        got[f"wgmma/{block_n}"] = forced("wgmma", px, pw, block_n)
    got["mma pitched"] = forced("mma", px, pw)
    got["mma packed"] = forced("mma", xq, w)
    torch.cuda.synchronize()
    for name, y in got.items():
        assert y.dtype == out_dtype and y.shape == (m, n), name
        assert torch.equal(y, want), (name, (y.double() - want.double()).abs().max().item())
    assert bool((_pad(px) == PAD).all()) and bool((_pad(pw) == PAD).all())


# (M, K): virchow's SwiGLU half at batch 1 and 32 (K 3,416), its and medsiglip's TP (1, 2) shard rows
# (1,708; 2,152), a short row (45) and one 4 past a multiple of 16 (4,308)
QUANT_PITCH_CASES = [(37, 3416), (8224, 3416), (9, 1708), (5, 2152), (7, 45), (6, 4308)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", QUANT_PITCH_CASES)
def test_quantizer_writes_pitched_xq_equal_to_the_packed_one(card, m, k, dtype):
    """quantize_rows_s8's xq at the 16-byte pitch (what every quantizer
    hands the products on the card) equals its xq written packed (pitch K),
    with equal scales, in each mode that writes xq and on each body:
    one-pass of the identity, layernorm and gated SiLU prologues (the
    template), given-amax of the identity (the streamed body, routed, and
    the template, forced) and of SiLU (the template); the identity's equals
    the plain version besides."""
    from atlaspatch_tpu_torch.ops import int8 as I

    gen = torch.Generator(device=card).manual_seed(m + k)
    x = (torch.randn(m, k, device=card, generator=gen) * 3).to(dtype)
    g = (torch.randn(m, k, device=card, generator=gen) * 3).to(dtype)
    gamma = (1 + 0.5 * torch.randn(k, device=card, generator=gen)).to(dtype)
    beta = (0.5 * torch.randn(k, device=card, generator=gen)).to(dtype)
    amax = I.row_amax_plain(x) * 1.25  # another shard's larger abs-max
    layout = (0, x.stride(0), m, 0, k)
    calls = {  # name: (prologue, keyword arguments of _launch_quantize, the plain version or None)
        "identity one-pass": ("identity", {}, I.quantize_rows_plain(x)),
        "layernorm one-pass": ("layernorm", dict(gamma=gamma, beta=beta, eps=1e-6), None),
        "silu * b one-pass": ("silu", dict(b=g), None),
        "identity given-amax stream": ("identity", dict(amax=amax), I.quantize_rows_plain(x, amax)),
        "identity given-amax template": ("identity", dict(amax=amax, body="template"),
                                         I.quantize_rows_plain(x, amax)),
        "silu given-amax template": ("silu", dict(amax=amax), None),
    }
    for name, (prologue, kw, plain) in calls.items():
        I.reset_launch_counts()
        got = I._launch_quantize(prologue, x, layout, **kw)
        packed = I._launch_quantize(prologue, x, layout, pitch=k, **kw)
        torch.cuda.synchronize()
        assert I.quantize_rows.launches == 2, name
        if name.endswith("stream"):
            assert I.quantize_rows.body_launches == {"stream": 2}, name
        assert got[0].stride() == (I.pitch16(k), 1) and packed[0].is_contiguous(), name
        assert torch.equal(got[0], packed[0]) and torch.equal(got[1], packed[1]), name
        if plain is not None:
            assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]), name


# --- quantize_rows_s8's prologues (csrc/int8_linear.cu) -----------------------------------
# (M, K, prologue, operand): vit_l_16's rows at batch 32 and 256 (norm1/norm2 → qkv/fc1 at K 1,024,
# GELU → fc2 at 4,096, the attention's output → proj at 1,024), medsiglip's (LayerNorm at 1,152,
# tanh GELU at 4,304), virchow's SwiGLU half (3,416: single-element units) and the other activations.
PROLOGUE_CASES = [
    *[(m, 1024, "layernorm", None) for m in (6304, 50432)],
    *[(m, 4096, "gelu_tanh", None) for m in (6304, 50432)],
    *[(m, 1024, "identity", "heads") for m in (6304, 50432)],
    (8192, 1152, "layernorm", None), (8192, 4304, "gelu_tanh", None), (8192, 1152, "identity", None),
    (6304, 3416, "silu", "swiglu"), (6304, 4096, "silu", "gated"), (6304, 4096, "gelu", None),
    (6304, 1024, "quick_gelu", None), (6304, 4096, "relu", None), (6304, 4096, "gelu", "swiglu"),
    (6304, 4096, "layernorm", None), (37, 45, "layernorm", None), (37, 45, "gelu_tanh", "gated"),
]
FUSED_FLIP_SHARE = 1e-3  # tests/test_torch_int8.py's bar: xq within 1 in this share, s_x within 2^-8


def _fused_operands(card, m, k, prologue, operand, dtype, seed=0):
    """The call's arguments on the card: rows like the residual stream (LayerNorm), fc1's output
    (activations; SwiGLU: the two halves of one output, gated: two outputs) or the attention's
    (B, T, H, D) einsum output (heads)."""
    gen = torch.Generator(device=card).manual_seed(seed + m + k)
    if operand == "heads":
        b, t = m // 197, 197
        attn = torch.softmax(torch.randn(b, 16, t, t, device=card, generator=gen) * 3, dim=-1).to(dtype)
        v = torch.randn(b, t, 16, k // 16, device=card, generator=gen).to(dtype)
        return (torch.einsum("bhqk,bkhd->bqhd", attn, v),)
    if prologue == "identity":
        return ((torch.randn(m, k, device=card, generator=gen) * 2).to(dtype),)
    if prologue == "layernorm":
        x = (torch.randn(m, k, device=card, generator=gen) * 2 + 0.3).to(dtype)
        w = (1 + 0.5 * torch.randn(k, device=card, generator=gen)).to(dtype)
        return x, w, (0.5 * torch.randn(k, device=card, generator=gen)).to(dtype), 1e-6
    if operand == "swiglu":
        a, b = (torch.randn(m, 2 * k, device=card, generator=gen) * 2).to(dtype).chunk(2, dim=-1)
        return a, prologue, b
    a = (torch.randn(m, k, device=card, generator=gen) * 2).to(dtype)
    b = (torch.randn(m, k, device=card, generator=gen) * 2).to(dtype) if operand == "gated" else None
    return a, prologue, b


def _fused_call(prologue, operand):
    from atlaspatch_tpu_torch.ops import int8 as I

    if prologue == "layernorm":
        return I.layernorm_quantize_rows, I.layernorm_quantize_rows_plain
    if prologue == "identity":
        if operand == "heads":
            return I.quantize_heads, lambda x: I.quantize_rows_plain(x.reshape(x.shape[0] * x.shape[1], -1))
        return I.quantize_rows, I.quantize_rows_plain
    return I.act_quantize_rows, I.act_quantize_rows_plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,prologue,operand", PROLOGUE_CASES)
def test_quantize_prologue_matches_plain(card, m, k, prologue, operand, dtype):
    """Each prologue against its plain version on the same inputs: identity at max-abs 0; layernorm
    and the activations within 1 in at most FUSED_FLIP_SHARE of xq, s_x within 2^-8."""
    from atlaspatch_tpu_torch.ops import int8 as I

    args = _fused_operands(card, m, k, prologue, operand, dtype)
    fused, plain = _fused_call(prologue, operand)
    I.reset_launch_counts()
    xq, s_x = fused(*args)
    torch.cuda.synchronize()
    assert I.quantize_rows.prologue_launches == {prologue: 1} and I.quantize_rows.launches == 1
    assert xq.shape == (m, k) and xq.dtype == torch.int8 and s_x.shape == (m,) and s_x.dtype == torch.float32
    want_xq, want_s = plain(*args)
    diff = (xq.int() - want_xq.int()).abs()
    rel = ((s_x - want_s).abs() / want_s).max().item()
    share = (diff > 0).float().mean().item()
    print(f"{prologue} {operand} M={m} K={k} {dtype}: {int((diff > 0).sum())} xq flipped ({share:.2e}), "
          f"s_x rel {rel:.2e}")
    if prologue == "identity":
        assert diff.max().item() == 0 and rel == 0
    else:
        assert diff.max().item() <= 1 and share <= FUSED_FLIP_SHARE and rel <= 2.0**-8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1024, 1152, 384, 4096])
def test_layernorm_statistics_are_atens(card, k, dtype):
    """The layernorm prologue's mean and 1 / sqrt(var + eps) against torch.native_layer_norm's on
    the card, row for row (its Welford order is mirrored: equal statistics, equal rows)."""
    from atlaspatch_tpu_torch.ops import int8 as I

    x, w, b, eps = _fused_operands(card, 6304, k, "layernorm", None, dtype)
    _, _, mean, rstd = I._launch_quantize("layernorm", x, (0, x.stride(0), x.shape[0], 0, k), gamma=w, beta=b,
                                          eps=eps, stats=True)
    _, want_mean, want_rstd = torch.native_layer_norm(x, (k,), w, b, eps)
    torch.cuda.synchronize()
    same_mean = (mean == want_mean.flatten()).float().mean().item()
    same_rstd = (rstd == want_rstd.flatten()).float().mean().item()
    print(f"layernorm K={k} {dtype}: mean equal in {same_mean:.4f} of rows, rstd in {same_rstd:.4f}")
    assert torch.allclose(mean, want_mean.flatten(), rtol=1e-5, atol=1e-6)
    assert torch.allclose(rstd, want_rstd.flatten(), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_prologue_keeps_ties_where_rows_lie(card, dtype):
    """Exact .5 ties and an all-zero row, through a row-strided view, a (B, T, H, D) view and a
    misaligned one (single-element units): equal to the plain version, max-abs 0."""
    from atlaspatch_tpu_torch.ops import int8 as I

    gen = torch.Generator(device=card).manual_seed(3)
    x = (torch.randn(2, 197, 16, 64, device=card, generator=gen) * 3).to(dtype)
    x[0, 0, 0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])  # amax 127 -> s = 1: ties to 127, 2, -4, 0
    x[0, 0, 0, 4:] = 0
    x[0, 0, 1:] = 0
    x[0, 1] = 0  # an all-zero row: s = 1e-8 / 127
    heads = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # (B, T, H, D) lying as (B, H, T, D)
    rows = torch.empty(394, 1024 + 16, dtype=dtype, device=card)[:, 8:1032]
    rows.copy_(x.reshape(394, 1024))
    odd = torch.empty(394 * 1024 + 1, dtype=dtype, device=card)[1:].view(394, 1024)
    odd.copy_(rows)
    want = I.quantize_rows_plain(x.reshape(394, 1024))
    assert want[0][0, :4].tolist() == [127, 2, -4, 0]
    for got in (I.quantize_heads(heads), I.quantize_rows(rows), I.quantize_rows(odd)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


class _FailingQuantizer:
    def atlas_quantize_rows_s8(self, *args):
        return 9  # cudaErrorInvalidConfiguration


@pytest.mark.parametrize("prologue", ["identity", "layernorm", "gelu_tanh"])
def test_a_failed_quantizer_launch_raises_and_nothing_runs_instead(card, monkeypatch, prologue):
    from atlaspatch_tpu_torch.ops import int8 as I

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    args = _fused_operands(card, 37, 1024, prologue, None, torch.bfloat16)
    fused, _ = _fused_call(prologue, None)
    for name in ("quantize_rows_plain", "layernorm_quantize_rows_plain", "act_quantize_rows_plain"):
        monkeypatch.setattr(I, name, refuse)
    monkeypatch.setattr(I, "load_int8_library", lambda: _FailingQuantizer())
    I.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"quantize_rows_s8 \\({prologue}\\) launch failed: cudaError 9"):
        fused(*args)
    assert I.quantize_rows.launches == 0 and not I.quantize_rows.prologue_launches


def test_fused_quantizers_refuse_on_the_card(card):
    from atlaspatch_tpu_torch.ops import int8 as I

    x = torch.zeros(4, 8, device=card)
    with pytest.raises(ValueError, match=r"\(8,\) torch.float32 weight on cuda"):
        I.layernorm_quantize_rows(x, torch.ones(8), torch.zeros(8, device=card), 1e-6)
    with pytest.raises(ValueError, match="takes b like a"):
        I.act_quantize_rows(x, "silu", torch.zeros(4, 8))
    with pytest.raises(ValueError, match=f"at most {I.QUANT_MAX_K} values"):
        I.act_quantize_rows(torch.zeros(2, I.QUANT_MAX_K + 16, device=card), "silu")
    with pytest.raises(ValueError, match="empty"):
        I.quantize_heads(torch.zeros(0, 4, 2, 8, device=card))


@pytest.mark.parametrize("kw", [{}, dict(swiglu=True, act="silu", mlp_hidden=96),
                                dict(gated_mlp=True, mlp_hidden=96, layerscale=True)])
def test_int8_blocks_launch_each_prologue_on_the_card(card, monkeypatch, kw):
    """A bfloat16 int8 ViT on the card: per block two layernorm quantizers, one activation and one
    identity (the attention's output), four int8 linears (five gated), no plain version; its output
    against the same model on the CPU (the unfused chain), cosine > 0.999."""
    import dataclasses

    from atlaspatch_tpu_torch.models.encoders.engine import _cast_floating_, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.vit import ViT, ViTSpec, quantize_vit_state_dict
    from atlaspatch_tpu_torch.ops import int8 as I

    spec = ViTSpec(img_size=64, patch_size=16, dim=128, depth=2, heads=2, **kw)
    state = quantize_vit_state_dict(init_random_weights_(ViT(spec), seed=0).state_dict())
    model = ViT(dataclasses.replace(spec, quant_int8=True))
    model.load_state_dict(state, strict=True)
    model = _cast_floating_(model, torch.bfloat16, keep=("qscale",))  # as the int8 engine casts it
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    with torch.no_grad():
        want = model(x).float()
        model.to(card)

        def refuse(*a, **k):
            raise AssertionError("a plain version ran on the card")

        for name in ("quantize_rows_plain", "layernorm_quantize_rows_plain", "act_quantize_rows_plain",
                     "int8_linear_plain"):
            monkeypatch.setattr(I, name, refuse)
        I.reset_launch_counts()
        got = model(x.to(card)).float().cpu()
    torch.cuda.synchronize()
    act = "silu" if kw.get("act") == "silu" else "gelu_tanh"
    assert I.quantize_rows.prologue_launches == {"layernorm": 4, act: 2, "identity": 2}
    assert I.int8_linear.launches == 2 * (5 if kw.get("gated_mlp") else 4)
    cos = torch.nn.functional.cosine_similarity(got, want)
    assert cos.min().item() > 0.999, cos


# --- tensor-parallel int8: amax-only, given-amax, the int32 output and dequant_sum_s32 ---
SPLIT_CASES = [  # (M, K, prologue, operand): vit_l_16's proj / fc2 rows at batch 8, a gated row, ragged ones
    (1576, 1024, "identity", "heads"), (1576, 4096, "gelu_tanh", None), (1576, 1024, "identity", None),
    (1000, 8192, "silu", "gated"), (37, 3416, "silu", "swiglu"), (37, 96, "gelu", None), (9, 90, "relu", None),
]


def _split(args, operand, parts=2):
    """The prologue's operands cut into ``parts`` slices of each row (heads: of the heads)."""
    if operand == "heads":
        return [(h,) for h in args[0].chunk(parts, dim=2)]
    if len(args) == 1:
        return [(x,) for x in args[0].chunk(parts, dim=1)]
    a, act, b = args
    return [(x, act, None if y is None else y) for x, y in
            zip(a.chunk(parts, dim=1), b.chunk(parts, dim=1) if b is not None else [None] * parts)]


def _amax_call(prologue, operand):
    from atlaspatch_tpu_torch.ops import int8 as I

    if prologue == "identity":
        if operand == "heads":
            return I.heads_amax, lambda x: I.row_amax_plain(x.reshape(x.shape[0] * x.shape[1], -1))
        return I.row_amax, I.row_amax_plain
    return (lambda a, act, b=None: I.act_row_amax(a, act, b)[0],
            lambda a, act, b=None: I.row_amax_plain(I._act_rows(a, act, b)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,prologue,operand", SPLIT_CASES)
def test_amax_modes_split_a_row_into_the_one_pass_bytes(card, m, k, prologue, operand, dtype):
    """amax-only against its plain version (identity max-abs 0; the activations' prologue values are
    ATen's where test_quantize_prologue_matches_plain says, so their abs-max within 2^-8); given-amax
    on the row's own amax equal to the one-pass kernel (max-abs 0), and on each half of the row with
    the halves' amaxes maxed, equal to the one-pass kernel's columns (the tensor-parallel split); an
    activation's halves also as the forward routes them, their stored values quantized by the
    identity prologue with the maxed amax."""
    from atlaspatch_tpu_torch.ops import int8 as I

    args = _fused_operands(card, m, k, prologue, operand, dtype)
    quantize, _ = _fused_call(prologue, operand)
    amax_of, amax_plain = _amax_call(prologue, operand)
    I.reset_launch_counts()
    whole_xq, whole_s = quantize(*args)
    amax = amax_of(*args)
    torch.cuda.synchronize()
    assert I.quantize_rows.mode_launches == {"one_pass": 1, "amax_only": 1}
    assert amax.shape == (m,) and amax.dtype == torch.float32
    want = amax_plain(*args)
    rel = ((amax - want).abs() / want.clamp_min(1e-30)).max().item()
    assert rel == 0 if prologue == "identity" else rel <= 2.0**-8, rel
    assert torch.equal(I._divide(amax.clamp_min(1e-8), 127.0), whole_s)
    given = quantize(*args, amax=amax)
    assert torch.equal(given[0], whole_xq) and torch.equal(given[1], whole_s)
    if prologue == "identity":  # given-amax against its plain version
        plain = I.quantize_rows_plain(args[0].reshape(m, k), want)
        assert torch.equal(given[0], plain[0]) and torch.equal(given[1], plain[1])
    halves = _split(args, operand)
    maxed = torch.maximum(*(amax_of(*h) for h in halves))
    assert torch.equal(maxed, amax)
    cols = [quantize(*h, amax=maxed) for h in halves]
    assert torch.equal(torch.cat([c[0] for c in cols], dim=1), whole_xq)
    assert all(torch.equal(c[1], whole_s) for c in cols)
    assert I.quantize_rows.mode_launches == {"one_pass": 1, "amax_only": 3, "given_amax": 3}
    # an activation's given-amax runs on the template; its amax-only and the identity's on the stream
    assert I.quantize_rows.body_launches == ({"template": 1, "stream": 6} if prologue == "identity" else
                                             {"template": 4, "stream": 3})
    if prologue != "identity":
        stored = [I.act_row_amax(*h)[1] for h in halves]
        cols = [I.quantize_rows(v, maxed) for v in stored]
        assert torch.equal(torch.cat([c[0] for c in cols], dim=1), whole_xq)
        assert all(torch.equal(c[1], whole_s) for c in cols)


# --- the tensor-parallel modes' streamed bodies against the template's modes -------------------
# Rows of the TP (1, 2) shards and ragged ones: M 1, 7, batch 32's and batch 256's vit_l_16 tokens; K
# vit_l_16's proj and fc2 shards (512, 2,048), the 7B's fc2 shard (4,096), virchow's and medsiglip's
# fc2 shards (1,708: 8-byte bfloat16 units; 2,152).
STREAM_MS = [1, 7, 6304, 50432]
STREAM_KS = [512, 1708, 2048, 2152, 4096]


def _stream_operands(card, m, k, operand, dtype):
    """(prologue, x, layout, rows, cols, b): plain rows, the attention's (B, T, H, D) output as the
    einsum leaves it ((B, H, T, D) in memory; 64-wide heads, or 4 heads where K is no multiple of
    64), fc1's tanh-GELU rows or a gated SiLU pair."""
    from atlaspatch_tpu_torch.ops import int8 as I

    gen = torch.Generator(device=card).manual_seed(m + k)
    if operand == "heads":
        b_, t_ = (m // 197, 197) if m % 197 == 0 else (1, m)
        h_, d_ = (k // 64, 64) if k % 64 == 0 else (4, k // 4)
        x = torch.randn(b_, h_, t_, d_, device=card, generator=gen).to(dtype).transpose(1, 2)
        x, layout, rows, cols = I._heads_layout("heads", x)
        return "identity", x, layout, rows, cols, None
    a = (torch.randn(m, k, device=card, generator=gen) * 2).to(dtype)
    b = (torch.randn(m, k, device=card, generator=gen) * 2).to(dtype) if operand == "silu gated" else None
    prologue = {"rows": "identity", "gelu_tanh": "gelu_tanh", "silu gated": "silu"}[operand]
    return prologue, a, (0, a.stride(0), m, 0, k), m, k, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["rows", "heads", "gelu_tanh", "silu gated"])
@pytest.mark.parametrize("k", STREAM_KS)
@pytest.mark.parametrize("m", STREAM_MS)
def test_amax_modes_stream_bodies_equal_the_template_modes(card, m, k, operand, dtype):
    """amax-only and given-amax as the forward routes them, on the streamed body, and forced in every
    narrower unit the operands admit, against the template's amax-only and given-amax on the same
    inputs: amax, xq and s_x max-abs 0. An activation's amax-only also stores its values, which
    given-amax quantizes by the identity prologue to the template's activation given-amax bytes and
    scales."""
    from atlaspatch_tpu_torch.ops import int8 as I

    prologue, x, layout, rows, cols, b = _stream_operands(card, m, k, operand, dtype)

    def run(mode, body, amax=None, unit=None):
        return I._launch_quantize(prologue, x, layout, rows=rows, cols=cols, b=b, mode=mode, amax=amax, body=body,
                                  unit=unit)

    def given(values, amax, unit=None):  # the identity's given-amax over stored (rows, cols) values
        return I._launch_quantize("identity", values, (0, cols, rows, 0, cols), mode="given_amax", amax=amax,
                                  unit=unit)

    elem = x.element_size()
    I.reset_launch_counts()
    want_amax = run("amax_only", "template")
    want_xq, want_s = run("given_amax", "template", want_amax)
    if prologue == "identity":
        amax = run("amax_only", None)
        xq, s_x = run("given_amax", None, want_amax)
    else:
        amax, values = run("amax_only", None)
        assert values.shape == (rows, cols) and values.dtype == dtype
        xq, s_x = given(values, want_amax)
    assert I.quantize_rows.body_launches == {"template": 2, "stream": 2}
    assert torch.equal(amax, want_amax) and torch.equal(xq, want_xq) and torch.equal(s_x, want_s)
    _, routed = I.quant_variant("amax_only", prologue, layout[4], elem, I._operand_alignment(x, layout, b))
    _, routed_given = I.quant_variant("given_amax", "identity", cols, elem)
    for unit in (32, 16, 8, elem):
        if unit <= routed:
            got = run("amax_only", "stream", unit=unit)
            if prologue != "identity":
                got, got_values = got
                assert torch.equal(got_values, values), unit
            assert torch.equal(got, want_amax), unit
        if unit <= (routed if prologue == "identity" else routed_given):
            got = run("given_amax", "stream", want_amax, unit=unit) if prologue == "identity" else \
                given(values, want_amax, unit)
            assert torch.equal(got[0], want_xq) and torch.equal(got[1], want_s), unit
    torch.cuda.synchronize()


def test_amax_modes_stream_body_refuses_what_it_does_not_take(card):
    """The streamed body takes amax-only of the identity and activation prologues (an activation's
    storing its values) and the identity's given-amax, in units that fit the operands; the rest is
    refused before a launch (ValueError) or by the C entry (a RuntimeError naming the cudaError, or
    its code), and nothing is counted."""
    from atlaspatch_tpu_torch.ops import int8 as I

    x = torch.randn(8, 96, device=card, dtype=torch.bfloat16)
    layout = (0, x.stride(0), 8, 0, 96)
    w, bias = torch.ones(96, device=card, dtype=torch.bfloat16), torch.zeros(96, device=card, dtype=torch.bfloat16)
    amax = torch.ones(8, device=card)
    I.reset_launch_counts()
    with pytest.raises(ValueError, match="streamed body takes"):
        I._launch_quantize("identity", x, layout, body="stream")
    with pytest.raises(ValueError, match="streamed body takes"):
        I._launch_quantize("layernorm", x, layout, gamma=w, beta=bias, eps=1e-6, mode="amax_only", body="stream")
    with pytest.raises(ValueError, match="streamed body takes"):
        I._launch_quantize("silu", x, layout, mode="given_amax", amax=amax, body="stream")
    with pytest.raises(ValueError, match="no body 'wide'"):
        I._launch_quantize("identity", x, layout, mode="amax_only", body="wide")
    odd = x[:, 1:]  # 95 values a row from an odd element: single elements only
    with pytest.raises(RuntimeError, match="cudaError 1"):
        I._launch_quantize("identity", odd, (0, odd.stride(0), 8, 0, 95), mode="amax_only", body="stream", unit=16)
    # the C entry: an activation's amax-only without the values' buffer, the identity's with one, an
    # activation's given-amax
    lib, out, xq = I.load_int8_library(), torch.empty(8, 96, device=card, dtype=torch.bfloat16), torch.empty(
        8, 96, device=card, dtype=torch.int8)
    stream = torch.cuda.current_stream().cuda_stream
    for prologue, mode, act in (("silu", "amax_only", None), ("identity", "amax_only", out),
                                ("gelu_tanh", "given_amax", None)):
        assert lib.atlas_quantize_rows_s8_stream(
            I.PROLOGUES.index(prologue), 1, 8, 96, x.data_ptr(), *layout, None, 0, 32, xq.data_ptr(), 96,
            amax.data_ptr(), I.QUANT_MODES.index(mode), amax.data_ptr(), None if act is None else act.data_ptr(),
            stream) == 1, (prologue, mode)
    assert I.quantize_rows.launches == 0
    assert torch.equal(I.row_amax(odd), I.row_amax_plain(odd))
    assert I.quantize_rows.body_launches == {"stream": 1}


# (M, N, K) of the int32 output beyond INT8_SHAPES: TP (1, 2) int8's shard products at batch 32,
# vit_l_16's proj and fc2 (M 6,304 = 49.25 tiles of 128 rows) and dinov3_vit7b16's (M 6,432); N no
# multiple of the 128-column tile (1,000) or of 8 (1,004); the TMA's zero-filled K tail (4,304 =
# 33.6 blocks of 128); virchow's and medsiglip's fc2 shards (K 1,708, 2,152: mma)
S32_SHAPES = [(6304, 1024, 512), (6304, 1024, 2048), (6432, 4096, 2048), (6432, 4096, 4096), (6304, 1000, 512),
              (37, 1004, 48), (6304, 1024, 4304), (130, 1280, 1708), (37, 1152, 2152)]


@pytest.mark.parametrize("m,n,k", INT8_SHAPES + S32_SHAPES)
def test_int32_output_matches_int_product(card, m, n, k):
    """The int32 product launches the body linear_variant picks (wgmma where it admits the shape);
    every body and tile width the shape admits, forced, equals the plain product bit for bit."""
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, _, w, _, _ = _int8_operands(card, m, n, k)
    routed = I.linear_variant(m, n, k, torch.int32, xq.data_ptr(), w.data_ptr())
    assert routed == ("wgmma" if k % 16 == 0 and n % 4 == 0 else "mma")
    I.reset_launch_counts()
    got = I.int8_linear_s32(xq, w)
    torch.cuda.synchronize()
    assert I.int8_linear.variant_launches == {routed: 1}
    assert I.int8_linear.out_launches == {"int32": 1}
    assert got.dtype == torch.int32 and got.shape == (m, n)
    want = I.int8_linear_s32_plain(xq, w)
    assert torch.equal(got, want)
    bodies = [("mma", None)] + ([("wgmma", bn) for bn in I.WGMMA_BLOCK_NS] if routed == "wgmma" else [])
    forced = {(v, bn): I._launch_linear(v, xq, None, w, None, None, torch.int32, bn) for v, bn in bodies}
    torch.cuda.synchronize()
    for variant, y in forced.items():
        assert y.dtype == torch.int32 and torch.equal(y, want), variant
    if routed == "mma":
        with pytest.raises(ValueError, match="int32 with N a multiple of 4"):
            I._launch_linear("wgmma", xq, None, w, None, None, torch.int32)
    if m * n * k <= 37 * 4304 * 1152:  # the host's int32 product, at the small shapes
        assert torch.equal(got.cpu(), I.int8_linear_s32_plain(xq.cpu(), w.cpu()))


def test_a_failed_int32_wgmma_encode_raises_and_never_retries(card, monkeypatch):
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, _, w, _, _ = _int8_operands(card, 37, 72, 4304)
    monkeypatch.setattr(I, "load_int8_library", lambda: _FailingLibrary())

    def refuse(*a, **k):
        raise AssertionError("a fallback ran")

    for name in ("int8_linear_s32_plain", "int_product"):
        monkeypatch.setattr(I, name, refuse)
    monkeypatch.setattr(torch, "_int_mm", refuse)
    I.reset_launch_counts()
    with pytest.raises(RuntimeError, match="encode failed: CUresult 1"):
        I.int8_linear_s32(xq, w)
    assert I.int8_linear.launches == 0 and not I.int8_linear.variant_launches and not I.int8_linear.out_launches


@pytest.mark.parametrize("parts", [2, 3, 8])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(37, 1024, 1536), (130, 72, 96), (33, 17, 48), (5, 4304, 4608)])
def test_dequant_sum_of_split_k_equals_the_whole_product(card, m, n, k, out_dtype, bias_dtype, parts):
    """dequant_sum_s32 over the int32 partials of K cut in ``parts`` equals int8_linear_s8 on the
    whole K (the routed body) and the plain version, max-abs 0."""
    from atlaspatch_tpu_torch.ops import int8 as I

    xq, s_x, w, qscale, bias = _int8_operands(card, m, n, k)
    bias = None if bias_dtype is None else bias.to(bias_dtype)
    partials = [I.int8_linear_s32(a.contiguous(), b.contiguous())
                for a, b in zip(xq.chunk(parts, dim=1), w.chunk(parts, dim=1))]
    I.reset_launch_counts()
    got = I.dequant_sum(partials, s_x, qscale, bias, out_dtype)
    torch.cuda.synchronize()
    assert I.dequant_sum.launches == 1 and got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, I.int8_linear(xq, s_x, w, qscale, bias, out_dtype))
    assert torch.equal(got, I.dequant_sum_plain(partials, s_x, qscale, bias, out_dtype))


def test_dequant_sum_refuses_what_it_does_not_take(card):
    from atlaspatch_tpu_torch.ops import int8 as I

    part = torch.zeros(4, 8, dtype=torch.int32, device=card)
    s_x, qscale = torch.ones(4, device=card), torch.ones(8, device=card)
    with pytest.raises(ValueError, match="1 to 8 partials"):
        I.dequant_sum([part] * 9, s_x, qscale, None, torch.bfloat16)
    with pytest.raises(ValueError, match="on one device"):
        I.dequant_sum([part, part.cpu()], s_x, qscale, None, torch.bfloat16)
    with pytest.raises(ValueError, match="int32 partials of one shape"):
        I.dequant_sum([part, part[:, :4]], s_x, qscale, None, torch.bfloat16)


@pytest.mark.parametrize("kw", [dict(gated_mlp=True, mlp_hidden=256, layerscale=True, act="silu"),
                                dict(swiglu=True, act="silu", mlp_hidden=192, pos_mode="rope", reg_tokens=2),
                                dict(swiglu=True, act="silu", mlp_hidden=200, layerscale=True, reg_tokens=4)])
def test_tensor_parallel_int8_equals_one_device_on_the_card(card, monkeypatch, kw):
    """A bfloat16 int8 ViT sharded over the card named twice equals the same model on one device bit
    for bit; per block the row-parallel quantizers run amax-only and given-amax on each shard, the
    partials come from the wgmma body in int32 (a shard's fc2 K of 100, virchow's case, at its
    16-byte pitch too) and dequant_sum_s32 runs once per row-parallel layer; no plain version runs."""
    import dataclasses

    from atlaspatch_tpu_torch.models.encoders.engine import _cast_floating_, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.vit import RowParallel, ViT, ViTSpec, quantize_vit_state_dict
    from atlaspatch_tpu_torch.ops import int8 as I
    from atlaspatch_tpu_torch.parallel.mesh import embedding_mesh
    from atlaspatch_tpu_torch.parallel.sharding import shard_vit

    spec = ViTSpec(img_size=64, patch_size=16, dim=128, depth=2, heads=4, **kw)
    state = quantize_vit_state_dict(init_random_weights_(ViT(spec), seed=0).state_dict())
    model = ViT(dataclasses.replace(spec, quant_int8=True))
    model.load_state_dict(state, strict=True)
    model = _cast_floating_(model, torch.bfloat16, keep=("qscale",)).eval().requires_grad_(False)
    (tp,) = shard_vit(model, embedding_mesh(2, [card, card]))
    model.to(card)
    assert isinstance(tp.blocks[0].attn, RowParallel) and tp.blocks[0].attn.quantized
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16).to(card)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    with torch.no_grad():
        want = model(x)
        for name in ("quantize_rows_plain", "layernorm_quantize_rows_plain", "act_quantize_rows_plain",
                     "int8_linear_plain", "int8_linear_s32_plain", "dequant_sum_plain", "row_amax_plain"):
            monkeypatch.setattr(I, name, refuse)
        I.reset_launch_counts()
        got = tp(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    linears = 5 if kw.get("gated_mlp") else 4
    assert I.quantize_rows.mode_launches == {"one_pass": 4, "amax_only": 8, "given_amax": 8}
    assert I.quantize_rows.body_launches == {"template": 4, "stream": 16}
    # fc2's amax-only stores SiLU's values, which its given-amax quantizes by the identity prologue
    assert I.quantize_rows.prologue_launches == {"layernorm": 4, "identity": 12, "silu": 4}
    # per block and shard: the column-parallel linears on wgmma in bfloat16, proj and fc2's partials
    # on wgmma in int32 (shard K 64 and 128 or 96)
    assert I.int8_linear.variant_launches == {"wgmma": 2 * 2 * linears}
    assert I.int8_linear.out_launches == {"bfloat16": 2 * 2 * (linears - 2), "int32": 2 * 2 * 2}
    assert I.dequant_sum.launches == 4
