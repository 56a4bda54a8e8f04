"""``process`` on existing coordinates: patch features appended slide by slide.

Set-up writes the cohort's listing and a coordinate H5 per listed slide (the
plain reference's coordinates), builds the results that the runner's
existing-coordinates path builds for them, makes the encoder's weights on the
card from the seed, builds the port's encoder as its zoo entry describes it
and warms every batch shape the engine can pad to. The window is one
``PatchFeatureEmbeddingService.embed_all`` over the listing (extractor-major:
one encoder), a closed loop as a user's job is. It opens at the publication
of the ``warm_slides``-th slide and closes at the first publication at least
``--seconds`` later; the rate is the patches of the slides published in
between over that time. Publications are timed through the ``progress``
object ``embed_all`` updates slide by slide.

Afterwards the features of patches drawn from the seed among the slides
published in the window are read back from their H5 files and compared with
the plain reference, which reads the same patches from the slide files
itself, resizes and normalizes them with Pillow and runs the float32 ViT on
weights made again from the seed.
"""

from __future__ import annotations

import gc
import json
import shutil
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from portbench import harness, weights
from portbench.inputs import cohort, coords
from portbench.reference import slide as ref_slide
from portbench.reference import vit as ref_vit
from portbench.reference.flops import vit_flops_per_patch


class _NoSegmentation:
    """The existing-coordinates path segments nothing."""

    def segment_thumbnail(self, wsi):
        raise AssertionError("segmentation asked for on existing coordinates")

    segment_batch = segment_thumbnail


class _Progress:
    """Timestamps each slide ``embed_all`` finishes and closes the window."""

    def __init__(self, ctx, warm: int, profile: harness.Profile) -> None:
        self.ctx, self.warm, self.profile = ctx, warm, profile
        self.times: list[float] = []
        self.t_open = self.t_close = None
        self.trace_from = self.trace_to = None

    def update(self, n: int = 1) -> None:
        from atlaspatch_tpu_torch.utils import perf

        now = time.perf_counter()
        for _ in range(n):
            self.times.append(now)
        done = len(self.times)
        if self.t_open is None:
            if done >= self.warm:
                self.t_open = now
                self.open_index = done
                perf.reset()
            return
        if self.profile.enabled:
            if self.profile.prof is None and now - self.t_open >= 0.3 * self.ctx.seconds:
                self.profile.start()
                self.trace_from = done
            elif self.profile.active and now - self.profile.t0 >= 3.0:
                self.profile.stop()
                self.trace_to = done
        if now - self.t_open >= self.ctx.seconds:
            self.t_close = now
            self.close_index = done
            self.stages = perf.report()
            if self.profile.active:  # a slice still open ends at this publication too
                self.profile.stop()
                self.trace_to = done
            raise harness.WindowClosed


def check_vit(cfg: dict, spec) -> None:
    """The zoo entry the program runs has the configuration's widths."""
    want = dict(img_size=cfg["img_size"], patch_size=cfg["patch_size"], dim=cfg["hidden_size"],
                depth=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
                hidden_dim=cfg["intermediate_size"], reg_tokens=cfg["reg_tokens"])
    got = {k: getattr(spec, k) for k in want}
    if got != want:
        raise ValueError(f"zoo entry widths {got} differ from the configuration's {want}")


def reference_model(cfg: dict, seed: int, device, served: torch.dtype) -> ref_vit.ViT:
    """The float32 reference on weights made again from the seed, rounded to
    the type they were served in."""
    with torch.device("meta"):
        meta = ref_vit.ViT(cfg)
    state = weights.state_dict(meta, seed, device, served)
    state = {k: v.float() for k, v in state.items()}
    with torch.device(device):
        model = ref_vit.ViT(cfg)
    model.load_state_dict(state)
    return model.eval()


def build_extractor(cfg: dict, traffic: dict, seed: int, device: str):
    """The port's encoder for the zoo entry, on weights made from the seed."""
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor
    from atlaspatch_tpu_torch.models.encoders.vit import ViT, quantize_vit_state_dict
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.services.feature_embedding import resolve_feature_dtype

    entry = ENTRIES[traffic["encoder"]]
    check_vit(cfg, entry.spec)
    compute = resolve_feature_dtype(device, traffic["precision"])
    with torch.device("meta"):
        meta = ref_vit.ViT(cfg)
    served = torch.bfloat16 if compute == "bfloat16" else torch.float32
    state = weights.state_dict(meta, seed, device, served)
    spec = entry.spec
    if compute == "int8":
        state = quantize_vit_state_dict(state)
        spec = replace(spec, quant_int8=True)
    with torch.device(device):
        model = ViT(spec)
    model.load_state_dict(state, strict=True)
    del state
    return TorchFeatureExtractor(name=entry.name, embedding_dim=entry.embedding_dim, spec=entry.preprocess,
                                 model=model, device=device, compute_dtype=compute), compute


def _count_forwards(ext, profile: harness.Profile) -> None:
    inner = ext.forward_device

    def forward_device(images_u8, replica=0):
        profile.add("forwards")
        profile.add("rows", int(images_u8.shape[0]))
        profile.add(f"batch:{int(images_u8.shape[0])}")
        with profile.span("forward"):
            return inner(images_u8, replica)

    ext.forward_device = forward_device
    inner_extract = ext.extract_batch

    def extract_batch(patches, *, batch_size=None):
        with profile.span("extract_batch"):
            return inner_extract(patches, batch_size=batch_size)

    ext.extract_batch = extract_batch


def run(ctx: harness.Context) -> dict:
    from atlaspatch_tpu_torch.core.config import (AppConfig, ExtractionConfig, FeatureExtractionConfig,
                                                  OutputConfig, ProcessingConfig, SegmentationConfig)
    from atlaspatch_tpu_torch.core.models import Slide
    from atlaspatch_tpu_torch.core.paths import patch_h5_path
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor
    from atlaspatch_tpu_torch.models.encoders.registry import PatchFeatureExtractorRegistry
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
    from atlaspatch_tpu_torch.services.mpp import CSVMPPResolver
    from atlaspatch_tpu_torch.services.storage import H5PatchWriter
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader
    from atlaspatch_tpu_torch.utils.h5 import read_h5_tree

    t = ctx.workload["traffic"]
    cfg = ctx.config
    ex = t["extraction"]
    device = ctx.device
    work = Path(tempfile.mkdtemp(prefix="portbench-embed-"))
    try:
        pool = cohort.pool(t["cohort"])
        entries = cohort.listing(pool, t["listing"], ctx.seed, work / "slides")
        ext_cfg = ExtractionConfig(patch_size=ex["patch_size"], step_size=ex["step_size"],
                                   target_magnification=ex["target_mag"], tissue_threshold=ex["tissue_threshold"],
                                   fast_mode=ex["fast_mode"], write_batch=ex["write_batch"])
        out_cfg = OutputConfig(output_root=work / "out")
        feat_cfg = FeatureExtractionConfig(extractors=[t["encoder"]], batch_size=t["feature_batch_size"],
                                           device=device, num_workers=t["feature_num_workers"],
                                           precision=t["precision"])
        first = ref_slide.open_slide(str(pool[0])).levels[0]
        ds = t["cohort"]["app_mag"] / ex["target_mag"]
        read = int(round(ex["patch_size"] * ds))
        xy_of = {src: coords.for_slide(src, ex) for src in pool}
        source = {entry.name: src for entry, src in entries}
        for entry, src in entries:
            xy = xy_of[src]
            writer = H5PatchWriter(chunk_rows=ex["write_batch"], patch_size=ex["patch_size"],
                                   patch_size_level0=read, level0_mag=t["cohort"]["app_mag"],
                                   target_mag=ex["target_mag"], level0_wh=(first.width, first.height), overlap=0,
                                   slide_stem=entry.stem, wsi_path=str(entry),
                                   extra_file_attrs={"filename": entry.name})
            h5 = patch_h5_path(Slide(path=entry), out_cfg, ext_cfg)
            h5.parent.mkdir(parents=True, exist_ok=True)
            writer.write_coords(h5, [(int(x), int(y), read, read, 0, None) for x, y in xy], batch=ex["write_batch"])
        app = AppConfig(processing=ProcessingConfig(input_path=work / "slides"),
                        segmentation=SegmentationConfig(device=device), extraction=ext_cfg, output=out_cfg,
                        features=feat_cfg, device=device).validated()
        results, failures = ProcessingRunner(app, _NoSegmentation(), PatchExtractionService(ext_cfg, out_cfg), None,
                                             CSVMPPResolver(None), DefaultWSILoader()).run()
        if failures or len(results) != len(entries):
            raise RuntimeError(f"existing-coordinates path: {len(results)} results, failures {failures[:3]}")
        results.sort(key=lambda r: r.slide.path.name)  # the listing's order

        ext, compute = build_extractor(cfg, t, ctx.seed, device)
        profile = harness.Profile(ctx.trace)
        _count_forwards(ext, profile)
        warm_rows = [np.zeros((read, read, 3), np.uint8)] * t["feature_batch_size"]
        b = 1
        while b <= t["feature_batch_size"]:  # every bucket a slide's last chunk can pad to
            ext.extract_batch(warm_rows[:b], batch_size=t["feature_batch_size"])
            b *= 2
        ext.cleanup = lambda: None  # embed_all releases its extractor; the benchmark does after the window
        registry = PatchFeatureExtractorRegistry()
        registry.register(t["encoder"], lambda: ext)
        service = PatchFeatureEmbeddingService(ext_cfg, out_cfg, feat_cfg, registry=registry)
        inner_read = service._read_patch_block

        def read_block(wsi, rows):
            with profile.span("patch_read"):
                return inner_read(wsi, rows)

        service._read_patch_block = read_block
        progress = _Progress(ctx, t["warm_slides"], profile)
        if device == "cuda":
            torch.cuda.synchronize()
        try:
            service.embed_all(results, wsi_loader=DefaultWSILoader(), progress=progress)
        except harness.WindowClosed:
            pass
        if progress.t_close is None:
            raise RuntimeError(f"the listing of {len(results)} slides ended before the window closed")
        profile.stop()
        setup_s = progress.t_open - ctx.t_process
        window = progress.t_close - progress.t_open
        in_window = results[progress.open_index : progress.close_index]
        patches = sum(r.num_patches for r in in_window)
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        TorchFeatureExtractor.cleanup(ext)
        del ext, service, registry
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # --- checks, after the window ------------------------------------------------
        key = f"features/{t['encoder']}"
        bad_rows = 0
        for r in in_window:
            tree = read_h5_tree(r.h5_path, data=False)
            if key not in tree.datasets or tree.datasets[key].shape != (r.num_patches, cfg["embedding_dim"]):
                bad_rows += 1
        numbers = compare(ctx, cfg, t, in_window, key, compute, bits=None, source=source, xy_of=xy_of, read=read)
        flops = vit_flops_per_patch(cfg)
        e2e = {
            "patches_per_s": patches / window,
            "mfu": 100.0 * flops * patches / window / harness.PEAK_FLOPS[compute],
            "setup_s": setup_s,
        }
        ctx.log(f"window {window:.3f} s: {len(in_window)} slides, {patches} patches; set-up {setup_s:.2f} s; "
                f"{flops / 1e9:.2f} GFLOP a patch; peak {memory_peak} B")
        ctx.log("feature gaps " + json.dumps(numbers))
        checks = [{"name": k, "value": numbers[k], "limit": v, "ok": numbers[k] <= v} for k, v in t["limits"].items()]
        checks.append({"name": "slides_with_wrong_rows", "value": bad_rows, "limit": 0, "ok": bad_rows == 0})
        out = {"setup_s": setup_s, "e2e": e2e, "attempted": len(in_window), "failed": bad_rows,
               "memory_peak_bytes": int(memory_peak), "checks": checks}
        if ctx.trace:
            traced = results[progress.trace_from : progress.trace_to]
            summary = profile.finish()
            out["layer"] = {
                "slice": summary,
                "stages": progress.stages,
                "patches": patches,
                "slides": len(in_window),
                "traced_patches": sum(r.num_patches for r in traced),
                "counts": profile.count,
                "flops_per_patch": flops,
                "peak_flops": harness.PEAK_FLOPS[compute],
                "precision": compute,
                "config": cfg,
            }
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def sample(ctx, in_window, n: int, last: int) -> list[tuple[object, int]]:
    """(result, row) pairs drawn from the seed among the published slides:
    ``n`` rows anywhere, then the last row of ``last`` distinct slides, which
    a slide's padded tail bucket produces."""
    rng = np.random.default_rng([ctx.seed, 1])
    picks = []
    for _ in range(n):
        r = in_window[int(rng.integers(len(in_window)))]
        picks.append((r, int(rng.integers(r.num_patches))))
    for i in rng.choice(len(in_window), size=min(last, len(in_window)), replace=False):
        r = in_window[int(i)]
        picks.append((r, r.num_patches - 1))
    return picks


def compare(ctx, cfg: dict, t: dict, in_window, key: str, compute: str, bits: int | None, *, source: dict,
            xy_of: dict, read: int) -> dict:
    """``gaps`` between the served features of the sampled patches and the
    reference's. The reference reads each patch at the coordinates the
    benchmark wrote for its row, from the pool file the listed slide links
    to."""
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    picks = sample(ctx, in_window, t["check_patches"], t["check_last_rows"])
    served, images, keys = [], [], []
    cache: dict = {}
    for r, row in picks:
        if r.h5_path not in cache:
            cache[r.h5_path] = read_h5(r.h5_path)[0]
        data = cache[r.h5_path]
        served.append(data[key][row])
        src = source[r.slide.path.name]
        x, y = (int(v) for v in xy_of[src][row])
        keys.append((str(src), x, y))
        images.append(ref_vit.preprocess(ref_slide.read_region(ref_slide.open_slide(str(src)), 0, x, y, read, read),
                                         cfg))
    want = reference_features(ctx, cfg, torch.stack(images), compute, bits)
    return gaps(np.stack(served).astype(np.float64), want, keys)


def gaps(got: np.ndarray, want: np.ndarray, keys: list) -> dict:
    """Over the sampled patches: the worst relative L2 gap |f - f_ref| /
    |f_ref| (a wrong row anywhere in the sample moves it); the worst and the
    upper quartile of the cosine distance 1 - cos(f, f_ref) (precision moves
    the quartile over many rows, which the worst patch's swings hide); the
    worst gap over the patch's own part |f - f_ref| / |f_ref - mean f_ref|;
    the patches whose nearest reference is another patch's (``keys`` name
    the patches; equal keys are one patch)."""
    norm = np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
    gap = np.linalg.norm(got - want, axis=1)
    cos_dist = 1.0 - (got * want).sum(1) / norm
    nearest = np.linalg.norm(got[:, None, :] - want[None, :, :], axis=2).argmin(axis=1)
    return {"feature_rel_err": float((gap / np.linalg.norm(want, axis=1)).max()),
            "feature_cos_dist": float(cos_dist.max()),
            "feature_cos_dist_q75": float(np.quantile(cos_dist, 0.75)),
            "feature_centered_err": float((gap / np.linalg.norm(want - want.mean(axis=0), axis=1)).max()),
            "patches_misplaced": int(sum(keys[j] != keys[i] for i, j in enumerate(nearest)))}


def reference_features(ctx, cfg: dict, images: torch.Tensor, compute: str, bits: int | None) -> np.ndarray:
    """The plain float32 ViT (``bits``: its fake-quantized control) in blocks of 32."""
    device = ctx.device
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        served = torch.bfloat16 if compute == "bfloat16" else torch.float32
        model = reference_model(cfg, ctx.seed, device, served)
        model.set_quant_bits(bits)
        out = []
        with torch.inference_mode():
            for i in range(0, images.shape[0], 32):
                out.append(model(images[i : i + 32].to(device)).double().cpu())
        del model
        return torch.cat(out).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def control(ctx: harness.Context) -> dict:
    """The cell's control, as its workload's ``control`` names it: the numbers
    the cell compares, one precision below the cell's.

    - ``{"program": {...}}``: the program itself with those traffic
      parameters (its own lower-precision path, such as ``"precision":
      "int8"``), run and checked as the cell is;
    - ``{"reference_bits": b}``: the reference with W``b``A``b`` block linears
      in the program's place, against the float32 reference, on patches drawn
      from the seed among the pool's coordinates: ``gaps``."""
    t, cfg, ex = ctx.workload["traffic"], ctx.config, ctx.workload["traffic"]["extraction"]
    spec = t["control"]
    if "program" in spec:
        lower = replace(ctx, workload={**ctx.workload, "traffic": {**t, **spec["program"]}})
        numbers = {c["name"]: c["value"] for c in run(lower)["checks"]}
        ctx.log("control checks " + json.dumps(numbers))
        return numbers
    pool = cohort.pool(t["cohort"])
    read = int(round(ex["patch_size"] * t["cohort"]["app_mag"] / ex["target_mag"]))
    rng = np.random.default_rng([ctx.seed, 3])
    images, keys = [], []
    for _ in range(t["check_patches"]):
        src = pool[int(rng.integers(len(pool)))]
        xy = coords.for_slide(src, ex)
        x, y = (int(v) for v in xy[int(rng.integers(len(xy)))])
        keys.append((str(src), x, y))
        images.append(ref_vit.preprocess(ref_slide.read_region(ref_slide.open_slide(str(src)), 0, x, y, read, read),
                                         cfg))
    images = torch.stack(images)
    want = reference_features(ctx, cfg, images, "float32", None)
    got = reference_features(ctx, cfg, images, "float32", spec["reference_bits"])
    numbers = gaps(got, want, keys)
    ctx.log("control gaps " + json.dumps(numbers))
    return numbers
