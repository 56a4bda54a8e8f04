"""AtlasPatch command line interface on PyTorch and CUDA.

The port of ``atlaspatch_tpu/cli.py``, with the same command and flag surface
as the reference CLI (reference: atlas_patch/cli.py:54-696):
`segment-and-get-coords`, `detect-tissue`, `process` and `info`, with the same
shared options, and the JAX package's `finetune-sam2` (norms-only SAM2
fine-tuning, whose ``sam2_finetuned.npz`` both packages' ``--sam2-checkpoint``
load) and `evaluate-masks` (IoU / F1 / precision / recall of predicted masks
against truth masks). Device flags name torch devices: ``cuda`` (the default),
``cuda:N`` or ``cpu``, with ``gpu`` an alias of ``cuda``. Without a card the
default device stops the run with an error that names ``--device cpu``; the
CLI never falls back to the CPU by itself.

Multi-GPU: ``--seg-data-parallel`` and ``--feature-parallel data|tensor``
build a mesh of every local card (``parallel/mesh.py``; with one card they
warn and run on it), `finetune-sam2 --data-parallel N` trains over N local
devices, and under torchrun's variables the pipeline commands and
`finetune-sam2` join a ``torch.distributed`` process group
(``parallel/multihost.py``): slides shard over its ranks, fine-tuning runs
in lockstep over them. ``verify-weights`` preflights checkpoints (the
port's ``tools/verify_weights.py``).

    python -m atlaspatch_tpu_torch.cli segment-and-get-coords SLIDES -o OUT \\
        --patch-size 256 --target-mag 20 [--device cpu]
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from pathlib import Path

import click

from atlaspatch_tpu_torch.core.config import (
    AppConfig,
    ExtractionConfig,
    FeatureExtractionConfig,
    OutputConfig,
    ProcessingConfig,
    SegmentationConfig,
    VisualizationConfig,
    normalize_device,
)
from atlaspatch_tpu_torch.core.models import Slide
from atlaspatch_tpu_torch.utils.logging_utils import configure_logging, install_noise_filter
from atlaspatch_tpu_torch.utils.progress import ProgressBar

logger = logging.getLogger("atlaspatch_tpu_torch.cli")


def _validate_seg_input_size(ctx, param, value):
    """Reject invalid --seg-input-size at the option layer (clean UsageError
    instead of a SegmentationConfig ValueError traceback)."""
    if value is not None and (value <= 0 or value % 32):
        raise click.BadParameter(
            f"must be a positive multiple of 32, got {value}"
        )
    return value


def _validate_device(ctx, param, value):
    """A torch device string (cuda, cuda:N, gpu, cpu), canonicalized; the JAX
    package's ``tpu`` is refused at the option layer."""
    if value is None:
        return None
    if value.strip().lower().split(":")[0] == "tpu":
        raise click.BadParameter(
            f"{value!r} names a TPU, which this PyTorch port does not run on; "
            "use cuda, cuda:<index> or cpu"
        )
    try:
        return normalize_device(value)
    except ValueError as e:
        raise click.BadParameter(str(e)) from e


def _require_devices(*devices: str) -> None:
    """Stop before any work when a CUDA device is asked for (the default) and
    no card is visible: the run never moves to the CPU unless asked to."""
    if any(d.startswith("cuda") for d in devices):
        import torch

        if not torch.cuda.is_available():
            raise click.UsageError(
                "CUDA is not available on this machine, and the default device is "
                "cuda; pass --device cpu (and --feature-device cpu) to run on the CPU."
            )


def _local_mesh(flag: str, device: str, tensor_parallel: bool = False):
    """A mesh of every local device of ``device``'s kind
    (``parallel.mesh.local_devices``): one data row per device, or with
    ``tensor_parallel`` one row of them all, as the JAX CLI builds it; None,
    with the JAX CLI's warning, when only one is visible."""
    from atlaspatch_tpu_torch.parallel import mesh

    devices = mesh.local_devices(device)
    if len(devices) <= 1:
        logger.warning("%s requested but only one device is visible.", flag)
        return None
    grid = mesh.embedding_mesh(len(devices) if tensor_parallel else 1, devices)
    logger.info("%s over %d %s devices: %s", flag, len(devices), devices[0].type, grid)
    return grid


# Shared option sets -----------------------------------------------------------
_COMMON_OPTIONS: list = [
    click.argument("wsi_path", type=click.Path(exists=True)),
    click.option("--output", "-o", type=click.Path(), required=True,
                 help="Output directory root for generated artifacts."),
    click.option("--patch-size", type=int, required=True,
                 help="Patch size at target magnification."),
    click.option("--step-size", type=int, default=None,
                 help="Stride between patches; defaults to patch size when omitted."),
    click.option("--target-mag", type=click.IntRange(1, 120), required=True,
                 help="Target magnification (e.g., 20, 40)."),
    click.option("--device", type=str, default="cuda", show_default=True,
                 callback=_validate_device,
                 help="Segmentation device (cuda, cuda:0, cpu; gpu maps to cuda)."),
    click.option("--tissue-thresh", type=float, default=0.0, show_default=True,
                 help="Minimum tissue area fraction."),
    click.option("--white-thresh", type=int, default=15, show_default=True,
                 help="Saturation threshold for white filtering."),
    click.option("--black-thresh", type=int, default=50, show_default=True,
                 help="RGB threshold for black filtering."),
    click.option("--seg-batch-size", type=int, default=1, show_default=True,
                 help="Segmentation batch."),
    click.option("--write-batch", type=int, default=8192, show_default=True,
                 help="HDF5 write batch."),
    click.option("--patch-workers", type=int, default=None,
                 help="Parallel worker threads for per-slide patch extraction; "
                      "defaults to CPU count."),
    click.option("--max-open-slides", type=int, default=200, show_default=True,
                 help="Upper bound on simultaneously open slides."),
    click.option("--fast-mode/--no-fast-mode", default=True, show_default=True,
                 help="fast-mode skips per-patch content filtering."),
    click.option("--save-images", is_flag=True, help="Export individual patch PNGs."),
    click.option("--visualize-grids", is_flag=True, help="Render patch grid overlay."),
    click.option("--visualize-mask", is_flag=True, help="Render predicted mask overlay."),
    click.option("--visualize-contours", is_flag=True, help="Render contour overlay."),
    click.option("--recursive", is_flag=True, help="Recursively search directories for WSIs."),
    click.option("--mpp-csv", type=click.Path(exists=True), default=None,
                 help="CSV with custom MPP."),
    click.option("--skip-existing/--force", default=True, show_default=True,
                 help="Skip existing H5."),
    click.option("--sam2-checkpoint", type=click.Path(exists=True), default=None,
                 help="Path to a SAM2 checkpoint (.pth/.pt, or the JAX package's .npz)."),
    click.option("--sam2-config", type=click.Path(exists=True), default=None,
                 help="SAM2 architecture YAML (reference hydra format); "
                      "defaults to the built-in hiera-tiny spec."),
    click.option("--seg-precision",
                 type=click.Choice(["float32", "bfloat16"], case_sensitive=False),
                 default="float32", show_default=True,
                 help="Segmentation compute precision (bfloat16 = faster, "
                      "hairline mask-boundary differences)."),
    click.option("--seg-input-size", type=int, default=None,
                 callback=_validate_seg_input_size,
                 help="SAM2 model input resolution (multiple of 32; default: "
                      "the architecture's 1024). Thumbnails are <=1024px, so "
                      "e.g. 512 runs the trunk ~4x cheaper on the same "
                      "pixels; validate mask quality for your checkpoint "
                      "before lowering."),
    click.option("--seg-data-parallel", is_flag=True,
                 help="Shard segmentation batches across all local GPUs "
                      "(data-parallel mesh; needs --seg-batch-size >= GPU count)."),
    click.option("--fast", is_flag=True,
                 help="Throughput preset: --seg-precision bfloat16 "
                      "--seg-batch-size 8 --seg-input-size 768. "
                      "Explicitly-passed seg flags still win."),
    click.option("--verbose", "-v", is_flag=True, help="Enable debug logging."),
]

_FEATURE_OPTIONS: list = [
    click.option("--feature-device", type=str, default=None, callback=_validate_device,
                 help="Device for feature extraction; defaults to --device."),
    click.option("--feature-extractors", required=True, type=str,
                 help="Space/comma separated feature extractors to run "
                      "(see `info`; add more via --feature-plugin)."),
    click.option("--feature-batch-size", type=int, default=32, show_default=True,
                 help="Batch size used when embedding patches."),
    click.option("--feature-num-workers", type=int, default=4, show_default=True,
                 help="Host reader thread count for feature extraction."),
    click.option("--feature-precision",
                 type=click.Choice(["float32", "float16", "bfloat16", "int8"], case_sensitive=False),
                 default="float16", show_default=True,
                 help="Computation precision (float16 maps to bfloat16 on the GPU; "
                      "int8 runs ViT-family encoders W8A8 on the tensor cores — "
                      "fastest, small feature drift)."),
    click.option("--feature-plugin", "feature_plugins", type=click.Path(exists=True),
                 multiple=True,
                 help="Python module(s) registering custom feature extractors via "
                      "register_feature_extractors(registry, device, dtype, num_workers)."),
    click.option("--feature-parallel",
                 type=click.Choice(["none", "data", "tensor"], case_sensitive=False),
                 default="none", show_default=True,
                 help="Shard feature embedding across all local GPUs: 'data' "
                      "splits batches, 'tensor' also shards ViT attention heads "
                      "and MLP hidden units (for ViT-g+ towers; int8 too)."),
]


def _apply_options(func, options: list):
    for opt in reversed(options):
        func = opt(func)
    return func


def common_options(func):
    return _apply_options(func, _COMMON_OPTIONS)


def feature_options(func):
    return _apply_options(func, _FEATURE_OPTIONS)


def _build_app_config(kw: dict, feature_cfg: FeatureExtractionConfig | None) -> AppConfig:
    if kw.get("fast"):
        # Preset fills only values the user didn't pass on the command line,
        # so `--fast --seg-precision float32` keeps the explicit float32.
        ctx = click.get_current_context(silent=True)

        def _explicit(name: str) -> bool:
            if ctx is None:
                return False
            src = ctx.get_parameter_source(name)
            return src is not None and src.name == "COMMANDLINE"

        if not _explicit("seg_precision"):
            kw["seg_precision"] = "bfloat16"
        if (
            not _explicit("seg_input_size")
            and kw.get("seg_input_size") is None
            and not kw.get("sam2_config")
        ):
            # 768 runs the trunk on ~0.56x the tokens of the architecture's
            # 1024. The reference-parity default stays 1024; pass
            # --seg-input-size 1024 to keep it under --fast. A custom
            # --sam2-config keeps ITS native size. Marked as preset-chosen:
            # the predictor falls back to the architecture's native size if
            # its window spec cannot tile 768.
            kw["seg_input_size"] = 768
            kw["_seg_input_size_preset"] = True
            if kw.get("sam2_checkpoint"):
                # Mask quality at a reduced size is per-checkpoint: say so
                # rather than degrade masks silently.
                logger.info(
                    "--fast runs SAM2 at input size 768. For your checkpoint, "
                    "validate mask quality at this size or pass "
                    "--seg-input-size 1024 for the parity resolution.",
                )
        if not _explicit("seg_batch_size"):
            kw["seg_batch_size"] = 8
            if (os.cpu_count() or 1) > 2:
                logger.info(
                    "--fast picked --seg-batch-size 8; on this %d-CPU host a "
                    "larger batch may be faster — time it and pass "
                    "--seg-batch-size explicitly.", os.cpu_count(),
                )
    return AppConfig(
        processing=ProcessingConfig(
            input_path=Path(kw["wsi_path"]),
            recursive=kw["recursive"],
            mpp_csv=Path(kw["mpp_csv"]) if kw["mpp_csv"] else None,
        ),
        segmentation=SegmentationConfig(
            checkpoint_path=Path(kw["sam2_checkpoint"]) if kw.get("sam2_checkpoint") else None,
            config_path=Path(kw["sam2_config"]) if kw.get("sam2_config") else None,
            device=kw["device"],
            batch_size=kw["seg_batch_size"],
            precision=kw.get("seg_precision", "float32").lower(),
            input_size=kw.get("seg_input_size"),
            input_size_preset=kw.get("_seg_input_size_preset", False),
        ),
        extraction=ExtractionConfig(
            patch_size=kw["patch_size"],
            step_size=kw["step_size"],
            target_magnification=kw["target_mag"],
            tissue_threshold=kw["tissue_thresh"],
            white_threshold=kw["white_thresh"],
            black_threshold=kw["black_thresh"],
            fast_mode=kw["fast_mode"],
            write_batch=kw["write_batch"],
            workers=kw["patch_workers"],
            max_open_slides=kw["max_open_slides"],
        ),
        output=OutputConfig(
            output_root=Path(kw["output"]),
            save_images=kw["save_images"],
            visualize_grids=kw["visualize_grids"],
            visualize_mask=kw["visualize_mask"],
            visualize_contours=kw["visualize_contours"],
            skip_existing=kw["skip_existing"],
        ),
        visualization=VisualizationConfig(),
        features=feature_cfg,
        device=kw["device"],
    ).validated()


def _run_pipeline(
    *, feature_cfg: FeatureExtractionConfig | None = None, registry=None, **kw
) -> tuple[list, list]:
    from atlaspatch_tpu_torch.utils import perf

    with perf.maybe_trace():
        results, failures = _run_pipeline_inner(
            feature_cfg=feature_cfg, registry=registry, **kw
        )
    perf.log_report()
    return results, failures


def _process_group(command):
    """Run ``command`` in a ``torch.distributed`` group when torchrun's
    variables ask for one (``multihost.maybe_init_distributed``, on the
    command's ``device``), destroyed when the command ends."""

    @functools.wraps(command)
    def run(**kw):
        from atlaspatch_tpu_torch.parallel.multihost import maybe_init_distributed, shutdown_distributed

        configure_logging(kw["verbose"])
        initialized = maybe_init_distributed(kw["device"])
        try:
            return command(**kw)
        finally:
            if initialized:
                shutdown_distributed()

    return run


def _run_pipeline_inner(
    *, feature_cfg: FeatureExtractionConfig | None = None, registry=None, **kw
) -> tuple[list, list]:
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.mpp import CSVMPPResolver
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.services.visualization import DefaultVisualizationService
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader

    configure_logging(kw["verbose"])
    app_cfg = _build_app_config(kw, feature_cfg)
    _require_devices(app_cfg.segmentation.device, *([app_cfg.features.device] if app_cfg.features else []))
    seg_mesh = None
    if kw.get("seg_data_parallel"):
        seg_mesh = _local_mesh("--seg-data-parallel", app_cfg.segmentation.device)

    feature_service = None
    if app_cfg.features is not None:
        from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService

        feature_service = PatchFeatureEmbeddingService(
            app_cfg.extraction, app_cfg.output, app_cfg.features, registry=registry
        )
    segmentation_service = SAM2SegmentationService(app_cfg.segmentation, mesh=seg_mesh)
    extractor_service = PatchExtractionService(app_cfg.extraction, app_cfg.output)
    visualizer_service = None
    if kw["visualize_grids"] or kw["visualize_mask"] or kw["visualize_contours"]:
        visualizer_service = DefaultVisualizationService(
            app_cfg.output, app_cfg.extraction, app_cfg.visualization
        )

    runner = ProcessingRunner(
        config=app_cfg,
        segmentation=segmentation_service,
        extractor=extractor_service,
        visualizer=visualizer_service,
        mpp_resolver=CSVMPPResolver(app_cfg.processing.mpp_csv),
        wsi_loader=DefaultWSILoader(),
        show_progress=not kw["verbose"],
    )
    try:
        results, failures = runner.run()
    finally:
        segmentation_service.close()

    click.echo("Segmentation and patch coordinate extraction complete.")

    if feature_service is not None:
        total_units = len(results) * len(app_cfg.features.extractors)
        progress = ProgressBar(
            total=total_units, enabled=not kw["verbose"] and total_units > 0,
            desc="Feature embedding",
        )
        try:
            failures.extend(
                feature_service.embed_all(
                    results, wsi_loader=DefaultWSILoader(), progress=progress
                )
            )
        finally:
            progress.close()

    return results, failures


def _echo_results(results: list, failures: list, verbose: bool, feature_cfg) -> None:
    click.echo(f"Completed {len(results)} slide(s), failures: {len(failures)}")
    if verbose:
        for res in results:
            feature_note = (
                f" features={','.join(feature_cfg.extractors)}" if feature_cfg else ""
            )
            click.echo(
                f"[OK] {res.slide.path.name} -> {res.h5_path} "
                f"(patches={res.num_patches}){feature_note}"
            )
        for slide, err in failures:
            click.echo(f"[FAIL] {slide.path.name}: {err}", err=True)


@click.group()
@click.version_option(version="0.1.0")
def cli():
    """AtlasPatch on PyTorch/CUDA: WSI segmentation, patching, and embedding on NVIDIA GPUs."""


@cli.command()
@common_options
@_process_group
def segment_and_get_coords(**kw):
    """Segment, patchify, and optionally visualize WSI files."""
    results, failures = _run_pipeline(feature_cfg=None, **kw)
    _echo_results(results, failures, kw["verbose"], None)


@cli.command()
@click.argument("wsi_path", type=click.Path(exists=True))
@click.option("--output", "-o", type=click.Path(), required=True,
              help="Output directory root for generated artifacts.")
@click.option("--device", type=str, default="cuda", show_default=True,
              callback=_validate_device, help="Segmentation device.")
@click.option("--seg-batch-size", type=click.IntRange(1, None), default=1, show_default=True,
              help="Segmentation batch size for thumbnail inference.")
@click.option("--recursive", is_flag=True, help="Recursively search directories for WSIs.")
@click.option("--mpp-csv", type=click.Path(exists=True), default=None,
              help="CSV with custom MPP.")
@click.option("--sam2-checkpoint", type=click.Path(exists=True), default=None,
              help="Path to a SAM2 checkpoint.")
@click.option("--seg-input-size", type=int, default=None,
              callback=_validate_seg_input_size,
              help="SAM2 model input resolution (multiple of 32; default: the "
                   "architecture's size, 1024 for hiera-tiny).")
@click.option("--verbose", "-v", is_flag=True, help="Enable debug logging.")
def detect_tissue(wsi_path, output, device, seg_batch_size, recursive, mpp_csv,
                  sam2_checkpoint, seg_input_size, verbose):
    """Run tissue segmentation only and export mask overlays."""
    from atlaspatch_tpu_torch.services.mpp import CSVMPPResolver
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader
    from atlaspatch_tpu_torch.utils import perf
    from atlaspatch_tpu_torch.utils.params import get_wsi_files
    from atlaspatch_tpu_torch.utils.visualization import visualize_mask_on_thumbnail

    configure_logging(verbose)
    processing_cfg = ProcessingConfig(
        input_path=Path(wsi_path),
        recursive=recursive,
        mpp_csv=Path(mpp_csv) if mpp_csv else None,
    ).validated()
    segmentation_cfg = SegmentationConfig(
        checkpoint_path=Path(sam2_checkpoint) if sam2_checkpoint else None,
        device=device,
        batch_size=seg_batch_size,
        input_size=seg_input_size,
    ).validated()
    vis_cfg = VisualizationConfig().validated()
    _require_devices(segmentation_cfg.device)

    slide_paths = get_wsi_files(str(processing_cfg.input_path), recursive=processing_cfg.recursive)
    output_root = Path(output)
    output_root.mkdir(parents=True, exist_ok=True)
    vis_dir = output_root / "visualization"

    mpp_resolver = CSVMPPResolver(processing_cfg.mpp_csv)
    wsi_loader = DefaultWSILoader()
    segmentation_service = SAM2SegmentationService(segmentation_cfg)

    results: list[tuple[Slide, Path]] = []
    failures: list[tuple[Slide, Exception | str]] = []
    progress = ProgressBar(total=len(slide_paths), enabled=not verbose, desc="Tissue detection")

    def cleanup(wsi) -> None:
        try:
            wsi.cleanup()
        except Exception:  # noqa: BLE001 — never mask the slide's outcome
            pass

    def process_batch(batch):
        if not batch:
            return
        # Per-slide fault isolation (beyond reference parity, which fails the
        # whole batch: reference cli.py:384-391): thumbnails prepare with
        # per-slide error capture; only healthy slides enter the device step,
        # and a device-step failure falls back to one-by-one segmentation.
        prepped = segmentation_service.prepare_thumbnails_safe([w for _, w in batch])
        healthy = []
        for (slide, wsi), thumb in zip(batch, prepped):
            if isinstance(thumb, Exception):
                failures.append((slide, thumb))
                cleanup(wsi)
                progress.update(1)
            else:
                healthy.append((slide, wsi, thumb))
        if not healthy:
            return
        thumbs = [t for _, _, t in healthy]
        try:
            masks = segmentation_service.segment_thumbnails(thumbs)
        except Exception:  # noqa: BLE001 — isolate the poisoned slide
            masks = []
            for _slide, _wsi, t in healthy:
                try:
                    masks.append(segmentation_service.segment_thumbnails([t])[0])
                except Exception as e:  # noqa: BLE001
                    masks.append(e)
        for (slide, wsi, _thumb), mask in zip(healthy, masks):
            if isinstance(mask, Exception):
                failures.append((slide, mask))
                cleanup(wsi)
                progress.update(1)
                continue
            try:
                out_path = visualize_mask_on_thumbnail(
                    mask=mask.data, wsi=wsi, output_dir=vis_dir,
                    thumbnail_size=vis_cfg.thumbnail_size,
                )
                results.append((slide, out_path))
            except Exception as e:  # noqa: BLE001
                failures.append((slide, e))
            finally:
                cleanup(wsi)
            progress.update(1)

    # ATLASPATCH_TORCH_TRACE=<dir>: a trace of the batches, as segment-and-get-coords writes
    with perf.maybe_trace():
        try:
            batch = []
            for path_str in slide_paths:
                base = Slide(path=Path(path_str))
                slide = Slide(path=base.path, mpp=mpp_resolver.resolve(base), backend=base.backend)
                try:
                    wsi = wsi_loader.open(slide)
                except Exception as e:  # noqa: BLE001
                    failures.append((slide, e))
                    progress.update(1)
                    continue
                batch.append((slide, wsi))
                if len(batch) >= segmentation_cfg.batch_size:
                    process_batch(batch)
                    batch = []
            if batch:
                process_batch(batch)
        finally:
            segmentation_service.close()
            progress.close()

    click.echo(f"Created {len(results)} mask overlay(s), failures: {len(failures)}")
    if verbose:
        for slide, path in results:
            click.echo(f"[OK] {slide.path.name} -> {path}")
        for slide, err in failures:
            click.echo(f"[FAIL] {slide.path.name}: {err}", err=True)


@cli.command()
@feature_options
@common_options
@_process_group
def process(**kw):
    """Run segmentation, patch extraction, and feature embedding into one H5."""
    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.models.encoders.custom import register_feature_extractors_from_module
    from atlaspatch_tpu_torch.services.feature_embedding import resolve_feature_dtype
    from atlaspatch_tpu_torch.utils.features import parse_feature_list

    feat_device = kw.pop("feature_device") or kw["device"]
    precision = kw.pop("feature_precision").lower()
    num_workers = kw.pop("feature_num_workers")
    batch_size = kw.pop("feature_batch_size")
    plugins = kw.pop("feature_plugins")
    extractors_raw = kw.pop("feature_extractors")

    dtype = resolve_feature_dtype(feat_device, precision)
    feat_parallel = kw.pop("feature_parallel", "none").lower()
    feat_mesh = None
    if feat_parallel != "none":
        feat_mesh = _local_mesh("--feature-parallel", feat_device, tensor_parallel=feat_parallel == "tensor")
    registry = build_default_registry(device=feat_device, num_workers=num_workers, dtype=dtype,
                                      mesh=feat_mesh, tensor_parallel=feat_parallel == "tensor")
    for plugin in plugins:
        register_feature_extractors_from_module(
            plugin,
            registry=registry,
            device=feat_device,  # plugins honor --feature-device like built-ins
            dtype=dtype,
            num_workers=num_workers,
        )

    try:
        feats = parse_feature_list(extractors_raw, choices=registry.available())
    except ValueError as e:
        raise click.BadParameter(str(e)) from e

    feature_cfg = FeatureExtractionConfig(
        extractors=feats,
        batch_size=batch_size,
        device=feat_device,
        num_workers=num_workers,
        precision=precision,
        plugins=[Path(p) for p in plugins],
    )
    results, failures = _run_pipeline(feature_cfg=feature_cfg, registry=registry, **kw)
    _echo_results(results, failures, kw["verbose"], feature_cfg)


@cli.command()
def info():
    """Display supported formats, encoders, and output structure."""
    from atlaspatch_tpu_torch.models.encoders.zoo import ZOO_STATUS

    click.echo(
        "Supported WSI formats (native TIFF decoder): .svs, .tif, .tiff, .ndpi, "
        ".scn, .bif (vendor-aware: NDPI SourceLens levels + striped giant-JPEG "
        "decode; SCN XML main-region pyramid; Ventana BIF iScan mag/MPP + AOI "
        "join-overlap correction; Philips TIFF pixel spacing + sparse tiles; "
        "Trestle per-level OverlapsXY correction + Objective Power)"
    )
    click.echo(
        "Non-TIFF containers (first-party readers): .mrxs (MIRAX), "
        ".vms/.vmu (Hamamatsu), .dcm (DICOM WSI)"
    )
    click.echo("Image formats: .png, .jpg, .jpeg, .bmp, .webp, .gif")
    click.echo(
        "Outputs: HDF5 per slide under patches/<stem>.h5; optional PNGs under "
        "images/<stem>; visualizations under visualization/."
    )
    click.echo(f"Feature extractors ({len(ZOO_STATUS['implemented'])} ready): "
               + ", ".join(ZOO_STATUS["implemented"]))
    if ZOO_STATUS["pending"]:
        click.echo("Registered, tower pending: " + ", ".join(ZOO_STATUS["pending"]))


@cli.command("finetune-sam2")
@click.argument("images_dir", type=click.Path(exists=True, file_okay=False))
@click.option("--masks", "masks_dir", type=click.Path(exists=True, file_okay=False),
              required=True,
              help="Directory of binary masks matching images by stem "
                   "(optional '_mask' suffix).")
@click.option("--output", "-o", type=click.Path(), required=True,
              help="Output directory for checkpoints and the final .npz.")
@click.option("--epochs", type=click.IntRange(1, None), default=1, show_default=True)
@click.option("--batch-size", type=click.IntRange(1, None), default=2, show_default=True)
@click.option("--learning-rate", type=float, default=1e-4, show_default=True)
@click.option("--sam2-checkpoint", type=click.Path(exists=True), default=None,
              help="Initial SAM2 weights (.pth/.pt, or the JAX package's .npz); defaults "
                   "to the auto-resolved checkpoint, or random init with "
                   "ATLASPATCH_ALLOW_RANDOM_WEIGHTS=1.")
@click.option("--sam2-config", type=click.Path(exists=True), default=None,
              help="SAM2 architecture YAML (reference hydra format).")
@click.option("--image-size", type=click.IntRange(32, None), default=None,
              help="Override model input size (small-scale experiments).")
@click.option("--data-parallel", type=click.IntRange(1, None), default=1,
              show_default=True,
              help="Shard batches over N local devices (data-parallel).")
@click.option("--save-every", type=click.IntRange(0, None), default=0,
              show_default=True, help="Save a checkpoint every N epochs.")
@click.option("--val-fraction", type=click.FloatRange(0.0, 0.9), default=0.0,
              show_default=True,
              help="Hold out this fraction of pairs; report val loss/IoU per epoch.")
@click.option("--resume", is_flag=True,
              help="Resume from the latest checkpoint in the output dir.")
@click.option("--lr-schedule", type=click.Choice(["constant", "cosine"]),
              default="constant", show_default=True,
              help="Learning-rate schedule (cosine decays over the full run).")
@click.option("--warmup-steps", type=click.IntRange(0, None), default=0,
              show_default=True, help="Linear LR warmup steps.")
@click.option("--augment", is_flag=True,
              help="Random horizontal/vertical flips (image+mask together).")
@click.option("--trainable", type=click.Choice(["norms", "all"]), default="norms",
              show_default=True,
              help="'norms' freezes the backbone (the reference recipe for "
                   "finetuning pretrained weights); 'all' trains every "
                   "parameter (required when starting from random init).")
@click.option("--seed", type=int, default=0, show_default=True)
@click.option("--device", type=str, default="cuda", show_default=True,
              callback=_validate_device, help="Training device (cuda, cuda:0, cpu).")
@click.option("--verbose", "-v", is_flag=True, help="Enable debug logging.")
@_process_group  # lockstep fine-tuning over the group's ranks
def finetune_sam2_cmd(images_dir, masks_dir, output, epochs, batch_size,
                      learning_rate, sam2_checkpoint, sam2_config, image_size,
                      data_parallel, save_every, val_fraction, resume,
                      lr_schedule, warmup_steps, augment, trainable, seed,
                      device, verbose):
    """Finetune SAM2 on (thumbnail, mask) pairs.

    Default recipe matches the reference's published training (backbone
    frozen, only normalization layers trained); --trainable all unlocks
    full training for from-scratch runs. The final sam2_finetuned.npz
    plugs straight into --sam2-checkpoint.
    """
    from atlaspatch_tpu_torch.models.train.loop import finetune_sam2

    _require_devices(device)
    bar = ProgressBar(total=None, enabled=not verbose, desc="finetune")

    def on_step(step: int, loss: float) -> None:
        bar.update(1)
        if verbose:
            logger.debug("step %d: loss %.4f", step, loss)

    try:
        summary = finetune_sam2(
            Path(images_dir),
            Path(masks_dir),
            Path(output),
            epochs=epochs,
            batch_size=batch_size,
            learning_rate=learning_rate,
            checkpoint=Path(sam2_checkpoint) if sam2_checkpoint else None,
            config_path=Path(sam2_config) if sam2_config else None,
            image_size=image_size,
            data_parallel=data_parallel,
            save_every=save_every,
            val_fraction=val_fraction,
            resume=resume,
            lr_schedule=lr_schedule,
            warmup_steps=warmup_steps,
            augment=augment,
            trainable=trainable,
            seed=seed,
            device=device,
            on_step=on_step,
        )
    finally:
        bar.close()
    if summary["first_loss"] is None:
        click.echo(
            f"Nothing left to train (resumed at step {summary['steps']})."
        )
    else:
        resumed = (
            f" (resumed at step {summary['resumed_at']})"
            if summary["resumed_at"]
            else ""
        )
        click.echo(
            f"Finetuned {summary['steps_this_run']} step(s) over "
            f"{summary['pairs']} pair(s){resumed}: "
            f"loss {summary['first_loss']:.4f} → {summary['final_loss']:.4f}"
        )
    if "val_loss" in summary:
        click.echo(
            f"Validation ({summary['val_pairs']} held-out pair(s)): "
            f"loss {summary['val_loss']:.4f}, IoU {summary['val_iou']:.4f}"
        )
    click.echo(f"Checkpoint: {summary['checkpoint']}")


@cli.command("evaluate-masks")
@click.argument("pred_dir", type=click.Path(exists=True, file_okay=False))
@click.option("--truth", "truth_dir", type=click.Path(exists=True, file_okay=False),
              required=True,
              help="Ground-truth binary masks, stem-matched to predictions.")
@click.option("--threshold", type=click.IntRange(0, 255), default=127,
              show_default=True, help="Grayscale > threshold counts as tissue.")
@click.option("--csv", "csv_path", type=click.Path(), default=None,
              help="Also write per-slide metrics as CSV.")
def evaluate_masks(pred_dir, truth_dir, threshold, csv_path):
    """Score predicted tissue masks against ground truth (IoU/F1/P/R).

    Predictions are detect-tissue's <stem>_mask_bw.png (or any stem-matched
    binary masks); truth masks match by stem with an optional '_mask'
    suffix. Reproduces the reference's published quality comparison
    (F1 vs baselines) on user annotations.
    """
    from atlaspatch_tpu_torch.utils.maskeval import score_mask_dirs

    rows, summary = score_mask_dirs(
        Path(pred_dir), Path(truth_dir), threshold=threshold
    )
    for r in rows:
        click.echo(
            f"{r['slide']}: IoU {r['iou']:.4f}  F1 {r['f1']:.4f}  "
            f"P {r['precision']:.4f}  R {r['recall']:.4f}"
        )
    click.echo(
        f"Mean over {summary['n']} slide(s): IoU {summary['iou']:.4f}  "
        f"F1 {summary['f1']:.4f}  P {summary['precision']:.4f}  "
        f"R {summary['recall']:.4f}"
    )
    if csv_path:
        import csv as _csv

        with open(csv_path, "w", newline="") as f:
            writer = _csv.DictWriter(
                f, fieldnames=["slide", "iou", "f1", "precision", "recall"]
            )
            writer.writeheader()
            writer.writerows(rows)
        click.echo(f"CSV: {csv_path}")


@cli.command("verify-weights")
@click.argument("weights_dir", type=click.Path(exists=True, file_okay=False))
@click.option("--names", default=None,
              help="Comma-separated encoder names (default: all 66).")
@click.option("--smoke/--no-smoke", default=True, show_default=True,
              help="Run a 1-image forward per checkpoint on --device (slow for "
                   "giant towers); --no-smoke stops at converter + shape checks.")
@click.option("--no-sam2", is_flag=True, help="Skip SAM2 checkpoint detection.")
@click.option("--device", type=str, default="cuda", show_default=True,
              callback=_validate_device, help="Device of the forward smoke (cuda, cuda:0, cpu).")
def verify_weights_cmd(weights_dir, names, smoke, no_sam2, device):
    """Preflight checkpoints: converter → shape check → forward smoke.

    One PASS/FAIL/SKIP line per encoder found under WEIGHTS_DIR (or the HF
    cache). Run this the moment real weights land so layout drift surfaces
    before a cohort job, not mid-run (the reference loads lazily at embed
    time: reference feature_embedding.py:277-310). Exits non-zero if any
    checkpoint FAILs; SKIPs (no checkpoint) are informational.
    """
    from atlaspatch_tpu_torch.tools.verify_weights import run_preflight

    _require_devices(device)
    name_list = [n.strip() for n in names.split(",") if n.strip()] if names else None
    try:
        results = run_preflight(
            Path(weights_dir),
            names=name_list,
            smoke=smoke,
            include_sam2=not no_sam2,
            device=device,
            report=click.echo,
        )
    except ValueError as e:
        raise click.ClickException(str(e)) from e
    if any(r.status == "FAIL" for r in results):
        sys.exit(1)


def main(argv: list[str] | None = None, standalone_mode: bool = True):
    """The console entry point. With ``standalone_mode=False`` (in-process
    callers) the command's exceptions propagate instead of becoming an exit
    code."""
    install_noise_filter()
    if not standalone_mode:
        return cli.main(args=argv, standalone_mode=False)
    try:
        cli.main(args=argv)
    except click.ClickException as e:
        click.echo(f"Error: {e}", err=True)
        sys.exit(1)
    except KeyboardInterrupt:
        click.echo("\nInterrupted by user", err=True)
        sys.exit(130)
    except Exception as e:  # noqa: BLE001
        click.echo(f"Unexpected error: {e}", err=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
