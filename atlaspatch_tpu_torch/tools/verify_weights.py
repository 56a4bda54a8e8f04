"""Weight preflight: converter → shape check → forward smoke, one line each.

The port of ``atlaspatch_tpu/tools/verify_weights.py``. The reference loads
checkpoints lazily at embed time, so a bad download or a layout drift only
surfaces mid-cohort (reference: atlas_patch/services/feature_embedding.py:
277-310, models/patch/*.py). Here validation is one command run the moment
weights land on disk:

    atlaspatch-tpu-torch verify-weights <dir> [--names a,b] [--no-smoke] [--device cpu]

For every encoder whose checkpoint is discoverable (``<dir>/<name>.{npz,
safetensors,pt,pth,bin}`` or the HF cache), the preflight runs the real
converter, compares every converted tensor's shape against the port's tower
built on ``torch.device("meta")`` (no weights materialized: the torch
counterpart of the JAX tool's ``jax.eval_shape``), and optionally runs a
1-image forward on ``device`` (``cuda`` by default) checking the output
width and finiteness. A SAM2 checkpoint (``sam2*.{npz,pt,pth}`` or
``model.pth``) is validated through the port's SAM2 converter and a
``segment_step`` smoke the same way. The rows' PASS / FAIL / SKIP rules and
the summary line are the JAX tool's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

logger = logging.getLogger("atlaspatch_tpu_torch.verify_weights")


@dataclasses.dataclass
class PreflightResult:
    name: str
    status: str  # PASS | FAIL | SKIP
    detail: str
    path: Path | None = None
    seconds: float = 0.0

    def line(self) -> str:
        where = f" [{self.path.name}]" if self.path is not None else ""
        return f"{self.status:4s} {self.name:24s} {self.detail}{where} ({self.seconds:.1f}s)"


def _shape_diff(converted: dict, expected: dict) -> list[str]:
    """Human-readable diffs between a converted state_dict and the model's
    ({key: shape} on both sides)."""
    diffs = []
    for key in sorted(set(converted) | set(expected)):
        if key not in converted:
            diffs.append(f"missing {key} {expected[key]}")
        elif key not in expected:
            diffs.append(f"unexpected {key} {converted[key]}")
        elif tuple(converted[key]) != tuple(expected[key]):
            diffs.append(f"shape {key}: ckpt {tuple(converted[key])} vs model {tuple(expected[key])}")
    return diffs


def _diff_row(name: str, diffs: list[str], path: Path, t0: float) -> PreflightResult:
    shown = "; ".join(diffs[:4]) + ("; ..." if len(diffs) > 4 else "")
    return PreflightResult(name, "FAIL", f"{len(diffs)} shape diffs: {shown}", path,
                           time.perf_counter() - t0)


def verify_encoder(entry, path: Path, *, smoke: bool = True, device: str = "cuda") -> PreflightResult:
    """Convert one checkpoint and validate it against its registered tower."""
    from atlaspatch_tpu_torch.models.encoders.zoo import _TOWERS, _convert, _load_state_dict, unflatten

    t0 = time.perf_counter()
    tower, from_flax = _TOWERS[entry.family]
    try:
        if path.suffix == ".npz":
            state = from_flax(unflatten(dict(np.load(path))))
        else:
            state = _convert(entry, _load_state_dict(path))
    except Exception as e:  # noqa: BLE001 — each failure is one report row
        return PreflightResult(entry.name, "FAIL", f"converter: {e}", path, time.perf_counter() - t0)

    try:
        with torch.device("meta"):
            expected = {k: tuple(v.shape) for k, v in tower(entry.spec).state_dict().items()}
        diffs = _shape_diff({k: tuple(v.shape) for k, v in state.items()}, expected)
    except Exception as e:  # noqa: BLE001
        return PreflightResult(entry.name, "FAIL", f"shape check: {e}", path, time.perf_counter() - t0)
    if diffs:
        return _diff_row(entry.name, diffs, path, t0)
    n_params = sum(int(np.prod(v.shape)) for v in state.values())

    if not smoke:
        return PreflightResult(
            entry.name, "PASS", f"{n_params / 1e6:.1f}M params, shapes ok (no smoke)",
            path, time.perf_counter() - t0,
        )
    size = entry.preprocess.crop
    try:
        model = tower(entry.spec)
        model.load_state_dict(state, strict=True)
        model = model.to(device=device, dtype=torch.float32).eval()
        with torch.inference_mode():
            out = model(torch.zeros((1, size, size, 3), dtype=torch.float32, device=device))
        out = out.float().cpu().numpy()
    except Exception as e:  # noqa: BLE001
        return PreflightResult(entry.name, "FAIL", f"forward: {e}", path, time.perf_counter() - t0)
    if out.shape != (1, entry.embedding_dim):
        return PreflightResult(
            entry.name, "FAIL",
            f"forward shape {out.shape} != (1, {entry.embedding_dim})", path,
            time.perf_counter() - t0,
        )
    if not np.isfinite(out).all():
        return PreflightResult(entry.name, "FAIL", "forward produced non-finite values", path,
                               time.perf_counter() - t0)
    return PreflightResult(
        entry.name, "PASS",
        f"{n_params / 1e6:.1f}M params, forward ({1},{entry.embedding_dim}) finite",
        path, time.perf_counter() - t0,
    )


# PIL resample codes used by HF preprocessor_config.json "resample"
_PIL_RESAMPLE = {0: "nearest", 2: "bilinear", 3: "bicubic", 1: "lanczos"}


def _hf_snapshot_dir(entry) -> Path | None:
    """Most recent HF cache snapshot dir for this entry's upstream repo."""
    repo = entry.source.split()[0] if entry.source and "/" in entry.source.split()[0] else None
    if not repo:
        return None
    hub = Path(
        os.environ.get("HF_HUB_CACHE")
        or Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub"
    )
    snaps = list((hub / f"models--{repo.replace('/', '--')}").glob("snapshots/*"))
    if not snaps:
        return None
    return max(snaps, key=lambda d: d.stat().st_mtime)


def _dig(cfg: dict, *keys):
    """First present key, looking inside a nested vision_config too."""
    for scope in (cfg, cfg.get("vision_config") or {}):
        for k in keys:
            if k in scope:
                return scope[k]
    return None


def verify_hf_config(entry, snapshot: Path) -> PreflightResult | None:
    """Diff pinned preprocessing/arch constants against the HF repo's own
    processor/config JSONs when they are present in the cache.

    The reference resolves some constants at runtime from these downloaded
    JSONs (reference: atlas_patch/models/patch/uni.py:13-125, hibou.py:12-74);
    this repo pins them from documentation, so any cached JSON is independent
    evidence worth diffing. Returns None when no JSON is cached (nothing to
    check); a row otherwise."""
    import json

    t0 = time.perf_counter()
    problems: list[str] = []
    checked: list[str] = []

    def _edge(value):
        """Pixel edge from the several shapes HF JSONs use for sizes:
        int, [h, w], {"height": ..}, {"shortest_edge": ..}. None if
        uninterpretable — an odd value is not evidence of a mismatch."""
        if isinstance(value, dict):
            value = value.get("shortest_edge", value.get("height"))
        if isinstance(value, (list, tuple)) and value:
            value = value[0]
        try:
            return int(value)
        except (TypeError, ValueError):
            return None

    # A malformed-but-parseable value (list sizes, odd-length means) must
    # degrade to a FAIL row for THIS entry, never abort the whole preflight.
    pp_path = snapshot / "preprocessor_config.json"
    if pp_path.exists():
        try:
            pp = json.loads(pp_path.read_text())
            pre = entry.preprocess
            mean, std = pp.get("image_mean"), pp.get("image_std")
            if mean is not None and pp.get("do_normalize", True):
                checked.append("mean/std")
                if np.shape(mean) != np.shape(tuple(pre.mean)) or not np.allclose(
                    mean, pre.mean, atol=1e-5
                ):
                    problems.append(f"image_mean {mean} != pinned {tuple(pre.mean)}")
                if std is not None and (
                    np.shape(std) != np.shape(tuple(pre.std))
                    or not np.allclose(std, pre.std, atol=1e-5)
                ):
                    problems.append(f"image_std {std} != pinned {tuple(pre.std)}")
            size = pp.get("size")
            if size is not None and pp.get("do_resize", True):
                checked.append("size")
                edge = _edge(size)
                if edge is not None and edge != int(pre.resize):
                    problems.append(f"size {size} != pinned resize {pre.resize}")
            crop = pp.get("crop_size")
            if crop is not None and pp.get("do_center_crop", False):
                checked.append("crop")
                edge = _edge(crop)
                if edge is not None and edge != int(pre.crop):
                    problems.append(f"crop_size {crop} != pinned crop {pre.crop}")
            resample = pp.get("resample")
            if resample is not None and resample in _PIL_RESAMPLE:
                checked.append("resample")
                if _PIL_RESAMPLE[resample] != pre.interpolation:
                    problems.append(
                        f"resample {_PIL_RESAMPLE[resample]} != pinned {pre.interpolation}"
                    )
        except Exception as e:  # noqa: BLE001 — still diff config.json below
            checked.append("preprocessor")
            problems.append(f"unreadable {pp_path.name}: {e}")

    cfg_path = snapshot / "config.json"
    spec = entry.spec
    if cfg_path.exists() and spec is not None:
        try:
            cfg = json.loads(cfg_path.read_text())
            # image_size is deliberately NOT diffed: HF configs carry the
            # NATIVE training size (e.g. dinov2 518) while the zoo pins the
            # reference's SERVING size (224, pos-embeds interpolated) — a
            # mismatch there is expected and correct.
            for json_keys, attr in (
                (("hidden_size", "embed_dim"), "dim"),
                (("num_hidden_layers",), "depth"),
                (("num_attention_heads",), "heads"),
                (("patch_size",), "patch_size"),
            ):
                want = getattr(spec, attr, None)
                got = _dig(cfg, *json_keys)
                if want is None or got is None:
                    continue
                checked.append(attr)
                try:
                    mismatch = int(got) != int(want)
                except (TypeError, ValueError):
                    mismatch = True
                if mismatch:
                    problems.append(f"{json_keys[0]} {got} != pinned {attr} {want}")
        except Exception as e:  # noqa: BLE001
            checked.append("config")
            problems.append(f"unreadable {cfg_path.name}: {e}")

    if not checked:
        return None
    if problems:
        shown = "; ".join(problems[:4]) + ("; ..." if len(problems) > 4 else "")
        return PreflightResult(entry.name, "FAIL", f"hf-config: {shown}", snapshot,
                               time.perf_counter() - t0)
    return PreflightResult(
        entry.name, "PASS", f"hf-config: {'/'.join(checked)} match cached JSONs",
        snapshot, time.perf_counter() - t0,
    )


def _find_sam2_checkpoint(weights_dir: Path) -> Path | None:
    for pattern in ("sam2*.npz", "sam2*.pt", "sam2*.pth", "model.pth"):
        matches = sorted(weights_dir.glob(pattern))
        if matches:
            return matches[0]
    return None


def verify_sam2(path: Path, *, smoke: bool = True, device: str = "cuda") -> PreflightResult:
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.convert import (
        _OPTIONAL_PREFIXES,
        _TIED_PE,
        load_checkpoint,
        load_into,
        load_npz,
    )
    from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel, segment_step

    t0 = time.perf_counter()
    cfg = SAM2Config.tiny()
    try:
        state = load_npz(path, cfg) if path.suffix == ".npz" else load_checkpoint(str(path))
    except Exception as e:  # noqa: BLE001
        return PreflightResult("sam2_hiera_tiny", "FAIL", f"converter: {e}", path,
                               time.perf_counter() - t0)
    try:
        with torch.device("meta"):
            expected = {k: tuple(v.shape) for k, v in SAM2ImageModel(cfg).state_dict().items()
                        if not k.startswith(_OPTIONAL_PREFIXES)}
        got = {k: tuple(np.shape(v)) for k, v in state.items() if k in expected}
        for a, b in (_TIED_PE, _TIED_PE[::-1]):  # one name of the tied projection suffices
            if a not in got and b in got:
                got[a] = got[b]
        diffs = _shape_diff(got, expected)
    except Exception as e:  # noqa: BLE001
        return PreflightResult("sam2_hiera_tiny", "FAIL", f"shape check: {e}", path,
                               time.perf_counter() - t0)
    if diffs:
        return _diff_row("sam2_hiera_tiny", diffs, path, t0)
    if not smoke:
        return PreflightResult("sam2_hiera_tiny", "PASS", "shapes ok (no smoke)", path,
                               time.perf_counter() - t0)
    try:
        model = SAM2ImageModel(cfg)
        load_into(model, state)
        model = model.to(device).eval()
        images = torch.zeros((1, cfg.image_size, cfg.image_size, 3), dtype=torch.uint8, device=device)
        logits = segment_step(model, images).cpu().numpy()
    except Exception as e:  # noqa: BLE001
        return PreflightResult("sam2_hiera_tiny", "FAIL", f"forward: {e}", path,
                               time.perf_counter() - t0)
    if not np.isfinite(logits).all():
        return PreflightResult("sam2_hiera_tiny", "FAIL", "non-finite mask logits", path,
                               time.perf_counter() - t0)
    return PreflightResult(
        "sam2_hiera_tiny", "PASS",
        f"segment_step {logits.shape} finite", path, time.perf_counter() - t0,
    )


def run_preflight(
    weights_dir: Path,
    *,
    names: Iterable[str] | None = None,
    smoke: bool = True,
    include_sam2: bool = True,
    device: str = "cuda",
    report: Callable[[str], None] = print,
) -> list[PreflightResult]:
    """Validate every discoverable checkpoint; returns all result rows."""
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES, _find_cached_weights

    wanted = list(names) if names else sorted(ENTRIES)
    unknown = [n for n in wanted if n not in ENTRIES]
    if unknown:
        raise ValueError(f"unknown encoder name(s): {', '.join(unknown)}")

    # Point weight discovery at the preflight dir only for the duration of
    # the run — an in-process caller's own weight resolution must not stay
    # silently redirected afterwards.
    prev = os.environ.get("ATLASPATCH_WEIGHTS_DIR")
    os.environ["ATLASPATCH_WEIGHTS_DIR"] = str(weights_dir)
    results: list[PreflightResult] = []
    try:
        for name in wanted:
            entry = ENTRIES[name]
            path = _find_cached_weights(entry)
            if path is None:
                results.append(PreflightResult(name, "SKIP", "no checkpoint found"))
            else:
                results.append(verify_encoder(entry, path, smoke=smoke, device=device))
            report(results[-1].line())
            snapshot = _hf_snapshot_dir(entry)
            if snapshot is not None:
                row = verify_hf_config(entry, snapshot)
                if row is not None:
                    results.append(row)
                    report(row.line())

        if include_sam2:
            sam2_path = _find_sam2_checkpoint(weights_dir)
            if sam2_path is not None:
                results.append(verify_sam2(sam2_path, smoke=smoke, device=device))
                report(results[-1].line())
    finally:
        if prev is None:
            os.environ.pop("ATLASPATCH_WEIGHTS_DIR", None)
        else:
            os.environ["ATLASPATCH_WEIGHTS_DIR"] = prev

    n_pass = sum(r.status == "PASS" for r in results)
    n_fail = sum(r.status == "FAIL" for r in results)
    n_skip = sum(r.status == "SKIP" for r in results)
    report(f"preflight: {n_pass} PASS, {n_fail} FAIL, {n_skip} SKIP")
    return results
