"""Feature-drift snapshots: hold the port's features against the reference's on real weights.

The port of ``atlaspatch_tpu/tools/drift_check.py``. Offline, the port is
held only against the JAX package on weights made from seeds; the moment
real checkpoints exist this tool closes the loop in two halves that can run
on different machines:

1. ``snapshot`` — embed a fixed, seeded synthetic patch batch through the
   port's production engine (``build_default_registry``, float32, on
   ``--device``, ``cuda`` by default) and write ``<out>/<name>.ours.npy``
   plus the exact input batch ``<out>/patches.npy`` (uint8 NHWC, the same
   bytes as the JAX tool's). Run where the weights are.
2. On a machine with the reference installed, embed ``patches.npy`` with the
   reference's extractor for the same model and save ``<out>/<name>.ref.npy``
   (reference API: ``FeatureExtractorFactory`` → ``extract_features``,
   reference services/feature_embedding.py).
3. ``compare`` — report max relative error + cosine per name and PASS/FAIL
   at the 1e-3 gate (``drift_report.json``).

Usage:
    python -m atlaspatch_tpu_torch.tools.drift_check snapshot OUT --names uni_v1,conch_v1 [--device cpu]
    python -m atlaspatch_tpu_torch.tools.drift_check compare OUT [--tolerance 1e-3]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

N_PATCHES = 8
PATCH_PX = 256
SEED = 20260820


def make_patches() -> np.ndarray:
    """Deterministic histology-ish uint8 batch — identical on every machine."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(120, 255, (N_PATCHES, PATCH_PX, PATCH_PX, 3), dtype=np.uint8)
    # low-frequency structure so attention/pooling see more than iid noise
    yy, xx = np.mgrid[0:PATCH_PX, 0:PATCH_PX].astype(np.float32) / PATCH_PX
    for i in range(N_PATCHES):
        blob = 0.5 + 0.5 * np.sin(6.28 * (yy * (i % 3 + 1) + xx * (i % 4 + 1)))
        base[i] = np.clip(base[i] * blob[..., None], 0, 255).astype(np.uint8)
    return base


def snapshot(out: Path, names: list[str], device: str = "cuda") -> int:
    from atlaspatch_tpu_torch.models.encoders.zoo import build_default_registry

    out.mkdir(parents=True, exist_ok=True)
    patches = make_patches()
    np.save(out / "patches.npy", patches)
    registry = build_default_registry(device=device, dtype="float32")
    failures = 0
    for name in names:
        try:
            ex = registry.create(name)
            feats = np.asarray(ex.extract_batch(list(patches), batch_size=N_PATCHES))
            ex.cleanup()
            assert np.isfinite(feats).all(), "non-finite features"
            np.save(out / f"{name}.ours.npy", feats.astype(np.float32))
            print(f"SNAP {name}: {feats.shape} -> {name}.ours.npy")
        except Exception as e:  # noqa: BLE001 — per-name isolation, report all
            failures += 1
            print(f"FAIL {name}: {type(e).__name__}: {e}")
    return failures


def compare(out: Path, tolerance: float) -> int:
    rows, failures = [], 0
    for ours_p in sorted(out.glob("*.ours.npy")):
        name = ours_p.name[: -len(".ours.npy")]
        ref_p = out / f"{name}.ref.npy"
        if not ref_p.exists():
            rows.append({"name": name, "status": "SKIP", "detail": "no .ref.npy"})
            continue
        ours, ref = np.load(ours_p), np.load(ref_p)
        if ours.shape != ref.shape:
            failures += 1
            rows.append({"name": name, "status": "FAIL",
                         "detail": f"shape {ours.shape} vs {ref.shape}"})
            continue
        denom = np.maximum(np.abs(ref), 1e-3)
        max_rel = float(np.max(np.abs(ours - ref) / denom))
        cos = float(np.mean(
            np.sum(ours * ref, -1)
            / (np.linalg.norm(ours, axis=-1) * np.linalg.norm(ref, axis=-1) + 1e-12)
        ))
        ok = max_rel < tolerance
        failures += 0 if ok else 1
        rows.append({"name": name, "status": "PASS" if ok else "FAIL",
                     "max_rel": max_rel, "cosine": cos})
    for r in rows:
        tail = (f"max_rel {r['max_rel']:.2e} cos {r['cosine']:.6f}"
                if "max_rel" in r else r["detail"])
        print(f"{r['status']:4s} {r['name']:24s} {tail}")
    (out / "drift_report.json").write_text(json.dumps(
        {"tolerance": tolerance, "results": rows}, indent=1))
    return failures


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("snapshot")
    s.add_argument("out", type=Path)
    s.add_argument("--names", required=True,
                   help="comma-separated encoder names, or 'all'")
    s.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    c = sub.add_parser("compare")
    c.add_argument("out", type=Path)
    c.add_argument("--tolerance", type=float, default=1e-3)
    args = ap.parse_args(argv)
    if args.cmd == "snapshot":
        names = args.names.split(",")
        if names == ["all"]:
            from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES

            names = [e.name for e in ENTRIES.values() if e.implemented]
        return 1 if snapshot(args.out, names, args.device) else 0
    return 1 if compare(args.out, args.tolerance) else 0


if __name__ == "__main__":
    sys.exit(main())
