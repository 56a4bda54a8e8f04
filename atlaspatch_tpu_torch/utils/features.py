"""Extractor-list parsing and H5 feature-completeness probes.

Same skip/resume semantics as the reference (atlas_patch/utils/features.py:
10-71): a ``features/<name>`` dataset only counts as done when its row count
equals the slide's expected patch total, so interrupted embeddings are
regenerated instead of silently kept partial. All validation errors are plain
``ValueError`` — the CLI layer maps them to user-facing messages. Files are
read by the port's own reader (utils/h5.py); a file it cannot read (missing,
or written by another HDF5 writer) counts as holding no feature.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

from atlaspatch_tpu_torch.utils.h5 import read_h5_tree


def parse_feature_list(raw: str, *, choices: list[str]) -> list[str]:
    """Split a comma/space separated extractor list; validate against ``choices``.

    Rejects empty input, unknown names, and repeated names (each with a
    message naming the offenders). Matching is case-insensitive; the returned
    names keep each choice's registered casing, in first-seen order.
    """
    names = [tok.lower() for tok in raw.replace(",", " ").split()]
    if not names:
        raise ValueError("At least one feature extractor name is required.")

    known = {c.lower(): c for c in choices}
    if unknown := [n for n in names if n not in known]:
        raise ValueError(
            f"Unknown extractor(s): {', '.join(unknown)}. Available: {', '.join(choices)}"
        )
    if dupes := sorted({n for i, n in enumerate(names) if n in names[:i]}):
        raise ValueError(
            f"Duplicate extractor(s) specified: {', '.join(dupes)}. "
            "Provide each extractor at most once."
        )
    return [known[n] for n in names]


def get_existing_features(
    h5_path: str | Path, *, expected_total: int | None = None
) -> set[str]:
    """Lowercased names under ``features/`` — restricted to complete datasets
    (row count == ``expected_total``) when a total is given.

    A missing or unreadable file yields the empty set: callers treat that as
    "nothing done yet" and regenerate.
    """
    try:
        datasets = read_h5_tree(Path(h5_path), data=False).datasets
    except Exception:  # noqa: BLE001 — any unreadable file counts as empty
        return set()
    return {
        path.split("/", 1)[1].lower()
        for path, arr in datasets.items()
        if path.startswith("features/")
        and (expected_total is None or (arr.ndim and int(arr.shape[0]) == int(expected_total)))
    }


def missing_features(
    h5_path: str | Path,
    required: Sequence[str] | Iterable[str],
    *,
    expected_total: int | None = None,
) -> list[str]:
    """Required names (lowercased, order kept) not yet complete in the H5."""
    done = get_existing_features(h5_path, expected_total=expected_total)
    return [name for name in map(str.lower, required) if name not in done]
