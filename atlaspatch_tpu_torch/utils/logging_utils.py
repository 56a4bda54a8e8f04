"""Logging configuration (reference: atlas_patch/utils/logging_utils.py:6-40)."""

from __future__ import annotations

import logging

_NOISY_SUBSTRINGS = (
    "Computing image embeddings for the provided images",
    "Image embeddings computed",
)


class NoiseFilter(logging.Filter):
    """Drop known-noisy info messages from inference internals."""

    def filter(self, record: logging.LogRecord) -> bool:  # type: ignore[override]
        msg = record.getMessage()
        return not any(s in msg for s in _NOISY_SUBSTRINGS)


def install_noise_filter() -> None:
    logging.getLogger().addFilter(NoiseFilter())


def configure_logging(verbose: bool) -> None:
    """-v drops ONLY the atlaspatch loggers to DEBUG. Third-party loggers
    (torch's and PIL's are chatty at DEBUG) stay at the
    root's default so pipeline debug lines remain readable."""
    root = logging.getLogger()
    target = logging.getLogger("atlaspatch_tpu_torch")
    level = logging.DEBUG if verbose else logging.WARNING

    root.setLevel(logging.INFO if verbose else level)
    target.setLevel(level)

    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | %(message)s")
        )
        root.addHandler(handler)

    for handler in root.handlers:
        handler.setLevel(level)
