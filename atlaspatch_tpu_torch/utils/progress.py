"""Thin progress-bar wrapper (tqdm when enabled, no-op otherwise)."""

from __future__ import annotations


class ProgressBar:
    def __init__(self, total: int, *, enabled: bool = True, desc: str = "") -> None:
        self._bar = None
        if enabled:
            try:
                from tqdm import tqdm

                self._bar = tqdm(total=total, desc=desc)
            except ImportError:
                self._bar = None

    def update(self, n: int = 1) -> None:
        if self._bar is not None:
            self._bar.update(n)

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()

    def __bool__(self) -> bool:  # allow `if progress:` guards
        return True
