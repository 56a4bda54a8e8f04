"""Build the port's native libraries from ``csrc/`` at first use.

Each library is a shared object with a plain C interface, loaded with
``ctypes``: the contour tracer and the slide decoder (``g++``) and the
attention kernel (``nvcc`` for ``sm_90a``). Outputs go to ``_build/`` beside
this file, named by a hash of the sources, the headers they include from
``csrc/`` and the command line, so an edited source never loads a stale
library. A build writes a temporary file and
renames it into place, so concurrent processes never load a half-written
object. The compiler's output (``nvcc -Xptxas -v`` register and spill counts)
is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def build_shared_library(
    name: str,
    sources: list[Path],
    command: list[str],
    link: list[str] = (),
    headers: list[Path] = (),
) -> Path:
    """Compile ``sources`` with ``command + [-o out, *sources, *link]``; return
    the .so. ``link`` (libraries) follows the sources, as ``ld --as-needed``
    requires. ``headers`` are the files the sources include from ``csrc/``;
    they are hashed into the name with the sources.

    Raises RuntimeError with the compiler's output when the build fails."""
    digest = hashlib.sha256()
    for part in (*command, *link):
        digest.update(part.encode())
    for src in (*sources, *headers):
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [*command, "-o", str(tmp), *[str(s) for s in sources], *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed (rc {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def build_log(library: Path) -> str:
    """The compiler output kept beside a built library."""
    log = library.with_suffix(".log")
    return log.read_text() if log.exists() else ""
