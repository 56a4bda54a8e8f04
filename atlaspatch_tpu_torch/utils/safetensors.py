"""The port's own ``.safetensors`` reader (no ``safetensors`` module needed).

The format (https://github.com/huggingface/safetensors, "Format"): a
little-endian u64 ``N``, then ``N`` bytes of JSON header mapping each tensor
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets relative
to the first byte after the header) plus an optional ``"__metadata__"`` dict
of strings, then the raw little-endian tensor bytes.

:func:`load_file` memory-maps the file copy-on-write and returns CPU tensors
that are views of the map (``torch.frombuffer``): nothing is read until it is
touched, and nothing is copied. It reads F64, F32, F16, BF16, I64, I32, I16,
I8, U8 and BOOL, and refuses a truncated file, an unknown dtype, offsets that
disagree with the shape, and tensors whose bytes overlap, naming the file
and the tensor.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
import sys
from pathlib import Path

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
# a header larger than this is not a checkpoint's (the upstream reader's cap)
MAX_HEADER_BYTES = 100_000_000


class SafetensorsError(ValueError):
    """A file that is not a readable ``.safetensors`` checkpoint."""


def read_header(path: str | Path) -> tuple[dict, dict, int]:
    """``(tensors, metadata, data_start)``: each tensor's header entry by name,
    the ``__metadata__`` dict (empty when absent) and the file offset of the
    data section. Checks the header and every entry against the file size."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError(f"{path.name}: truncated: {size} bytes, no header length")
        (n,) = struct.unpack("<Q", head)
        if n > min(size - 8, MAX_HEADER_BYTES):
            raise SafetensorsError(f"{path.name}: truncated: header of {n} bytes in a file of {size}")
        raw = f.read(n)
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path.name}: header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path.name}: header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    data_start = 8 + n
    data_len = size - data_start
    spans = []
    for name, entry in header.items():
        try:
            dtype, shape, (begin, end) = entry["dtype"], entry["shape"], entry["data_offsets"]
        except (TypeError, KeyError, ValueError) as e:
            raise SafetensorsError(f"{path.name}: tensor {name!r}: malformed entry {entry!r}") from e
        if dtype not in DTYPES:
            raise SafetensorsError(f"{path.name}: tensor {name!r}: unknown dtype {dtype!r}")
        if not all(isinstance(d, int) and d >= 0 for d in shape):
            raise SafetensorsError(f"{path.name}: tensor {name!r}: bad shape {shape!r}")
        nbytes = math.prod(shape) * DTYPES[dtype].itemsize
        if not (isinstance(begin, int) and isinstance(end, int) and 0 <= begin <= end):
            raise SafetensorsError(f"{path.name}: tensor {name!r}: bad data_offsets {[begin, end]}")
        if end - begin != nbytes:
            raise SafetensorsError(f"{path.name}: tensor {name!r}: data_offsets {[begin, end]} hold "
                                   f"{end - begin} bytes, its {dtype} shape {shape} needs {nbytes}")
        if end > data_len:
            raise SafetensorsError(f"{path.name}: truncated: tensor {name!r} ends at byte {end} of a "
                                   f"{data_len}-byte data section")
        spans.append((begin, end, name))
    reached, owner = 0, None
    for begin, end, name in sorted(spans):
        if end == begin:  # an empty tensor owns no bytes
            continue
        if begin < reached:
            raise SafetensorsError(f"{path.name}: tensors {owner!r} and {name!r} overlap")
        reached, owner = end, name
    return header, metadata, data_start


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of the file by name, as CPU views of a copy-on-write map
    of it, in the header's order."""
    if sys.byteorder != "little":  # the format is little-endian; so are the hosts the port runs on
        raise SafetensorsError("reading .safetensors needs a little-endian host")
    header, _, data_start = read_header(path)
    out: dict[str, torch.Tensor] = {}
    if not header:
        return out
    with open(path, "rb") as f:
        # ACCESS_COPY: writable views (torch.frombuffer needs one), pages shared
        # with the page cache until something writes to them
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, entry in header.items():
        dtype, shape = DTYPES[entry["dtype"]], entry["shape"]
        begin = entry["data_offsets"][0]
        count = math.prod(shape)
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(mm, dtype=dtype, count=count, offset=data_start + begin).reshape(shape)
    return out
