"""Local device mesh + sharding helpers, one process driving its devices.

The port of ``atlaspatch_tpu/parallel/mesh.py``. A :class:`LocalMesh` is a
('data', 'model') grid of torch devices. Segmentation, embedding and
fine-tuning split a batch contiguously over 'data' (as ``P("data")`` does):
each data row holds one replica of the model (or, with tensor parallelism,
one group of shards over its 'model' devices), runs its rows, and the
outputs are gathered in row order. Data parallelism needs no collective;
tensor parallelism sums its row-parallel partials by explicit
device-to-device copies, in a fixed shard order (``parallel/sharding.py``).

``local_devices`` is the one place that lists this process's devices; an
explicit device list may name a device more than once (meshes of repeated
``cpu`` devices on the CPU, of one card named twice on a one-card machine).
"""

from __future__ import annotations

import copy
from typing import Any, Sequence

import torch
from torch import nn

class LocalMesh:
    """A (data, model) grid of torch devices."""

    def __init__(self, grid: Sequence[Sequence[torch.device | str]]):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a mesh needs a non-empty rectangular grid of devices, got {grid!r}")
        self.grid: list[list[torch.device]] = rows

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def devices(self) -> list[torch.device]:
        """Every device in device order (data-major)."""
        return [d for row in self.grid for d in row]

    @property
    def data_devices(self) -> list[torch.device]:
        """The first device of each data row: where its replica's inputs and
        outputs live."""
        return [row[0] for row in self.grid]

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape}, {[str(d) for d in self.devices]})"


def local_devices(kind: str = "cuda") -> list[torch.device]:
    """This process's devices of ``kind`` ("cuda" or "cpu"): every visible
    card, or the one card this rank owns when a process group gives each
    local rank a card of its own (``multihost.owned_card``); one ``cpu``
    for the CPU. Tests patch this function to build larger meshes."""
    if torch.device(kind).type != "cuda":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return []
    from atlaspatch_tpu_torch.parallel.multihost import owned_card

    card = owned_card()
    if card is not None:
        return [torch.device("cuda", card)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def embedding_mesh(model_parallel: int = 1, devices: Sequence | None = None) -> LocalMesh:
    """Mesh over ``devices`` (default: ``local_devices()``) with
    ``model_parallel`` devices per data row."""
    devs = list(devices) if devices is not None else local_devices()
    if model_parallel < 1 or len(devs) % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} must divide device count {len(devs)}")
    return LocalMesh([devs[i : i + model_parallel] for i in range(0, len(devs), model_parallel)])


def split_rows(n: int, parts: int) -> list[slice]:
    """Contiguous row slices of an ``n``-row batch over ``parts`` equal parts
    (``n`` must divide)."""
    if n % parts:
        raise ValueError(f"batch of {n} rows does not divide over {parts} data devices")
    per = n // parts
    return [slice(i * per, (i + 1) * per) for i in range(parts)]


def shard_batch(mesh: LocalMesh, batch: Any) -> list[torch.Tensor]:
    """A host (numpy, or pinned torch) or device batch split contiguously
    over the mesh's data axis: one tensor per data row, on the row's first
    device, where its replica (or its tensor-parallel group) takes its
    input; these are ``P("data")``'s addressable shards, which repeat the
    row's rows on each of its 'model' devices. Copies from pinned memory
    are asynchronous."""
    t = torch.as_tensor(batch)
    rows = split_rows(t.shape[0], mesh.shape["data"])
    return [t[r].to(d, non_blocking=True) for r, d in zip(rows, mesh.data_devices)]


def replicate(mesh: LocalMesh, model: nn.Module) -> list[nn.Module]:
    """One replica of ``model`` per data row, on the row's first device, in
    row order: ``model`` itself is the first when it lies on the first data
    device already, the rest are copies (a device named twice gets two)."""
    first = next(model.parameters()).device
    return [model if i == 0 and first == d else copy.deepcopy(model).to(d)
            for i, d in enumerate(mesh.data_devices)]


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device | str) -> torch.Tensor:
    """Per-replica outputs concatenated in data order on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=0)

