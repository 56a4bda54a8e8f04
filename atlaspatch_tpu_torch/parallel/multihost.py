"""Multi-host coordination.

The workload is embarrassingly parallel at slide granularity, so the
distribution model is: (1) static round-robin sharding of the slide list per
host — each host's reads stay host-local and feed its own cards, with no
cross-host tensor traffic; (2) the reference's shared-FS lock-file/idempotent-
resume protocol (reference: atlas_patch/orchestration/runner.py:154-181) kept
as-is for elasticity, so extra or restarted hosts self-shard safely.

A ``torch.distributed`` process group (the counterpart of the JAX package's
``jax.distributed``) is initialized only when torchrun's variables ask for
one (``WORLD_SIZE`` > 1 with ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``). The backend follows from the setting: ``nccl`` when each
local rank owns a card of its own (``LOCAL_WORLD_SIZE`` ≤ the visible
cards; the rank's card becomes the current device), ``gloo`` when the ranks
run on the CPU or share a card, which NCCL refuses.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence, TypeVar

import torch
import torch.distributed as dist

logger = logging.getLogger("atlaspatch_tpu_torch.multihost")

T = TypeVar("T")

ENV_NUM_HOSTS = "ATLASPATCH_NUM_HOSTS"
ENV_HOST_ID = "ATLASPATCH_HOST_ID"
GROUP_VARS = ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def choose_backend(local_world: int, device: str = "cuda") -> str:
    """``nccl`` when the ranks run on cards and each local rank owns one;
    ``gloo`` on the CPU or when ranks share a card."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def maybe_init_distributed(device: str = "cuda") -> bool:
    """Initialize the default process group when ``WORLD_SIZE`` > 1, from
    torchrun's variables; returns whether this call initialized it. A
    no-op otherwise, or when a group is already live. ``device`` is the
    command's device, which picks the backend (``choose_backend``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or (dist.is_available() and dist.is_initialized()):
        return False
    missing = [v for v in GROUP_VARS if not os.environ.get(v)]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} asks for a process group, but {', '.join(missing)} unset")
    rank, local_rank = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(local_world, device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=world,
        rank=rank,
    )
    logger.info(
        "torch.distributed initialized: rank %d/%d (local rank %d of %d), backend %s",
        rank, world, local_rank, local_world, backend,
    )
    return True


def shutdown_distributed() -> None:
    """Destroy the default process group, if one is live."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def live_group() -> tuple[int, int] | None:
    """(rank, world_size) of a live default group of more than one rank."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return None


def owned_card() -> int | None:
    """The card this rank owns (its LOCAL_RANK) under a live ``nccl`` group,
    else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
    return None


def collective_device() -> torch.device:
    """Where a tensor handed to a collective of the default group lives: the
    current card under ``nccl``, the CPU under ``gloo``."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str) -> None:
    """Wait for every rank of a live group; a no-op without one."""
    if live_group() is not None:
        logger.debug("barrier %s", name)
        dist.barrier()


def host_identity() -> tuple[int, int]:
    """(host_id, num_hosts) from env overrides, a live process group, or
    (0, 1)."""
    num = os.environ.get(ENV_NUM_HOSTS)
    if num is not None:
        return int(os.environ.get(ENV_HOST_ID, "0")), max(1, int(num))
    group = live_group()
    if group is not None:
        return group
    return 0, 1


def host_shard(items: Sequence[T], *, steal: bool = False) -> list[T]:
    """This host's work list: its round-robin shard, then (with ``steal``)
    every other host's items appended after.

    With stealing a fast host drains its own shard and then races the
    stragglers' slides through the shared-FS lock + skip-existing protocol —
    the reference's N-jobs-race-on-locks elasticity with less lock contention
    on the common path. Callers must only enable it when skip-existing
    semantics are on, otherwise finished slides would be reprocessed.
    Disable explicitly with ATLASPATCH_HOST_STEAL=0.
    """
    host_id, num_hosts = host_identity()
    if num_hosts <= 1:
        return list(items)
    mine = [x for i, x in enumerate(items) if i % num_hosts == host_id]
    if steal and os.environ.get("ATLASPATCH_HOST_STEAL", "1") != "0":
        others = [x for i, x in enumerate(items) if i % num_hosts != host_id]
        logger.info(
            "Host %d/%d takes %d of %d slides (+%d stealable)",
            host_id, num_hosts, len(mine), len(items), len(others),
        )
        return mine + others
    logger.info("Host %d/%d takes %d of %d slides", host_id, num_hosts, len(mine), len(items))
    return mine
