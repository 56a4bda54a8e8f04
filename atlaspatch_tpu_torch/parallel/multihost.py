"""Multi-host coordination.

The workload is embarrassingly parallel at slide granularity, so the
distribution model is: (1) static round-robin sharding of the slide list per
host — each host's reads stay host-local and feed its own cards, with no
cross-host tensor traffic; (2) the reference's shared-FS lock-file/idempotent-
resume protocol (reference: atlas_patch/orchestration/runner.py:154-181) kept
as-is for elasticity, so extra or restarted hosts self-shard safely.

Host identity comes from ``ATLASPATCH_NUM_HOSTS`` / ``ATLASPATCH_HOST_ID``
only. The JAX package also reads a live ``jax.distributed`` setup; its
``torch.distributed`` counterpart is not ported yet, so a multi-process group
without those variables reads as one host.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence, TypeVar

logger = logging.getLogger("atlaspatch_tpu_torch.multihost")

T = TypeVar("T")

ENV_NUM_HOSTS = "ATLASPATCH_NUM_HOSTS"
ENV_HOST_ID = "ATLASPATCH_HOST_ID"


def host_identity() -> tuple[int, int]:
    """(host_id, num_hosts) from the environment, or (0, 1)."""
    num = os.environ.get(ENV_NUM_HOSTS)
    if num is not None:
        return int(os.environ.get(ENV_HOST_ID, "0")), max(1, int(num))
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
