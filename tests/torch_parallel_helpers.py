"""Shared by the port's mesh tests (``tests/test_torch_parallel*.py``): the
JAX mesh on the conftest's virtual CPU devices, the port's CPU "devices",
and the bar on packed mask bits."""

from __future__ import annotations

import numpy as np

NEAR = 1e-4
BF16_NEAR = 2.0**-5  # of the largest |logit|: four bfloat16 ulps (2^-7 relative spacing)
THRESHOLD = 0.0


def _jax_mesh(data: int, model_parallel: int = 1):
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices()[: data * model_parallel]).reshape(data, model_parallel)
    return Mesh(devices, axis_names=("data", "model"))


def _cpus(n: int) -> list:
    import torch

    return [torch.device("cpu")] * n


def _assert_bits(got, want, logits, what, near=NEAR):
    differ = got != want
    near = np.abs(logits - THRESHOLD) < near
    assert not (differ & ~near).any(), f"{what}: {int((differ & ~near).sum())} bits differ away from the threshold"
    assert 0 < got.mean() < 1, what
