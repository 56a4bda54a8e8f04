"""Seeded upstream-layout checkpoints for the PyTorch port's zoo towers.

``tests/upstream_layouts.py`` gives an encoder's exact upstream key layout
(timm / transformers / open_clip / torchscale / CHIEF naming) and shapes, as
zeros, from a Flax param tree. This module feeds it the Flax tree of the
port's own tower (its ``state_dict`` shapes, read on the meta device and
renamed back by the inverse of ``vit.flax_tree_to_torch``) and writes seeded
values into every tensor, so the dict is a checkpoint a tower can run on:

  * kernels (``*.weight`` / ``*_weight`` of 2 or more dims) N(0, 1/fan_in);
  * LayerNorm and BatchNorm scales 1 + N(0, 0.05), BatchNorm scales further
    ×0.25 (deep random residual stacks otherwise grow activations to ~1e6);
  * BatchNorm variances 1 + |N(0, 0.05)|;
  * everything else (biases, tokens, tables, positional embeddings, layer
    scales, BatchNorm means) N(0, 0.05).

numpy only (and torch for the meta-device shapes): ``chip_smoke.py`` uses it
on the card's host, where JAX is absent.
"""

from __future__ import annotations

import numpy as np

from upstream_layouts import synth_state_dict  # tests/ is on the path (pytest, chip_smoke.py)

BN_SCALE = 0.25


def flax_shape_tree(state_shapes: dict) -> dict:
    """A port ``state_dict``'s shapes ({key: shape}) → the Flax param tree of
    zeros arrays that ``vit.flax_tree_to_torch`` maps onto it (zeros are not
    allocated until written: the tree costs no memory)."""
    leaf_names = {"running_mean": "mean", "running_var": "var"}
    tree: dict = {}
    for key, shape in state_shapes.items():
        parts = key.split(".")
        path, leaf = [], parts[-1]
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "blocks" and parts[i + 1].isdigit():
                path.append(f"blocks_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        shape = tuple(shape)
        if leaf == "weight" and len(shape) == 4:
            leaf, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
        elif leaf == "weight" and len(shape) == 2:
            leaf, shape = "kernel", shape[::-1]
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf_names.get(leaf, leaf)] = np.zeros(shape, np.float32)
    return tree


def fill(sd: dict, seed: int) -> dict:
    """Seeded values for every tensor of an upstream-layout dict of zeros,
    by the rules of the module docstring; keys in sorted order."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(sd):
        shape = sd[key].shape
        base = key.rsplit(".", 1)[0]
        if key.endswith(("weight", "_weight")) and len(shape) >= 2:
            value = rng.standard_normal(shape, dtype=np.float32) * np.float32(np.prod(shape[1:]) ** -0.5)
        elif key.endswith("running_var"):
            value = 1.0 + np.abs(rng.normal(0.0, 0.05, shape))
        elif key.endswith(".weight"):
            value = 1.0 + rng.normal(0.0, 0.05, shape)
            if f"{base}.running_var" in sd:
                value *= BN_SCALE
        else:
            value = rng.normal(0.0, 0.05, shape)
        out[key] = np.asarray(value, np.float32)
    return out


def upstream_checkpoint(entry, state_shapes: dict, seed: int) -> dict:
    """The upstream-layout checkpoint of ``entry`` (its family's naming, the
    port tower's shapes ``state_shapes``), with seeded values."""
    return fill(synth_state_dict(entry, flax_shape_tree(state_shapes)), seed)
