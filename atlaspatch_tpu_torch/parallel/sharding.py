"""Tensor-parallel sharding of the unified ViT encoders over a mesh's 'model' axis.

The port of ``atlaspatch_tpu/parallel/sharding.py``. The plan is the JAX
package's rule (``_spec_for_path``) read on the Flax key of every parameter
of a port ViT (``vit_flax_key_map``), as a PartitionSpec-like tuple in the
Flax layout:

  qkv, fc1, fc_gate, fc_up  kernel (None, "model"), bias ("model",): column-parallel
  attn proj, fc2            kernel ("model", None), bias (): row-parallel
  everything else           (): replicated

The JAX package hands the plan to XLA, which shards the fused (D, 3D) qkv
kernel's columns contiguously (no whole heads per shard) and inserts the
collectives that fix it. ``shard_vit`` instead splits the same axes by head
and by hidden unit: shard i holds the q, k and v columns of heads
[i·H/N, (i+1)·H/N), the matching input columns of ``proj``, and the hidden
units [i·F/N, (i+1)·F/N) of the MLP (of each SwiGLU half), so each shard
computes whole heads, and a ``RowParallel`` sums the partials on the data
row's first device in shard order and adds the bias once. Activations stay
batch-split over 'data' (``models/encoders/engine.py``).

The int8 serving mode's linears split the same way: ``weight_q`` and
``qscale`` of the column-parallel ones by head column or hidden unit,
``weight_q`` of ``proj`` and ``fc2`` by input column, their ``qscale`` whole
on every shard (the plan replicates it); each shard's ``weight_q`` lies at a
16-byte row pitch on its device (``pitch_int8_weights``), so that a shard's
product runs on the wgmma body whatever its K. Their ``RowParallel`` takes the
row scale across the shards and sums int32 partials before one
dequantization, as the JAX program does (``models/encoders/vit.py``).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from atlaspatch_tpu_torch.models.encoders.vit import Attention, Int8Linear, Mlp, RowParallel, ViT, pitch_int8_weights

_COL_PARALLEL = ("qkv", "fc1", "fc_gate", "fc_up")
COLUMN, ROW = (None, "model"), ("model", None)


def _spec_for_key(flax_key: str) -> tuple:
    """The JAX ``_spec_for_path`` on a '/'-joined Flax key."""
    names = flax_key.split("/")
    leaf = names[-1]
    owner = names[-2] if len(names) >= 2 else ""
    if owner in _COL_PARALLEL:
        if leaf in ("kernel", "kernel_q"):
            return COLUMN
        if leaf in ("bias", "qscale"):
            return ("model",)
    if owner == "fc2" or (owner == "proj" and "attn" in flax_key):
        if leaf in ("kernel", "kernel_q"):
            return ROW
        return ()  # row-parallel bias/qscale apply to the un-sharded output dim
    return ()


def vit_flax_key_map(model: ViT) -> dict[str, str]:
    """{state-dict key of ``model``: the '/'-joined key of its Flax
    parameter}, the inverse of ``flax_tree_to_torch``'s names: ``blocks.{i}``
    → ``blocks_{i}``; a Linear or Conv ``weight`` → ``kernel``, a LayerNorm's
    → ``scale``; ``weight_q`` → ``kernel_q``."""
    out = {}
    for key in model.state_dict():
        prefix, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        module = model.get_submodule(prefix)
        if leaf == "weight":
            leaf = "scale" if isinstance(module, nn.LayerNorm) else "kernel"
        elif leaf == "weight_q" and isinstance(module, Int8Linear):
            leaf = "kernel_q"
        parts = prefix.split(".") if prefix else []
        names, i = [], 0
        while i < len(parts):
            if parts[i] == "blocks" and i + 1 < len(parts) and parts[i + 1].isdigit():
                names.append(f"blocks_{parts[i + 1]}")
                i += 2
            else:
                names.append(parts[i])
                i += 1
        out[key] = "/".join(names + [leaf])
    return out


def vit_tp_plan(model: ViT) -> dict[str, tuple]:
    """{Flax key: PartitionSpec-like tuple} of every parameter of ``model``,
    as the JAX ``vit_tp_shardings`` gives its Flax counterpart."""
    return {flax: _spec_for_key(flax) for flax in vit_flax_key_map(model).values()}


def _check_divides(model: ViT, n: int) -> None:
    spec = model.spec
    if spec.heads % n or spec.hidden_dim % n:
        raise ValueError(
            f"a 'model' axis of {n} must divide the heads ({spec.heads}) and the MLP hidden width "
            f"({spec.hidden_dim}) of this ViT"
        )


def _row_parallel_owners(model: ViT) -> list[str]:
    """The modules whose row-parallel linear the plan names (an attention's
    ``proj``, an MLP's ``fc2``), each checked to take its input from
    column-parallel linears."""
    keys = vit_flax_key_map(model)
    plan = vit_tp_plan(model)
    owners = []
    kernels = (".weight", ".weight_q")  # a float or an int8 linear's
    for key, flax in keys.items():
        if key.endswith(kernels) and plan[flax] == ROW:
            owner = key.rsplit(".", 2)[0]
            module = model.get_submodule(owner)
            column = [k for k in keys if k.startswith(owner + ".") and k.endswith(kernels)
                      and k.split(".")[-2] in _COL_PARALLEL]
            if not isinstance(module, (Attention, Mlp)) or any(plan[keys[k]] != COLUMN for k in column):
                raise ValueError(f"{owner}: no column-parallel input for its row-parallel layer")
            owners.append(owner)
    return owners


def _slice(sd: dict, columns: tuple[str, ...], outputs: torch.Tensor, row: str, inputs: torch.Tensor) -> dict:
    """A shard's part of a state_dict: each column-parallel linear's weight
    (or int8 ``weight_q``), ``qscale`` and bias at ``outputs``; the
    row-parallel linear's weight at input columns ``inputs``, its int8
    ``qscale`` whole, its bias left to ``RowParallel``."""
    part = {}
    for key, t in sd.items():
        owner, leaf = key.rsplit(".", 1)
        if owner in columns:
            part[key] = t[outputs.to(t.device)]
        elif owner == row and leaf in ("weight", "weight_q"):
            part[key] = t[:, inputs.to(t.device)]
        elif owner == row and leaf == "qscale":
            part[key] = t.clone()
    return part


def _attention_shard(module: Attention, i: int, n: int) -> tuple[Attention, dict]:
    spec = module.spec
    heads = slice(i * spec.heads // n, (i + 1) * spec.heads // n)
    hd = spec.dim // spec.heads
    cols = torch.arange(3 * spec.dim).reshape(3, spec.heads, hd)[:, heads].reshape(-1)
    ins = torch.arange(spec.dim).reshape(spec.heads, hd)[heads].reshape(-1)
    part = _slice(module.state_dict(), ("qkv",), cols, "proj", ins)
    shard = Attention(spec, shards=n)
    for name, buf in module.named_buffers(recurse=False):  # the RoPE tables, as cast
        setattr(shard, name, buf.clone())
    return shard, part


def _mlp_shard(module: Mlp, i: int, n: int) -> tuple[Mlp, dict]:
    spec = module.spec
    hidden = spec.hidden_dim
    units = torch.arange(hidden)[i * hidden // n : (i + 1) * hidden // n]
    names = ("fc_gate", "fc_up") if spec.gated_mlp else ("fc1",)
    rows = torch.cat([units, units + hidden]) if spec.swiglu and not spec.gated_mlp else units
    return Mlp(spec, shards=n), _slice(module.state_dict(), names, rows, "fc2", units)


def _shard(module: Attention | Mlp, devices: list[torch.device]) -> RowParallel:
    n = len(devices)
    shards = []
    for i, device in enumerate(devices):
        shard, part = (_attention_shard if isinstance(module, Attention) else _mlp_shard)(module, i, n)
        shard.load_state_dict({k: v.contiguous() for k, v in part.items()}, strict=True, assign=True)
        # each int8 weight at a 16-byte row pitch on its device: a slice of K 1,708 starting at byte
        # 1,708 of a row (virchow's fc2, shard 1) becomes a pitched copy of its own
        shards.append(pitch_int8_weights(shard.eval().requires_grad_(False).to(device)))
    bias = module.proj.bias if isinstance(module, Attention) else module.fc2.bias
    return RowParallel(shards, bias)


def shard_vit(model: ViT, mesh) -> list[ViT]:
    """One tensor-parallel replica of ``model`` per data row of ``mesh``:
    every module the plan makes row-parallel (the blocks' attention and
    MLP, a MAP head's MLP) becomes a ``RowParallel`` over the row's 'model'
    devices; the rest (embeddings, norms, heads) lies on the row's first
    device. ``model`` itself is left as it is. In the int8 serving mode a
    float MLP (the MAP head's, which stays float) stays whole on the row's
    first device too: a float row-parallel sums float partials, which one
    device's product does not, and tensor-parallel int8 computes one
    device's result bit for bit."""
    n = mesh.shape["model"]
    _check_divides(model, n)
    owners = [owner for owner in _row_parallel_owners(model)
              if model.get_submodule(owner).spec.quant_int8 == model.spec.quant_int8]
    replicas = []
    for row in mesh.grid:
        replica = copy.deepcopy(model)
        for owner in owners:  # placeholders, so moving the replica leaves the shards where they lie
            parent, _, attr = owner.rpartition(".")
            setattr(replica.get_submodule(parent), attr, nn.Identity())
        replica.to(row[0])
        for owner in owners:
            parent, _, attr = owner.rpartition(".")
            setattr(replica.get_submodule(parent), attr, _shard(model.get_submodule(owner), row))
        replicas.append(replica)
    return replicas
