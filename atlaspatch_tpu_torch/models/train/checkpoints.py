"""Training checkpoint save/restore for SAM2 fine-tuning.

The port of ``atlaspatch_tpu/models/train/checkpoints.py``, with one format:
the JAX package's atomic ``step_XXXXXXXX.npz`` (written to
``step_XXXXXXXX.npz.tmp.npz``, then published by ``os.replace``, so a reader
only ever sees a whole checkpoint). Each file holds

- ``params/<key>``: every parameter, under the '/'-joined key of the JAX
  parameter tree and in its layout (``convert.torch_to_flax_flat``);
- ``exp_avg/<key>`` and ``exp_avg_sq/<key>``: AdamW's moments of the tensors
  the optimizer holds, by the same keys and in the same layout;
- ``step``: the number of updates applied.

The JAX package's single-process checkpoints are orbax step directories,
which the port does not read (no orbax here): ``restore_checkpoint`` refuses
them, and the JAX package's multi-host ``.npz`` files, by name.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from atlaspatch_tpu_torch.models.sam2.convert import (
    flax_to_torch,
    from_flax_layout,
    load_into,
    to_flax_layout,
    torch_to_flax_flat,
    unflatten,
)
from atlaspatch_tpu_torch.models.train.finetune import update_count

MOMENTS = ("exp_avg", "exp_avg_sq")


def _npz_path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir).resolve() / f"step_{step:08d}.npz"


def save_checkpoint(ckpt_dir: str | Path, step: int, model, optimizer, params: dict) -> Path:
    """Write ``model``'s parameters and ``optimizer``'s AdamW state for
    ``params`` ({Flax key: tensor}, as ``trainable_parameters`` gives them)
    at ``step``; returns the file."""
    path = _npz_path(ckpt_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"params/{k}": v for k, v in torch_to_flax_flat(model, model.cfg).items()}
    for name in MOMENTS:
        moments = {k: optimizer.state[t][name] for k, t in params.items() if optimizer.state.get(t)}
        arrays.update({f"{name}/{k}": v for k, v in to_flax_layout(model, moments).items()})
    arrays["step"] = np.asarray(update_count(optimizer), np.int64)
    tmp = path.with_name(path.name + ".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # readers only ever see a complete checkpoint
    return path


def _step_of(p: Path) -> int | None:
    name = p.name
    if name.endswith(".tmp.npz"):
        return None
    if name.endswith(".npz"):
        name = name[: -len(".npz")]
    elif not p.is_dir():
        return None
    tail = name.split("_", 1)[1] if "_" in name else ""
    return int(tail) if tail.isdigit() else None


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = sorted(s for p in Path(ckpt_dir).glob("step_*") if (s := _step_of(p)) is not None)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str | Path, step: int | None, model, optimizer, params: dict) -> int:
    """Load the checkpoint of ``step`` (the latest when None) into ``model``
    (in place) and ``optimizer`` (its AdamW state for ``params``, the same
    {Flax key: tensor} that was saved); returns the step."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    npz = _npz_path(ckpt_dir, step)
    if not npz.exists():
        if npz.with_suffix("").is_dir():
            raise ValueError(
                f"{npz.with_suffix('')} is an orbax checkpoint directory (the JAX package's "
                "single-process format); orbax is not available to atlaspatch_tpu_torch, which "
                f"reads only its own {npz.name} files"
            )
        raise FileNotFoundError(f"no checkpoint {npz}")
    with np.load(npz) as data:
        if "step" not in data.files:
            raise ValueError(
                f"{npz} is not an atlaspatch_tpu_torch checkpoint (no 'step' array; the JAX "
                "package's multi-host checkpoints are not read)"
            )
        flat = {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith("params/")}
        moments = {name: {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith(f"{name}/")}
                   for name in MOMENTS}
        saved_step = int(data["step"])
    load_into(model, flax_to_torch(unflatten(flat), model.cfg))
    state = {name: from_flax_layout(model, moments[name]) for name in MOMENTS}
    index = {id(t): i for i, t in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    restored = {
        index[id(t)]: {
            "step": torch.tensor(float(saved_step), dtype=torch.float32),
            **{name: state[name][k] for name in MOMENTS},
        }
        for k, t in params.items()
        if k in state["exp_avg"]
    }
    sd = optimizer.state_dict()
    sd["state"] = restored
    optimizer.load_state_dict(sd)
    return step
