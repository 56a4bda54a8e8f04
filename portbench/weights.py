"""Seeded random weights, made on the device in one draw.

The names and shapes come from the reference model, built on the meta device;
one ``torch.randn`` over all their elements, from a generator on the device
seeded with the run's seed, is cut into views, and each view is scaled in
place by the law its name asks for:

- a matrix or kernel (two or more dimensions): N(0, 1 / fan_in);
- a LayerNorm scale: 1 + N(0, 0.1);  a LayerScale: 0.5 + N(0, 0.1);
- the random-Fourier projection: N(0, 1);
- biases, tokens and positional embeddings: N(0, 0.02).

The same seed on the same device gives the same weights, so the reference
can make them again once the program's state is gone.
"""

from __future__ import annotations

import torch
from torch import nn

_UNIT = ("positional_embedding",)
_SMALL = ("bias", "cls_token", "reg_token", "pos_embed", "pos_embed_window", "no_memory_embedding")


def _law(name: str, shape: torch.Size) -> tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _UNIT:
        return 1.0, 0.0
    if leaf in ("ls1", "ls2"):
        return 0.1, 0.5
    if leaf in _SMALL:
        return 0.02, 0.0
    if len(shape) >= 2:
        return (shape.numel() // shape[0]) ** -0.5, 0.0
    return 0.1, 1.0  # LayerNorm scale


def state_dict(meta_model: nn.Module, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Every tensor of ``meta_model``'s state_dict, drawn on ``device`` in
    ``dtype`` (drawn in float32, cast in one call); tied tensors stay tied."""
    named: dict[int, tuple[str, torch.Size]] = {}
    keys: dict[str, int] = {}
    for name, t in meta_model.state_dict(keep_vars=True).items():
        keys[name] = id(t)
        named.setdefault(id(t), (name, t.shape))
    total = sum(shape.numel() for _, shape in named.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    spans, at = {}, 0
    for ident, (name, shape) in named.items():
        std, mean = _law(name, shape)
        view = flat[at : at + shape.numel()]
        view.mul_(std).add_(mean)
        spans[ident] = (at, shape)
        at += shape.numel()
    if dtype != torch.float32:
        flat = flat.to(dtype)
    return {name: flat[spans[i][0] : spans[i][0] + spans[i][1].numel()].view(spans[i][1])
            for name, i in keys.items()}
