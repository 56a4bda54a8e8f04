"""The benchmark's FLOP counts, taken over the reference models.

``torch.utils.flop_counter.FlopCounterMode`` counts 2 per multiply-add of
every matrix product, convolution and attention product, on the meta device
at the cell's shapes, so the count is of the work a forward needs, whatever
program runs it. Elementwise work is not counted.
"""

from __future__ import annotations

from functools import lru_cache

import torch
from torch.utils.flop_counter import FlopCounterMode


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def vit_flops_per_patch(cfg: dict) -> float:
    """One forward of the configuration's ViT on one image."""
    return _vit(tuple(sorted((k, v) for k, v in cfg.items() if not isinstance(v, (dict, list)))))


@lru_cache(maxsize=8)
def _vit(items: tuple) -> float:
    from portbench.reference import vit

    cfg = dict(items)
    with torch.device("meta"):
        model = vit.ViT(cfg).eval()
    images = torch.zeros((1, cfg["img_size"], cfg["img_size"], 3), device="meta")
    with torch.inference_mode():
        return float(_count(lambda: model(images)))
