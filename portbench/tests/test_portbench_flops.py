"""The benchmark's FLOP count: the reference ViT against its closed form."""

from __future__ import annotations

from portbench import harness
from portbench.reference import flops


def test_vit_count_is_the_closed_form():
    cfg = harness.config("virchow2")
    d, f, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    patches = (cfg["img_size"] // cfg["patch_size"]) ** 2
    tokens = patches + 1 + cfg["reg_tokens"]
    linear_macs = d * 3 * d + d * d + d * 2 * f + f * d  # 19.67M a token a block
    attention = 2 * 2 * tokens * tokens * d  # QK^T and PV
    embed = 2 * patches * d * 3 * cfg["patch_size"] ** 2
    want = 2 * linear_macs * tokens * layers + attention * layers + embed
    assert round(linear_macs / 1e6, 2) == 19.67
    assert flops.vit_flops_per_patch(cfg) == want
    assert round(want / 1e9, 1) == 340.1
