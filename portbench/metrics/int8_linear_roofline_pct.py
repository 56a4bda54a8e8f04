"""int8 kernels: the least time the block linears of the forwards in the
profiled slice could take, over the device time of ``int8_linear_s8``, in %.

A forward of B images runs, per block, four products of M = B·T rows
(T = patches + class + register tokens): qkv (3·dim × dim), proj (dim × dim),
fc1 (2·hidden × dim) and fc2 (dim × hidden). Each is bound by the larger of
2·M·N·K operations at 1,979 TOP/s and its bytes at 3.35 TB/s: xq (M·K int8),
the weight (N·K int8), the scales (4·(M + N)) and the bfloat16 output (2·M·N).
"""

from portbench.harness import HBM_BYTES_PER_S, PEAK_FLOPS

PATTERNS = ("int8_linear_s8",)


def products(cfg: dict, rows: int) -> list[tuple[int, int, int]]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return [(rows, 3 * d, d), (rows, d, d), (rows, 2 * f, d), (rows, d, f)] * cfg["num_hidden_layers"]


def bound_s(cfg: dict, batch: int) -> float:
    tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1 + cfg["reg_tokens"]
    total = 0.0
    for m, n, k in products(cfg, batch * tokens):
        nbytes = m * k + n * k + 4 * (m + n) + 2 * m * n
        total += max(2.0 * m * n * k / PEAK_FLOPS["int8"], nbytes / HBM_BYTES_PER_S)
    return total


def read(layer: dict):
    if layer.get("precision") != "int8":
        return None
    sl = layer["slice"]
    seconds = sum(v for n, v in sl["by_name"].items() if any(p in n for p in PATTERNS))
    batches = {int(k[6:]): v for k, v in layer["counts"].items() if k.startswith("batch:")}
    if not seconds or not batches:
        return None
    return 100.0 * sum(n * bound_s(layer["config"], b) for b, n in batches.items()) / seconds
