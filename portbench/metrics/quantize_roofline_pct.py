"""int8 kernels: the least time the quantizers of the forwards in the
profiled slice could take, over the device time of ``quantize_rows_s8`` and
its streamed bodies, in %.

A forward of M = B·T rows quantizes, per block: the LayerNorm's output before
qkv and before fc1 (each reads M·dim bfloat16, writes M·dim int8 and M
float32 scales), the SwiGLU's output before fc2 (reads M·2·hidden bfloat16,
writes M·hidden int8 and M scales) and the attention's output before proj
(reads M·dim, writes M·dim and M scales): bytes at 3.35 TB/s.
"""

from portbench.harness import HBM_BYTES_PER_S

PATTERNS = ("quantize_rows_s8", "quantize_stream_")


def bytes_per_forward(cfg: dict, batch: int) -> float:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    m = batch * ((cfg["img_size"] // cfg["patch_size"]) ** 2 + 1 + cfg["reg_tokens"])
    per_block = 3 * (m * d * 2 + m * d + 4 * m) + (m * 2 * f * 2 + m * f + 4 * m)
    return float(per_block * cfg["num_hidden_layers"])


def read(layer: dict):
    if layer.get("precision") != "int8":
        return None
    sl = layer["slice"]
    seconds = sum(v for n, v in sl["by_name"].items() if any(p in n for p in PATTERNS))
    batches = {int(k[6:]): v for k, v in layer["counts"].items() if k.startswith("batch:")}
    if not seconds or not batches:
        return None
    return 100.0 * sum(n * bytes_per_forward(layer["config"], b) for b, n in batches.items()) / HBM_BYTES_PER_S / seconds
