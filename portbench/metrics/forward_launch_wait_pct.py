"""ViT: the share of the ``embed_forward`` spans' wall that their dispatch
thread spent off the CPU (waiting for the interpreter lock or the scheduler),
100 × (wall − thread CPU) / wall, in %."""


def read(layer: dict):
    row = layer.get("stages", {}).get("embed_forward")
    return 100.0 * (row["total_s"] - row["cpu_s"]) / row["total_s"] if row and row["total_s"] else None
