"""ViT: device-busy ms in the profiled slice per 32 rows forwarded in it (a
batch-32 forward's worth; padded rows count, as the card computes them)."""


def read(layer: dict):
    rows = layer.get("counts", {}).get("rows", 0)
    if "flops_per_patch" not in layer or not rows:
        return None
    return layer["slice"]["busy_s"] * 1e3 / (rows / 32.0)
