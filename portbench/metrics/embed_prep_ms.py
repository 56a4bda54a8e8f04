"""Encoder engine: the ``embed_prep`` stage (host resize and normalization
inputs), ms per 1,000 patches published in the window."""


def read(layer: dict):
    row = layer.get("stages", {}).get("embed_prep")
    return row["total_s"] * 1e6 / layer["patches"] if row and layer.get("patches") else None
