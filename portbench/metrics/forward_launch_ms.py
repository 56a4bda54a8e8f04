"""ViT: host wall ms to launch one forward, the ``embed_forward`` span on a
dispatch thread (the input's normalization and the encoder's eager launches),
over the window."""


def read(layer: dict):
    row = layer.get("stages", {}).get("embed_forward")
    return row["total_s"] * 1e3 / row["count"] if row and row["count"] else None
