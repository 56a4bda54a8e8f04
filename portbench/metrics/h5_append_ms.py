"""Feature append: the ``h5_append`` stage, ms per slide."""


def read(layer: dict):
    row = layer.get("stages", {}).get("h5_append")
    return row["total_s"] * 1e3 / row["count"] if row and row["count"] else None
