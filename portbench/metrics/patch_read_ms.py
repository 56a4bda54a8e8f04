"""Feature embedding service: the ``patch_read`` stage, ms per 1,000 patches
published in the window."""


def read(layer: dict):
    row = layer.get("stages", {}).get("patch_read")
    return row["total_s"] * 1e6 / layer["patches"] if row and layer.get("patches") else None
