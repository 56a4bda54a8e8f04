"""Encoder engine: the ``embed_drain`` spans, where ``extract_batch`` waits
for its last forwards and fetches before it returns (once a block), ms per
1,000 patches published in the window."""


def read(layer: dict):
    row = layer.get("stages", {}).get("embed_drain")
    return row["total_s"] * 1e6 / layer["patches"] if row and layer.get("patches") else None
