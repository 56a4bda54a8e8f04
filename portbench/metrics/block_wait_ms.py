"""Feature embedding service: the embedding thread's waits for pixels, the
``block_wait`` spans (a prefetched block, or one read inline) and the
``slide_wait`` spans (a slide's prep), ms per 1,000 patches published in the
window."""


def read(layer: dict):
    stages = layer.get("stages", {})
    rows = [stages[k] for k in ("block_wait", "slide_wait") if k in stages]
    if not rows or not layer.get("patches"):
        return None
    return sum(r["total_s"] for r in rows) * 1e6 / layer["patches"]
