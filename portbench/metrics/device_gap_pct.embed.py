"""Device: the share of the window's time, from the encoder engine's events on
the card, in which no batch was in flight (``embed_device_gap``) over that
time plus the time with at least one (``embed_device_span``), in %."""


def read(layer: dict):
    stages = layer.get("stages", {})
    gap, span = stages.get("embed_device_gap"), stages.get("embed_device_span")
    if not gap or not span or not gap["total_s"] + span["total_s"]:
        return None
    return 100.0 * gap["total_s"] / (gap["total_s"] + span["total_s"])
