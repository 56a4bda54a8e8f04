"""Device: the share of an embed cell's profiled slice with no kernel, copy or
set running on the card, in %."""


def read(layer: dict):
    sl = layer.get("slice")
    if "flops_per_patch" not in layer or not sl or not sl["window_s"]:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
