"""The whole encoder step's share of the card's peak in the profiled slice:
the benchmark's FLOPs per patch (reference/flops.py) times the patches of the
slides published within the slice, over the slice's wall time (which starts
and ends at a publication), over the peak of the cell's precision, in %."""


def read(layer: dict):
    patches = layer.get("traced_patches", 0)
    if "flops_per_patch" not in layer or not patches:
        return None
    return 100.0 * layer["flops_per_patch"] * patches / layer["slice"]["window_s"] / layer["peak_flops"]
