"""The window's model FLOPs (the published step's, counted on the meta
device, per step done) over the window and the card's bf16 dense peak
(989 TFLOP/s), in %."""

from portbench.device import PEAK_OPS


def read(r):
    if r["kind"] != "train" or "flops_per_step" not in r:
        return None
    return 100.0 * r["flops_per_step"] * r["steps"] / r["window_s"] \
        / PEAK_OPS["bf16"]
