"""The captured bucket calls' share of the card's bf16 dense peak (989
TFLOP/s), in %: the model FLOPs of the requests served in the window (the
published forward's, counted on the meta device, every member's in an
ensemble) over the summed event-bracketed device time of the window's
bucket calls. The offered rate is fixed, so the FLOPs over the window
would read that rate; over the calls' device time they read how well each
call uses the card, padded rows and all."""

from portbench.device import PEAK_OPS


def read(r):
    if r["kind"] != "serve" or "flops_per_request" not in r \
            or not r.get("busy_s"):
        return None
    return 100.0 * r["flops_per_request"] * r["requests"] / r["busy_s"] \
        / PEAK_OPS["bf16"]
