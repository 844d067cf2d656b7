"""The resblock 3x3 convs' share of their roofline, in %: the least time
the card could take for their work (16 convs per member forward at the
bucket's (B, H/4, W/4, 256) -> 256, the larger of operations over the bf16
peak and bytes over the memory rate) over the device time of the kernel
that ran them, from a torch.profiler trace of direct replays of the
window's most used bucket after the window."""


def read(r):
    c = r.get("conv3x3")
    if r["kind"] != "serve" or not c or c["device_s"] <= 0:
        return None
    return 100.0 * c["bound_s"] / c["device_s"]
