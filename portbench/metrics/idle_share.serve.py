"""The card's idle share of the window, in %: 1 - (the sum of the device
time of each timed call, between a pair of CUDA events recorded on the
calling stream) / (the window's device time, between a pair of events on
the same stream)."""


def read(r):
    if r["kind"] != "serve" or r.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["device_window_s"])
