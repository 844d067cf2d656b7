"""Images of domain A trained on per second: batch x steps completed in the
window, over the window (host clock, the window closed by a synchronize)."""


def read(r):
    if r["kind"] != "train":
        return None
    return r["batch"] * r["steps"] / r["window_s"]
