"""Device ms per train step: the summed event-bracketed device time of the
window's compiled-step calls over the steps."""


def read(r):
    if r["kind"] != "train" or r.get("busy_s") is None or not r["steps"]:
        return None
    return 1e3 * r["busy_s"] / r["steps"]
