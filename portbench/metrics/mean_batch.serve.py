"""Images per dispatched batch, from the engine's counters over the
window."""


def read(r):
    s = r.get("stats")
    if r["kind"] != "serve" or not s or not s["batches"]:
        return None
    return s["images_done"] / s["batches"]
