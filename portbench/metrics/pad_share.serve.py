"""Padded rows over dispatched rows, in %, from the engine's counters
(``BatchingEngine.snapshot_stats``) over the window."""


def read(r):
    s = r.get("stats")
    if r["kind"] != "serve" or not s or not s["rows"]:
        return None
    return 100.0 * s["padded_rows"] / s["rows"]
