"""The 95th percentile of every request's time from ``submit`` to its answer
in the client's hands, over all requests of the window (host clock)."""

import numpy as np


def read(r):
    if r["kind"] != "serve" or not r["latency_s"]:
        return None
    return 1e3 * float(np.percentile(r["latency_s"], 95))
