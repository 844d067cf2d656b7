"""The median host ms that a compiled-step call holds its caller, with no
synchronize: input staging, the graph's input copies and the replay's
launch, which waits while the device's queue is full."""

import statistics


def read(r):
    if r["kind"] != "train" or not r.get("enqueue_ms"):
        return None
    return statistics.median(r["enqueue_ms"])
