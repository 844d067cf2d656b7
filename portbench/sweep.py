"""Sweep the offered rate of a serving mix once, to find the highest rate
the program sustains on the card; a serving cell's traffic file then
offers a fixed share of it.

    python3 portbench/sweep.py --workload <cell> --rates 600,800,1000 \
        --seconds 8 --seed <n>

One set-up (the cell's configuration and traffic, every bucket warmed up),
then for each rate in turn the cell's open-loop arrivals for ``--seconds``
and the wait for their answers. One JSON line per rate: the offered and the
completed rate (requests over the time from the first arrival to the last
answer), the latency's median, 95th and 99th percentiles, how long the
last answer came after the last arrival, and the mean batch. No check of
the answers: a sweep only sizes the traffic.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from portbench import harness
    from portbench.drivers import serve_open

    if not torch.cuda.is_available():
        print("a sweep needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.manifest()
    cell = harness.cell_of(bench, args.workload)
    env = harness.Env(
        config=harness.load_json(harness.HERE, "configs",
                                 f"{cell['config']}.json"),
        traffic=harness.load_json(harness.HERE, "traffic",
                                  f"{cell['traffic']}.json"),
        seed=args.seed, seconds=args.seconds, trace=False, device="cuda",
        t_start=time.perf_counter())
    s = serve_open.serving(env)
    print(json.dumps({"setup_s": time.perf_counter() - env.t_start}),
          flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        before = s["engine"].snapshot_stats()
        t0 = time.perf_counter()
        loop = serve_open.offer(s, rate, args.seconds, env.traffic,
                                args.seed)
        span = time.perf_counter() - t0
        lat = 1e3 * np.asarray(loop.latency_s)
        d = serve_open.stats_delta(before, s["engine"].snapshot_stats())
        print(json.dumps({
            "rate": rate, "sent": loop.sent, "failed": loop.failed,
            "completed_per_s": len(lat) / span,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "drain_s": span - float(loop.times[-1]),
            "mean_batch": d["images_done"] / max(d["batches"], 1)}),
            flush=True)
    s["engine"].stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
