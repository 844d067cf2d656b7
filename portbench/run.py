"""Run one cell of the benchmark of ``councilx_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (imports, the kernels loaded from ``build/``, weights and
inputs from the seed, warm-up and captures) runs from the process's start
to the window; the window measures for ``--seconds``; the reference then
checks what the window's path produced. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last, each
number compared beside its limit); the numbers compared are also the last
lines of standard error. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.manifest()
    cell = harness.cell_of(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    config = harness.load_json(harness.HERE, "configs",
                               f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                f"{cell['traffic']}.json")
    limits = harness.load_json(harness.HERE, "limits",
                               f"{args.workload}.json")
    env = harness.Env(config=config, traffic=traffic, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=T_START)
    out = harness.drive(env)
    line = harness.result_line(bench, args.workload, env.trace, out, limits)

    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    faults = harness.line_faults(bench, args.workload,
                                 "layer" if env.trace else "e2e", line)
    from portbench.device import card
    print(f"card: {card()}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    if faults:
        print("result line refused: " + "; ".join(faults), file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
