"""Training CLI of the port, argument-compatible with the reference
train.py and with ``councilx/cli/train.py``:

    python -m councilx_torch.cli.train --config configs/<run>.yaml \\
        [--output_path outputs] [--resume] [--max_steps N] [--seed 0] \\
        [--synthetic] [--profile] [--debug_nans] [--device cuda]

The run goes to ``<output_path>/<config name>/``: ``config.yaml``,
``metrics.jsonl``, ``images/`` sample sheets with ``index.html``, and
``checkpoints/step_XXXXXXXX/`` snapshots, which ``--resume`` continues
and ``councilx_torch.cli.translate`` / ``.gui`` / ``.serve`` read.
SIGTERM or SIGINT finish the current step, write a final snapshot and exit
0 (a second signal kills). ``--device`` defaults to the card; ``cpu``
trains on the CPU.

Multi-GPU: one process per GPU, the config's ``num_devices`` the number of
processes (and ``council_parallel`` the council axis), launched by torchrun

    torchrun --nproc_per_node=G -m councilx_torch.cli.train --config run.yaml

or by hand, every process with ``--coordinator host:port --num_processes
G --process_id i`` (or the ``COUNCILX_COORDINATOR`` /
``COUNCILX_NUM_PROCESSES`` / ``COUNCILX_PROCESS_ID`` variables). Each
process takes ``cuda:LOCAL_RANK`` (``--device cpu``: the CPU over gloo).
Signals are left to their default action there: one process stopping early
would strand the others in a collective.
"""

import argparse
import os
import signal
import threading

import torch

from councilx_torch.config import load_config
from councilx_torch.parallel import multihost
from councilx_torch.train.loop import train


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="yaml config path")
    p.add_argument("--output_path", default="outputs")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--trainer", default="council",
                   help="kept for reference CLI compatibility")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (smoke runs)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of steps 10-15")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly (slow; "
                        "debugging only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; 'cpu' to train "
                        "on the CPU)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0, or a URL (file://...): "
                        "multi-process runs launched without torchrun")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    args = p.parse_args(argv)
    try:
        device = multihost.maybe_init_distributed(
            args.coordinator, args.num_processes, args.process_id,
            device=args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from None

    cfg = load_config(args.config)
    run_name = os.path.splitext(os.path.basename(args.config))[0]

    # graceful shutdown: the first SIGTERM/SIGINT asks the loop to stop
    # after the current step and snapshot (the run then resumes as a
    # bitwise continuation); a second one takes the default action
    stop_event = threading.Event()

    def _request_stop(signum, frame):
        # the event first: print() can raise inside a handler that lands
        # mid-write, and the request must be recorded by then
        stop_event.set()
        signal.signal(signum, signal.SIG_DFL)
        print(f"signal {signum}: finishing the current step and "
              "checkpointing (repeat to force-kill)", flush=True)

    previous = ({sig: signal.signal(sig, _request_stop)
                 for sig in (signal.SIGTERM, signal.SIGINT)}
                if multihost.process_count() == 1 else {})
    try:
        with torch.autograd.set_detect_anomaly(args.debug_nans):
            summary = train(cfg, output_path=args.output_path,
                            run_name=run_name, resume=args.resume,
                            synthetic=args.synthetic,
                            max_steps=args.max_steps, seed=args.seed,
                            profile_steps=(range(10, 15) if args.profile
                                           else None),
                            stop_event=stop_event, device=device)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    print(summary, flush=True)
    return summary


if __name__ == "__main__":
    try:
        main()
    finally:
        multihost.shutdown()
