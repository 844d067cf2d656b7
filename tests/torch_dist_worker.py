"""One rank of a multi-process councilx_torch run on the CPU (gloo), for
the tests in tests/test_torch_parallel_*.py; holds no tests itself and
imports no JAX.

    python tests/torch_dist_worker.py SPEC.json RANK WORLD

SPEC names the scenario, the process group's ``file://`` store and the
output directory; the rank writes ``rank<RANK>.pt`` there. Scenarios:

* ``steps``: train steps of each run in turn (a tiny config, the layout of
  ``num_devices = WORLD`` and the run's ``council_parallel``, built by
  ``train.loop.make_trainer``); records every step's metrics and this rank's
  state, and the snapshot gathered to rank 0. A run's weights, batch and z
  codes may come from a file (the JAX package's, for the parity test).
* ``compiled``: each run twice from the same init, batch and z, through
  ``train_step`` and through ``compile_step`` over the CPU stand-in of the
  capture context (tests/test_torch_capture_helpers.py); after every step
  each samples the display rows and takes a snapshot, as the train loop
  does between replays. Records both routes' metrics, states, samples and
  snapshots, and the compiled step's graphs and replays.
* ``cli``: ``councilx_torch.cli.train.main`` on each argument list in turn,
  recording the display batches the loop samples and what it printed;
  ``standin`` (one flag per argument list) runs the loop on the stand-in,
  so it takes the captured route.

:func:`launch` starts the ranks from a test and returns their outputs.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import torch

from councilx_torch.cli import train as train_cli
from councilx_torch.config import Config
from councilx_torch.parallel import multihost
from councilx_torch.train import loop


def _batch(seed: int, b: int, hw: int):
    r = np.random.default_rng(seed)
    return (r.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
            r.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32))


def run_steps(spec, world: int) -> dict:
    out = {}
    for run in spec["runs"]:
        cfg = Config.from_dict({**run["raw"], "num_devices": world,
                                "council_parallel": run.get("council", 1)})
        trainer = loop.make_trainer(cfg, device="cpu")
        given = (torch.load(run["given"], weights_only=True)
                 if run.get("given") else None)
        if given is None:
            state = trainer.init_state(0)
            x_a, x_b = _batch(run.get("batch_seed", 0), cfg.batch_size,
                              cfg.data.crop_image_height)
            zs = [None] * run["steps"]
        else:
            state = trainer.load_state(given["state_dicts"])
            x_a, x_b, zs = given["x_a"], given["x_b"], given["zs"]
        b = cfg.batch_size // trainer.data_size
        rows = slice(trainer.data_index * b, (trainer.data_index + 1) * b)
        metrics, local = [], []
        for step in range(run["steps"]):
            state, m = trainer.train_step(state, x_a[rows], x_b[rows],
                                          zs=zs[step])
            metrics.append({k: float(v) for k, v in m.items()})
            local.append(state.snapshot())
        out[run["name"]] = {"metrics": metrics, "local": local,
                            "snapshot": trainer.snapshot(state),
                            "layout": (trainer.data_index, trainer.data_size,
                                       trainer.member_offset,
                                       trainer.n_local)}
    return out


def run_compiled(spec, world: int) -> dict:
    from test_torch_capture_helpers import use_stand_in

    use_stand_in(setattr)
    out = {}
    for run in spec["runs"]:
        cfg = Config.from_dict({**run["raw"], "num_devices": world,
                                "council_parallel": run.get("council", 1)})
        x_a, x_b = _batch(0, cfg.batch_size, cfg.data.crop_image_height)
        disp = torch.from_numpy(x_a[:2])
        z_disp = torch.randn((cfg.council.council_size, 2, cfg.gen.style_dim),
                             generator=torch.Generator().manual_seed(9))
        res = {}
        for route in ("eager", "compiled"):
            trainer = loop.make_trainer(cfg, device="cpu")
            state = trainer.init_state(0)
            step = (trainer.compile_step(state) if route == "compiled"
                    else trainer.train_step)
            b = cfg.batch_size // trainer.data_size
            rows = slice(trainer.data_index * b, (trainer.data_index + 1) * b)
            got = {"metrics": [], "local": [], "samples": [], "snapshots": []}
            for _ in range(run["steps"]):
                state, m = step(state, x_a[rows], x_b[rows])
                got["metrics"].append({k: float(v) for k, v in m.items()})
                got["local"].append(state.snapshot())
                got["samples"].append(trainer.sample(state, disp,
                                                     z=z_disp)[0])
                got["snapshots"].append(trainer.snapshot(state))
            if route == "compiled":
                got["graphs"] = len(step.calls)
                got["replays"] = sum(c.replays for c, _ in
                                     step.calls.values())
            res[route] = got
        out[run["name"]] = res
    return out


def run_cli(spec, rank: int, world: int) -> dict:
    from test_torch_capture_helpers import use_stand_in

    shown = []
    write_samples = loop._write_samples

    def record(trainer, state, test_u8, train_u8, *args, **kw):
        shown.append((test_u8.copy(), train_u8.copy()))
        return write_samples(trainer, state, test_u8, train_u8, *args, **kw)

    loop._write_samples = record
    # the logger's TensorBoard events are not what the tests hold, and the
    # import takes seconds per process: metrics.jsonl alone
    sys.modules["torch.utils.tensorboard"] = None
    group = ([] if world == 1 else
             ["--coordinator", spec["store"], "--num_processes", str(world),
              "--process_id", str(rank)])
    summaries, printed = [], []
    for argv, standin in zip(spec["argvs"], spec.get(
            "standin", [False] * len(spec["argvs"]))):
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            if standin:
                use_stand_in(lambda obj, name, value: stack.enter_context(
                    mock.patch.object(obj, name, value)))
            stack.enter_context(contextlib.redirect_stdout(buf))
            summaries.append(train_cli.main(argv + group +
                                            ["--device", "cpu"]))
        print(buf.getvalue(), end="", flush=True)
        printed.append(buf.getvalue())
    return {"summaries": summaries, "shown": shown, "printed": printed}


def launch(spec: dict, world: int, tmp, timeout: float = 240) -> list:
    """Run ``spec`` on ``world`` ranks, each a subprocess of this script
    with one thread, rendezvous through a ``file://`` store under ``tmp``
    -> every rank's output, in rank order."""
    out = tempfile.mkdtemp(prefix=f"{spec['scenario']}-{world}-",
                           dir=str(tmp))
    spec = {**spec, "out": out, "store": f"file://{out}/store"}
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
    logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), spec_path,
                     str(r), str(world)], env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            assert p.returncode == 0, f"rank {r}: {p.returncode}\n{f.read()}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    spec_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    if spec["scenario"] == "cli":
        out = run_cli(spec, rank, world)
    else:
        if world > 1:
            multihost.maybe_init_distributed(spec["store"], world, rank,
                                             device="cpu")
        run = run_compiled if spec["scenario"] == "compiled" else run_steps
        out = run(spec, world)
    torch.save(out, f"{spec['out']}/rank{rank}.pt")
    multihost.shutdown()


if __name__ == "__main__":
    main()
