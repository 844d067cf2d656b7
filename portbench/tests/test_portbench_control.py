"""The controls of ``correct``, on the card at each cell's own size; they
print their readings (``pytest -s``).

* Training: the reference put in the program's place, its conv and linear
  operands rounded to fp8 (e4m3 forward, e5m2 backward, scaled per
  tensor), the precision below the configuration's bfloat16; and two
  faults a step can have, planted in the reference put in the program's
  place: half of each batch, its means taken over the rest, and the
  council discriminators left unstepped. Each against the float32
  reference, over both stretches the benchmark checks: the first three
  steps from the seeded weights, and one step from the float32
  reference's state after them (standing in for the program's state
  before the window's checked step), three seeds each.
* Serving: the program with its own int8 path on (``quant: w8a8``, W8A8
  with per-image activation scales), at the cell's load for a short
  window, three seeds.

Each must read ``correct`` false under the cell's limits. The benchmark's
own runs do not run these.
"""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.drivers.train_step import (START_NAMES, WARM_STEPS,
                                          WINDOW_NAMES, make_inputs,
                                          reference_run, start_state,
                                          stretch_checks)

BENCH = harness.manifest()
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


class FP8(torch.autograd.Function):
    """fp8 operands, as fp8 training computes them: the forward rounds a
    tensor to e4m3 and the backward its gradient to e5m2, each scaled per
    tensor so that its largest magnitude meets the format's largest."""

    @staticmethod
    def forward(ctx, t):
        s = 448.0 / t.abs().amax().clamp_min(1e-30)
        return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s

    @staticmethod
    def backward(ctx, g):
        s = 57344.0 / g.abs().amax().clamp_min(1e-30)
        return (g * s).to(torch.float8_e5m2).to(g.dtype) / s


def fp8(t: torch.Tensor) -> torch.Tensor:
    return FP8.apply(t)


def cells(train: bool):
    return [c["name"] for c in BENCH["workloads"]
            if (harness.load_json(harness.HERE, "traffic",
                                  f"{c['traffic']}.json")["driver"]
                == "train_step") == train]


def cdis_unstepped(council):
    """The council discriminators' Adam step skipped: their parameters,
    moments and count stay as they were (the moments nought at first)."""
    opt = council.opt["cdis"]

    def update(params, grads):
        for k, p in params.items():
            opt.mu.setdefault(k, torch.zeros_like(p))
            opt.nu.setdefault(k, torch.zeros_like(p))
    opt.update = update


def load(cell):
    c = harness.cell_of(BENCH, cell)
    return (harness.load_json(harness.HERE, "configs", f"{c['config']}.json"),
            harness.load_json(harness.HERE, "traffic", f"{c['traffic']}.json"),
            harness.load_json(harness.HERE, "limits", f"{cell}.json"))


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' "
                    "own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells(train=True))
def test_train_controls_read_incorrect(cell):
    needs_card()
    config, traffic, limits = load(cell)
    cfg = config["config"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = []
    for seed in SEEDS:
        inputs = make_inputs(cfg, traffic, seed, torch.device("cuda"))
        start = start_state(inputs)
        ref = reference_run(cfg, inputs, start, 0, WARM_STEPS)
        before = ref.pop("state")
        ref_w = reference_run(cfg, inputs, before, WARM_STEPS, 1)
        del ref_w["state"]
        for name, kw in (("fp8", {"q": fp8}),
                         ("half_batch", {"rows": inputs["batch"] // 2}),
                         ("cdis_unstepped", {"tamper": cdis_unstepped})):
            ctrl = reference_run(cfg, inputs, start, 0, WARM_STEPS, **kw)
            del ctrl["state"]
            ctrl_w = reference_run(cfg, inputs, before, WARM_STEPS, 1, **kw)
            del ctrl_w["state"]
            got = {**stretch_checks(cfg, start, ctrl, ref, START_NAMES),
                   **stretch_checks(cfg, before, ctrl_w, ref_w,
                                    WINDOW_NAMES)}
            print("CONTROL", json.dumps({"cell": cell, "control": name,
                                         "seed": seed, **got}), flush=True)
            readings.append((name, got))
            del ctrl, ctrl_w
            torch.cuda.empty_cache()
        del inputs, ref, ref_w, before
        torch.cuda.empty_cache()
    for name, got in readings:
        out = {"checks": got, "attempted": 1, "failed": 0}
        assert not harness.judge(out, limits), (name, got)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells(train=False))
def test_serve_int8_control_reads_incorrect(cell):
    needs_card()
    config, traffic, limits = load(cell)
    config = {**config, "config": {**config["config"], "quant": "w8a8"}}
    readings = []
    for seed in SEEDS:
        env = harness.Env(config=config, traffic=traffic, seed=seed,
                          seconds=3.0, trace=False, device="cuda",
                          t_start=time.perf_counter())
        out = harness.drive(env)
        print("CONTROL", json.dumps({"cell": cell, "control": "w8a8",
                                     "seed": seed, **out["checks"]}),
              flush=True)
        readings.append(out)
        torch.cuda.empty_cache()
    for out in readings:
        assert not harness.judge(out, limits), out["checks"]
