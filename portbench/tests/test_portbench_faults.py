"""A run with its timed path broken underneath reads ``correct`` false.

Each test drives the rest of a run (the cell's traffic driver, its checks
and the cell's own limits) on the CPU at a tiny size, skipping the
harness's look for a card, with one fault planted in the program's path:
a train step that leaves its state as it was; a train step on half of the
batch, its means taken over the rest; a train step that leaves one group
(the council discriminators) unstepped; each of these only from the
window's first call on, so that set-up's three steps are sound and the
window's checked step alone can catch it; an answer altered where it is
produced. A sound run passes on the same path."""

import time

import pytest
import torch

from councilx_torch.train.trainer import GROUPS
from portbench import harness
from portbench.drivers.train_step import WARM_STEPS
from portbench.drivers.serve_open import TimedTranslator
from portbench.tests.tiny import tiny

SEED = 2 ** 33 + 3
BENCH = harness.manifest()


def driver(cell):
    name = harness.cell_of(BENCH, cell)["traffic"]
    return harness.load_json(harness.HERE, "traffic", f"{name}.json")[
        "driver"]


def train_cells():
    return [c["name"] for c in BENCH["workloads"]
            if driver(c["name"]) == "train_step"]


def serve_cells():
    return [c["name"] for c in BENCH["workloads"]
            if driver(c["name"]) == "serve_open"]


def run(cell, hooks, traffic):
    env = harness.Env(config={"config": tiny()}, traffic=traffic, seed=SEED,
                      seconds=0.5, trace=False, device="cpu",
                      t_start=time.perf_counter(), hooks=hooks)
    out = harness.drive(env)
    limits = harness.load_json(harness.HERE, "limits", f"{cell}.json")
    return harness.judge(out, limits), out["checks"]


def _state_tensors(state, groups):
    tensors = [p for g in groups for m in getattr(state, g)["a2b"]
               for p in m.parameters()]
    for g in groups:
        opt = getattr(state, f"opt_{g}")
        tensors += [opt.count] + opt.mu + opt.nu
    return tensors


def restoring(groups):
    """A step that puts back, after stepping, what ``groups`` held."""
    def wrap(step):
        def call(state, x_a, x_b, zs):
            tensors = _state_tensors(state, groups)
            saved = [t.detach().clone() for t in tensors]
            out = step(state, x_a, x_b, zs)
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            return out
        return call
    return wrap


def half(step):
    def call(state, x_a, x_b, zs):
        h = x_a.shape[0] // 2
        return step(state, x_a[:h], x_b[:h],
                    {"gen": {"a2b": zs["gen"]["a2b"][:, :h]}})
    return call


def from_the_window(fault):
    """``fault`` on every call after the first ``WARM_STEPS``."""
    def wrap(step):
        broken, calls = fault(step), [0]

        def call(*args):
            calls[0] += 1
            return (step if calls[0] <= WARM_STEPS else broken)(*args)
        return call
    return wrap


unchanged = restoring(GROUPS)
cdis_unstepped = restoring(("cdis",))


class AlteredAnswers(TimedTranslator):
    def translate_all_u8io_device(self, members, x_u8, z):
        out = super().translate_all_u8io_device(members, x_u8, z)
        return (out.int() + 6).clamp(0, 255).to(torch.uint8)

    def translate_u8io_device(self, params, x_u8, z=None, **kw):
        out = super().translate_u8io_device(params, x_u8, z=z, **kw)
        return (out.int() + 6).clamp(0, 255).to(torch.uint8)


TRAIN = {"driver": "train_step", "pool": 4}


def serve_traffic(cell):
    t = harness.load_json(harness.HERE, "traffic",
                          f"{harness.cell_of(BENCH, cell)['traffic']}.json")
    return {**t, "rate_per_s": 20.0, "gaps": 16, "pool": 8, "max_batch": 8,
            "sample": 8, "member": "all" if t["member"] == "all" else 0}


@pytest.mark.parametrize("cell", train_cells())
@pytest.mark.parametrize("fault", [
    None, unchanged, half, cdis_unstepped, from_the_window(unchanged),
    from_the_window(half), from_the_window(cdis_unstepped)])
def test_train_fault_reads_incorrect(cell, fault):
    hooks = {"wrap_step": fault} if fault else {}
    correct, checks = run(cell, hooks, TRAIN)
    assert correct == (fault is None), checks


@pytest.mark.parametrize("cell", serve_cells())
@pytest.mark.parametrize("fault", [None, AlteredAnswers])
def test_serve_fault_reads_incorrect(cell, fault):
    hooks = {"translator": fault} if fault else {}
    correct, checks = run(cell, hooks, serve_traffic(cell))
    assert correct == (fault is None), checks
