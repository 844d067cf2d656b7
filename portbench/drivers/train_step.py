"""Training traffic: the program's compiled train step, replayed back to back.

Parameters (a traffic file): ``pool``, the number of seeded batches the
steps cycle through; ``batch`` (optional), images per domain, else the
configuration's ``batch_size``.

Set-up makes the weights and the pool of batches and style codes from the
seed on the device, builds the program's trainer with those weights, and
compiles its step (``CouncilTrainer.compile_step``). The first three calls
of that one object are the warm-up (an eager step, the capture and its
replay, a replay), on batches 0, 1 and 2; the window goes on from batch 3.
The window's first call, the graph's second replay, is checked: the state
is copied just before it and just after it (inside the window, on the
calling stream). The first and not a later one: the bfloat16 step drifts
from the float32 one as the focus mask shrinks and the L1 content
reconstruction's residual nears nought, so that a later step's gap is
rounding and no fault (``PERF.md``, section 2).

Once the window has closed, the reference follows the first three steps
from the same weights, batches and style codes, and takes the checked step
again from the program's state before it, with its batch and style codes.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import torch

from councilx_torch.config import Config
from councilx_torch.train.trainer import GROUPS, CouncilTrainer
from portbench import check
from portbench.device import CallTimer, profile_kernels
from portbench.flops import train_flops
from portbench.reference.step import Council
from portbench.weights import make_state

WARM_STEPS = 3
START_NAMES = ("loss1_gap", "grad1_gap", "change3_gap")
WINDOW_NAMES = ("lossw_gap", "gradw_gap", "changew_gap")

State = Dict[str, torch.Tensor]


def make_inputs(cfg: dict, traffic: dict, seed: int, dev) -> dict:
    """The run's weights (MUNIT-layout state dicts per group), its pool of
    batches (x_a, x_b: (pool, B, H, W, 3) in [-1, 1]) and style codes (z:
    (pool, N, B, style_dim)), all from the seed on ``dev``."""
    batch = traffic.get("batch") or cfg["batch_size"]
    hw, pool = cfg["crop_image_height"], traffic["pool"]
    n, sdim = cfg["council"]["council_size"], cfg["gen"]["style_dim"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p0 = make_state(cfg, gen, dev)
    x_a = torch.rand((pool, batch, hw, hw, 3), generator=gen, device=dev)
    x_b = torch.rand((pool, batch, hw, hw, 3), generator=gen, device=dev)
    z = torch.randn((pool, n, batch, sdim), generator=gen, device=dev)
    return {"p0": p0, "x_a": x_a * 2 - 1, "x_b": x_b * 2 - 1, "z": z,
            "batch": batch, "hw": hw}


def start_state(inputs: dict) -> State:
    """The state before the first step: the seeded weights, no moments,
    count 0, in :func:`program_state`'s layout."""
    out = {f"p:{g}.{i}.{k}": v for g, sds in inputs["p0"].items()
           for i, sd in enumerate(sds) for k, v in sd.items()}
    out.update({f"count:{g}": torch.zeros((), dtype=torch.int32)
                for g in GROUPS})
    return out


def program_state(state) -> State:
    """The program's own state tensors (not copies) by name:
    ``p:<leaf>``, ``mu:<leaf>``, ``nu:<leaf>`` for every leaf
    ``<group>.<member>.<name>``, and ``count:<group>``."""
    out = {}
    for grp in GROUPS:
        mods = getattr(state, grp)["a2b"]
        opt = getattr(state, f"opt_{grp}")
        leaves = [(f"{grp}.{i}.{k}", p) for i, m in enumerate(mods)
                  for k, p in m.named_parameters()]
        for (name, p), mu, nu in zip(leaves, opt.mu, opt.nu):
            out.update({f"p:{name}": p.detach(), f"mu:{name}": mu,
                        f"nu:{name}": nu})
        out[f"count:{grp}"] = opt.count
    return out


def part(state: State, kind: str) -> State:
    """``{leaf: tensor}`` of one kind (``p``, ``mu``, ``nu``)."""
    return {k[len(kind) + 1:]: v for k, v in state.items()
            if k.startswith(kind + ":")}


def reference_run(cfg: dict, inputs: dict, state: State, first: int,
                  steps: int, q=None, rows: Optional[int] = None,
                  tamper=None) -> dict:
    """The reference from ``state`` (:func:`program_state`'s layout)
    through ``steps`` steps on batches ``first``, ``first + 1``, ...:
    each step's losses, the first step's gradients, the first moments after
    it and the parameters after the last, by leaf, and its whole state
    after the last in that layout. ``q`` rounds its conv and
    linear operands; ``rows`` keeps only the first rows of every batch;
    ``tamper(council)`` plants a fault (the last three for the controls of
    ``portbench/tests``)."""
    p0 = inputs["p0"]
    sds = {g: [{k: state.get(f"p:{g}.{i}.{k}", v) for k, v in sd.items()}
               for i, sd in enumerate(p0[g])] for g in GROUPS}
    ref = Council(cfg, sds, q=q, device=inputs["x_a"].device)
    for g in GROUPS:
        opt = ref.opt[g]
        opt.count = int(state[f"count:{g}"])
        for kind in ("mu", "nu"):
            setattr(opt, kind, {k[len(g) + 1:]: v.float().clone()
                                for k, v in part(state, kind).items()
                                if k.startswith(g + ".")})
    ref.step_no = ref.opt["gen"].count
    if tamper is not None:
        tamper(ref)
    sl = slice(None) if rows is None else slice(0, rows)
    out = {"losses": []}
    for i in range(first, first + steps):
        r = ref.step(inputs["x_a"][i, sl], inputs["x_b"][i, sl],
                     inputs["z"][i, :, sl])
        grads = r.pop("grads")
        out["losses"].append({k: float(v) for k, v in r.items()})
        if i == first:
            out["grads1"] = {f"{g}.{k}": v for g in GROUPS
                             for k, v in grads[g].items()}
            out["mu1"] = {f"{g}.{k}": v.clone() for g in GROUPS
                          for k, v in ref.opt[g].mu.items()}
        del grads, r
    out["p_end"] = {f"{g}.{k}": p.detach() for g in GROUPS
                    for k, p in ref.params(g).items()}
    out["state"] = {f"p:{k}": v for k, v in out["p_end"].items()}
    for g in GROUPS:
        opt = ref.opt[g]
        out["state"][f"count:{g}"] = torch.tensor(opt.count)
        for kind in ("mu", "nu"):
            out["state"].update({f"{kind}:{g}.{k}": v
                                 for k, v in getattr(opt, kind).items()})
    return out


def stretch_checks(cfg: dict, before: State, prog: dict, ref: dict,
                   names) -> dict:
    """One stretch's numbers: the program's (or a control's) ``losses``,
    ``mu1`` and ``p_end`` against the reference's, from ``before``."""
    mu = part(before, "mu")
    return check.update_checks(
        part(before, "p"), mu or None, prog["mu1"], prog["p_end"],
        prog["losses"][0], ref["grads1"], ref["p_end"], ref["losses"][0],
        cfg["beta1"], cfg["weight_decay"], names)


def leaves(state: State, kind: str) -> State:
    return {k: v.detach().clone() for k, v in part(state, kind).items()}


def run(env) -> dict:
    cfg, dev = env.config["config"], torch.device(env.device)
    inputs = make_inputs(cfg, env.traffic, env.seed, dev)
    x_a, x_b, z = inputs["x_a"], inputs["x_b"], inputs["z"]
    pool = x_a.shape[0]

    trainer = CouncilTrainer(Config.from_dict(cfg), device=dev)
    state = trainer.load_state({"a2b": inputs["p0"]}, seed=env.seed)
    step = (trainer.compile_step(state) if dev.type == "cuda"
            else trainer.train_step)
    step = env.hooks.get("wrap_step", lambda s: s)(step)
    live = program_state(state)

    def call(i):
        return step(state, x_a[i], x_b[i], {"gen": {"a2b": z[i]}})

    prog = {"losses": []}
    for i in range(WARM_STEPS):
        _, metrics = call(i)
        prog["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            prog["mu1"] = leaves(live, "mu")
    prog["p_end"] = leaves(live, "p")

    before = {k: torch.empty_like(v) for k, v in live.items()}
    after = {k: torch.empty_like(v) for k, v in live.items()}
    timer = CallTimer()
    traced = env.trace and dev.type == "cuda"
    enqueue_ms = []
    k = WARM_STEPS
    env.sync()
    t0 = time.perf_counter()
    if traced:
        timer.open()
    while True:
        checked = k == WARM_STEPS
        if checked:
            torch._foreach_copy_(list(before.values()), list(live.values()))
        ev = timer.start()
        h0 = time.perf_counter()
        _, metrics = call(k % pool)
        enqueue_ms.append(1e3 * (time.perf_counter() - h0))
        timer.stop(ev)
        if checked:
            torch._foreach_copy_(list(after.values()), list(live.values()))
            checked_metrics = metrics
        k += 1
        if time.perf_counter() - t0 >= env.seconds:
            break
    if traced:
        timer.close()
    env.sync()
    window_s = time.perf_counter() - t0
    steps = k - WARM_STEPS

    out = {"readings": {"kind": "train", "setup_s": t0 - env.t_start,
                        "window_s": window_s, "steps": steps,
                        "batch": inputs["batch"], "enqueue_ms": enqueue_ms},
           "attempted": steps, "failed": 0,
           "memory_peak_bytes": env.memory_peak()}
    if traced:
        out["timer"] = timer.read()
        out["kernels"] = profile_kernels(lambda: call(0), calls=2)
        out["readings"]["flops_per_step"] = train_flops(
            cfg, inputs["batch"], inputs["hw"])
    window = {"losses": [{k: float(v) for k, v in checked_metrics.items()}],
              "mu1": part(after, "mu"), "p_end": part(after, "p")}

    del step, trainer, state, metrics, checked_metrics, live, after
    gc.collect()
    env.free()
    start = start_state(inputs)
    out["checks"] = {
        **stretch_checks(cfg, start, prog,
                         reference_run(cfg, inputs, start, 0, WARM_STEPS),
                         START_NAMES),
        **stretch_checks(cfg, before, window,
                         reference_run(cfg, inputs, before,
                                       WARM_STEPS % pool, 1),
                         WINDOW_NAMES)}
    return out
