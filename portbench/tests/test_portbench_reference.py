"""The plain reference against the program at a tiny size on the CPU, in
float32: a serving forward (one member and all members) and train steps
with the focus mask on and off. The test imports both; the reference
imports nothing of the program."""

import copy

import pytest
import torch

from councilx_torch.config import Config
from councilx_torch.inference.translate import Translator
from councilx_torch.train.trainer import CouncilTrainer
from portbench.drivers.train_step import (START_NAMES, WARM_STEPS,
                                          WINDOW_NAMES, leaves, make_inputs,
                                          program_state, reference_run,
                                          start_state, stretch_checks)
from portbench.reference.step import build, serve_u8
from portbench.tests.tiny import tiny
from portbench.weights import make_state


@pytest.mark.parametrize("focus", [True, False])
def test_train_steps_match_the_program(focus):
    """The first three steps from the seeded weights, and a fourth from the
    program's own state after them, as the benchmark checks them."""
    cfg = tiny(focus)
    inputs = make_inputs(cfg, {"pool": 4}, seed=2 ** 33 + 7, dev="cpu")
    trainer = CouncilTrainer(Config.from_dict(cfg), device="cpu")
    state = trainer.load_state({"a2b": copy.deepcopy(inputs["p0"])})
    live = program_state(state)

    def call(i):
        _, m = trainer.train_step(state, inputs["x_a"][i], inputs["x_b"][i],
                                  {"gen": {"a2b": inputs["z"][i]}})
        return {k: float(v) for k, v in m.items()}

    prog = {"losses": []}
    for i in range(WARM_STEPS):
        prog["losses"].append(call(i))
        if i == 0:
            prog["mu1"] = leaves(live, "mu")
    prog["p_end"] = leaves(live, "p")
    before = {k: v.detach().clone() for k, v in live.items()}
    window = {"losses": [call(WARM_STEPS)], "mu1": leaves(live, "mu"),
              "p_end": leaves(live, "p")}
    start = start_state(inputs)
    got = {**stretch_checks(cfg, start, prog,
                            reference_run(cfg, inputs, start, 0, WARM_STEPS),
                            START_NAMES),
           **stretch_checks(cfg, before, window,
                            reference_run(cfg, inputs, before, WARM_STEPS, 1),
                            WINDOW_NAMES)}
    # float32 on both sides: rounding alone
    for name in ("loss1_gap", "grad1_gap", "lossw_gap", "gradw_gap"):
        assert got[name] < 1e-5, got
    assert got["change3_gap"] < 1e-3 and got["changew_gap"] < 1e-3, got


@pytest.mark.parametrize("all_members", [True, False])
def test_serving_forward_matches_the_program(all_members):
    cfg = tiny(focus=all_members)
    gen = torch.Generator().manual_seed(11)
    sds = make_state(cfg, gen, "cpu", groups=("gen",))["gen"]
    x = torch.randint(0, 256, (3, 32, 32, 3), generator=gen,
                      dtype=torch.uint8)
    z = torch.randn((3, 3), generator=gen)
    tr = Translator(Config.from_dict(cfg), device="cpu")
    members = tr.load_members(sds)
    ref = []
    for sd in sds:
        m = build(cfg, "gen")
        m.load_state_dict(sd, strict=True)
        ref.append(m)
    want = serve_u8(ref if all_members else ref[:1], x, z)
    got = (tr.translate_all_u8io_device(members, x, z) if all_members
           else tr.translate_u8io_device(members[0], x, z=z)[None])
    assert got.shape == want.shape
    assert (got.int() - want.int()).abs().max() <= 1
