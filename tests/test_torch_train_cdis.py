"""councilx_torch's train step: the council-discriminator update ratio and
the member-chunked generator phase vs the JAX package; ``remat`` and
``gen_member_chunks`` vs the port's own plain path.

The JAX cases run the tiny parity-mode config of
tests/test_torch_train_helpers.py with one setting changed, two steps on both
sides, with the tolerances of tests/test_torch_train.py: metrics to 1e-5
relative, parameters within 2 * lr per step.
"""

import numpy as np
import pytest
import torch

from councilx_torch.config import Config
from councilx_torch.train.trainer import CouncilTrainer
from test_torch_train_helpers import (LR, Pair, assert_metrics_close, batch,
                                max_param_diff, raw_config)

torch.set_num_threads(2)

CASES = {
    "cdis_k_per_step": dict(council={"council_dis_relative_iteration": 2,
                                     "cdis_ratio_mode": "k_per_step"}),
    "cdis_every_kth": dict(council={"council_dis_relative_iteration": 2,
                                    "cdis_ratio_mode": "every_kth"}),
    "gen_member_chunks": dict(gen_member_chunks=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_match_jax(case):
    pair = Pair(**CASES[case])
    jm, pm, want, ps = pair.run(2)
    assert_metrics_close(jm, pm, rtol=1e-5)
    assert max_param_diff(want, ps) <= 2 * LR * 2
    if case == "cdis_every_kth":
        # step 0 updates the council discriminators, step 1 skips them
        assert [m["cdis_updated"] for m in pm] == [1.0, 0.0]
        assert pm[1]["loss_dis_council"] == 0.0


def _port_steps(steps=2, **over):
    """``steps`` port-only steps from one seeded init -> (metrics, state)."""
    trainer = CouncilTrainer(Config.from_dict(raw_config(**over)),
                             device="cpu")
    state = trainer.init_state(seed=3)
    x_a, x_b = batch(1)
    out = []
    for _ in range(steps):
        zs = trainer.draw_zs(state, x_a.shape[0])
        state, m = trainer.train_step(state, x_a, x_b, zs=zs)
        out.append({k: float(v) for k, v in m.items()})
    return out, state


@pytest.mark.parametrize("over,exact", [(dict(remat=True), True),
                                        (dict(gen_member_chunks=2), False)])
def test_remat_and_member_chunks_match_the_plain_step(over, exact):
    want, ws = _port_steps()
    got, gs = _port_steps(**over)
    a, b = ws.state_dicts(), gs.state_dicts()
    diffs = [float((x[k] - y[k]).abs().max())
             for d in a for grp in a[d] for x, y in zip(a[d][grp], b[d][grp])
             for k in x]
    if exact:
        # remat recomputes the same operations on the same inputs
        assert got == want and max(diffs) == 0.0
    else:
        # chunking regroups the member means of the mask losses (f32)
        assert_metrics_close(want, got, rtol=1e-6)
        assert max(diffs) <= 2 * LR * 2


def test_not_ported_options_raise():
    for over in (dict(remat_stages=True), dict(vgg_w=1.0)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            CouncilTrainer(Config.from_dict(raw_config(**over)),
                           device="cpu")


def test_trainer_defaults_to_the_card():
    trainer = CouncilTrainer(Config.from_dict(raw_config()))
    assert trainer.device.type == "cuda"
    if not torch.cuda.is_available():
        # no card here: the state is not made on the CPU instead
        with pytest.raises((AssertionError, RuntimeError)):
            trainer.init_state(seed=0)


def test_sample_and_drawn_z_shapes():
    trainer = CouncilTrainer(Config.from_dict(raw_config()), device="cpu")
    state = trainer.init_state(seed=0)
    x_a, _ = batch()
    x_t, mask = trainer.sample(state, x_a)
    assert x_t.shape == (2, 2, 32, 32, 3) and mask.shape == (2, 2, 32, 32, 1)
    assert np.isfinite(x_t.numpy()).all()
    zs = trainer.draw_zs(state, 2)
    assert zs["gen"]["a2b"].shape == (2, 2, 3)
    assert zs["gen"] is zs["dis"] is zs["cdis"]      # z_mode "shared"
