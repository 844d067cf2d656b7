"""councilx_torch's train step vs the JAX package's: directions, z streams,
the focus mask and loss-weight schedules.

Each case: the tiny parity-mode config of
tests/test_torch_train_helpers.py with one setting changed, the JAX init
carried into the port, two steps on both sides with the z codes the JAX
step draws injected into the port. The
tolerances are those of tests/test_torch_train.py, for the same reasons:
metrics to 1e-5 relative (f32 sums in another order), parameters within
2 * lr per step (Adam's first update turns rounding-noise gradients into
moves of up to +-lr).
"""

import pytest
import torch

from test_torch_train_helpers import (LR, Pair, assert_metrics_close,
                                max_param_diff)

torch.set_num_threads(2)

CASES = {
    "both_directions": dict(do_b2a=True),
    "z_per_phase": dict(z_mode="per_phase"),
    "focus_off": dict(focus_loss={"focus_enabled": False}),
    # in-step weight schedules: recon_x ramps up over 2 steps, the council
    # term starts at step 1
    "scheduled_weights": dict(
        recon_x_w={"base": 10.0, "warmup_iters": 2},
        council={"council_w": {"base": 0.2, "start_at_iter": 1}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_match_jax(case):
    pair = Pair(**CASES[case])
    jm, pm, want, ps = pair.run(2)
    assert_metrics_close(jm, pm, rtol=1e-5)
    assert max_param_diff(want, ps) <= 2 * LR * 2
    if case == "both_directions":
        assert {"loss_gen_adv_a2b", "loss_gen_adv_b2a"} <= set(pm[0])
    if case == "focus_off":
        assert not any("mask" in k for k in pm[0])


def test_one_step_with_the_conv_engines_matches_jax():
    """One step outside parity mode (f32, two-pass statistics) under the
    JAX defaults plus ``upsample_engine: phase`` and ``resblock_fuse_pad``:
    the phase_fused 7x7 convs, the phase upsample conv and the resblocks'
    strips engine on both sides, the same tolerances."""
    pair = Pair(parity_mode=False, norm_stats="two_pass",
                upsample_engine="phase", resblock_fuse_pad=True)
    assert pair.jt.gen.upsample_engine == "phase"
    assert pair.jt.gen.resblock_fuse_pad and pair.jt.gen.fuse_upsample
    jm, pm, want, ps = pair.run(1)
    assert_metrics_close(jm, pm, rtol=1e-5)
    assert max_param_diff(want, ps) <= 2 * LR
