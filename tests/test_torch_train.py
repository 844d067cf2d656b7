"""councilx_torch's CouncilTrainer vs the JAX package's, in parity mode.

The tiny config of tests/test_train_step.py (council-2, dim 8, n_res 2,
32px, f32), the JAX init carried into the port, the same batch and the z
codes the JAX step draws (tests/test_torch_train_helpers.py). Checked on
the CPU:

* per-phase gradients: ``jax.value_and_grad`` over ``_gen_loss_dir``,
  ``_dis_loss_dir`` and ``council_dis_loss`` against ``torch.autograd``
  over the port's same functions;
* one and two whole train steps: every metric, and the parameters after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from councilx.losses.council import council_dis_loss as jcouncil_dis_loss
from councilx_torch.ckpt.manager import params_to_state_dicts
from councilx_torch.ckpt.torch_export import (export_ms_image_dis,
                                              unstack_members)
from councilx_torch.losses.council import council_dis_loss
from test_torch_train_helpers import (LR, Pair, assert_grads_close,
                                assert_metrics_close, batch, max_param_diff,
                                named_grads)

torch.set_num_threads(2)

# per-phase gradients: f32 on both sides, the same operations summed in
# another order, so each gradient tensor agrees to 1e-4 of its own largest
# entry
GRAD_REL = 1e-4
# losses of one phase on the same weights: f32 sums in another order
LOSS_RTOL = 1e-5
# metrics of whole steps (measured: below 1e-6 relative on both steps)
METRIC_RTOL = 1e-5
# Parameters after a step: every conv bias that IN/AdaIN follows has an
# exactly-zero gradient in exact arithmetic (the norm removes it), so its
# computed gradient is rounding noise, and so is any gradient entry that
# happens to be near zero. Adam's first update lr * g / (|g| + eps) turns
# such noise into a move of up to +-lr, so a parameter may differ by up to
# 2 * lr per step (measured: 1.6 lr after one step, 2.3 lr after two).


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def inputs(pair):
    js = pair.jax_state()
    x_a, x_b = batch()
    z = pair.jax_zs(js)["gen"]["a2b"]
    fakes = np.array(pair.jt._translate_members(
        js.params["a2b"]["gen"], jnp.asarray(x_a), jnp.asarray(z))[0])
    return js, pair.port_state(), x_a, x_b, z, fakes


def _dis_dicts(grads, cfg):
    return [{k: torch.from_numpy(np.array(v)) for k, v in
             export_ms_image_dis(t, cfg.dis.n_layer,
                                 cfg.dis.num_scales).items()}
            for t in unstack_members(jax.device_get(grads))]


def test_load_state_carries_the_jax_init(pair):
    state = pair.port_state()
    assert state.step == 0 and int(state.opt_gen.count) == 0
    got = state.state_dicts()["a2b"]
    want = params_to_state_dicts(pair.params["a2b"]["gen"], pair.cfg)
    for a, b in zip(got["gen"], want):
        assert all(torch.equal(a[k], b[k]) for k in b)
    with pytest.raises(ValueError, match="council of 2"):
        pair.pt.load_state({"a2b": {g: v[:1] for g, v in got.items()}})


def test_gen_phase_grads_match_jax(pair, inputs):
    js, ps, x_a, _, z, _ = inputs
    p = js.params["a2b"]

    def loss(gp):
        return pair.jt._gen_loss_dir(gp, p["dis"], p["cdis"],
                                     jnp.asarray(x_a), jnp.asarray(z),
                                     js.step)

    (lj, mj), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(p["gen"])
    lp, mp = pair.pt._gen_loss_dir(ps.gen["a2b"], ps.dis["a2b"],
                                   ps.cdis["a2b"], torch.from_numpy(x_a),
                                   torch.from_numpy(z), 0)
    assert set(mp) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(lp), float(lj), rtol=LOSS_RTOL)
    assert_grads_close(named_grads(ps.gen["a2b"], lp),
                       params_to_state_dicts(jax.device_get(gj), pair.cfg),
                       GRAD_REL)


def test_dis_phase_grads_match_jax(pair, inputs):
    js, ps, _, x_b, _, fakes = inputs

    def loss(dp):
        return pair.jt._dis_loss_dir(dp, jnp.asarray(fakes),
                                     jnp.asarray(x_b), js.step)

    lj, gj = jax.jit(jax.value_and_grad(loss))(js.params["a2b"]["dis"])
    lp = pair.pt._dis_loss_dir(ps.dis["a2b"], torch.from_numpy(fakes),
                               torch.from_numpy(x_b), 0)
    np.testing.assert_allclose(float(lp), float(lj), rtol=LOSS_RTOL)
    assert_grads_close(named_grads(ps.dis["a2b"], lp),
                       _dis_dicts(gj, pair.cfg), GRAD_REL)


@pytest.mark.parametrize("polarity", ["own_real", "own_fake"])
def test_council_dis_phase_grads_match_jax(pair, inputs, polarity):
    js, ps, x_a, _, _, fakes = inputs

    def loss(cp):
        return jcouncil_dis_loss(pair.jt._cdis_apply, cp, jnp.asarray(fakes),
                                 jnp.asarray(x_a), "lsgan", True,
                                 polarity=polarity)

    lj, gj = jax.jit(jax.value_and_grad(loss))(js.params["a2b"]["cdis"])
    lp = council_dis_loss(ps.cdis["a2b"], torch.from_numpy(fakes),
                          torch.from_numpy(x_a), "lsgan", True,
                          polarity=polarity)
    np.testing.assert_allclose(float(lp), float(lj), rtol=LOSS_RTOL)
    assert_grads_close(named_grads(ps.cdis["a2b"], lp),
                       _dis_dicts(gj, pair.cfg), GRAD_REL)


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_jax(pair, steps):
    jm, pm, want, ps = pair.run(steps)
    # step 1 runs on identical weights, f32 sums in another order; step 2
    # on weights that already differ by Adam's amplified noise (see the
    # note on parameters at the top)
    assert_metrics_close(jm, pm, rtol=METRIC_RTOL)
    assert max_param_diff(want, ps) <= 2 * LR * steps
    assert ps.step == steps and int(ps.opt_gen.count) == steps
