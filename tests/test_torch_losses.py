"""councilx_torch's discriminator, losses and optimizer vs the JAX package.

Same weights (JAX trees carried into the port by
``councilx_torch.ckpt.torch_export.export_ms_image_dis``, loaded strictly)
and the same numpy inputs through both; f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from councilx.config import Config as JConfig
from councilx.losses import council as jcouncil
from councilx.losses import focus as jfocus
from councilx.losses import gan as jgan
from councilx.nn.blocks import avg_pool_3x3_s2 as jax_avg_pool
from councilx.nn.discriminator import MsImageDis as JMsImageDis
from councilx.train.optim import make_optimizers as jmake_optimizers
from councilx_torch.ckpt.torch_export import (export_ms_image_dis,
                                              unstack_members)
from councilx_torch.config import Config
from councilx_torch.losses import council, focus, gan
from councilx_torch.nn.blocks import avg_pool_3x3_s2
from councilx_torch.nn.discriminator import MsImageDis
from councilx_torch.train.optim import make_optimizers

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dis_pair(input_dim, n_members, seed=0, n_layer=2, num_scales=2,
              hw=32):
    """Stacked JAX MsImageDis params, its module, and the port's members
    loaded from the same weights."""
    jdis = JMsImageDis(input_dim=input_dim, dim=8, n_layer=n_layer,
                       num_scales=num_scales)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_members)
    params = jax.vmap(jdis.init, in_axes=(0, None))(
        keys, jnp.zeros((1, hw, hw, input_dim)))["params"]
    # the JAX init draws biases as zeros; make them visible to the test
    params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.arange(a.size).reshape(a.shape) / a.size
        if a.ndim == 2 else a, params)
    members = []
    for tree in unstack_members(jax.device_get(params)):
        m = MsImageDis(input_dim=input_dim, dim=8, n_layer=n_layer,
                       num_scales=num_scales)
        m.load_state_dict({k: _t(v) for k, v in export_ms_image_dis(
            tree, n_layer, num_scales).items()}, strict=True)
        members.append(m)
    return jdis, params, members


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 7, 10, 6)])
def test_avg_pool_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_avg_pool(jnp.asarray(x)))
    got = avg_pool_3x3_s2(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("input_dim", [3, 6])
def test_discriminator_matches_jax(input_dim):
    jdis, params, members = _dis_pair(input_dim, 1, n_layer=3,
                                      num_scales=3)
    x = np.random.default_rng(1).uniform(
        -1, 1, (2, 32, 32, input_dim)).astype(np.float32)
    p0 = jax.tree_util.tree_map(lambda a: a[0], params)
    want = jdis.apply({"params": p0}, jnp.asarray(x))
    got = members[0](_t(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        # f32 convs, sums in another order
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("gan_type", ["lsgan", "nsgan"])
def test_gan_losses_match_jax(gan_type):
    r = np.random.default_rng(2)
    fake = [r.standard_normal((2, s, s, 1)).astype(np.float32)
            for s in (8, 4)]
    real = [r.standard_normal((2, s, s, 1)).astype(np.float32)
            for s in (8, 4)]
    want_d = jgan.gan_dis_loss([jnp.asarray(a) for a in fake],
                               [jnp.asarray(a) for a in real], gan_type)
    want_g = jgan.gan_gen_loss([jnp.asarray(a) for a in fake], gan_type)
    got_d = gan.gan_dis_loss([_t(a) for a in fake], [_t(a) for a in real],
                             gan_type)
    got_g = gan.gan_gen_loss([_t(a) for a in fake], gan_type)
    np.testing.assert_allclose(float(got_d), float(want_d), rtol=1e-6)
    np.testing.assert_allclose(float(got_g), float(want_g), rtol=1e-6)
    with pytest.raises(ValueError, match="gan_type"):
        gan.gan_gen_loss([_t(a) for a in fake], "wgan")


def test_focus_losses_match_jax():
    mask = np.random.default_rng(3).uniform(0, 1, (3, 2, 9, 7, 1)).astype(
        np.float32)
    for name in ("mask_size_loss", "mask_binary_loss", "mask_tv_loss"):
        want = getattr(jfocus, name)(jnp.asarray(mask))
        got = getattr(focus, name)(_t(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)


def test_make_pairs_and_pair_mask_match_jax():
    r = np.random.default_rng(4)
    fakes = r.standard_normal((3, 2, 4, 4, 3)).astype(np.float32)
    x_in = r.standard_normal((2, 4, 4, 3)).astype(np.float32)
    for cond in (True, False):
        want = jcouncil.make_pairs(jnp.asarray(fakes), jnp.asarray(x_in),
                                   cond)
        got = council.make_pairs(_t(fakes), _t(x_in), cond)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jcouncil._pair_mask(2, 4, 1, 2)
    got = council._pair_mask(2, 4, 1, 2, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("polarity", ["own_real", "own_fake"])
@pytest.mark.parametrize("gan_type", ["lsgan", "nsgan"])
@torch.no_grad()
def test_council_losses_match_jax(polarity, gan_type):
    n = 3
    jdis, params, members = _dis_pair(6, n, seed=5)
    r = np.random.default_rng(6)
    fakes = r.uniform(-1, 1, (n, 2, 32, 32, 3)).astype(np.float32)
    x_in = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)

    def apply(p, x):
        return jdis.apply({"params": p}, x)

    jf, jx, tf, tx = jnp.asarray(fakes), jnp.asarray(x_in), _t(fakes), \
        _t(x_in)
    kw = dict(gan_type=gan_type, conditional=True, polarity=polarity)
    # f32 through the discriminators, sums in another order
    tol = dict(rtol=1e-5, atol=1e-6)

    want = jcouncil.council_gen_loss(apply, params, jf, jx, **kw)
    got = council.council_gen_loss(members, tf, tx, **kw)
    np.testing.assert_allclose(float(got), float(want), **tol)
    want = jcouncil.council_dis_loss(apply, params, jf, jx, **kw)
    got = council.council_dis_loss(members, tf, tx, **kw)
    np.testing.assert_allclose(float(got), float(want), **tol)

    # shard-local pieces: outputs 1..2 against every discriminator, and
    # discriminators 1..2 against every output
    want = jcouncil.council_gen_loss(apply, params, jf[1:], jx,
                                     out_offset=1, **kw)
    got = council.council_gen_loss(members, tf[1:], tx, out_offset=1, **kw)
    np.testing.assert_allclose(float(got), float(want), **tol)
    p12 = jax.tree_util.tree_map(lambda a: a[1:], params)
    want = jcouncil.council_dis_loss(apply, p12, jf, jx, dis_offset=1,
                                     n_total=n, **kw)
    got = council.council_dis_loss(members[1:], tf, tx, dis_offset=1,
                                   n_total=n, **kw)
    np.testing.assert_allclose(float(got), float(want), **tol)
    # remat recomputes the same numbers
    got_r = council.council_dis_loss(members[1:], tf, tx, dis_offset=1,
                                     n_total=n, remat=True, **kw)
    assert float(got_r) == float(got)


def test_council_dis_loss_of_a_single_member_is_zero():
    _, _, members = _dis_pair(6, 1)
    got = council.council_dis_loss(members, torch.zeros(1, 1, 32, 32, 3),
                                   torch.zeros(1, 32, 32, 3))
    assert float(got) == 0.0


@pytest.mark.parametrize("policy,mu_dtype", [("step", "float32"),
                                             ("step", "bfloat16"),
                                             ("constant", "float32")])
def test_optimizer_matches_optax(policy, mu_dtype):
    raw = {"lr": 1e-2, "beta1": 0.5, "beta2": 0.999, "weight_decay": 1e-3,
           "lr_policy": policy, "step_size": 3, "gamma": 0.5,
           "adam_mu_dtype": mu_dtype}
    jtx = jmake_optimizers(JConfig.from_dict(raw))[0]
    tx = make_optimizers(Config.from_dict(raw))[1]
    r = np.random.default_rng(7)
    shapes = [(4, 3, 3, 3), (5,), (2, 7)]
    p = [r.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(a) for a in p]
    js = jtx.init(jp)
    tp = [_t(a) for a in p]
    ts = tx.init(tp)
    # 8 updates cross the StepLR boundaries at counts 3 and 6
    for it in range(8):
        g = [r.standard_normal(s).astype(np.float32) for s in shapes]
        u, js = jtx.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, u)
        before = [a.clone() for a in tp]
        new, ts_new = tx.update(tp, [_t(a) for a in g], ts)
        # the update is functional: its inputs are left as they were
        assert all(torch.equal(a, b) for a, b in zip(tp, before))
        tp, ts = new, ts_new
        assert int(ts.count) == it + 1
        for a, b in zip(jp, tp):
            # the same f32 operations in the same order
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7,
                                       rtol=1e-6)
    assert ts.mu[0].dtype == (torch.bfloat16 if mu_dtype == "bfloat16"
                              else torch.float32)
    lr = tx.learning_rate(torch.tensor(7, dtype=torch.int32))
    want = 1e-2 * (0.25 if policy == "step" else 1.0)
    np.testing.assert_allclose(float(lr), want, rtol=1e-6)
