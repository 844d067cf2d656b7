"""The discriminator norms ``sn`` (spectral-norm conv) and ``bn`` (batch
norm) of councilx_torch against the JAX package's modules, state included.

Weights and state move JAX -> port through
``councilx_torch.ckpt.torch_export`` (``spectral_stats`` ``u`` ->
``conv.module.weight_u``; ``batch_stats`` -> ``norm.running_mean`` /
``running_var``); inputs from a seeded numpy generator; every case in f32,
where both sides do the same operations in other orders. Tolerances:
outputs within 1e-5 of their largest value, ``u`` and the running
statistics within 1e-6 absolute (unit vectors; statistics of O(1) data).
Also: both trainers refuse to train these norms -- the port's by design,
the JAX package's because its step applies the discriminators without
their variable collections.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from councilx.config import Config as JConfig
from councilx.nn.blocks import Conv2dBlock as JConv2dBlock
from councilx.nn.blocks import SpectralConv as JSpectralConv
from councilx.nn.discriminator import MsImageDis as JMsImageDis
from councilx.train.trainer import CouncilTrainer as JTrainer
from councilx_torch.ckpt.torch_export import (_conv_block_inv,
                                              export_ms_image_dis)
from councilx_torch.config import Config
from councilx_torch.nn.blocks import Conv2dBlock, SpectralConv
from councilx_torch.nn.discriminator import MsImageDis
from councilx_torch.train.trainer import CouncilTrainer
from test_torch_train_helpers import batch, raw_config

torch.set_num_threads(2)

OUT_REL = 1e-5
STATE_ATOL = 1e-6
STATS = {"sn": "spectral_stats", "bn": "batch_stats"}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=OUT_REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module


def _port_sn(jvars, in_dim, out_dim, k, stride=1):
    p = jvars["params"]
    sd = _conv_block_inv({"SpectralConv_0": p}, "x", "sn", stats={
        "SpectralConv_0": jvars["spectral_stats"]})
    conv = SpectralConv(in_dim, out_dim, k, stride)
    return _load(conv, {k[len("x.conv."):]: v for k, v in sd.items()})


def test_spectral_conv_matches_jax():
    """One training-mode call: output and the updated u (as
    tests/test_spectral.py checks the JAX module); then an eval-mode call
    uses the stored u and leaves it."""
    x = _x(0, (2, 8, 8, 4))
    m = JSpectralConv(features=6, kernel_size=(3, 3))
    jvars = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    conv = _port_sn(jvars, 4, 6, 3)
    y, mut = m.apply(jvars, jnp.asarray(x), mutable=["spectral_stats"])
    got = conv(torch.from_numpy(x))
    _close(got.detach(), y)
    u = conv.module.weight_u
    np.testing.assert_allclose(u.numpy(), mut["spectral_stats"]["u"],
                               rtol=0, atol=STATE_ATOL)
    # weight_v: the iteration's v in MUNIT's (I, kh, kw) order, so that
    # MUNIT's sigma = u @ W.view(O, -1) @ v is the JAX module's
    kernel = np.asarray(jvars["params"]["kernel"])
    w_mat = kernel.transpose(3, 0, 1, 2).reshape(6, -1)
    v = w_mat.T @ np.asarray(jvars["spectral_stats"]["u"])
    v /= np.linalg.norm(v) + 1e-12
    w = conv.module.weight_bar.detach().reshape(6, -1)
    np.testing.assert_allclose(float(u @ (w @ conv.module.weight_v)),
                               float(u.numpy() @ (w_mat @ v)), rtol=1e-5)
    y2 = m.apply({"params": jvars["params"], **mut}, jnp.asarray(x))
    conv.eval()
    _close(conv(torch.from_numpy(x)).detach(), y2)
    assert torch.equal(conv.module.weight_u, u)


def test_spectral_u_converges_to_the_top_singular_value():
    """50 training-mode calls on both sides: u equal to JAX's, and sigma
    within rtol 1e-3 of the kernel's largest singular value."""
    x = _x(1, (1, 6, 6, 3))
    m = JSpectralConv(features=5, kernel_size=(3, 3))
    jvars = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    conv = _port_sn(jvars, 3, 5, 3)
    state = jvars
    for _ in range(50):
        _, mut = m.apply(state, jnp.asarray(x), mutable=["spectral_stats"])
        state = {"params": jvars["params"], **mut}
        conv(torch.from_numpy(x))
    u = conv.module.weight_u.numpy()
    np.testing.assert_allclose(u, state["spectral_stats"]["u"], rtol=0,
                               atol=1e-5)
    kernel = np.asarray(jvars["params"]["kernel"])
    w_mat = kernel.transpose(3, 0, 1, 2).reshape(5, -1)
    v = w_mat.T @ u
    v /= np.linalg.norm(v)
    np.testing.assert_allclose(float(u @ (w_mat @ v)),
                               np.linalg.svd(w_mat, compute_uv=False)[0],
                               rtol=1e-3)


def test_bn_conv2dblock_matches_flax():
    """Conv2dBlock(norm='bn'), 4x4 stride 2 as in the discriminator: 3
    training-mode calls (outputs, running mean and var after each), then an
    eval-mode call (batch statistics, running ones untouched)."""
    blk = JConv2dBlock(8, 4, 2, 1, norm="bn", activation="lrelu",
                       pad_type="reflect")
    xs = [_x(2 + i, (3, 16, 16, 4)) for i in range(4)]
    jvars = blk.init(jax.random.PRNGKey(2), jnp.asarray(xs[0]))
    # a non-trivial affine
    jvars["params"]["BatchNorm_0"]["scale"] = jnp.linspace(0.5, 1.5, 8)
    jvars["params"]["BatchNorm_0"]["bias"] = jnp.linspace(-0.2, 0.2, 8)
    sd = _conv_block_inv(jvars["params"], "x", "bn",
                         stats=jvars["batch_stats"])
    port = _load(Conv2dBlock(4, 8, 4, 2, 1, norm="bn", activation="lrelu",
                             pad_type="reflect"),
                 {k[len("x."):]: v for k, v in sd.items()})
    for x in xs[:3]:
        y, mut = blk.apply(jvars, jnp.asarray(x), mutable=["batch_stats"])
        jvars = {"params": jvars["params"], **mut}
        _close(port(torch.from_numpy(x)).detach(), y)
        st = mut["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(port.norm.running_mean.numpy(),
                                   st["mean"], rtol=0, atol=STATE_ATOL)
        np.testing.assert_allclose(port.norm.running_var.numpy(),
                                   st["var"], rtol=0, atol=STATE_ATOL)
    assert int(port.norm.num_batches_tracked) == 3
    before = {k: v.clone() for k, v in port.state_dict().items()}
    y, _ = blk.apply(jvars, jnp.asarray(xs[3]), mutable=["batch_stats"])
    port.eval()
    _close(port(torch.from_numpy(xs[3])).detach(), y)
    assert all(torch.equal(v, before[k]) for k, v in
               port.state_dict().items())


@pytest.mark.parametrize("norm", ["sn", "bn", "in", "ln"])
def test_ms_image_dis_matches_flax(norm):
    """MsImageDis (dim 8, 3 layers, 2 scales, 32px) with the norm on its
    inner blocks: every scale's logits and the state after 3
    training-mode calls, then an eval-mode call."""
    jm = JMsImageDis(input_dim=3, dim=8, n_layer=3, norm=norm, num_scales=2)
    xs = [_x(10 + i, (2, 32, 32, 3)) for i in range(4)]
    jvars = jm.init(jax.random.PRNGKey(3), jnp.asarray(xs[0]))
    coll = STATS.get(norm)
    port = MsImageDis(3, 8, 3, norm=norm, num_scales=2)

    def carried(v):
        return export_ms_image_dis(v["params"], 3, 2, norm,
                                   stats=v.get(coll) if coll else None)

    _load(port, carried(jvars))
    mutable = [coll] if coll else False
    for x in xs[:3]:
        out = jm.apply(jvars, jnp.asarray(x), mutable=mutable)
        ys, mut = out if coll else (out, {})
        jvars = {"params": jvars["params"], **mut}
        got = port(torch.from_numpy(x))
        for g, w in zip(got, ys):
            _close(g.detach(), w)
        if coll:
            want = carried(jvars)
            state = port.state_dict()
            for k in want:
                if k.endswith(("weight_u", "running_mean", "running_var")):
                    np.testing.assert_allclose(
                        state[k].numpy(), want[k], rtol=0,
                        atol=STATE_ATOL, err_msg=k)
    port.eval()
    out = jm.apply(jvars, jnp.asarray(xs[3]),
                   mutable=["batch_stats"] if norm == "bn" else False)
    ys = out[0] if norm == "bn" else out
    for g, w in zip(port(torch.from_numpy(xs[3])), ys):
        _close(g.detach(), w)


@pytest.mark.parametrize("norm", ["sn", "bn"])
def test_trainers_refuse_stateful_dis_norms(norm):
    """The port refuses dis.norm sn/bn when it builds its trainer; the JAX
    trainer builds and inits, then its first step misses the collection.
    If that step ever trains, the port's refusal should become a feature."""
    raw = raw_config(dis={"norm": norm})
    with pytest.raises(ValueError, match=STATS[norm]):
        CouncilTrainer(Config.from_dict(raw), device="cpu")
    jt = JTrainer(JConfig.from_dict(raw))
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0))
    x_a, x_b = batch()
    try:
        jt.train_step(state, jnp.asarray(x_a), jnp.asarray(x_b))
    except flax.errors.ScopeCollectionNotFound as e:
        assert STATS[norm] in str(e)
    else:
        pytest.fail(f"the JAX trainer now trains dis.norm={norm!r}: "
                    "councilx_torch's CouncilTrainer should train it too")
