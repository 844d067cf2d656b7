"""councilx_torch.ops.upsample_conv's engines and the fused-upsample block
against the JAX package, on the CPU in f32.

The same numpy inputs from a seed go through ``councilx/ops/
upsample_conv.py`` (precision "highest") and the port: the dilated and
phase engines of ``upsample2x_conv5x5``, the border strips and the under-4x4
fallback, and ``upsample2x_conv5x5_ln_fused``. Tolerances are the JAX
package's own (tests/test_ops.py, tests/test_round5.py): values atol 2e-5 /
rtol 1e-5 (3e-5 / 1e-4 with the LN folded in); gradients of sum(sin(y))
against ``jax.grad`` at 3e-5 / 1e-4, or 5e-5 / 1e-3 where the LN is folded
in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from councilx.nn.blocks import Conv2dBlock as JConv2dBlock
from councilx.nn.blocks import norm_mean_var as jnorm_mean_var
from councilx.ops import upsample_conv as juc
from councilx_torch.ckpt.torch_export import _conv_block_inv
from councilx_torch.nn.blocks import Conv2dBlock, MunitLayerNorm
from councilx_torch.ops import upsample_conv as uc

torch.set_num_threads(2)

PAD_TYPES = ("reflect", "replicate", "zero")
HWS = ((4, 4), (5, 7), (8, 8), (16, 12))
VAL_TOL = dict(atol=2e-5, rtol=1e-5)
LN_VAL_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=3e-5, rtol=1e-4)
LN_GRAD_TOL = dict(atol=5e-5, rtol=1e-3)


def _inputs(seed, shape, cin, cout):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape + (cin,)).astype(np.float32)
    k = (r.standard_normal((5, 5, cin, cout)) * 0.1).astype(np.float32)
    b = (r.standard_normal(cout) * 0.1).astype(np.float32)
    g = (np.abs(r.standard_normal(cout)) + 0.5).astype(np.float32)
    bt = (r.standard_normal(cout) * 0.1).astype(np.float32)
    return x, k, b, g, bt


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _ln(gamma, beta, precision="f32", stats="two_pass"):
    ln = MunitLayerNorm(gamma.shape[0], precision=precision, stats=stats)
    ln.gamma = torch.nn.Parameter(gamma)
    ln.beta = torch.nn.Parameter(beta)
    return ln


def _jln_reference(y, gamma, beta, eps=1e-5, stats="two_pass", act=None):
    """The unfused JAX LayerNorm in f32 (tests/test_round5.py's)."""
    axes = tuple(range(1, y.ndim))
    n = int(np.prod(y.shape[1:]))
    mean, var = jnorm_mean_var(y, axes, stats)
    out = (y - mean) / (jnp.sqrt(var * (n / (n - 1))) + eps) * gamma + beta
    return act(out) if act is not None else out


@pytest.mark.parametrize("engine", ("dilated", "phase"))
@pytest.mark.parametrize("hw", HWS + ((3, 5),))
@pytest.mark.parametrize("pad_type", PAD_TYPES)
def test_upsample_conv_matches_jax(pad_type, hw, engine):
    """Both interior engines, their border strips, and the under-4x4
    fallback ((3, 5))."""
    x, k, b, _, _ = _inputs(0, (2,) + hw, 6, 8)
    want = np.asarray(juc.upsample2x_conv5x5(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), pad_type,
        precision="highest", engine=engine))
    got = uc.upsample2x_conv5x5(*_t(x, k, b), pad_type, engine)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 8)
    np.testing.assert_allclose(got.numpy(), want, **VAL_TOL)


@pytest.mark.parametrize("engine", ("dilated", "phase"))
def test_upsample_conv_gradients_match_jax(engine):
    x, k, b, _, _ = _inputs(1, (1, 8, 8), 4, 3)

    def loss(x_, k_, b_):
        return jnp.sum(jnp.sin(juc.upsample2x_conv5x5(
            x_, k_, b_, "reflect", precision="highest", engine=engine)))

    want = jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, (x, k, b)))
    ts = _t(x, k, b, grad=True)
    torch.sin(uc.upsample2x_conv5x5(*ts, "reflect", engine)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_derived_kernels_match_jax():
    """The 6x6 dilated kernel bit for bit; the phase kernels within f32
    rounding (the JAX einsum's sums, in another order)."""
    _, k, _, _, _ = _inputs(2, (1, 4, 4), 6, 8)
    np.testing.assert_array_equal(
        uc._dilated_kernel(torch.from_numpy(k)).numpy(),
        np.asarray(juc._dilated_kernel(jnp.asarray(k))))
    np.testing.assert_allclose(
        uc.phase_kernels(torch.from_numpy(k), torch.float32).numpy(),
        np.asarray(juc._phase_kernels(jnp.asarray(k), "highest")),
        atol=1e-6, rtol=1e-6)


def test_strips_to_phase_layout_match_jax():
    r = np.random.default_rng(3)
    row = r.standard_normal((2, 2, 10, 3)).astype(np.float32)
    col = r.standard_normal((2, 8, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        uc._strip_to_phase_row(torch.from_numpy(row)).numpy(),
        np.asarray(juc._strip_to_phase_row(jnp.asarray(row))))
    np.testing.assert_array_equal(
        uc._strip_to_phase_col(torch.from_numpy(col)).numpy(),
        np.asarray(juc._strip_to_phase_col(jnp.asarray(col))))


@pytest.mark.parametrize("hw", ((4, 4), (8, 6), (16, 12), (3, 5)))
@pytest.mark.parametrize("pad_type", PAD_TYPES)
def test_ln_fused_matches_jax(pad_type, hw):
    x, k, b, g, bt = _inputs(4, (2,) + hw, 4, 4)
    want = np.asarray(juc.upsample2x_conv5x5_ln_fused(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), pad_type,
        jnp.asarray(g), jnp.asarray(bt), ln_precision="f32",
        act=jax.nn.relu, precision="highest"))
    xt, kt, btt = _t(x, k, b)
    got = uc.upsample2x_conv5x5_ln_fused(
        xt, kt, btt, pad_type, _ln(*_t(g, bt)), torch.relu)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 4)
    np.testing.assert_allclose(got.detach().numpy(), want, **LN_VAL_TOL)


@pytest.mark.parametrize("precision", ("f32", "mixed", "bf16"))
@pytest.mark.parametrize("stats", ("two_pass", "one_pass"))
def test_ln_fused_precision_and_stats_modes(precision, stats):
    """At f32 input every precision is the unfused LN's formula."""
    x, k, b, g, bt = _inputs(5, (2, 6, 6), 4, 4)
    want = np.asarray(_jln_reference(
        juc.upsample2x_conv5x5_reference(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), "reflect",
            precision="highest"), jnp.asarray(g), jnp.asarray(bt),
        stats=stats))
    got = uc.upsample2x_conv5x5_ln_fused(
        *_t(x, k, b), "reflect", _ln(*_t(g, bt), precision, stats))
    np.testing.assert_allclose(got.detach().numpy(), want, **LN_VAL_TOL)


def test_ln_fused_gradients_match_jax():
    x, k, b, g, bt = _inputs(6, (1, 8, 8), 4, 3)

    def loss(x_, k_, b_, g_, bt_):
        return jnp.sum(jnp.sin(juc.upsample2x_conv5x5_ln_fused(
            x_, k_, b_, "reflect", g_, bt_, ln_precision="f32",
            act=jax.nn.relu, precision="highest")))

    want = jax.grad(loss, (0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, k, b, g, bt)))
    xt, kt, btt, gt, bett = _t(x, k, b, g, bt, grad=True)
    ln = _ln(gt, bett)
    torch.sin(uc.upsample2x_conv5x5_ln_fused(
        xt, kt, btt, "reflect", ln, torch.relu)).sum().backward()
    for t, w in zip((xt, kt, btt, ln.gamma, ln.beta), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **LN_GRAD_TOL)


@pytest.mark.parametrize("engine,fuse", [("dilated", True), ("phase", True),
                                         ("ln_fused", True),
                                         ("dilated", False)])
def test_upsample_block_matches_jax(engine, fuse):
    """The decoder's upsample block (upsample2x, 5x5, 'ln', relu) against
    the flax block under each ``upsample_engine`` and without
    ``fuse_upsample``: output, and the gradients of its input, conv weight
    and LN gamma."""
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 6, 5, 8)).astype(np.float32)
    jblk = JConv2dBlock(4, 5, 1, 2, norm="ln", activation="relu",
                        pad_type="reflect", upsample2x=True,
                        fuse_upsample=fuse, upsample_engine=engine)
    params = jax.device_get(
        jblk.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jnp.sin(jblk.apply(
        {"params": p}, xx))), (0, 1))(params, jnp.asarray(x))
    tblk = Conv2dBlock(8, 4, 5, 1, 2, norm="ln", activation="relu",
                       pad_type="reflect", upsample2x=True,
                       fuse_upsample=fuse, upsample_engine=engine)
    sd = _conv_block_inv(params, "blk", norm="ln")
    tblk.load_state_dict({k[4:]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    xt = torch.tensor(x, requires_grad=True)
    got = tblk(xt)
    assert got.shape == (2, 12, 10, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, **LN_VAL_TOL)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               **LN_GRAD_TOL)
    np.testing.assert_allclose(
        tblk.conv.weight.grad.permute(2, 3, 1, 0).numpy(),
        np.asarray(gp["Conv_0"]["kernel"]), **LN_GRAD_TOL)
    np.testing.assert_allclose(tblk.norm.gamma.grad.numpy(),
                               np.asarray(gp["MunitLayerNorm_0"]["gamma"]),
                               **LN_GRAD_TOL)


@pytest.mark.parametrize("kind", ("dilated", "phase", "packed"))
def test_derived_weight_is_made_once_per_weight_version(kind):
    """With gradients off a block's derived weight is made once and kept
    until the weight changes; under autograd it is made in the graph."""
    blk = Conv2dBlock(8, 4, 5, 1, 2, norm="ln", upsample2x=True)
    torch.nn.init.normal_(blk.conv.weight)
    with torch.no_grad():
        a = blk.derived_weight(kind, torch.float32)
        assert blk.derived_weight(kind, torch.float32) is a
        assert blk.derived_weight(kind, torch.bfloat16) is not a
        blk.conv.weight.mul_(2.0)
        b = blk.derived_weight(kind, torch.float32)
    assert b is not a
    torch.testing.assert_close(b, 2.0 * a, rtol=1e-6, atol=1e-6)
    with torch.inference_mode():
        c = blk.derived_weight(kind, torch.float16)
    assert not c.is_inference()
    d = blk.derived_weight(kind, torch.float32)
    assert d.requires_grad and d.grad_fn is not None
    torch.testing.assert_close(d.detach(), b, rtol=0, atol=0)
