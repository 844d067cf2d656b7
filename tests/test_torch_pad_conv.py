"""councilx_torch.ops.pad_conv, the pad-1 conv and the fuse_pad blocks
against the JAX package, on the CPU in f32.

The same numpy inputs from a seed go through ``councilx/ops/pad_conv.py``
(precision "highest") and the port. Tolerances are the JAX package's own
(tests/test_ops.py): values atol 2e-5 / rtol 1e-5; gradients of
sum(sin(y)) against ``jax.grad`` at 3e-5 / 1e-4, or 5e-5 / 1e-3 where an
IN is folded in. The cases are tests/test_ops.py's: pad types reflect,
replicate and zero, H x W (4, 4), (5, 7), (8, 8) and (16, 12), K = 3 and
7, every engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from councilx.nn.blocks import Conv2dBlock as JConv2dBlock
from councilx.nn.blocks import ResBlocks as JResBlocks
from councilx.nn.blocks import apply_instance_norm as japply_in
from councilx.ops import pad_conv as jpc
from councilx_torch.ckpt.torch_export import _conv_block_inv, _res_blocks_inv
from councilx_torch.nn.blocks import Conv2dBlock, ResBlocks
from councilx_torch.ops import pad_conv as pc
from councilx_torch.ops.conv3x3 import (conv3x3_dgrad_reference,
                                        conv3x3_same_zero,
                                        conv3x3_same_zero_reference,
                                        conv3x3_valid_reference,
                                        conv3x3_wgrad_reference)

torch.set_num_threads(2)

PAD_TYPES = ("reflect", "replicate", "zero")
HWS = ((4, 4), (5, 7), (8, 8), (16, 12))
ENGINES = ("auto", "phase", "strips", "reference")
VAL_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=3e-5, rtol=1e-4)
NORM_GRAD_TOL = dict(atol=5e-5, rtol=1e-3)


def _inputs(seed, shape, k, cin, cout):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape + (cin,)).astype(np.float32)
    kk = (r.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = (r.standard_normal(cout) * 0.1).astype(np.float32)
    return x, kk, b


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _load(module, sd, prefix):
    n = len(prefix) + 1
    module.load_state_dict({k[n:]: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("k", (3, 7))
@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("pad_type", PAD_TYPES)
def test_conv2d_same_matches_jax(pad_type, hw, k, engine):
    # 6 -> 5 channels: channel-starved, so "auto" takes phase where H and
    # W are even
    x, kk, b = _inputs(0, (2,) + hw, k, 6, 5)
    want = np.asarray(jpc.conv2d_same(jnp.asarray(x), jnp.asarray(kk),
                                      jnp.asarray(b), pad_type,
                                      precision="highest", engine=engine))
    got = pc.conv2d_same(*_t(x, kk, b), pad_type, engine)
    assert got.shape == (2,) + hw + (5,)
    np.testing.assert_allclose(got.numpy(), want, **VAL_TOL)


@pytest.mark.parametrize("hw,k,cin,cout", [
    ((8, 8), 3, 24, 24), ((5, 7), 3, 24, 24), ((8, 6), 7, 24, 20),
    ((12, 12), 7, 3, 64), ((12, 12), 7, 64, 3), ((2, 3), 3, 24, 24)])
def test_conv2d_same_routes_match_jax(hw, k, cin, cout):
    """"auto" on shapes that are not channel-starved (strips, K1's
    interior at K = 3), the boundary convs' shapes (phase), and an input
    under 2P (the reference path)."""
    x, kk, b = _inputs(1, (2,) + hw, k, cin, cout)
    want = np.asarray(jpc.conv2d_same(jnp.asarray(x), jnp.asarray(kk),
                                      jnp.asarray(b), "reflect",
                                      precision="highest"))
    got = pc.conv2d_same(*_t(x, kk, b), "reflect")
    np.testing.assert_allclose(got.numpy(), want, **VAL_TOL)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("k", (3, 7))
def test_conv2d_same_gradients_match_jax(k, engine):
    x, kk, b = _inputs(5, (1, 8, 8), k, 4, 3)

    def loss(x_, k_, b_):
        return jnp.sum(jnp.sin(jpc.conv2d_same(
            x_, k_, b_, "reflect", precision="highest", engine=engine)))

    want = jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, (x, kk, b)))
    ts = _t(x, kk, b, grad=True)
    torch.sin(pc.conv2d_same(*ts, "reflect", engine)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_phase_packed_kernel_matches_jax():
    _, kk, _ = _inputs(2, (1, 4, 4), 7, 3, 4)
    np.testing.assert_array_equal(
        pc._phase_packed_kernel(torch.from_numpy(kk)).numpy(),
        np.asarray(jpc._phase_packed_kernel(jnp.asarray(kk))))


@pytest.mark.parametrize("pad_type", ("reflect", "replicate"))
@pytest.mark.parametrize("hw", ((8, 8), (16, 12)))
def test_conv2d_same_phase_matches_jax(pad_type, hw):
    x, kk, b = _inputs(3, (2,) + hw, 7, 3, 8)
    want = np.asarray(jpc.conv2d_same_phase(
        jnp.asarray(x), jnp.asarray(kk), jnp.asarray(b), pad_type,
        precision="highest"))
    got = pc.conv2d_same_phase(*_t(x, kk, b), pad_type)
    np.testing.assert_allclose(got.numpy(), want, **VAL_TOL)
    ref = np.asarray(jpc.conv2d_same_reference(
        jnp.asarray(x), jnp.asarray(kk), jnp.asarray(b), pad_type,
        precision="highest"))
    np.testing.assert_allclose(
        pc.conv2d_same_reference(*_t(x, kk, b), pad_type).numpy(), ref,
        **VAL_TOL)


_ACTS = {"relu": (torch.relu, jax.nn.relu), "tanh": (torch.tanh, jnp.tanh),
         "none": (None, None)}


@pytest.mark.parametrize("pad_type", ("reflect", "replicate"))
@pytest.mark.parametrize("norm,act", [("in", "relu"), ("in", "none"),
                                      ("none", "tanh"), ("none", "relu")])
def test_phase_fused_matches_jax(norm, act, pad_type):
    x, kk, b = _inputs(4, (2, 12, 10), 7, 3, 8)
    tact, jact = _ACTS[act]
    want = np.asarray(jpc.conv2d_same_phase_fused(
        jnp.asarray(x), jnp.asarray(kk), jnp.asarray(b), pad_type,
        norm=norm, in_precision="f32", act=jact, precision="highest"))
    got = pc.conv2d_same_phase_fused(*_t(x, kk, b), pad_type, norm, tact)
    assert got.shape == (2, 12, 10, 8)
    np.testing.assert_allclose(got.numpy(), want, **VAL_TOL)


def test_phase_fused_gradients_match_jax():
    """Against the unfused JAX path (pad + conv, then IN), as
    tests/test_ops.py holds the JAX function."""
    x, kk, b = _inputs(10, (1, 8, 8), 7, 3, 4)

    def loss(x_, k_, b_):
        y = japply_in(jpc.conv2d_same_reference(
            x_, k_, b_, "reflect", precision="highest"), "f32")
        return jnp.sum(jnp.sin(y))

    want = jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, (x, kk, b)))
    ts = _t(x, kk, b, grad=True)
    torch.sin(pc.conv2d_same_phase_fused(*ts, "reflect", "in")).sum(
    ).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **NORM_GRAD_TOL)


@pytest.mark.parametrize("hw,c,o", [((6, 5), 8, 16), ((7, 9), 12, 20),
                                    ((1, 1), 3, 2)])
def test_conv3x3_same_zero_plain_version(hw, c, o):
    """The pad-1 op on the CPU is its plain version: zero pad, then
    conv3x3_valid_reference; its gradients are those of F.conv2d with
    padding 1, and of the plain dgrad and wgrad at pad 1."""
    r = np.random.default_rng(7)
    x = torch.tensor(r.standard_normal((2,) + hw + (c,)), requires_grad=True)
    k = torch.tensor(r.standard_normal((3, 3, c, o)), requires_grad=True)
    g = torch.tensor(r.standard_normal((2,) + hw + (o,)))
    y = conv3x3_same_zero(x, k)
    want = conv3x3_valid_reference(F.pad(x, (0, 0, 1, 1, 1, 1)), k)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    torch.testing.assert_close(conv3x3_same_zero_reference(x, k), want,
                               rtol=0, atol=0)
    dx, dk = torch.autograd.grad(y, (x, k), g)
    xl = x.detach().permute(0, 3, 1, 2).requires_grad_()
    kl = k.detach().permute(3, 2, 0, 1).requires_grad_()
    yl = F.conv2d(xl, kl, padding=1)
    dxl, dkl = torch.autograd.grad(yl, (xl, kl), g.permute(0, 3, 1, 2))
    torch.testing.assert_close(dx, dxl.permute(0, 2, 3, 1), rtol=1e-10,
                               atol=1e-10)
    torch.testing.assert_close(dk, dkl.permute(2, 3, 1, 0), rtol=1e-10,
                               atol=1e-10)
    torch.testing.assert_close(conv3x3_dgrad_reference(g, k.detach(), 1),
                               dx, rtol=0, atol=0)
    torch.testing.assert_close(
        conv3x3_wgrad_reference(x.detach(), g, 1), dk, rtol=1e-10,
        atol=1e-10)


def test_conv3x3_same_zero_matches_jax():
    """K1's pad-1 op against JAX's zero-padded conv (the strips engine's
    interior in the JAX package), values and gradients."""
    x, kk, _ = _inputs(8, (2, 9, 7), 3, 16, 24)

    def conv(x_, k_):
        return jax.lax.conv_general_dilated(
            x_, k_, (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")

    xj, kj = jnp.asarray(x), jnp.asarray(kk)
    ts = _t(x, kk, grad=True)
    y = conv3x3_same_zero(*ts)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(conv(xj, kj)),
                               **VAL_TOL)
    torch.sin(y).sum().backward()
    want = jax.grad(lambda a, b: jnp.sum(jnp.sin(conv(a, b))), (0, 1))(xj, kj)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("engine", ("auto", "phase_fused", "phase", "strips",
                                    "reference"))
@pytest.mark.parametrize("cin,cout,norm,act", [
    (3, 8, "in", "relu"), (24, 4, "none", "tanh"), (24, 24, "in", "relu"),
    (3, 8, "none", "prelu")])
def test_fuse_pad_block_matches_jax(engine, cin, cout, norm, act):
    """Conv2dBlock(fuse_pad=True) against the flax block at each
    boundary_engine, forward and the gradient of its input and weight: the
    starved 7x7 boundary shapes (phase_fused under auto), a shape that is
    not starved (strips), and prelu (no fused tail)."""
    r = np.random.default_rng(9)
    x = r.standard_normal((2, 10, 8, cin)).astype(np.float32)
    jblk = JConv2dBlock(cout, 7, 1, 3, norm=norm, activation=act,
                        pad_type="reflect", fuse_pad=True,
                        boundary_engine=engine)
    params = jax.device_get(
        jblk.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])

    def loss(p, xx):
        return jnp.sum(jnp.sin(jblk.apply({"params": p}, xx)))

    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(loss, (0, 1))(params, jnp.asarray(x))
    tblk = Conv2dBlock(cin, cout, 7, 1, 3, norm=norm, activation=act,
                       pad_type="reflect", fuse_pad=True,
                       boundary_engine=engine)
    sd = _conv_block_inv(params, "blk", norm=norm)
    if act == "prelu":
        sd["blk.activation.weight"] = params["prelu_alpha"]
    _load(tblk, sd, "blk")
    xt = torch.tensor(x, requires_grad=True)
    got = tblk(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL_TOL)
    torch.sin(got).sum().backward()
    tol = NORM_GRAD_TOL if norm == "in" else GRAD_TOL
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(
        tblk.conv.weight.grad.permute(2, 3, 1, 0).numpy(),
        np.asarray(gp["Conv_0"]["kernel"]), **tol)


@pytest.mark.parametrize("norm", ["in", "adain"])
def test_resblocks_fuse_pad_match_jax(norm):
    """ResBlocks(fuse_pad=True) (the strips engine on K1's pad-1 op at a
    width that is not starved) against the flax stack, values and input
    gradients; the derived weights are made in the graph there, and once
    with gradients off (the serving path), which must agree."""
    r = np.random.default_rng(4)
    dim, n_blocks = 24, 2
    x = r.standard_normal((2, 8, 6, dim)).astype(np.float32)
    jrb = JResBlocks(n_blocks, dim, norm=norm, activation="relu",
                     pad_type="reflect", fuse_pad=True)
    pairs = ([(r.standard_normal((2, dim)).astype(np.float32),
               r.standard_normal((2, dim)).astype(np.float32))
              for _ in range(2 * n_blocks)] if norm == "adain" else None)
    jpairs = ([(jnp.asarray(g), jnp.asarray(b)) for g, b in pairs]
              if pairs else None)
    params = jax.device_get(
        jrb.init(jax.random.PRNGKey(5), jnp.asarray(x), jpairs)["params"])
    want = np.asarray(jrb.apply({"params": params}, jnp.asarray(x), jpairs))
    gx = jax.grad(lambda xx: jnp.sum(jnp.sin(jrb.apply(
        {"params": params}, xx, jpairs))))(jnp.asarray(x))
    trb = ResBlocks(n_blocks, dim, norm=norm, activation="relu",
                    pad_type="reflect", fuse_pad=True)
    _load(trb, _res_blocks_inv(params, "blk", n_blocks, norm=norm, dim=dim),
          "blk")
    tpairs = ([(torch.from_numpy(g), torch.from_numpy(b)) for g, b in pairs]
              if pairs else None)
    xt = torch.tensor(x, requires_grad=True)
    got = trb(xt, tpairs)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5,
                               rtol=1e-5)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               **NORM_GRAD_TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(trb(torch.from_numpy(x),
                                          tpairs).numpy(),
                                      got.detach().numpy())
