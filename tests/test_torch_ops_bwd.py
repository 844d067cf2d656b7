"""Backward of councilx_torch's kernel sites vs the JAX package's Pallas VJPs.

On the CPU the port's autograd Functions run the plain versions of the
backward kernels (``conv3x3_dgrad_reference``, ``conv3x3_wgrad_reference``,
``instance_norm_backward_reference``); they are held against ``jax.vjp`` of
``conv3x3_valid`` and ``instance_norm_pallas``, whose Pallas kernels run in
interpret mode, as tests/test_pallas_conv.py and tests/test_pallas_norm.py
run them. The backward kernels themselves run only on a GPU:
tests/test_torch_cuda.py compares each with its plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from councilx.ops.pallas_conv import conv3x3_valid as jax_conv3x3_valid
from councilx.ops.pallas_norm import instance_norm_pallas
from councilx_torch.ops import conv3x3 as conv_ops
from councilx_torch.ops.conv3x3 import (Conv3x3Valid, conv3x3_dgrad_reference,
                                        conv3x3_valid, conv3x3_wgrad,
                                        conv3x3_wgrad_reference)
from councilx_torch.ops.instance_norm import (InstanceNorm, instance_norm,
                                              instance_norm_backward_reference,
                                              instance_norm_forward_reference)

torch.set_num_threads(2)


def _interp(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        with pltpu.force_tpu_interpret_mode():
            return fn(*args, **kw)
    return run


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# plain backward versions vs the JAX Pallas VJPs (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2])
def test_conv3x3_backward_references_match_pallas_vjp(b):
    r = np.random.default_rng(b)
    h = w = 8
    c = 128
    xp = r.standard_normal((b, h + 2, w + 2, c)).astype(np.float32)
    k = (r.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    g = r.standard_normal((b, h, w, c)).astype(np.float32)

    @_interp
    def vjp(xp, k, g):
        _, f = jax.vjp(jax_conv3x3_valid, xp, k)
        return f(g)

    want_dxp, want_dk = (np.asarray(a) for a in vjp(jnp.asarray(xp),
                                                    jnp.asarray(k),
                                                    jnp.asarray(g)))
    got_dxp = conv3x3_dgrad_reference(_t(g), _t(k)).numpy()
    got_dk = conv3x3_wgrad_reference(_t(xp), _t(g)).numpy()
    # f32 sums of 9*C (dgrad) and B*H*W (wgrad) products in another order
    np.testing.assert_allclose(got_dxp, want_dxp, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got_dk, want_dk, atol=2e-4, rtol=1e-4)
    # the autograd Function returns the same through conv3x3_valid
    xt, kt = _t(xp).requires_grad_(), _t(k).requires_grad_()
    dxp, dk = torch.autograd.grad(conv3x3_valid(xt, kt), (xt, kt), _t(g))
    np.testing.assert_allclose(dxp.numpy(), got_dxp, atol=0, rtol=0)
    np.testing.assert_allclose(dk.numpy(), got_dk, atol=0, rtol=0)


def _conv_kernel_contract(x, wk, pad, dgrad):
    """What csrc/conv3x3.cu computes, in plain PyTorch: x (B, Hin, Win, C),
    zero outside, with the forward conv's kernel weight wk -> (B, Hin + 2
    pad - 2, Win + 2 pad - 2, O). The forward reads wk (3, 3, O, C) as
    wk[t][o][c]; the dgrad reads wk (3, 3, C, O) with its taps flipped, as
    wk[8-t][c][o]."""
    xz = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    h, w = xz.shape[1] - 2, xz.shape[2] - 2
    taps = wk.flip((0, 1)) if dgrad else wk.transpose(2, 3)
    return sum(xz[:, dy:dy + h, dx:dx + w] @ taps[dy, dx]
               for dy in range(3) for dx in range(3))


@pytest.mark.parametrize("b,h,w,c,o", [(2, 8, 8, 128, 128),
                                       (2, 5, 7, 16, 24), (3, 4, 3, 72, 136)])
def test_conv_kernel_layouts_match_the_references(b, h, w, c, o):
    """The kernel's weight layout and in-kernel zero pad: the forward (pad
    0 on xp) and the dgrad (pad 2 on the unpadded g), both with the kernel
    weight ``_kernel_weight`` makes, give the plain versions, and at 128
    channels the JAX package's conv3x3_valid and its VJP (Pallas,
    interpret mode)."""
    r = np.random.default_rng(b + c)
    xp = r.standard_normal((b, h + 2, w + 2, c)).astype(np.float32)
    k = (r.standard_normal((3, 3, c, o)) / (9 * c) ** 0.5).astype(np.float32)
    g = r.standard_normal((b, h, w, o)).astype(np.float32)
    wk = conv_ops._kernel_weight(_t(k), torch.float32)
    y = _conv_kernel_contract(_t(xp), wk, 0, False)
    dxp = _conv_kernel_contract(_t(g), wk, 2, True)
    assert y.shape == (b, h, w, o) and dxp.shape == xp.shape
    # f32 sums of 9*C (forward) or 9*O (dgrad) products in another order
    np.testing.assert_allclose(
        y.numpy(), conv_ops.conv3x3_valid_reference(_t(xp), _t(k)).numpy(),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        dxp.numpy(), conv3x3_dgrad_reference(_t(g), _t(k)).numpy(),
        atol=1e-5, rtol=1e-5)
    if c % 128 == 0 and o % 128 == 0:
        @_interp
        def fwd_vjp(xp, k, g):
            y, f = jax.vjp(jax_conv3x3_valid, xp, k)
            return y, f(g)[0]

        want_y, want_dxp = (np.asarray(a) for a in fwd_vjp(
            jnp.asarray(xp), jnp.asarray(k), jnp.asarray(g)))
        np.testing.assert_allclose(y.numpy(), want_y, atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(dxp.numpy(), want_dxp, atol=2e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_backward_reference_matches_pallas_vjp(affine, dtype):
    r = np.random.default_rng(3)
    b, h, w, c = 2, 8, 8, 16
    x = (r.standard_normal((b, h, w, c)) * 2 + 0.5).astype(np.float32)
    gm = r.standard_normal((b, c)).astype(np.float32)
    bt = r.standard_normal((b, c)).astype(np.float32)
    dy = r.standard_normal((b, h, w, c)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    args = (jnp.asarray(x, jdt),) + ((jnp.asarray(gm), jnp.asarray(bt))
                                      if affine else ())

    @_interp
    def vjp(dy, *args):
        _, f = jax.vjp(instance_norm_pallas, *args)
        return f(dy)

    want = [np.asarray(a, np.float32) for a in vjp(jnp.asarray(dy, jdt),
                                                   *args)]
    xt = torch.from_numpy(np.array(args[0], np.float32)).to(tdt)
    gt = _t(gm) if affine else None
    _, mean, rstd = instance_norm_forward_reference(
        xt, gt, _t(bt) if affine else None)
    dx, dg, db = instance_norm_backward_reference(
        torch.from_numpy(np.array(jnp.asarray(dy, jdt), np.float32)).to(
            tdt), xt, mean, rstd, gt)
    assert dx.dtype == tdt
    # f32: sums over HW in another order; bf16: dx rounds once to bf16 on
    # both sides from f32 values that differ in the last f32 bits, so they
    # may land a bf16 step apart (2**-8 relative)
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == "float32"
           else dict(atol=2 ** -8 * np.abs(want[0]).max(), rtol=2 ** -7))
    np.testing.assert_allclose(dx.float().numpy(), want[0], **tol)
    if affine:
        np.testing.assert_allclose(dg.numpy(), want[1], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(db.numpy(), want[2], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


def test_wrappers_return_the_ports_functions():
    xp = torch.randn(1, 5, 5, 8, requires_grad=True)
    k = torch.randn(3, 3, 8, 8, requires_grad=True)
    y = conv3x3_valid(xp, k)
    assert type(y.grad_fn).__name__ == "Conv3x3ValidBackward"
    assert y.grad_fn._forward_cls is Conv3x3Valid
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    for args in ((), (torch.randn(2, 8), torch.randn(2, 8))):
        y = instance_norm(x, *args)
        assert y.grad_fn._forward_cls is InstanceNorm
    with torch.no_grad():
        assert conv3x3_valid(xp, k).grad_fn is None
        assert instance_norm(x).grad_fn is None


def test_conv3x3_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(2, 5, 6, 8, dtype=torch.float64, generator=g,
                     requires_grad=True)
    k = torch.randn(3, 3, 8, 16, dtype=torch.float64, generator=g,
                    requires_grad=True)
    assert torch.autograd.gradcheck(conv3x3_valid, (xp, k))


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_gradcheck_float64(affine):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 3, 8, dtype=torch.float64, generator=g,
                    requires_grad=True)
    args = ((torch.randn(2, 8, dtype=torch.float64, generator=g,
                         requires_grad=True),
             torch.randn(2, 8, dtype=torch.float64, generator=g,
                         requires_grad=True)) if affine else ())
    assert torch.autograd.gradcheck(instance_norm, (x,) + args)


def test_conv3x3_dk_comes_back_in_the_weights_dtype():
    # JAX's _bwd_rule: dk.astype(k.dtype), from f32 sums
    xp = torch.randn(1, 6, 6, 8).bfloat16().requires_grad_()
    k = torch.randn(3, 3, 8, 8).bfloat16().requires_grad_()
    dxp, dk = torch.autograd.grad(conv3x3_valid(xp, k).float().sum(),
                                  (xp, k))
    assert dk.dtype == torch.bfloat16 and dxp.dtype == torch.bfloat16
    want = conv3x3_wgrad_reference(xp.detach(), torch.ones(1, 4, 4, 8,
                                                           dtype=xp.dtype))
    assert want.dtype == torch.float32
    assert torch.equal(dk, want.bfloat16())
    assert torch.equal(conv3x3_wgrad(xp.detach(), torch.ones(
        1, 4, 4, 8, dtype=xp.dtype), torch.bfloat16), dk)


def test_conv3x3_backward_takes_a_non_contiguous_cotangent():
    xp = torch.randn(2, 6, 5, 8, requires_grad=True)
    k = torch.randn(3, 3, 8, 8, requires_grad=True)
    y = conv3x3_valid(xp, k)
    g = torch.randn(2, 8, 3, 4).permute(0, 3, 2, 1)     # (2, 4, 3, 8) view
    assert not g.is_contiguous()
    got = torch.autograd.grad(y, (xp, k), g, retain_graph=True)
    want = torch.autograd.grad(y, (xp, k), g.contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pad_type", ["reflect", "replicate"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_pad2d_backward_matches_torch_pad(pad_type, p):
    """The gradient through pad2d (the reflect pad in front of every kernel
    conv, which folds d(xp) back onto x) is torch's ReflectionPad2d /
    ReplicationPad2d gradient, and gradchecks."""
    from councilx_torch.nn.blocks import pad2d

    g = torch.Generator().manual_seed(p)
    x = torch.randn(2, 5, 7, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    y = pad2d(x, p, pad_type)
    ref = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (p,) * 4,
                                  mode=pad_type).permute(0, 2, 3, 1)
    assert torch.equal(y, ref)
    dy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    got, = torch.autograd.grad(y, x, dy)
    want, = torch.autograd.grad(ref, x, dy)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert torch.autograd.gradcheck(lambda t: pad2d(t, p, pad_type), (x,))
