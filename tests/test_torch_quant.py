"""The port's W8A8 ops (councilx_torch/ops/quant.py) vs the JAX package's
(councilx/ops/quant.py), on the CPU, where the port runs its plain
versions; and the CUDA wrappers' Python with their launches stubbed.

Codes, scales and int32 accumulators are held bit-equal: both sides divide
(IEEE), round half to even, clip to +-127 and sum exactly. The f32 output
of the rescale is held within 1 ulp (one multiply of an exact product, one
add). Inputs come from numpy seeds.
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from councilx.nn.blocks import pad2d as jpad2d
from councilx.ops import quant as jq
from councilx_torch.ops import quant as q_ops

torch.set_num_threads(2)

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(t):
    """A port tensor as a JAX array of the same dtype (bf16 via f32,
    exact)."""
    dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy()).astype(dt)


def _images(seed, shape=(3, 6, 7, 12)):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32) * 2.0
    x[1] = 0.0                                   # a zero image
    # image 2: max |x| = 127, so a_s = 1 and every code's quotient is the
    # value itself: half-way values round to even, both signs
    x[2] = np.round(x[2] * 8) + 0.5
    x[2].flat[0] = 127.0
    x[2].flat[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return x


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_quantize_kernel_per_channel_is_bit_equal(dtype, jdtype):
    r = np.random.default_rng(1)
    k = r.standard_normal((4, 4, 12, 10)).astype(np.float32) * 0.1
    k[..., 3] = 0.0                              # a zero output channel
    k[..., 4] = np.round(k[..., 4] * 100) + 0.5  # half-way codes
    k[0, 0, 0, 4] = 127.0
    kt = _t(k, dtype)
    k8, w_s = q_ops.quantize_kernel_per_channel(kt)
    jk8, jw_s = jq.quantize_kernel_per_channel(_j(kt))
    np.testing.assert_array_equal(k8.numpy(), np.asarray(jk8))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(jw_s))
    assert k8.dtype == torch.int8 and int(k8.abs().max()) <= 127


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_quantize_act_per_image_is_bit_equal(dtype, jdtype):
    xt = _t(_images(2), dtype)
    q, a_s = q_ops.quantize_act_per_image(xt)
    jqx, ja_s = jq.quantize_act_per_image(_j(xt))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(a_s.numpy(), np.asarray(ja_s))
    assert a_s.shape == (3, 1, 1, 1)
    # the zero image: scale 1e-12 / 127, every code 0
    assert int(q[1].abs().max()) == 0
    # half to even on the .5 image (a_s = 1)
    assert float(a_s[2]) == 1.0
    assert q[2].flatten()[1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("a_scale", [0.0, 1.0, 0.01, 0.003])
def test_quantize_act_static_is_bit_equal(dtype, jdtype, a_scale):
    xt = _t(_images(3), dtype)
    q, a_s = q_ops.quantize_act_static(xt, torch.tensor(a_scale))
    jqx, ja_s = jq.quantize_act_static(_j(xt), jnp.asarray(a_scale,
                                                            jnp.float32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(a_s.numpy(), np.asarray(ja_s))
    # small scales clip to +-127, never -128
    assert int(q.min()) >= -127 and int(q.max()) <= 127


@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zero"])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_act_with_its_pad_equals_pad_then_quantize(pad_type,
                                                            static):
    """The serving step quantizes the padded tensor; the JAX block pads,
    then quantizes."""
    xt = _t(_images(4), torch.bfloat16)
    a_scale = torch.tensor(0.02) if static else None
    q, a_s = q_ops.quantize_act(xt, 2, pad_type, a_scale)
    xp = jpad2d(_j(xt), 2, pad_type)
    jqx, ja_s = (jq.quantize_act_static(xp, jnp.asarray(0.02, jnp.float32))
                 if static else jq.quantize_act_per_image(xp))
    assert q.shape == (3, 10, 11, 12)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(a_s.numpy(), np.asarray(ja_s))


def _jax_acc(q, k8, stride):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(q.numpy()), jnp.asarray(k8.numpy()), (stride, stride),
        "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (4, 1), (4, 2)])
@pytest.mark.parametrize("static", [False, True])
def test_conv_w8a8_matches_jax(kernel, stride, static):
    r = np.random.default_rng(kernel * 10 + stride)
    x = r.standard_normal((2, 11, 10, 12)).astype(np.float32)
    k = (r.standard_normal((kernel, kernel, 12, 20)) * 0.2).astype(
        np.float32)
    bias = r.standard_normal(20).astype(np.float32)
    a_scale = 0.025 if static else None
    xt, kt, bt = _t(x), _t(k), _t(bias)
    at = None if a_scale is None else torch.tensor(a_scale)
    ja = None if a_scale is None else jnp.asarray(a_scale, jnp.float32)

    # the int32 accumulator, from the codes both sides make
    qx, _ = (q_ops.quantize_act_static(xt, at) if static
             else q_ops.quantize_act_per_image(xt))
    k8, _ = q_ops.quantize_kernel_per_channel(kt)
    acc = q_ops.conv_w8a8_reference(qx, k8, stride)
    want = _jax_acc(qx, k8, stride)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)

    # the whole op, f32 out: within 1 ulp
    y = q_ops.conv_w8a8(xt, kt, bt, stride, torch.float32, at)
    jy = jq.conv_w8a8(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                      stride, jnp.float32, ja)
    assert y.shape == jy.shape
    np.testing.assert_array_max_ulp(y.numpy(), np.asarray(jy), maxulp=1)
    # and bf16 in and out, without a bias: one rounding of that value to
    # bf16, so within one bf16 step (2^16 f32 ulps)
    yb = q_ops.conv_w8a8(xt.bfloat16(), kt, None, stride, torch.bfloat16,
                         at)
    jyb = jq.conv_w8a8(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(k),
                       None, stride, jnp.bfloat16, ja)
    np.testing.assert_array_max_ulp(yb.float().numpy(),
                                    np.asarray(jyb).astype(np.float32),
                                    maxulp=2 ** 16)


def test_quantize_weights_lays_out_and_pads_for_the_kernel():
    r = np.random.default_rng(5)
    k = _t(r.standard_normal((3, 3, 12, 20)))
    w = q_ops.quantize_weights(k)
    k8, w_s = q_ops.quantize_kernel_per_channel(k)
    assert w.w8.shape == (24, 3, 3, 16) and w.w_s.shape == (24,)
    assert (w.in_channels, w.out_channels) == (12, 20)
    torch.testing.assert_close(w.w8[:20, :, :, :12], k8.permute(3, 0, 1, 2),
                               rtol=0, atol=0)
    assert int(w.w8[20:].abs().max()) == 0
    assert int(w.w8[..., 12:].abs().max()) == 0
    assert torch.equal(w.w_s[:20], w_s) and float(w.w_s[20:].abs().max()) == 0


def test_the_wrappers_raise_under_autograd():
    x = torch.randn(1, 5, 5, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="serving only"):
        q_ops.quantize_act(x, 1, "reflect")
    with pytest.raises(RuntimeError, match="serving only"):
        q_ops.conv_w8a8(x, torch.randn(3, 3, 8, 8))
    with torch.no_grad():
        q, a_s = q_ops.quantize_act(x, 1, "reflect")
        w = q_ops.quantize_weights(torch.randn(3, 3, 8, 8))
        bias = torch.randn(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="serving only"):
        q_ops.conv_int8(q, w, a_s, bias)


# ---------------------------------------------------------------------------
# the CUDA wrappers' Python, launches stubbed by plain-torch stand-ins that
# read and write the buffers through the pointers they are given
# ---------------------------------------------------------------------------


def _view(ptr, shape, dtype):
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


_ACT = {0: torch.float32, 1: torch.bfloat16}
_PADS = {0: "zero", 1: "reflect", 2: "replicate"}
_OUT = {0: torch.float32, 1: torch.bfloat16, 2: torch.int32}


class _FakeLib:
    """councilx_quant_absmax / councilx_quant_act / councilx_conv_int8 with
    the C signatures, computing what the kernels compute with the plain
    versions; records each call."""

    def __init__(self):
        self.calls = []

    def councilx_quant_absmax(self, x, partial, b, n, dtype, splits, stream):
        self.calls.append(("absmax", b, n, splits))
        xs = _view(x, (b, n), _ACT[dtype]).float().abs()
        part = _view(partial, (b, splits), torch.float32)
        for s, chunk in enumerate(torch.tensor_split(xs, splits, dim=1)):
            part[:, s] = chunk.amax(dim=1) if chunk.numel() else 0.0
        return 0

    def councilx_quant_act(self, x, q, scale_in, a_s_out, splits, b, h, w,
                           c, cq, pad, pad_type, dtype, stream):
        self.calls.append(("quant", b, h, w, c, cq, pad, pad_type, splits))
        xs = _view(x, (b, h, w, c), _ACT[dtype])
        if splits:
            m = _view(scale_in, (b, splits), torch.float32).amax(dim=1)
            a_s = q_ops.div127(m.clamp_min(1e-12)).view(b, 1, 1, 1)
            _view(a_s_out, (b,), torch.float32)[:] = a_s.view(b)
        else:
            a_s = _view(scale_in, (1,), torch.float32).clamp_min(1e-12)
            _view(a_s_out, (1,), torch.float32)[:] = a_s
        codes, _ = q_ops.quantize_act_reference(xs, pad, _PADS[pad_type],
                                                a_s.view(-1)[:1].view(())
                                                if not splits else None)
        out = _view(q, (b, h + 2 * pad, w + 2 * pad, cq), torch.int8)
        out.zero_()
        out[..., :c] = codes
        return 0

    def councilx_conv_int8(self, x, w, a_s, per_image, w_s, bias, y, b, hp,
                           wp, c, o, kh, kw, stride, ho, wo, out, stream):
        self.calls.append(("conv", b, hp, wp, c, o, kh, kw, stride, ho, wo,
                           out, per_image, bias is not None))
        qx = _view(x, (b, hp, wp, c), torch.int8)
        w8 = _view(w, (o, kh, kw, c), torch.int8)
        acc = q_ops.conv_w8a8_reference(qx, w8.permute(1, 2, 3, 0), stride)
        dst = _view(y, (b, ho, wo, o), _OUT[out])
        if _OUT[out] == torch.int32:
            dst[:] = acc
            return 0
        scale = _view(a_s, (b if per_image else 1,), torch.float32)
        scale = scale.view(-1, 1, 1, 1) if per_image else scale.view(())
        bs = None if bias is None else _view(bias, (o,), torch.float32)
        dst[:] = q_ops.rescale_reference(acc, scale,
                                         _view(w_s, (o,), torch.float32),
                                         bs, _OUT[out])
        return 0


@pytest.fixture
def fake_cuda(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(q_ops, "_quant_act_lib", lambda: lib)
    monkeypatch.setattr(q_ops, "_conv_int8_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("c,o", [(12, 20), (16, 8), (3, 5), (32, 64)])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zero"])
def test_cuda_wrappers_pad_channels_and_pass_the_scales(fake_cuda, c, o,
                                                        static, pad_type):
    """Q2 writes C rounded up to 16 channels (zeros beyond C) from the
    unpadded input; Q1 takes them with the padded weight and returns O
    channels: the same codes, accumulator and output as the plain path."""
    r = np.random.default_rng(c * 100 + o)
    x = _t(r.standard_normal((2, 7, 6, c)) * 3, torch.bfloat16)
    k = _t(r.standard_normal((4, 4, c, o)) * 0.2)
    bias = _t(r.standard_normal(o))
    a_scale = torch.tensor(0.03) if static else None
    w = q_ops.quantize_weights(k)
    before = (q_ops.quantize_act.launches,
              q_ops.quantize_act.absmax_launches, q_ops.conv_int8.launches)
    qx, a_s = q_ops._quantize_act_cuda(x, 1, pad_type, a_scale)
    y = q_ops._conv_int8_cuda(qx, w, a_s, bias, 2, torch.bfloat16)
    acc = q_ops._conv_int8_cuda(qx, w, a_s, None, 2, torch.int32)
    assert (q_ops.quantize_act.launches, q_ops.quantize_act.absmax_launches,
            q_ops.conv_int8.launches) == (before[0] + 1,
                                          before[1] + (not static),
                                          before[2] + 2)
    c16 = -(-c // 16) * 16
    assert qx.shape == (2, 9, 8, c16) and not qx[..., c:].any()
    want_q, want_s = q_ops.quantize_act_reference(x, 1, pad_type, a_scale)
    assert torch.equal(qx[..., :c], want_q)
    assert torch.equal(a_s, want_s)
    assert y.shape == (2, 3, 3, o) and y.is_contiguous()
    assert torch.equal(y, q_ops.conv_int8_reference(
        want_q, w, want_s, bias, 2, torch.bfloat16))
    assert torch.equal(acc, q_ops.conv_int8_reference(
        want_q, w, want_s, None, 2, torch.int32))
    kinds = [call[0] for call in fake_cuda.calls]
    assert kinds == ([] if static else ["absmax"]) + ["quant", "conv",
                                                      "conv"]


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(fake_cuda):
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="pad"):
        q_ops._quantize_act_cuda(x, 4, "reflect", None)
    with pytest.raises(ValueError, match="contiguous"):
        q_ops._quantize_act_cuda(x.transpose(1, 2), 1, "zero", None)
    with pytest.raises(ValueError, match="dtype|bf16"):
        q_ops._quantize_act_cuda(x.half(), 1, "zero", None)
    w = q_ops.quantize_weights(torch.randn(3, 3, 16, 8))
    with pytest.raises(ValueError, match="padded"):
        q_ops._conv_int8_cuda(torch.zeros(1, 6, 6, 12, dtype=torch.int8), w,
                              torch.ones(()), None, 1, torch.float32)
    with pytest.raises(ValueError, match="out dtype"):
        q_ops._conv_int8_cuda(torch.zeros(1, 6, 6, 16, dtype=torch.int8), w,
                              torch.ones(()), None, 1, torch.float16)
    assert fake_cuda.calls == []
