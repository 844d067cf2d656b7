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
    """councilx_quant_act_plan / councilx_quant_act / councilx_conv_int8
    with the C signatures, computing what the kernels compute with the
    plain versions; records each call. The occupancy query answers
    ``capacity`` blocks and ``stash_bytes`` per block."""

    def __init__(self, capacity=264, stash_bytes=112 * 1024):
        self.calls = []
        self.capacity, self.stash_bytes = capacity, stash_bytes

    def councilx_quant_act_plan(self, dtype, vec, stash, capacity):
        self.calls.append(("plan", dtype, vec))
        stash._obj.value = self.stash_bytes
        capacity._obj.value = self.capacity
        return 0

    def councilx_quant_act(self, x, q, scale_in, a_s_out, part, per_image,
                           b, h, w, c, cq, pad, pad_type, dtype, vec, splits,
                           per_split, stash, stream):
        self.calls.append(("quant", b, h, w, c, cq, pad, pad_type,
                           per_image, vec, splits, per_split, stash,
                           part is not None))
        hp, wp = h + 2 * pad, w + 2 * pad
        # the kernel's own grid rules: whole iterations covering the image,
        # a grid wait (scratch) only per image over several splits, a
        # stash only per image
        assert per_split % 256 == 0 and splits * per_split >= \
            hp * wp * cq // 16 > (splits - 1) * per_split
        assert (part is not None) == (per_image and splits > 1)
        assert stash == 0 or per_image
        xs = _view(x, (b, h, w, c), _ACT[dtype])
        if per_image:
            m = xs.float().abs().amax(dim=(1, 2, 3))
            a_s = q_ops.div127(m.clamp_min(1e-12)).view(b, 1, 1, 1)
            _view(a_s_out, (b,), torch.float32)[:] = a_s.view(b)
        else:
            a_s = _view(scale_in, (1,), torch.float32).clamp_min(1e-12)
            _view(a_s_out, (1,), torch.float32)[:] = a_s
        codes, _ = q_ops.quantize_act_reference(xs, pad, _PADS[pad_type],
                                                a_s.view(-1)[:1].view(())
                                                if not per_image else None)
        out = _view(q, (b, hp, wp, cq), torch.int8)
        out.zero_()
        out[..., :c] = codes
        return 0

    def councilx_conv_int8(self, x, w, a_s, per_image, w_s, bias, y, b, hp,
                           wp, c, o, kh, kw, stride, ho, wo, bk, bn, out,
                           stream):
        self.calls.append(("conv", b, hp, wp, c, o, kh, kw, stride, ho, wo,
                           bk, bn, out, per_image, bias is not None))
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
    monkeypatch.setattr(q_ops, "_quant_plans", {})
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
              q_ops.quantize_act.per_image_launches,
              q_ops.conv_int8.launches)
    qx, a_s = q_ops._quantize_act_cuda(x, 1, pad_type, a_scale)
    y = q_ops._conv_int8_cuda(qx, w, a_s, bias, 2, torch.bfloat16)
    acc = q_ops._conv_int8_cuda(qx, w, a_s, None, 2, torch.int32)
    assert (q_ops.quantize_act.launches,
            q_ops.quantize_act.per_image_launches,
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
    # Q2 is one launch in either mode (per image after its occupancy query)
    kinds = [call[0] for call in fake_cuda.calls]
    assert kinds == ([] if static else ["plan"]) + ["quant", "conv", "conv"]


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


@pytest.mark.parametrize("kernel,stride", [(3, 1), (4, 2)])
@pytest.mark.parametrize("o", [20, 128, 512])
@pytest.mark.parametrize("c", [12, 64, 128, 256])
def test_conv_int8_wrapper_pads_channels_and_picks_its_tiles(fake_cuda, c, o,
                                                             kernel, stride):
    """Q1's wrapper hands the kernel C padded to 16 and O to 8, 128-byte K
    steps where C is a multiple of 128 (else 64), 256-channel tiles where
    O is above 128 (else 128), and slices O back."""
    r = np.random.default_rng(c + o + kernel)
    x = _t(r.standard_normal((2, 5, 6, c)) * 3, torch.bfloat16)
    w = q_ops.quantize_weights(_t(r.standard_normal((kernel, kernel, c, o))
                                  * 0.1))
    bias = _t(r.standard_normal(o))
    qx, a_s = q_ops._quantize_act_cuda(x, 1, "reflect", None)
    y = q_ops._conv_int8_cuda(qx, w, a_s, bias, stride, torch.bfloat16)
    cq, o8 = -(-c // 16) * 16, -(-o // 8) * 8
    ho, wo = (7 - kernel) // stride + 1, (8 - kernel) // stride + 1
    conv = fake_cuda.calls[-1]
    assert conv[:11] == ("conv", 2, 7, 8, cq, o8, kernel, kernel, stride,
                         ho, wo)
    assert conv[11:13] == ((128 if cq % 128 == 0 else 64),
                           (256 if o8 > 128 else 128))
    assert conv[13:] == (1, 1, True)
    assert y.shape == (2, ho, wo, o) and y.is_contiguous()
    want_q, want_s = q_ops.quantize_act_reference(x, 1, "reflect")
    assert torch.equal(y, q_ops.conv_int8_reference(
        want_q, w, want_s, bias, stride, torch.bfloat16))


# the resblock site's items per image: 66 x 66 padded pixels x 16 groups
_RESBLOCK_ITEMS = 66 * 66 * 256 // 16


@pytest.mark.parametrize("b,splits,per_iters", [
    (1, 137, 2), (8, 31, 9), (64, 4, 69), (264, 1, 273), (300, 1, 273)])
def test_quant_split_fills_the_card_at_every_batch(b, splits, per_iters):
    """Q2's grid at the resblock site on a card that holds 264 blocks: per
    image, as many chunks per image as fit (none under 2 iterations), so
    bucket 1 runs 137 blocks, not one, and one block per image once the
    images fill the card; static, 137 chunks of 2 iterations per image at
    every batch."""
    got = q_ops._quant_split(b, _RESBLOCK_ITEMS, 264)
    assert got == (splits, per_iters * 256)
    assert b * splits <= max(b, 264)
    assert splits * got[1] >= _RESBLOCK_ITEMS > (splits - 1) * got[1]
    assert q_ops._quant_split(b, _RESBLOCK_ITEMS, None) == (137, 512)


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_act_is_one_launch_split_from_the_occupancy_query(
        fake_cuda, b, static):
    """Q2 in either mode: one launch whose split comes from the (stubbed)
    occupancy query; per image it gets scratch for the grid wait only over
    several splits, and a stash of whole iterations within the queried
    bytes; the codes and scales are the plain version's."""
    fake_cuda.capacity, fake_cuda.stash_bytes = 16, 40 * 1024
    r = np.random.default_rng(b)
    x = _t(r.standard_normal((b, 32, 32, 32)) * 2, torch.bfloat16)
    a_scale = torch.tensor(0.02) if static else None
    q, a_s = q_ops._quantize_act_cuda(x, 1, "reflect", a_scale)
    splits, per = q_ops._quant_split(b, 34 * 34 * 2, None if static else 16)
    # per image: as many chunks as 16 co-resident blocks allow; static: no
    # wait, chunks of 2 iterations whatever the batch
    assert splits == (5 if static else {1: 5, 8: 2, 64: 1}[b])
    stash = 0 if static else min(per // 256, 40 * 1024 // (256 * 16 * 2))
    plan = [] if static else [("plan", 1, 1)]
    assert fake_cuda.calls == plan + [
        ("quant", b, 32, 32, 32, 32, 1, 1, int(not static), 1, splits, per,
         stash, not static and splits > 1)]
    want_q, want_s = q_ops.quantize_act_reference(x, 1, "reflect", a_scale)
    assert torch.equal(q, want_q) and torch.equal(a_s, want_s)
    # the plan is asked once per device and kernel
    q_ops._quantize_act_cuda(x, 1, "reflect", a_scale)
    assert [c[0] for c in fake_cuda.calls] == [c[0] for c in plan] + [
        "quant", "quant"]


def test_quantize_act_takes_ragged_channels_and_any_alignment(fake_cuda):
    """C off the 16-channel grid, or x off the 16-byte grid, runs the
    kernel's scalar loads (vec 0) rather than being refused."""
    x = torch.randn(2, 6, 5, 12, dtype=torch.bfloat16)
    q_ops._quantize_act_cuda(x, 1, "replicate", None)
    flat = torch.randn(2 * 6 * 5 * 16 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(2, 6, 5, 16)
    q, a_s = q_ops._quantize_act_cuda(off, 1, "zero", None)
    assert [c[9] for c in fake_cuda.calls if c[0] == "quant"] == [0, 0]
    want_q, want_s = q_ops.quantize_act_reference(off, 1, "zero")
    assert torch.equal(q, want_q) and torch.equal(a_s, want_s)


@pytest.mark.parametrize("o,bias,in_place", [
    (8, lambda: torch.randn(8), True),
    (20, lambda: torch.randn(20), False),            # O rounded up to 24
    (8, lambda: torch.randn(8).bfloat16(), False),
    (8, lambda: torch.randn(16)[::2], False),        # strided
    (8, lambda: torch.randn(9)[1:], False),          # off the 16-byte grid
])
def test_conv_int8_wrapper_reads_an_f32_bias_in_place(fake_cuda, o, bias,
                                                      in_place):
    """An f32 bias of O (a multiple of 8) contiguous, aligned channels goes
    to the kernel as it is, with no copy launched; a ragged O, another
    dtype, a strided or a misaligned view is copied first (zero-padded to
    O'). The output is the plain version's either way."""
    bias = bias()
    r = np.random.default_rng(o)
    qx = torch.from_numpy(r.integers(-127, 128, (1, 6, 6, 16), dtype=np.int8))
    w = q_ops.quantize_weights(torch.randn(3, 3, 16, o))
    passed = []
    real = fake_cuda.councilx_conv_int8

    def record(*args):
        passed.append(args[5])
        return real(*args)

    fake_cuda.councilx_conv_int8 = record
    y = q_ops._conv_int8_cuda(qx, w, torch.ones(()), bias, 1, torch.float32)
    assert (passed == [bias.data_ptr()]) == in_place
    assert torch.equal(y, q_ops.conv_int8_reference(qx, w, torch.ones(()),
                                                    bias, 1, torch.float32))


def test_conv_int8_wrapper_refuses_sides_strides_and_misalignment(fake_cuda):
    w3 = q_ops.quantize_weights(torch.randn(3, 3, 16, 8))
    q = torch.zeros(1, 20, 20, 16, dtype=torch.int8)
    one = torch.ones(())
    with pytest.raises(ValueError, match="stride"):
        q_ops._conv_int8_cuda(q, w3, one, None, 9, torch.float32)
    with pytest.raises(ValueError, match="up to 8"):
        q_ops._conv_int8_cuda(q, q_ops.quantize_weights(
            torch.randn(9, 9, 16, 8)), one, None, 1, torch.float32)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(1 + 20 * 20 * 16, dtype=torch.int8)
        q_ops._conv_int8_cuda(flat[1:].view(1, 20, 20, 16), w3, one, None, 1,
                              torch.float32)
    with pytest.raises(ValueError, match="a_s"):
        q_ops._conv_int8_cuda(q, w3, torch.ones(3), None, 1, torch.float32)
    with pytest.raises(ValueError, match="a_scale"):
        q_ops._quantize_act_cuda(torch.zeros(1, 4, 4, 16), 1, "zero",
                                 torch.ones(2))
    assert fake_cuda.calls == []


def _codes_by_reciprocal(x, a):
    """csrc/quant_act.cu's code_bits in float32 numpy: x * RN(1/a) clipped
    to +-127, rounded by the 1.5 * 2^23 trick, the IEEE division within
    2^-12 of a tie."""
    x, a = np.float32(x), np.float32(a)
    big = np.float32(12582912.0)
    t = np.clip(x * (np.float32(1) / a), np.float32(-127), np.float32(127))
    u = t + big
    d = np.abs(t - (u - big))
    near = ~(np.abs(d - np.float32(0.5)) > np.float32(2.0 ** -12))
    with np.errstate(invalid="ignore"):
        div = np.clip(np.rint(x / a), np.float32(-127), np.float32(127))
    u = np.where(near, div + big, u)
    return (u.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("seed", range(4))
def test_reciprocal_codes_equal_the_division_codes(seed):
    """Q2 quantizes by a multiply with the reciprocal and divides only near
    a rounding tie; on random activations at any scale, bf16-rounded ones,
    and values at, just above and just below every tie, its codes are the
    plain version's (an IEEE division, then rint)."""
    r = np.random.default_rng(seed)
    for trial in range(6):
        x = (r.standard_normal(20000) * 10.0 ** r.uniform(-3, 3)).astype(
            np.float32)
        if trial % 2:
            x = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)
        a = np.float32(np.float32(np.abs(x).max() * r.uniform(0.3, 1.2))
                       / np.float32(127))
        ties = (np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)) * a
        x = np.concatenate([x, ties, np.nextafter(ties, np.float32(np.inf)),
                            np.nextafter(ties, np.float32(-np.inf)),
                            np.float32([0.0, -0.0, np.inf, -np.inf])])
        want, _ = q_ops.quantize_act_static(torch.from_numpy(x),
                                            torch.tensor(a))
        np.testing.assert_array_equal(_codes_by_reciprocal(x, a),
                                      want.numpy())
