"""The port's reflect and replicate pad (councilx_torch/ops/pad.py) on the
CPU: the plain fold against the autograd of the index gather, and the CUDA
wrappers' Python with the two launches stubbed by stand-ins that read and
write the buffers through the pointers, word counts and strides they are
given, as csrc/pad_nhwc.cu does.
"""

import contextlib
import ctypes
import types

import pytest
import torch

from councilx_torch.ops import pad as pad_ops

torch.set_num_threads(2)

_ACT = {0: torch.float32, 1: torch.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (2, 8, 6, 4)])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("pad_type", ["reflect", "replicate"])
def test_plain_fold_is_the_gathers_autograd(pad_type, p, shape, dtype):
    """The fold written with slices and adds (P1''s plain version and its
    oracle on the card) is the gradient that autograd takes through the
    gather, at odd and even sizes: equal up to the order of at most nine
    f32 (f64) adds per element."""
    g = torch.Generator().manual_seed(p)
    x = torch.randn(shape, dtype=dtype, generator=g, requires_grad=True)
    y = pad_ops.pad_reference(x, p, pad_type)
    dy = torch.randn(y.shape, dtype=dtype, generator=g)
    want, = torch.autograd.grad(y, x, dy)
    got = pad_ops.pad_fold_reference(dy, shape[1], shape[2], p, pad_type)
    assert got.dtype == dtype and got.shape == x.shape
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the CUDA wrappers' Python, launches stubbed
# ---------------------------------------------------------------------------


def _strided(ptr, shape, strides, dtype):
    """The tensor of ``dtype`` at address ``ptr`` with ``shape`` and
    element ``strides``."""
    esize = torch.empty((), dtype=dtype).element_size()
    n = esize * (1 + sum((d - 1) * s for d, s in zip(shape, strides)))
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(shape, strides)


def _source(n, p, pad_type):
    """The kernel's source() of every padded index, as a list."""
    out = []
    for i in range(-p, n + p):
        if pad_type == 1:
            out.append(-i if i < 0 else 2 * (n - 1) - i if i >= n else i)
        else:
            out.append(min(max(i, 0), n - 1))
    return out


class _FakeLib:
    """councilx_pad_nhwc / councilx_pad_nhwc_fold with the C signatures,
    doing what the kernels do from what they are passed: P1 copies words
    of ``word`` bytes, P1' sums elements of its dtype (in f64 here); both
    hold the launch contract (aligned pointers, whole words a pixel, a
    channel stride of one element wherever a word holds more). Records
    each call."""

    def __init__(self):
        self.calls = []

    def councilx_pad_nhwc(self, x, y, b, h, w, words, sb, sh, sw, sc, p,
                          pad_type, word, stream):
        self.calls.append(("pad", words, word, sb, sh, sw, sc))
        assert word in (2, 4, 8, 16) and x % word == 0 and y % word == 0
        src = _strided(x, (b, h, w, words, word),
                       (sb * word, sh * word, sw * word, sc * word, 1),
                       torch.uint8)
        hp, wp = h + 2 * p, w + 2 * p
        ih, iw = _source(h, p, pad_type), _source(w, p, pad_type)
        _strided(y, (b, hp, wp, words, word),
                 (hp * wp * words * word, wp * words * word, words * word,
                  word, 1), torch.uint8)[:] = src[:, ih][:, :, iw]
        return 0

    def councilx_pad_nhwc_fold(self, dy, dx, b, h, w, words, sb, sh, sw, sc,
                               p, pad_type, dtype, word, stream):
        self.calls.append(("fold", words, word, sb, sh, sw, sc))
        dt = _ACT[dtype]
        per = word // torch.empty((), dtype=dt).element_size()
        assert per >= 1 and dy % word == 0 and dx % word == 0
        assert per == 1 or sc == 1
        c = words * per
        hp, wp = h + 2 * p, w + 2 * p
        g = _strided(dy, (b, hp, wp, c),
                     (sb * per, sh * per, sw * per, sc), dt).double()
        rows = torch.zeros(b, h, wp, c, dtype=torch.float64).index_add_(
            1, torch.tensor(_source(h, p, pad_type)), g)
        out = torch.zeros(b, h, w, c, dtype=torch.float64).index_add_(
            2, torch.tensor(_source(w, p, pad_type)), rows)
        _strided(dx, (b, h, w, c), (h * w * c, w * c, c, 1), dt)[:] = out
        return 0


@pytest.fixture
def fake_cuda(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(pad_ops, "_pad_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


def _laid_out(layout, shape, dtype, g):
    """A tensor of ``shape`` laid out as the model's pads meet them:
    contiguous; a slice of W (the strips engine's columns) or of H; channels
    not innermost; an address one element off the 16-byte grid."""
    b, h, w, c = shape

    def randn(*dims):
        return torch.randn(*dims, generator=g).to(dtype)

    if layout == "contiguous":
        return randn(*shape)
    if layout == "w_slice":
        return randn(b, h, w + 3, c)[:, :, 1:w + 1]
    if layout == "h_slice":
        return randn(b, h + 2, w, c)[:, 2:]
    if layout == "channels_strided":
        return randn(b, c, h, w).permute(0, 2, 3, 1)
    return randn(b * h * w * c + 1)[1:].view(shape)


LAYOUTS = ["contiguous", "w_slice", "h_slice", "channels_strided",
           "misaligned"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 6, 64])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pad_type", ["reflect", "replicate"])
def test_cuda_wrappers_pass_words_and_strides(fake_cuda, pad_type, layout, c,
                                              dtype):
    """P1's wrapper hands the kernel x's words and strides so that the
    copy is the gather, bit for bit, and P1''s so that the fold is the
    plain one (within one rounding of dy's dtype), at p 1 and 2, from every
    layout; one launch each, counted."""
    g = torch.Generator().manual_seed(c)
    for p in (1, 2):
        shape = (2, 5, 4, c)
        x = _laid_out(layout, shape, dtype, g)
        before = (pad_ops.pad_nhwc.launches, pad_ops.pad_fold.launches)
        y = pad_ops._pad_cuda(x, p, pad_type)
        assert y.is_contiguous()
        assert torch.equal(y, pad_ops.pad_reference(x, p, pad_type))
        dy = _laid_out(layout, tuple(y.shape), dtype, g)
        dx = pad_ops._fold_cuda(dy, 5, 4, p, pad_type)
        assert dx.is_contiguous() and dx.dtype == dtype
        want = pad_ops.pad_fold_reference(dy, 5, 4, p, pad_type)
        torch.testing.assert_close(dx, want, rtol=2 ** -7 if
                                   dtype == torch.bfloat16 else 1e-6,
                                   atol=1e-6)
        assert (pad_ops.pad_nhwc.launches,
                pad_ops.pad_fold.launches) == (before[0] + 1, before[1] + 1)
    assert [call[0] for call in fake_cuda.calls] == ["pad", "fold"] * 2


@pytest.mark.parametrize("dtype,c,offset,want", [
    (torch.bfloat16, 64, 0, 16), (torch.float32, 256, 0, 16),
    (torch.bfloat16, 3, 0, 2), (torch.float32, 3, 0, 4),
    (torch.bfloat16, 6, 0, 4), (torch.float32, 6, 0, 8),
    (torch.bfloat16, 64, 1, 2), (torch.bfloat16, 64, 4, 8),
    (torch.float32, 64, 2, 8)])
def test_word_is_the_widest_the_pixel_and_the_address_allow(dtype, c, offset,
                                                            want):
    """16 bytes wherever C and the address allow (the resblocks' C = 256,
    the decoder's 64); the image's C = 3 element by element; C = 6 (the
    council discriminator's input) in 4- or 8-byte words; an address off
    the grid takes the word that it allows."""
    n = 2 * 3 * 5 * c
    t = torch.zeros(n + offset, dtype=dtype)[offset:].view(2, 3, 5, c)
    assert pad_ops._word_bytes(t) == want
    y = torch.zeros(2, 5, 7, c, dtype=dtype)
    assert pad_ops._word_bytes(t, y) == want


def test_pad_function_differentiates_through_the_kernels(fake_cuda):
    """The autograd Function: P1 forward, the fold backward (here the plain
    one: a CPU cotangent), the gather's gradient."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 5, 8, generator=g, requires_grad=True)
    y = pad_ops._Pad.apply(x, 2, "reflect")
    dy = torch.randn(y.shape, generator=g)
    got, = torch.autograd.grad(y, x, dy)
    ref = pad_ops.pad_reference(x, 2, "reflect")
    assert torch.equal(y, ref)
    want, = torch.autograd.grad(ref, x, dy)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert [call[0] for call in fake_cuda.calls] == ["pad"]


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(fake_cuda):
    x = torch.zeros(1, 3, 8, 4)
    with pytest.raises(ValueError, match="dtype"):
        pad_ops._pad_cuda(x.half(), 1, "reflect")
    with pytest.raises(ValueError, match="reflect pad 3"):
        pad_ops._pad_cuda(x, 3, "reflect")
    with pytest.raises(ValueError, match="padding"):
        pad_ops._pad_cuda(x, 0, "replicate")
    with pytest.raises(ValueError, match="pad_type"):
        pad_ops._pad_cuda(x, 1, "zero")
    with pytest.raises(ValueError, match="empty"):
        pad_ops._pad_cuda(torch.zeros(0, 3, 8, 4), 1, "reflect")
    with pytest.raises(ValueError, match="NHWC"):
        pad_ops._pad_cuda(torch.zeros(3, 8, 4), 1, "reflect")
    big = torch.zeros(1, 1, 1, 1).expand(2 ** 15, 2 ** 15 + 1, 1, 1)
    with pytest.raises(ValueError, match="int32"):
        pad_ops._pad_cuda(big, 1, "replicate")
    with pytest.raises(ValueError, match="padded by"):
        pad_ops._fold_cuda(torch.zeros(1, 5, 9, 4), 3, 8, 1, "reflect")
    with pytest.raises(ValueError, match="reflect pad 3"):
        pad_ops._fold_cuda(torch.zeros(1, 9, 14, 4), 3, 8, 3, "reflect")
    assert fake_cuda.calls == []
