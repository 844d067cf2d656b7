"""The CUDA-only Python of two kernel wrappers, on the CPU, with the kernel
launches stubbed.

* The 3x3 conv takes any channel count on the card: its wrappers zero-pad
  C and O up to multiples of 8 (the TMA loads' 16-byte rows), launch the
  same kernels and slice the result back. Here the launch is replaced by
  the plain version on the padded operands, which must see multiples of 8
  and give the unpadded plain result (f64, so padding with zero channels
  is exact up to summation order).
* The IN/AdaIN backward takes any batch: past the cooperative limit it
  launches one block per group with no scratch. Here the library entry
  point is replaced by a recorder.

On the card, tests/test_torch_cuda.py holds both against the plain
versions (``test_conv3x3_at_channels_not_multiples_of_8``,
``test_instance_norm_backward_at_batch_128``).
"""

import contextlib
import types

import pytest
import torch

from councilx_torch.ops import conv3x3 as conv_ops
from councilx_torch.ops import instance_norm as norm_ops

CHANNELS = [(12, 20), (3, 8), (16, 5), (8, 16), (1, 1)]


def _fake_launch_conv(calls):
    """Stands in for ``_launch_conv``: the plain version of what the
    kernel computes on the operands it is given, which must be multiples
    of 8 wide."""
    def launch(name, x, wk, pad, dgrad):
        assert x.shape[-1] % 8 == 0 and wk.shape[2] % 8 == 0
        assert wk.shape[3] % 8 == 0 and wk.is_contiguous()
        k = wk.transpose(2, 3)      # the forward's (3, 3, C, O)
        calls.append((name, tuple(x.shape), tuple(wk.shape), pad, dgrad))
        if dgrad:
            assert pad == 2 and x.shape[-1] == k.shape[3]
            return conv_ops.conv3x3_dgrad_reference(x, k)
        assert pad == 0 and x.shape[-1] == k.shape[2]
        return conv_ops.conv3x3_valid_reference(x, k)
    return launch


@pytest.mark.parametrize("c,o", CHANNELS)
def test_conv_forward_and_dgrad_pad_channels_to_multiples_of_8(
        monkeypatch, c, o):
    calls = []
    monkeypatch.setattr(conv_ops, "_launch_conv", _fake_launch_conv(calls))
    g = torch.Generator().manual_seed(c * 100 + o)
    xp = torch.randn(2, 7, 9, c, generator=g, dtype=torch.float64)
    k = torch.randn(3, 3, c, o, generator=g, dtype=torch.float64)
    gy = torch.randn(2, 5, 7, o, generator=g, dtype=torch.float64)
    before = (conv_ops.conv3x3_valid.launches, conv_ops.conv3x3_dgrad.launches)
    y = conv_ops._forward_cuda(xp, k)
    dxp = conv_ops._dgrad_cuda(gy, k)
    assert (conv_ops.conv3x3_valid.launches,
            conv_ops.conv3x3_dgrad.launches) == (before[0] + 1,
                                                 before[1] + 1)
    c8, o8 = -(-c // 8) * 8, -(-o // 8) * 8
    assert calls == [("conv3x3_valid", (2, 7, 9, c8), (3, 3, o8, c8), 0,
                      False),
                     ("conv3x3_dgrad", (2, 5, 7, o8), (3, 3, o8, c8), 2,
                      True)]
    assert y.shape == (2, 5, 7, o) and y.is_contiguous()
    assert dxp.shape == xp.shape and dxp.is_contiguous()
    torch.testing.assert_close(y, conv_ops.conv3x3_valid_reference(xp, k),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dxp, conv_ops.conv3x3_dgrad_reference(gy, k),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("c,o", CHANNELS)
def test_conv_wgrad_pads_channels_to_multiples_of_8(monkeypatch, c, o):
    seen = []

    def launch(xp, g, out_dtype, pad):
        assert xp.shape[-1] % 8 == 0 and g.shape[-1] % 8 == 0 and pad == 0
        seen.append((tuple(xp.shape), tuple(g.shape)))
        return conv_ops.conv3x3_wgrad_reference(xp, g).to(out_dtype)

    monkeypatch.setattr(conv_ops, "_launch_wgrad", launch)
    gen = torch.Generator().manual_seed(c * 10 + o)
    xp = torch.randn(2, 7, 9, c, generator=gen, dtype=torch.float64)
    gy = torch.randn(2, 5, 7, o, generator=gen, dtype=torch.float64)
    before = conv_ops.conv3x3_wgrad.launches
    dk = conv_ops._wgrad_cuda(xp, gy, torch.float64)
    assert conv_ops.conv3x3_wgrad.launches == before + 1
    c8, o8 = -(-c // 8) * 8, -(-o // 8) * 8
    assert seen == [((2, 7, 9, c8), (2, 5, 7, o8))]
    assert dk.shape == (3, 3, c, o) and dk.is_contiguous()
    torch.testing.assert_close(dk, conv_ops.conv3x3_wgrad_reference(xp, gy),
                               rtol=1e-12, atol=1e-12)


def test_conv_refuses_a_kernel_of_other_channels_before_padding():
    """12 and 10 input channels both pad to 16; the mismatch must raise
    before the padding could hide it."""
    with pytest.raises(ValueError, match="does not match"):
        conv_ops._forward_cuda(torch.zeros(1, 6, 6, 12),
                               torch.zeros(3, 3, 10, 8))
    with pytest.raises(ValueError, match="does not match"):
        conv_ops._dgrad_cuda(torch.zeros(1, 4, 4, 20),
                             torch.zeros(3, 3, 8, 18))


@pytest.fixture
def stub_norm_bwd(monkeypatch):
    """``_backward_cuda`` on CPU tensors: the device checks, the device
    context, the stream and the occupancy query stubbed (396 blocks, an
    H100's for the bf16 kernel), the library entry point recording its
    arguments."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(councilx_instance_norm_bwd=entry)
    monkeypatch.setattr(norm_ops, "_norm_bwd_lib", lambda: lib)
    monkeypatch.setattr(norm_ops, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(norm_ops, "_norm_bwd_capacity", lambda *a: 396)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("b,want_splits", [(8, 12), (99, 1), (100, 1),
                                           (128, 1)])
@pytest.mark.parametrize("affine", [False, True])
def test_norm_backward_launch_at_any_batch(stub_norm_bwd, b, want_splits,
                                           affine):
    """At (B, 64, 64, 256) bf16: B = 8 splits HW 12 ways under the
    cooperative launch, with its (B, splits, C, 2) scratch; from 99 on the
    groups fill the card, so one split and no scratch (a null pointer), the
    kernel's plain launch."""
    x = torch.zeros(b, 64, 64, 256, dtype=torch.bfloat16)
    mean = torch.zeros(b, 256)
    gm = torch.ones(b, 256) if affine else None
    before = norm_ops.instance_norm_backward.launches
    dx, dgamma, dbeta = norm_ops._backward_cuda(x, x, mean, mean, gm)
    assert norm_ops.instance_norm_backward.launches == before + 1
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert (dgamma is None) == (not affine)
    (args,) = stub_norm_bwd
    part, (bb, hw, c, dtype, vec, splits, rows) = args[8], args[9:16]
    assert (bb, hw, c, dtype, vec) == (b, 4096, 256, 1, 8)
    assert splits == want_splits and splits * rows >= hw
    assert (part is None) == (splits == 1)
