"""councilx_torch's kernels and serving path on an NVIDIA GPU.

Every test here needs a card and skips without one. The file imports
neither JAX nor ``councilx``, so it also runs on a GPU machine without JAX,
where tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from councilx_torch.config import Config, load_config
from councilx_torch.inference.translate import Translator
from councilx_torch.ops.conv3x3 import (conv3x3_dgrad,
                                        conv3x3_dgrad_reference,
                                        conv3x3_same_zero,
                                        conv3x3_same_zero_reference,
                                        conv3x3_valid, conv3x3_valid_reference,
                                        conv3x3_wgrad, conv3x3_wgrad_reference,
                                        hwio_weight)
from councilx_torch.ops import _build
from councilx_torch.ops import instance_norm as norm_ops
from councilx_torch.ops import pad as pad_ops
from councilx_torch.ops.instance_norm import (
    instance_norm, instance_norm_backward, instance_norm_backward_reference,
    instance_norm_forward_reference, instance_norm_reference)
from councilx_torch.train.trainer import CouncilTrainer
from councilx_torch.utils import trace

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a GPU")
    # every kernel library before the first test, so that no nvcc runs in
    # this process between profiled calls: short traces taken after an
    # in-process build have come back without a device event
    _build.build_cuda_libraries(chip_smoke.CUDA_SOURCES)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the resblock conv at serving width, the reduced config's 128 channels at
# 16x16, and ragged shapes: M not a multiple of the 128-pixel tile, W other
# than 64, C and O multiples of 8 but not of 64
CONV_SHAPES = [(2, 64, 64, 256, 256), (2, 16, 16, 128, 128),
               (3, 17, 45, 72, 136), (1, 5, 7, 16, 24), (3, 9, 3, 8, 136)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,o", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(cuda, dtype, b, h, w, c, o):
    g = torch.Generator(device=cuda).manual_seed(0)
    xp = torch.randn(b, h + 2, w + 2, c, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, c, o, device=cuda, generator=g)
         / (9 * c) ** 0.5).to(dtype)
    before = conv3x3_valid.launches
    got = conv3x3_valid(xp, k).float()
    torch.cuda.synchronize()
    assert conv3x3_valid.launches == before + 1
    want = conv3x3_valid_reference(xp.float(), k.float())
    # bf16: one rounding of the f32 sum (a bf16 step is 2**-8 relative);
    # f32: sums of 9*C terms in another order
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * \
        want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


# the forward's shapes: the resblock site; batch 1 at 256x256 (one group
# over many chunks); bucket 64 at the resblocks (more groups than the card
# holds at once: one chunk per group, no grid barrier); the 128x128 site
# (chunks larger than their stash); a small one; too few rows to split;
# ragged C split over HW: scalar loads in both dtypes (6), a partial last
# group of 16-byte vectors (200)
NORM_FWD_SHAPES = [(8, 64, 64, 256), (1, 256, 256, 64), (64, 64, 64, 256),
                   (8, 128, 128, 128), (2, 32, 32, 64), (2, 5, 7, 24),
                   (2, 32, 32, 6), (1, 64, 64, 200)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", NORM_FWD_SHAPES)
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_kernel_matches_plain(cuda, dtype, shape, affine):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    args = ()
    if affine:
        args = (torch.randn(shape[0], shape[3], device=cuda, generator=g),
                torch.randn(shape[0], shape[3], device=cuda, generator=g))
    got = instance_norm(x, *args).float()
    want = instance_norm_reference(x, *args).float()
    # bf16: both sides round once from f32 and may differ by a step at the
    # largest magnitude; f32: sums over HW in another order
    tol = (2 ** -6 if dtype == torch.bfloat16 else 1e-5) * \
        want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", NORM_FWD_SHAPES)
def test_instance_norm_statistics_match_plain(cuda, dtype, shape):
    """The f32 mean and rstd that the backward reads, stored by chunk 0 of
    each group, in every mode of the forward's grid."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    _, mean, rstd = norm_ops._forward(x, None, None, 1e-5)
    _, want_mean, want_rstd = instance_norm_forward_reference(x)
    # f32 sums over HW of the same inputs, in another order
    _close(mean, want_mean, 1e-5)
    _close(rstd, want_rstd, 1e-5)


def test_instance_norm_forward_shapes_pick_each_mode(cuda):
    """On this card, NORM_FWD_SHAPES reach every mode of the forward's
    grid: many chunks of one group, one chunk per group (plain launch),
    and chunks larger than their stash."""
    stash_bytes, cap = norm_ops._norm_fwd_plan(cuda, 1, 8, False)

    def grid(b, h, w, c):
        return norm_ops._norm_fwd_grid(b, h * w, c, 8, 2, stash_bytes, cap)

    assert grid(1, 256, 256, 64)[0] >= 64
    assert grid(64, 64, 64, 256)[0] == 1
    splits, rows, stash = grid(8, 128, 128, 128)
    assert splits > 1 and stash * 32 < rows


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_statistics_far_from_zero_mean(cuda, affine):
    """f32 x * 3 + 64: the mean, then the variance of the centred values
    (E[x^2] - E[x]^2 in f32 would miss rstd by ~1e-3 here)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(2, 64, 64, 256, device=cuda, generator=g) * 3 + 64
    gm = (torch.randn(2, 256, device=cuda, generator=g) if affine
          else None)
    got = norm_ops._forward(x, gm, gm, 1e-5)
    want = instance_norm_forward_reference(x, gm, gm)
    # f32 sums over HW in another order
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 64, 64, 256), (1, 256, 256, 64)])
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_forward_is_deterministic(cuda, dtype, shape, affine):
    """Split over HW, the chunk statistics are merged in a fixed order: two
    calls give bit-equal y, mean and rstd."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    gm = (torch.randn(shape[0], shape[3], device=cuda, generator=g)
          if affine else None)
    a = norm_ops._forward(x, gm, gm, 1e-5)
    b = norm_ops._forward(x, gm, gm, 1e-5)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    # C = 12 is padded to 16 and taken; a kernel of other input channels
    # is refused before any padding could hide it
    x = torch.zeros(1, 6, 6, 12, device=cuda)
    with pytest.raises(ValueError, match="does not match"):
        conv3x3_valid(x, torch.zeros(3, 3, 10, 8, device=cuda))
    x = torch.zeros(1, 6, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_valid(x.transpose(1, 2), torch.zeros(3, 3, 8, 8,
                                                     device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        instance_norm(x.half())


def test_translate_on_gpu_matches_cpu_and_runs_the_kernels(cuda):
    # smoke_tiny: f32, dim 8 (content 32 channels), n_res 2, 32px
    cfg = load_config(os.path.join(REPO, "configs", "smoke_tiny.yaml"))
    sds = [{k: v.cpu() for k, v in g.state_dict().items()}
           for g in Translator(cfg, device="cpu").init_members(2, seed=0)]
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    z = r.standard_normal((3, 3)).astype(np.float32)
    cpu = Translator(cfg, device="cpu")
    want = cpu.translate(cpu.load_members(sds), x, z=z, member=1)[0]
    gpu = Translator(cfg, device=cuda)
    gens = gpu.load_members(sds)
    conv0, norm0 = conv3x3_valid.launches, instance_norm.launches
    got = gpu.translate(gens, x, z=z, member=1)[0].cpu()
    # per member forward: 2 resblocks x 2 convs in the encoder and the
    # decoder; 7 IN (7x7, two downsamples, 4 resblock convs) + 4 AdaIN
    assert conv3x3_valid.launches - conv0 == 8
    assert instance_norm.launches - norm0 == 11
    # f32 through ~20 layers, TF32 off, sums in another order
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# backward kernels and the autograd Functions on the card
# ---------------------------------------------------------------------------


def _close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_through_the_kernels_matches_plain(cuda, dtype):
    """The autograd Functions launch the kernels forward and backward on
    the card, and their gradients equal those of the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(2)
    xp = torch.randn(2, 10, 9, 16, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, 16, 24, device=cuda, generator=g) / 12).to(dtype)
    gy = torch.randn(2, 8, 7, 24, device=cuda, generator=g).to(dtype)
    xk = [t.clone().requires_grad_() for t in (xp, k)]
    counts = (conv3x3_valid.grad_launches, conv3x3_dgrad.launches,
              conv3x3_wgrad.launches)
    got = torch.autograd.grad(conv3x3_valid(*xk), xk, gy)
    assert (conv3x3_valid.grad_launches, conv3x3_dgrad.launches,
            conv3x3_wgrad.launches) == tuple(c + 1 for c in counts)
    assert all(t is not None for t in got)
    xk = [t.float().clone().requires_grad_() for t in (xp, k)]
    want = torch.autograd.grad(conv3x3_valid_reference(*xk), xk, gy.float())
    # bf16: each side rounds an f32 sum once; f32: sums in another order
    rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for a, b in zip(got, want):
        _close(a, b, rel)

    x = (torch.randn(2, 5, 7, 24, device=cuda, generator=g) * 3 + 1).to(dtype)
    dy = torch.randn(2, 5, 7, 24, device=cuda, generator=g).to(dtype)
    for affine in (False, True):
        args = ([torch.randn(2, 24, device=cuda, generator=g)
                 for _ in range(2)] if affine else [])
        ins = [t.clone().requires_grad_() for t in [x] + args]
        before = instance_norm_backward.launches
        got = torch.autograd.grad(instance_norm(*ins), ins, dy)
        assert instance_norm_backward.launches == before + 1
        assert all(t is not None for t in got)
        ins = [t.float().clone().requires_grad_() for t in [x] + args]
        want = torch.autograd.grad(instance_norm_reference(*ins), ins,
                                   dy.float())
        for a, b in zip(got, want):
            # bf16: dx rounds once from f32; f32: sums over HW reordered
            _close(a, b, 2 ** -6 if dtype == torch.bfloat16 else 1e-4)


# the wgrad's own ragged shapes: B*H*W not a multiple of its 64-pixel K'
# step times its splits, C past one 128-channel tile and not a multiple of
# 64, O past one 256-output tile; and 135 tiles, more than the 132 SMs of
# an H100, so one split
WGRAD_SHAPES = [(2, 33, 31, 200, 264), (1, 4, 4, 1920, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,o", [(8, 64, 64, 256, 256)]
                         + CONV_SHAPES[1:] + WGRAD_SHAPES)
def test_conv3x3_backward_kernels_match_plain(cuda, dtype, b, h, w, c, o):
    g = torch.Generator(device=cuda).manual_seed(3)
    xp = torch.randn(b, h + 2, w + 2, c, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, c, o, device=cuda, generator=g)
         / (9 * c) ** 0.5).to(dtype)
    gy = torch.randn(b, h, w, o, device=cuda, generator=g).to(dtype)
    # dgrad: the forward kernel on the cotangent, padded by its loads; one
    # rounding
    _close(conv3x3_dgrad(gy, k), conv3x3_dgrad_reference(gy.float(),
                                                         k.float()),
           2 ** -7 if dtype == torch.bfloat16 else 1e-5)
    # wgrad: f32 sums of B*H*W products in another order, then (bf16) one
    # rounding of the result to the weight's dtype
    want = conv3x3_wgrad_reference(xp, gy)
    _close(conv3x3_wgrad(xp, gy, dtype), want,
           2 ** -7 if dtype == torch.bfloat16 else 1e-4)
    _close(conv3x3_wgrad(xp, gy), want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_dgrad_makes_no_padded_copy(cuda, dtype):
    """The dgrad's zero pad comes from the kernel's loads and its weight is
    the forward's, read transposed: on the blocks' k (``hwio_weight``) no
    pad op runs on the card, and the conv kernel is the only kernel."""
    g = torch.Generator(device=cuda).manual_seed(6)
    gy = torch.randn(2, 16, 16, 128, device=cuda, generator=g).to(dtype)
    k = hwio_weight(torch.randn(128, 128, 3, 3, device=cuda, generator=g)
                    / 34, dtype)
    _close(conv3x3_dgrad(gy, k), conv3x3_dgrad_reference(gy.float(),
                                                         k.float()),
           2 ** -7 if dtype == torch.bfloat16 else 1e-5)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        dxp = conv3x3_dgrad(gy, k)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "pad" in n.lower()], names
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "conv3x3_" in kernels[0], kernels
    assert dxp.shape == (2, 18, 18, 128)


def test_conv3x3_dgrad_launches_from_a_fresh_thread(cuda):
    """On the blocks' k the dgrad makes no copy before its launch, so in a
    new thread (as autograd's backward worker is) its launch is the
    thread's first CUDA call; the tensor maps must still encode."""
    g = torch.Generator(device=cuda).manual_seed(7)
    gy = torch.randn(2, 8, 7, 24, device=cuda, generator=g).bfloat16()
    k = hwio_weight(torch.randn(24, 16, 3, 3, device=cuda, generator=g) / 12,
                    torch.bfloat16)
    out = {}

    def run():
        try:
            out["dxp"] = conv3x3_dgrad(gy, k)
            torch.cuda.synchronize()
        except Exception as e:      # re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    _close(out["dxp"], conv3x3_dgrad_reference(gy.float(), k.float()), 2 ** -7)


def _device_kernels(fn):
    """The names of the device kernels that one call of fn runs. A trace
    with no device event at all is taken again (up to three times): the
    profiler on the card's machine now and then drops a whole trace."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def test_conv3x3_wgrad_is_one_kernel(cuda):
    """bf16: the split partials are summed in the same launch, so one
    device kernel per call (no second summing kernel, no memset)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    xp = torch.randn(2, 18, 18, 128, device=cuda, generator=g).bfloat16()
    gy = torch.randn(2, 16, 16, 128, device=cuda, generator=g).bfloat16()
    kernels = _device_kernels(lambda: conv3x3_wgrad(xp, gy, torch.bfloat16))
    assert len(kernels) == 1 and "wgrad_wgmma_kernel" in kernels[0], kernels


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_backward_is_one_kernel(cuda, affine):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(2, 16, 16, 128, device=cuda, generator=g).bfloat16()
    dy = torch.randn(2, 16, 16, 128, device=cuda, generator=g).bfloat16()
    gm = (torch.randn(2, 128, device=cuda, generator=g) if affine
          else None)
    _, mean, rstd = instance_norm_forward_reference(x, gm, gm)
    kernels = _device_kernels(
        lambda: instance_norm_backward(dy, x, mean, rstd, gm))
    assert (len(kernels) == 1
            and "instance_norm_bwd_kernel" in kernels[0]), kernels


@pytest.mark.parametrize("shape", [(2, 32, 32, 128), (128, 8, 8, 256)])
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_forward_is_one_kernel(cuda, shape, affine):
    """One device kernel per call in both modes: the split over HW (first
    shape) and one chunk per group (second: 512 groups)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(*shape, device=cuda, generator=g).bfloat16()
    gm = (torch.randn(shape[0], shape[3], device=cuda, generator=g)
          if affine else None)
    kernels = _device_kernels(lambda: instance_norm(x, gm, gm))
    assert (len(kernels) == 1
            and "instance_norm_fwd_kernel" in kernels[0]), kernels


def test_conv3x3_wgrad_launches_from_a_fresh_thread(cuda):
    """The wgrad encodes tensor maps too, inside autograd's backward worker
    (a thread whose first CUDA call its launch may be)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    xp = torch.randn(2, 10, 9, 16, device=cuda, generator=g).bfloat16()
    gy = torch.randn(2, 8, 7, 24, device=cuda, generator=g).bfloat16()
    out = {}

    def run():
        try:
            out["dk"] = conv3x3_wgrad(xp, gy, torch.bfloat16)
            torch.cuda.synchronize()
        except Exception as e:      # re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    _close(out["dk"], conv3x3_wgrad_reference(xp, gy), 2 ** -7)


def test_conv3x3_wgrad_is_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    xp = torch.randn(8, 66, 66, 256, device=cuda, generator=g).bfloat16()
    gy = torch.randn(8, 64, 64, 256, device=cuda, generator=g).bfloat16()
    a = conv3x3_wgrad(xp, gy, torch.bfloat16)
    b = conv3x3_wgrad(xp, gy, torch.bfloat16)
    assert torch.equal(a, b)
    assert torch.equal(conv3x3_wgrad(xp.float(), gy.float()),
                       conv3x3_wgrad(xp.float(), gy.float()))


# the norm backward's shapes: the three of the train step's sites, small
# ones, and ragged ones: C not a multiple of the 16-byte vector (scalar
# loads), C past one 64-channel group
NORM_BWD_SHAPES = [(8, 64, 64, 256), (8, 128, 128, 128), (8, 256, 256, 64),
                   (2, 32, 32, 64), (2, 5, 7, 24), (2, 5, 7, 6),
                   (1, 3, 3, 200)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", NORM_BWD_SHAPES)
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_backward_kernel_matches_plain(cuda, dtype, shape,
                                                     affine):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    dy = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    gm = (torch.randn(shape[0], shape[3], device=cuda, generator=g)
          if affine else None)
    _, mean, rstd = instance_norm_forward_reference(x, gm, gm)
    got = instance_norm_backward(dy, x, mean, rstd, gm)
    want = instance_norm_backward_reference(dy, x, mean, rstd, gm)
    # bf16: dx rounds once from f32 on both sides; f32: sums over HW in
    # another order, through a difference of like terms
    _close(got[0], want[0], 2 ** -6 if dtype == torch.bfloat16 else 1e-4)
    if affine:
        _close(got[1], want[1], 1e-4)
        _close(got[2], want[2], 1e-4)
    else:
        assert got[1] is None and got[2] is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 64, 64, 256), (2, 5, 7, 24)])
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_backward_is_deterministic(cuda, dtype, shape, affine):
    """Split over HW, the partial sums are added in a fixed order: two calls
    on the same inputs are bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    dy = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    gm = (torch.randn(shape[0], shape[3], device=cuda, generator=g)
          if affine else None)
    _, mean, rstd = instance_norm_forward_reference(x, gm, gm)
    a = instance_norm_backward(dy, x, mean, rstd, gm)
    b = instance_norm_backward(dy, x, mean, rstd, gm)
    for u, v in zip(a, b):
        assert (u is None and v is None) or torch.equal(u, v)


def test_train_step_on_gpu_matches_cpu(cuda):
    """Two steps of the tiny council-2 config in f32 (parity mode) on the
    card and on the CPU, from the same weights, batch and z."""
    raw = {"batch_size": 2, "lr": 1e-4, "parity_mode": True,
           "compute_dtype": "float32",
           "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3,
                   "n_downsample": 2, "n_res": 2},
           "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
           "council": {"council_size": 2, "council_w": 0.2},
           "data": {"crop_image_height": 32, "crop_image_width": 32}}
    cfg = Config.from_dict(raw)
    cpu = CouncilTrainer(cfg, device="cpu")
    cpu_state = cpu.init_state(seed=0)
    gpu = CouncilTrainer(cfg, device=cuda)
    gpu_state = gpu.load_state(cpu_state.state_dicts())
    r = np.random.default_rng(0)
    x_a, x_b = (r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
                for _ in range(2))
    before = conv3x3_wgrad.launches
    for _ in range(2):
        zs = cpu.draw_zs(cpu_state, 2)
        cpu_state, want = cpu.train_step(cpu_state, x_a, x_b, zs=zs)
        gpu_state, got = gpu.train_step(gpu_state, x_a, x_b, zs=zs)
        for k in want:
            # f32, TF32 off, sums in another order through ~40 layers
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=k)
    assert conv3x3_wgrad.launches > before


# ---------------------------------------------------------------------------
# inputs the kernels once refused: the norm backward at any batch, the conv
# at channel counts that are not multiples of 8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_backward_at_batch_128(cuda, dtype, affine):
    """(128, 64, 64, 256): 512 groups, more than one cooperative launch
    holds in bf16 (396 blocks on an H100) and too many to split in f32, so
    one plain launch of a block per group; it matches the plain version and
    two calls are bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(15)
    shape = (128, 64, 64, 256)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    dy = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    gm = (torch.randn(128, 256, device=cuda, generator=g) if affine
          else None)
    cap = norm_ops._norm_bwd_capacity(cuda, 1 if dtype == torch.bfloat16
                                      else 0, 16 // x.element_size(),
                                      affine)
    assert norm_ops._norm_bwd_grid(128, 64 * 64, 256,
                                   16 // x.element_size(), cap)[0] == 1
    _, mean, rstd = instance_norm_forward_reference(x, gm, gm)
    before = instance_norm_backward.launches
    got = instance_norm_backward(dy, x, mean, rstd, gm)
    again = instance_norm_backward(dy, x, mean, rstd, gm)
    assert instance_norm_backward.launches == before + 2
    want = instance_norm_backward_reference(dy, x, mean, rstd, gm)
    # as test_instance_norm_backward_kernel_matches_plain
    _close(got[0], want[0], 2 ** -6 if dtype == torch.bfloat16 else 1e-4)
    if affine:
        _close(got[1], want[1], 1e-4)
        _close(got[2], want[2], 1e-4)
    for u, v in zip(got, again):
        assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,o", [(12, 20), (3, 8), (16, 5)])
def test_conv3x3_at_channels_not_multiples_of_8(cuda, dtype, c, o):
    """C and O are zero-padded to multiples of 8 around the same kernels:
    forward, dgrad and wgrad each launch once and match the plain
    versions."""
    g = torch.Generator(device=cuda).manual_seed(16)
    b, h, w = 2, 17, 23
    xp = torch.randn(b, h + 2, w + 2, c, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, c, o, device=cuda, generator=g)
         / (9 * c) ** 0.5).to(dtype)
    gy = torch.randn(b, h, w, o, device=cuda, generator=g).to(dtype)
    counts = (conv3x3_valid.launches, conv3x3_dgrad.launches,
              conv3x3_wgrad.launches)
    y = conv3x3_valid(xp, k)
    dxp = conv3x3_dgrad(gy, k)
    dk = conv3x3_wgrad(xp, gy, dtype)
    torch.cuda.synchronize()
    assert (conv3x3_valid.launches, conv3x3_dgrad.launches,
            conv3x3_wgrad.launches) == tuple(n + 1 for n in counts)
    assert y.shape == (b, h, w, o) and dxp.shape == xp.shape
    assert dk.shape == (3, 3, c, o)
    # as test_conv3x3_kernel_matches_plain and the backward test: one
    # rounding of an f32 sum (bf16), or sums in another order (f32)
    rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    _close(y, conv3x3_valid_reference(xp.float(), k.float()), rel)
    _close(dxp, conv3x3_dgrad_reference(gy.float(), k.float()), rel)
    _close(dk, conv3x3_wgrad_reference(xp, gy),
           2 ** -7 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,o", [(8, 64, 64, 256, 256), (3, 17, 45, 72,
                                                               136),
                                       (2, 33, 31, 200, 264),
                                       (2, 9, 7, 12, 20)])
def test_conv3x3_pad1_kernels_match_plain(cuda, dtype, b, h, w, c, o):
    """K1 at a zero pad of 1 on the unpadded input (the strips engine's
    interior), its dgrad at pad 1 and K2 with the pad in its loads, each
    once per call through the autograd Function, against the plain
    versions; no pad op runs on the card where C and O are multiples of 8
    (others have their channels zero-padded around the same kernels)."""
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(b, h, w, c, device=cuda, generator=g).to(dtype)
    k = hwio_weight(torch.randn(o, c, 3, 3, device=cuda, generator=g)
                    / (9 * c) ** 0.5, dtype)
    gy = torch.randn(b, h, w, o, device=cuda, generator=g).to(dtype)
    xl, kl = x.clone().requires_grad_(), k.detach().clone().requires_grad_()
    counts = (conv3x3_valid.launches, conv3x3_valid.grad_launches,
              conv3x3_dgrad.launches, conv3x3_wgrad.launches)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        y = conv3x3_same_zero(xl, kl)
        dx, dk = torch.autograd.grad(y, (xl, kl), gy)
        torch.cuda.synchronize()
    assert (conv3x3_valid.launches, conv3x3_valid.grad_launches,
            conv3x3_dgrad.launches, conv3x3_wgrad.launches) == tuple(
                n + 1 for n in counts)
    names = [e.key for e in prof.key_averages()]
    if c % 8 == 0 and o % 8 == 0:
        assert not [n for n in names if "pad" in n.lower()], names
    assert y.shape == (b, h, w, o) and dx.shape == x.shape
    rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    _close(y, conv3x3_same_zero_reference(x.float(), k.float()), rel)
    _close(dx, conv3x3_dgrad_reference(gy.float(), k.float(), 1), rel)
    _close(dk, conv3x3_wgrad_reference(x, gy, 1),
           2 ** -7 if dtype == torch.bfloat16 else 1e-4)


# ---------------------------------------------------------------------------
# the train loop's data path on the card
# ---------------------------------------------------------------------------


def test_augment_on_the_card_equals_the_cpu(cuda):
    """The crop-and-flip gather and the normalize on the card give the CPU
    result bit for bit, at the headline shape (batch 8, 270 -> 256)."""
    from councilx_torch.data.ondevice import augment_batch, draw_crops

    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 270, 270, 3), dtype=np.uint8))
    crops = draw_crops(0, 3, 0, range(8), 270, 270, 256, 256)
    want = augment_batch(x, 256, 256, crops=crops)
    got = augment_batch(x.pin_memory().to(cuda, non_blocking=True), 256,
                        256, crops=crops.pin_memory())
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert torch.equal(augment_batch(x.to(cuda), 256, 256, train=False).cpu(),
                       augment_batch(x, 256, 256, train=False))


# ---------------------------------------------------------------------------
# the W8A8 kernels: Q2 (activation quantize) and Q1 (int8 conv)
# ---------------------------------------------------------------------------


QUANT_SHAPES = [  # x (B, H, W, C), pad, pad type, kernel, stride, O
    ((2, 9, 11, 24), 1, "reflect", 3, 1, 20),
    ((3, 16, 16, 64), 1, "reflect", 4, 2, 40),
    ((2, 8, 8, 32), 1, "replicate", 3, 1, 128),
    ((1, 5, 7, 12), 2, "zero", 5, 1, 8),
    ((2, 64, 64, 256), 1, "reflect", 3, 1, 256),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,pad,pad_type,k,stride,o", QUANT_SHAPES)
def test_quant_kernels_match_plain(cuda, dtype, shape, pad, pad_type, k,
                                   stride, o):
    """Q2's codes and scales (static and per image) and Q1's int32
    accumulator and output are bit-equal to the plain versions."""
    from councilx_torch.ops import quant as q_ops

    g = torch.Generator(device=cuda).manual_seed(21)
    x = (torch.randn(*shape, device=cuda, generator=g) * 2).to(dtype)
    c = shape[-1]
    w = q_ops.quantize_weights(torch.randn(k, k, c, o, device=cuda,
                                           generator=g) / (k * k * c) ** 0.5)
    bias = torch.randn(o, device=cuda, generator=g)
    counts = (q_ops.quantize_act.launches,
              q_ops.quantize_act.per_image_launches, q_ops.conv_int8.launches)
    for a_scale in (None, (x.float().abs().amax() * 0.8 / 127).reshape(())):
        q, a_s = q_ops.quantize_act(x, pad, pad_type, a_scale)
        want_q, want_s = q_ops.quantize_act_reference(x, pad, pad_type,
                                                      a_scale)
        torch.cuda.synchronize()
        assert torch.equal(q[..., :c], want_q) and not q[..., c:].any()
        assert torch.equal(a_s.reshape(-1), want_s.reshape(-1))
        for out in (torch.int32, dtype):
            b = None if out == torch.int32 else bias
            got = q_ops.conv_int8(q, w, a_s, b, stride, out)
            want = q_ops.conv_int8_reference(want_q, w, want_s, b, stride,
                                             out)
            torch.cuda.synchronize()
            assert got.dtype == out and torch.equal(got, want)
    assert (q_ops.quantize_act.launches,
            q_ops.quantize_act.per_image_launches,
            q_ops.conv_int8.launches) == (counts[0] + 2, counts[1] + 1,
                                          counts[2] + 4)


# ragged cases of the TMA + wgmma Q1 and the one-pass Q2: chip_smoke.py's
# (batch 1 with M under one 128-pixel tile; tiles that straddle two images,
# per-image scales; both strides; C in {16, 64, 128, 256}; O in {8, 24,
# 128, 512}), and Q2's grid wait over 4 images with Q1's 128-channel tile
@pytest.mark.parametrize("shape,pad,pad_type,k,stride,o",
                         chip_smoke.QUANT_RAGGED + (
                             ((4, 32, 32, 128), 1, "replicate", 3, 1, 8),))
def test_quant_kernels_at_ragged_shapes(cuda, shape, pad, pad_type, k,
                                        stride, o):
    """Q2 (both modes) and Q1 (int32, bf16 and f32 out) bit-equal to their
    plain versions at the ragged shapes, and each bit-equal over two
    launches."""
    from councilx_torch.ops import quant as q_ops

    g = torch.Generator(device=cuda).manual_seed(sum(shape) + k + o)
    x = (torch.randn(*shape, device=cuda, generator=g) * 2).bfloat16()
    c = shape[-1]
    w = q_ops.quantize_weights(torch.randn(k, k, c, o, device=cuda,
                                           generator=g) / (k * k * c) ** 0.5)
    bias = torch.randn(o, device=cuda, generator=g)
    for a_scale in (None, (x.float().abs().amax() * 0.8 / 127).reshape(())):
        q, a_s = q_ops.quantize_act(x, pad, pad_type, a_scale)
        q2, a_s2 = q_ops.quantize_act(x, pad, pad_type, a_scale)
        want_q, want_s = q_ops.quantize_act_reference(x, pad, pad_type,
                                                      a_scale)
        torch.cuda.synchronize()
        assert torch.equal(q[..., :c], want_q) and not q[..., c:].any()
        assert torch.equal(a_s.reshape(-1), want_s.reshape(-1))
        assert torch.equal(q, q2) and torch.equal(a_s, a_s2)
        for out in (torch.int32, torch.bfloat16, torch.float32):
            b = None if out == torch.int32 else bias
            got = q_ops.conv_int8(q, w, a_s, b, stride, out)
            again = q_ops.conv_int8(q, w, a_s, b, stride, out)
            want = q_ops.conv_int8_reference(want_q, w, want_s, b, stride,
                                             out)
            torch.cuda.synchronize()
            assert got.dtype == out and torch.equal(got, want), (a_scale,
                                                                 out)
            assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(1, 64, 64, 256), (8, 64, 64, 256),
                                   (64, 16, 16, 64)])
def test_quantize_act_per_image_is_one_kernel(cuda, shape):
    """Q2's per-image mode is one device kernel (its grid wait inside),
    at bucket 1, 8 and 64; so is Q1, with an f32 bias of O channels too
    (no copy of it)."""
    from councilx_torch.ops import quant as q_ops

    x = torch.randn(*shape, device=cuda).bfloat16()
    names = _device_kernels(lambda: q_ops.quantize_act(x, 1, "reflect"))
    assert len(names) == 1 and "quant_kernel" in names[0], names
    q, a_s = q_ops.quantize_act(x, 1, "reflect")
    w = q_ops.quantize_weights(torch.randn(3, 3, shape[-1], 64,
                                           device=cuda))
    bias = torch.randn(64, device=cuda)
    for bs in (None, bias):
        names = _device_kernels(lambda: q_ops.conv_int8(q, w, a_s, bs))
        assert len(names) == 1 and "conv_int8_kernel" in names[0], names


def test_quant_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from councilx_torch.ops import quant as q_ops

    x = torch.zeros(1, 6, 6, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype|bf16"):
        q_ops.quantize_act(x.half(), 1, "reflect")
    with pytest.raises(ValueError, match="contiguous"):
        q_ops.quantize_act(x.transpose(1, 2), 1, "reflect")
    w = q_ops.quantize_weights(torch.zeros(3, 3, 16, 8, device=cuda))
    with pytest.raises(ValueError, match="padded"):
        q_ops.conv_int8(torch.zeros(1, 6, 6, 12, dtype=torch.int8,
                                    device=cuda), w,
                        torch.ones((), device=cuda))


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_static"])
def test_quantized_translate_on_gpu_matches_cpu(cuda, mode):
    """smoke_tiny (f32) with every heavy conv quantized: the card's Q1/Q2
    path against the CPU's plain one, and the launches per forward."""
    from councilx_torch.ops import quant as q_ops

    raw = dict(load_config(os.path.join(REPO, "configs",
                                        "smoke_tiny.yaml")).to_dict())
    raw.update(quant=mode, quant_scope="heavy")
    cfg = Config.from_dict(raw)
    cpu = Translator(Config.from_dict({**raw, "quant": "none"}),
                     device="cpu")
    sds = [{k: v.cpu() for k, v in g.state_dict().items()}
           for g in cpu.init_members(1, seed=0)]
    stats = None
    if mode == "w8a8_static":
        from councilx_torch.ckpt.torch_convert import port_quant_stats_to_tree
        from councilx_torch.tools import calibrate_quant
        gen = cpu.make_gen(quant="w8a8_calib")
        gen.load_state_dict(sds[0])
        stats = port_quant_stats_to_tree(calibrate_quant.calibrate(
            cpu, gen, calibrate_quant.calibration_batches(cfg, None, 2, 1, 0),
            2, 0), cfg)
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    z = r.standard_normal((3, 3)).astype(np.float32)
    tr_cpu = Translator(cfg, quant_stats=stats, device="cpu")
    want = tr_cpu.translate(tr_cpu.load_members(sds)[0], x, z=z)[0]
    gpu = Translator(cfg, quant_stats=stats, device=cuda)
    gen = gpu.load_members(sds)[0]
    counts = (q_ops.conv_int8.launches, conv3x3_valid.launches)
    got = gpu.translate(gen, x, z=z)[0].cpu()
    # 2 downsamples, 2 x 2 x 2 resblock convs, 2 upsample phase convs
    assert q_ops.conv_int8.launches - counts[0] == 12
    assert conv3x3_valid.launches == counts[1]
    d = (got - want).abs()
    assert float(d.mean()) <= 1e-3 and float(d.max()) <= 5e-2


# ---------------------------------------------------------------------------
# the captured routes (utils/graphs.py): each replay bit-equal to the eager
# call it captured
# ---------------------------------------------------------------------------


def _coop_cases(cuda):
    """The three cooperative launches, at shapes that take them: the norm
    forward and backward split over HW (batch 1 at 256x256), and Q2 per
    image."""
    from councilx_torch.ops import quant as q_ops

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(1, 256, 256, 64, device=cuda, generator=g).bfloat16()
    dy = torch.randn(1, 256, 256, 64, device=cuda, generator=g).bfloat16()
    gm = torch.randn(1, 64, device=cuda, generator=g)
    _, mean, rstd = norm_ops._forward(x, gm, gm, 1e-5)
    xq = torch.randn(1, 64, 64, 256, device=cuda, generator=g).bfloat16()
    return {
        "norm_fwd": lambda: instance_norm(x, gm, gm),
        "norm_bwd": lambda: instance_norm_backward(dy, x, mean, rstd, gm)[0],
        "quant_per_image": lambda: q_ops.quantize_act(xq, 1, "reflect")[0]}


@pytest.mark.parametrize("case", ["norm_fwd", "norm_bwd", "quant_per_image"])
def test_cooperative_launch_is_captured(cuda, case):
    """A cooperative launch inside a CUDA graph replays bit-equal to the
    eager launch (a capture the runtime refused would raise)."""
    from councilx_torch.utils.graphs import CaptureContext

    fn = _coop_cases(cuda)[case]
    ctx = CaptureContext(cuda)
    want = ctx.run(fn).clone()
    call = ctx.capture(fn, [], case)
    got = call().clone()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _serving_cfg():
    raw = dict(chip_smoke.FLAGSHIP)
    raw["gen"] = {**raw["gen"], "n_res": 2}
    return Config.from_dict(raw)


@pytest.mark.parametrize("bucket", [1, 8])
@pytest.mark.parametrize("method", ["translate_u8io_device",
                                    "translate_all_u8io_device"])
def test_captured_serving_call_is_the_eager_one(cuda, bucket, method):
    """The flagship serving model (n_res cut to 2) at buckets 1 and 8:
    the replayed graph's uint8 output bit-equal to the eager call's, on
    two different inputs (the second through the static buffers)."""
    cfg = _serving_cfg()
    tr = Translator(cfg, device=cuda)
    gens = tr.init_members(2, seed=0)
    params = gens if "all" in method else gens[0]
    call = tr.captured(method, params, bucket, (256, 256))
    r = np.random.default_rng(bucket)
    for _ in range(2):
        x = r.integers(0, 256, (bucket, 256, 256, 3), dtype=np.uint8)
        z = r.standard_normal((bucket, cfg.gen.style_dim)).astype(
            np.float32)
        got = call(torch.from_numpy(x), torch.from_numpy(z)).cpu()
        want = getattr(tr, method)(params, x, z).cpu()
        assert torch.equal(got, want)


def test_engine_pipeline_returns_each_request_its_own_image(cuda):
    """Back-to-back distinct full batches through the 2-deep pipeline on
    the captured route: every request gets its own image, bit-equal to
    the eager call of its batch."""
    from councilx_torch.inference.server import BatchingEngine

    cfg = _serving_cfg()
    tr = Translator(cfg, device=cuda)
    gen = tr.init_members(1, seed=1)[0]
    engine = BatchingEngine(tr, gen, (256, 256), max_batch=8,
                            max_delay_ms=500.0)
    assert engine.graphs
    r = np.random.default_rng(2)
    images = r.integers(0, 256, (48, 256, 256, 3), dtype=np.uint8)
    engine.start()
    try:
        engine.warmup([8])
        futures = [engine.submit(im, seed=i) for i, im in enumerate(images)]
        outs = [f.result(timeout=300) for f in futures]
        stats = engine.snapshot_stats()
    finally:
        engine.stop()
    assert stats["batch_size_histogram"] == {8: 6}, stats
    zs = np.stack([engine.make_z(i) for i in range(48)])
    for j in range(0, 48, 8):
        want = tr.translate_u8io(gen, images[j:j + 8], z=zs[j:j + 8])
        for i in range(8):
            np.testing.assert_array_equal(outs[j + i], want[i])
    assert len({o.tobytes() for o in outs}) == 48


# the one-process trainer's options, at chip_smoke's reduced config
GRAPH_VARIANTS = {
    "float32": {},
    "bfloat16": {"compute_dtype": "bfloat16"},
    "remat": {"compute_dtype": "bfloat16", "remat": True},
    "remat_nested": {"compute_dtype": "bfloat16", "remat": True,
                     "remat_stages": True},
    "member_chunks": {"compute_dtype": "bfloat16", "gen_member_chunks": 2},
    "per_phase_guarded": {"compute_dtype": "bfloat16", "z_mode": "per_phase",
                          "skip_nonfinite_updates": True},
    "dis_shared_k_per_step": {
        "compute_dtype": "bfloat16", "z_mode": "dis_shared",
        "council": {"council_size": 2, "council_w": 0.2,
                    "council_dis_relative_iteration": 2,
                    "cdis_ratio_mode": "k_per_step"}},
    "both_directions_no_focus": {"compute_dtype": "bfloat16",
                                 "do_b2a": True,
                                 "focus_loss": {"focus_enabled": False}},
    "engines": {"compute_dtype": "bfloat16", "upsample_engine": "phase",
                "resblock_fuse_pad": True},
    "vgg": {"compute_dtype": "bfloat16", "vgg_w": 1.0},
}


@pytest.mark.parametrize("variant", sorted(GRAPH_VARIANTS))
def test_captured_train_steps_are_the_eager_ones(cuda, tmp_path, variant):
    """chip_smoke's reduced config under each option of the one-process
    trainer: one eager warm-up call and three replays of the compiled
    step, every metric, parameter and Adam moment bit-equal to four eager
    steps from the same weights, batch and z (cuDNN deterministic: the
    discriminators' convs)."""
    raw = {**chip_smoke.REDUCED, **GRAPH_VARIANTS[variant]}
    if variant == "vgg":
        raw["vgg_model_path"] = chip_smoke.write_random_vgg(
            str(tmp_path / "vgg16.npz"))
    cfg = Config.from_dict(raw)
    torch.backends.cudnn.deterministic = True
    try:
        eager = CouncilTrainer(cfg, device=cuda)
        ref = eager.init_state(seed=0)
        comp = CouncilTrainer(cfg, device=cuda)
        state = comp.load_state(ref.state_dicts(), seed=1)
        ref = eager.load_state(ref.state_dicts(), seed=1)
        step = comp.compile_step(state)
        r = np.random.default_rng(0)
        x_a, x_b = (torch.from_numpy(r.uniform(-1, 1, (2, 64, 64, 3)).astype(
            np.float32)).to(cuda) for _ in range(2))
        for i in range(4):
            # each draws its z from its own generator, seeded alike
            ref, want = eager.train_step(ref, x_a, x_b)
            state, got = step(state, x_a, x_b)
            for k in want:
                assert torch.equal(got[k], want[k].float()), (i, k)
        assert sum(c.replays for c, _ in step.calls.values()) == 3
        a, b = state.snapshot(), ref.snapshot()
        assert chip_smoke.payload_diff(a, b) == []
    finally:
        torch.backends.cudnn.deterministic = False


def test_captured_device_marks_time_each_replay(cuda):
    """A step captured while tracing holds its five device marks as event
    nodes: after each replay and a synchronize their four intervals read,
    every one positive, and sum to within 5% of an event pair around the
    replay; the replays stay bit-equal to a step captured untraced. The
    clock anchor's wait is its error."""
    from councilx_torch.utils import trace

    cfg = Config.from_dict(chip_smoke.REDUCED)
    r = np.random.default_rng(0)
    x_a, x_b = (torch.from_numpy(r.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)).to(cuda) for _ in range(2))
    torch.backends.cudnn.deterministic = True
    got = {}
    try:
        for record in (False, True):
            trainer = CouncilTrainer(cfg, device=cuda)
            state = trainer.init_state(seed=0)
            step = trainer.compile_step(state)
            if record:
                trace.clear()
                trace.on()
            try:
                got[record] = []
                for i in range(5):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    _, m = step(state, x_a, x_b)
                    b.record()
                    torch.cuda.synchronize()
                    got[record].append(m)
                    if record and i >= 2:
                        ph = step.phase_ms()
                        assert list(ph) == ["translate", "cdis", "dis",
                                            "gen"]
                        assert min(ph.values()) > 0, ph
                        pair = a.elapsed_time(b)
                        assert abs(sum(ph.values()) / pair - 1) < 0.05, \
                            (ph, pair)
                anchor = trace.clock_anchor(cuda)
            finally:
                trace.off()
            if not record:
                assert step.phase_ms() == {}
        assert 0 <= anchor.error_ns < 1e9
        names = [r[0] for r in trace.records()]
        assert names.count("step.replay") == 4
        assert names.count("setup.capture") == 1
        for want, have in zip(got[False], got[True]):
            for k in want:
                assert torch.equal(want[k], have[k]), k
    finally:
        torch.backends.cudnn.deterministic = False
        trace.clear()


@pytest.mark.parametrize("variant", ["dis_shared", "member_chunks"])
def test_captured_step_after_a_sample_reads_the_live_weights(cuda, variant):
    """The fakes of a no-grad generator forward (``dis_shared``, member
    chunks) read the engines' derived weights (phase-packed 7x7, dilated
    6x6) from the blocks' cache: a ``sample`` between the warm-up and the
    capture, and after every replay, leaves an eager entry that the graph
    must neither freeze nor read after the next sample frees it. Four
    replays, each step and each sample bit-equal to an eager trainer's."""
    raw = {**chip_smoke.REDUCED, "compute_dtype": "bfloat16"}
    if variant == "dis_shared":
        raw["z_mode"] = "dis_shared"
    else:
        raw["gen_member_chunks"] = 2
    cfg = Config.from_dict(raw)
    torch.backends.cudnn.deterministic = True
    try:
        eager = CouncilTrainer(cfg, device=cuda)
        ref = eager.init_state(seed=0)
        comp = CouncilTrainer(cfg, device=cuda)
        state = comp.load_state(ref.state_dicts(), seed=1)
        ref = eager.load_state(ref.state_dicts(), seed=1)
        step = comp.compile_step(state)
        r = np.random.default_rng(3)
        x_a, x_b = (torch.from_numpy(r.uniform(-1, 1, (2, 64, 64, 3)).astype(
            np.float32)).to(cuda) for _ in range(2))
        z = torch.from_numpy(r.standard_normal(
            (cfg.council.council_size, 2, cfg.gen.style_dim)).astype(
            np.float32))
        for i in range(5):
            ref, want = eager.train_step(ref, x_a, x_b)
            state, got = step(state, x_a, x_b)
            for k in want:
                assert torch.equal(got[k], want[k].float()), (i, k)
            # the sample's z is given, so the steps' z streams stay alike
            got_s = comp.sample(state, x_a, z=z)[0]
            want_s = eager.sample(ref, x_a, z=z)[0]
            assert torch.equal(got_s, want_s), i
        assert sum(c.replays for c, _ in step.calls.values()) == 4
        assert chip_smoke.payload_diff(state.snapshot(), ref.snapshot()) == []
    finally:
        torch.backends.cudnn.deterministic = False


# ---------------------------------------------------------------------------
# the multi-device routes captured: the NCCL train steps in a world of one
# rank, and the sharded translators over the card named twice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trainer_name", ["DataParallelTrainer",
                                          "CouncilShardTrainer"])
def test_world_one_nccl_compiled_steps_are_the_eager_ones(cuda, tmp_path,
                                                          trainer_name):
    """chip_smoke's reduced config with the skip-nonfinite gate on (the
    MIN over the world) in an NCCL group of one rank: one eager warm-up
    call and three replays of the compiled step, with the graphs' all-
    reduces and gathers inside, every metric, parameter and Adam moment
    bit-equal to four eager steps of the same trainer type; between the
    steps an eager sample and snapshot on the same communicators, equal
    too."""
    import torch.distributed as dist

    from councilx_torch.parallel.council_shard import CouncilShardTrainer
    from councilx_torch.parallel.mesh import DataParallelTrainer, make_mesh

    cfg = Config.from_dict({**chip_smoke.REDUCED, "compute_dtype": "bfloat16",
                            "skip_nonfinite_updates": True})
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        def make():
            if trainer_name == "DataParallelTrainer":
                return DataParallelTrainer(cfg, make_mesh(1), device=cuda)
            return CouncilShardTrainer(cfg, make_mesh(1, always_2d=True),
                                       device=cuda)

        eager, comp = make(), make()
        ref = eager.init_state(seed=0)
        state = comp.load_state(ref.state_dicts(), seed=1)
        ref = eager.load_state(ref.state_dicts(), seed=1)
        step = comp.compile_step(state)
        r = np.random.default_rng(5)
        x_a, x_b = (torch.from_numpy(r.uniform(-1, 1, (2, 64, 64, 3)).astype(
            np.float32)).to(cuda) for _ in range(2))
        z = torch.from_numpy(r.standard_normal(
            (cfg.council.council_size, 2, cfg.gen.style_dim)).astype(
            np.float32))
        for i in range(4):
            ref, want = eager.train_step(ref, x_a, x_b)
            state, got = step(state, x_a, x_b)
            for k in want:
                assert torch.equal(got[k], want[k].float()), (i, k)
            assert torch.equal(comp.sample(state, x_a, z=z)[0],
                               eager.sample(ref, x_a, z=z)[0]), i
            assert chip_smoke.payload_diff(comp.snapshot(state),
                                           eager.snapshot(ref)) == [], i
        assert sum(c.replays for c, _ in step.calls.values()) == 3
        assert trainer_name in next(iter(step.calls.values()))[0].name
        # destroying the group waits for the graphs that hold its
        # collectives
        del step
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("layout", ["D=2", "K=2"])
def test_sharded_captured_call_is_the_eager_one(cuda, layout):
    """The flagship serving model (n_res cut to 2) over the card named
    twice: a sharded translator's captured call at bucket 8 bit-equal to
    its eager call on two inputs, the first result unchanged by the second
    call (the gather copies out of the graphs' outputs); then its engine
    on the captured route returns the eager engine's images."""
    from councilx_torch.inference.server import BatchingEngine
    from councilx_torch.inference.translate import (MemberShardedTranslator,
                                                    ShardedTranslator)
    from councilx_torch.parallel.mesh import make_member_mesh

    cfg = _serving_cfg()
    sds = [g.state_dict() for g in Translator(cfg, device="cpu")
           .init_members(cfg.council.council_size, seed=2)]
    if layout == "D=2":
        tr = ShardedTranslator(cfg, [cuda, cuda])
        params = tr.load_members(sds)[0]
        method = "translate_u8io_device"
    else:
        tr = MemberShardedTranslator(cfg, make_member_mesh(
            2, devices=[cuda, cuda]))
        params = tr.load_members(sds)
        method = "translate_all_u8io_device"
    call = tr.captured(method, params, 8, (256, 256))
    r = np.random.default_rng(6)
    kept = None
    for _ in range(2):
        x = r.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
        z = r.standard_normal((8, cfg.gen.style_dim)).astype(np.float32)
        got = call(torch.from_numpy(x), torch.from_numpy(z))
        want = getattr(tr, method)(params, x, z)
        assert torch.equal(got, want)
        if kept is None:
            kept, first = got, want.clone()
    assert torch.equal(kept, first)
    images = r.integers(0, 256, (16, 256, 256, 3), dtype=np.uint8)
    outs = {}
    for graphs in (False, True):
        engine = BatchingEngine(tr, params, (256, 256), max_batch=8,
                                max_delay_ms=500.0,
                                all_members=layout != "D=2")
        assert engine.graphs
        engine.graphs = graphs
        engine.start()
        try:
            engine.warmup([8])
            outs[graphs] = [f.result(timeout=300) for f in
                            [engine.submit(im, seed=i)
                             for i, im in enumerate(images)]]
        finally:
            engine.stop()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    tr.close()


# ---------------------------------------------------------------------------
# P1 / P1': the reflect and replicate pad (csrc/pad_nhwc.cu) and its fold
# ---------------------------------------------------------------------------

# the pad's shape classes: the image (C 3) and the council discriminator's
# input (C 6, odd H and W: sub-16-byte words), batch 1, the decoder's and
# the resblocks' widths (odd H), the strips engine's 2p-wide border slices
# of rows and of columns, and channels that are not innermost
PAD_CASES = ["c3", "c6_odd", "c64_b1", "c128", "c256_odd", "row_strip",
             "col_strip", "channels_strided"]


def _pad_input(case, p, dtype, g, device):
    def randn(*dims):
        return torch.randn(*dims, device=device, generator=g).to(dtype)

    if case == "c3":
        return randn(2, 16, 16, 3)
    if case == "c6_odd":
        return randn(2, 17, 9, 6)
    if case == "c64_b1":
        return randn(1, 12, 15, 64)
    if case == "c128":
        return randn(2, 8, 8, 128)
    if case == "c256_odd":
        return randn(2, 9, 16, 256)
    if case == "row_strip":
        return randn(2, 16, 16, 256)[:, :2 * p]
    if case == "col_strip":
        return randn(2, 16, 16, 64)[:, :, -2 * p:]
    return randn(2, 64, 9, 10).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("pad_type", ["reflect", "replicate"])
@pytest.mark.parametrize("case", PAD_CASES)
def test_pad_kernel_is_the_gather(cuda, case, pad_type, p, dtype):
    """P1 copies values: bit-equal to the index gather, one launch."""
    g = torch.Generator(device=cuda).manual_seed(p)
    x = _pad_input(case, p, dtype, g, cuda)
    before = pad_ops.pad_nhwc.launches
    got = pad_ops.pad_nhwc(x, p, pad_type)
    torch.cuda.synchronize()
    assert pad_ops.pad_nhwc.launches == before + 1
    assert got.is_contiguous()
    assert torch.equal(got, pad_ops.pad_reference(x, p, pad_type))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("pad_type", ["reflect", "replicate"])
@pytest.mark.parametrize("case", PAD_CASES)
def test_pad_fold_is_the_gathers_gradient(cuda, case, pad_type, p, dtype):
    """P1' through autograd against the plain fold in f64 (the oracle) and
    against autograd's gradient of the gather: f32 to 1e-6 relative (sums
    of at most sixteen f32 terms in another order); bf16 within one
    rounding of the f64 sum element by element. The gather's bf16 gradient
    rounds more than once where several padded positions fold onto one
    pixel (up to two bf16 steps from P1''s at 4 to 16 terms, on an H100),
    so against it P1' is held to that gradient's own distance from the sum
    plus one rounding."""
    g = torch.Generator(device=cuda).manual_seed(10 + p)
    x = _pad_input(case, p, dtype, g, cuda)
    b, h, w, c = x.shape
    shape = (b, h + 2 * p, w + 2 * p, c)
    dy = (torch.randn(b, c, shape[1], shape[2], device=cuda,
                      generator=g).permute(0, 2, 3, 1)
          if case == "channels_strided"
          else torch.randn(shape, device=cuda, generator=g)).to(dtype)
    leaf = x.detach().requires_grad_()
    before = pad_ops.pad_fold.launches
    got, = torch.autograd.grad(pad_ops.pad_nhwc(leaf, p, pad_type), leaf,
                               dy)
    torch.cuda.synchronize()
    assert pad_ops.pad_fold.launches == before + 1
    leaf = x.detach().requires_grad_()
    want, = torch.autograd.grad(pad_ops.pad_reference(leaf, p, pad_type),
                                leaf, dy)
    oracle = pad_ops.pad_fold_reference(dy.double(), h, w, p, pad_type)
    if dtype == torch.float32:
        _close(got, oracle, 1e-6)
        _close(got, want, 1e-6)
        return
    # one round to nearest of the f32 sum, which holds the bf16 terms'
    # sum exactly but where their exponents lie far apart
    err = (got.double() - oracle).abs()
    one = 2 ** -8 * oracle.abs() + 2 ** -20 * oracle.abs().max()
    assert (err <= one).all(), err.max().item()
    gap = (got.double() - want.double()).abs()
    assert (gap <= (want.double() - oracle).abs() + one).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pad_type", ["reflect", "replicate"])
def test_pad_fold_is_deterministic(cuda, dtype, pad_type):
    g = torch.Generator(device=cuda).manual_seed(21)
    dy = torch.randn(8, 66, 66, 256, device=cuda, generator=g).to(dtype)
    first = pad_ops.pad_fold(dy, 64, 64, 1, pad_type)
    for _ in range(3):
        assert torch.equal(pad_ops.pad_fold(dy, 64, 64, 1, pad_type), first)


def test_pad_is_one_kernel_each_way(cuda):
    g = torch.Generator(device=cuda).manual_seed(22)
    x = torch.randn(2, 32, 32, 128, device=cuda, generator=g).bfloat16()
    dy = torch.randn(2, 34, 34, 128, device=cuda, generator=g).bfloat16()
    kernels = _device_kernels(lambda: pad_ops.pad_nhwc(x, 1, "reflect"))
    assert len(kernels) == 1 and "pad_nhwc_kernel" in kernels[0], kernels
    kernels = _device_kernels(
        lambda: pad_ops.pad_fold(dy, 32, 32, 1, "reflect"))
    assert len(kernels) == 1 and "pad_fold_kernel" in kernels[0], kernels


def test_pad_kernels_are_captured(cuda):
    """P1 and P1' replayed from a CUDA graph, bit-equal to eager."""
    from councilx_torch.utils.graphs import CaptureContext

    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn(4, 20, 24, 64, device=cuda, generator=g).bfloat16()
    dy = torch.randn(4, 26, 30, 64, device=cuda, generator=g).bfloat16()
    fns = {"pad": lambda: pad_ops.pad_nhwc(x, 3, "reflect"),
           "fold": lambda: pad_ops.pad_fold(dy, 20, 24, 3, "replicate")}
    for name, fn in fns.items():
        ctx = CaptureContext(cuda)
        want = ctx.run(fn).clone()
        call = ctx.capture(fn, [], name)
        got = call().clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


def _recorded(fn):
    """fn() with the recorder on from empty -> (fn's result, the counts)."""
    trace.clear()
    trace.on()
    try:
        out = fn()
    finally:
        trace.off()
    counts = trace.counts()
    trace.clear()
    return out, counts


@pytest.mark.parametrize("method", ["translate_u8io_device",
                                    "translate_all_u8io_device"])
def test_captured_translate_runs_no_gather(cuda, method):
    """Member 0's and the all-members serving call at bucket 8: their warm-
    up and capture pad through P1 (``pad.kernel`` counted), and a replay
    launches P1 and no index gather."""
    cfg = _serving_cfg()
    tr = Translator(cfg, device=cuda)
    gens = tr.init_members(2, seed=0)
    params = gens if "all" in method else gens[0]
    call, counts = _recorded(lambda: tr.captured(method, params, 8,
                                                 (256, 256)))
    assert counts["pad.kernel"] > 0
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.integers(0, 256, (8, 256, 256, 3),
                                    dtype=np.uint8))
    z = torch.from_numpy(r.standard_normal(
        (8, cfg.gen.style_dim)).astype(np.float32))
    names = _device_kernels(lambda: call(x, z))
    assert not [n for n in names if "index_elementwise" in n], names
    assert any("pad_nhwc_kernel" in n for n in names), names


def test_captured_train_step_runs_no_index_backward(cuda):
    """chip_smoke's reduced config in bf16: the compiled step's warm-up and
    capture pad through P1 (``pad.kernel`` counted), and a replay launches P1 and P1' and
    neither the gather, nor index_put_'s backward kernel, nor a sort. The
    index_elementwise launches left are torch.flip's, of the conv weights
    derived in the step: K1''s flipped kernel (``ops/conv3x3.py``
    ``_kernel_weight``) and the dilated upsample's flipped 6x6 kernel
    (``ops/upsample_conv.py``)."""
    cfg = Config.from_dict({**chip_smoke.REDUCED,
                            "compute_dtype": "bfloat16"})
    tr = CouncilTrainer(cfg, device=cuda)
    r = np.random.default_rng(4)
    x_a, x_b = (torch.from_numpy(r.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)).to(cuda) for _ in range(2))
    held = [tr.init_state(seed=0)]

    def step_once():
        held[0], _ = step(held[0], x_a, x_b)

    def build():
        compiled = tr.compile_step(held[0])
        for _ in range(2):        # the eager warm-up, then the capture
            held[0], _ = compiled(held[0], x_a, x_b)
        return compiled

    step, counts = _recorded(build)
    assert counts["pad.kernel"] > 0
    names = _device_kernels(step_once)
    bad = [n for n in names if any(k in n for k in (
        "indexing_backward", "Sort", "sort", "radix"))
           or ("index_elementwise" in n and "flip_kernel_impl" not in n)]
    assert not bad, "\n".join(bad)
    assert any("pad_fold_kernel" in n for n in names), names


def test_pad_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 3, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        pad_ops.pad_nhwc(x.half(), 1, "reflect")
    with pytest.raises(ValueError, match="reflect pad 3"):
        pad_ops.pad_nhwc(x, 3, "reflect")
    with pytest.raises(ValueError, match="pad_type"):
        pad_ops.pad_nhwc(x, 1, "zero")
    with pytest.raises(ValueError, match="padded by"):
        pad_ops.pad_fold(torch.zeros(1, 5, 9, 4, device=cuda), 3, 8, 1,
                         "reflect")
    # pad2d sends every CUDA pad to the kernels: no fallback to the gather
    from councilx_torch.nn.blocks import pad2d

    with pytest.raises(ValueError, match="dtype"):
        pad2d(x.half(), 1, "reflect")
