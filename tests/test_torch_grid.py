"""The launch arithmetic of councilx_torch's split kernels, on the CPU.

The wgrad kernel (csrc/conv3x3_wgrad.cu) splits its B*H*W reduction into
whole 64-pixel K' steps, and the norm backward (csrc/instance_norm_bwd.cu)
splits HW into whole iterations of its 256 threads under a cooperative
launch that must fit on the card. Both splits are pure Python in the
wrappers, so they are held here against what the kernels assume: every
pixel (row) in exactly one non-empty split, the split count in its stated
range. Also: chip_smoke.py builds every CUDA source of the package.
"""

import glob
import os

import pytest
import torch

import chip_smoke
from councilx_torch.ops import _build
from councilx_torch.ops import conv3x3 as conv_ops
from councilx_torch.ops import instance_norm as norm_ops

# (C, O, B*H*W): the training shape, the reduced config's, the GPU tests'
# ragged ones, a single K' step, and more tiles than an H100 has SMs
WGRAD_CASES = [(256, 256, 8 * 64 * 64), (128, 128, 2 * 16 * 16),
               (72, 136, 3 * 17 * 45), (16, 24, 1 * 5 * 7),
               (8, 136, 3 * 9 * 3), (200, 264, 2 * 33 * 31),
               (1920, 256, 16), (256, 256, 1)]


def _covers_once(splits: int, per: int, total: int):
    """Splits [s * per, (s + 1) * per) clipped to total: each non-empty,
    together [0, total) once."""
    ranges = [(s * per, min(total, (s + 1) * per)) for s in range(splits)]
    assert all(lo < hi for lo, hi in ranges), ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("c,o,pixels", WGRAD_CASES)
@pytest.mark.parametrize("sms", [132, 114])
def test_wgrad_bf16_split_fills_one_wave(c, o, pixels, sms):
    splits, per = conv_ops._wgrad_split(torch.bfloat16, c, o, pixels, sms)
    bk = conv_ops._WGRAD_TILE[2]
    assert per % bk == 0
    _covers_once(splits, per, pixels)
    tiles = conv_ops._wgrad_tiles(c, o)
    # one block per SM: never more blocks than SMs, unless one split
    # already has more tiles than the card has SMs
    assert 1 <= splits <= max(1, sms // tiles)
    assert splits * tiles <= max(sms, tiles)


def test_wgrad_bf16_split_at_the_training_shape():
    # 18 tiles of (one tap, 128 channels) x 256 outputs; 7 splits of 74
    # and 68 steps: 126 blocks, one wave on 132 SMs
    assert conv_ops._wgrad_tiles(256, 256) == 18
    assert conv_ops._wgrad_split(torch.bfloat16, 256, 256, 32768) == (
        7, 74 * 64)


@pytest.mark.parametrize("c,o,pixels", WGRAD_CASES)
def test_wgrad_f32_split_covers_every_pixel_once(c, o, pixels):
    splits, per = conv_ops._wgrad_split(torch.float32, c, o, pixels)
    assert per % conv_ops._WGRAD_F32_TILE[2] == 0
    _covers_once(splits, per, pixels)


# (B, HW, C, vec): the train step's three norm sites, the GPU tests' small
# and ragged shapes, scalar loads
NORM_CASES = [(8, 64 * 64, 256, 8), (8, 128 * 128, 128, 8),
              (8, 256 * 256, 64, 8), (8, 64 * 64, 256, 4),
              (2, 5 * 7, 24, 8), (2, 5 * 7, 6, 1), (1, 9, 200, 1),
              (16, 4, 1024, 8)]


@pytest.mark.parametrize("b,hw,c,vec", NORM_CASES)
@pytest.mark.parametrize("max_blocks", [396, 528, 1056])
def test_norm_backward_grid_fits_the_cooperative_launch(b, hw, c, vec,
                                                        max_blocks):
    splits, rows = norm_ops._norm_bwd_grid(b, hw, c, vec, max_blocks)
    # a chunk is whole iterations of 256 threads, 64 / vec per pixel row
    per_iter = norm_ops._BWD_THREADS // (norm_ops._BWD_CHANNELS // vec)
    assert rows % per_iter == 0
    _covers_once(splits, rows, hw)
    groups = b * -(-c // norm_ops._BWD_CHANNELS)
    assert 1 <= splits and groups * splits <= max_blocks


def test_norm_backward_grid_at_the_resblock_sites():
    # bf16 at 3 blocks per SM on 132 SMs (the kernel's 66-68 registers):
    # (8, 64, 64, 256) is 32 groups of (sample, 64 channels) and 128
    # iterations of 32 rows: 12 chunks of 11 iterations, 384 blocks
    assert norm_ops._norm_bwd_grid(8, 4096, 256, 8, 396) == (12, 352)
    # (8, 256, 256, 64): 8 groups, 2048 iterations: 49 chunks of 42
    assert norm_ops._norm_bwd_grid(8, 65536, 64, 8, 396) == (49, 1344)


def test_norm_backward_grid_raises_when_the_groups_do_not_fit():
    with pytest.raises(ValueError, match="groups exceed"):
        norm_ops._norm_bwd_grid(64, 16, 2048, 8, 1000)


@pytest.mark.parametrize("dtype,c,want", [(torch.bfloat16, 256, 8),
                                          (torch.bfloat16, 24, 8),
                                          (torch.bfloat16, 20, 1),
                                          (torch.float32, 20, 4),
                                          (torch.float32, 6, 1)])
def test_norm_backward_vector_width(dtype, c, want):
    t = torch.zeros(2, 3, 5, c, dtype=dtype)
    assert norm_ops._norm_bwd_vec(t, t, t) == want
    # an operand off the 16-byte grid takes scalar loads
    off = torch.zeros(2 * 3 * 5 * c + 1, dtype=dtype)[1:].view(2, 3, 5, c)
    assert norm_ops._norm_bwd_vec(t, off, t) == 1


def test_chip_smoke_builds_every_cuda_source():
    sources = sorted(os.path.splitext(os.path.basename(p))[0]
                     for p in glob.glob(os.path.join(_build.CSRC_DIR,
                                                     "*.cu")))
    assert sorted(chip_smoke.CUDA_SOURCES) == sources
    assert "instance_norm_bwd" in sources
