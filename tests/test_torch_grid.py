"""The launch arithmetic of councilx_torch's split kernels, on the CPU.

The wgrad kernel (csrc/conv3x3_wgrad.cu) splits its B*H*W reduction into
whole 64-pixel K' steps, and the norm kernels (csrc/instance_norm_fwd.cu,
csrc/instance_norm_bwd.cu) split HW into whole iterations of their 256
threads under a cooperative launch that must fit on the card. The splits
are pure Python in the wrappers, so they are held here against what the
kernels assume: every pixel (row) in exactly one non-empty split, the
split count in its stated range, the forward's stash within its chunk and
its shared-memory budget. The forward kernel's fixed-order merge of chunk
statistics is held here in numpy against the plain version. Also:
chip_smoke.py builds every CUDA source of the package, and nothing of the
port imports Triton.
"""

import glob
import os
import re

import numpy as np
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
              (16, 4, 1024, 8), (128, 64 * 64, 256, 8)]


@pytest.mark.parametrize("b,hw,c,vec", NORM_CASES)
@pytest.mark.parametrize("max_blocks", [396, 528, 1056])
def test_norm_backward_grid_fits_the_cooperative_launch(b, hw, c, vec,
                                                        max_blocks):
    splits, rows = norm_ops._norm_bwd_grid(b, hw, c, vec, max_blocks)
    # a chunk is whole iterations of 256 threads, 64 / vec per pixel row
    per_iter = norm_ops._NORM_THREADS // (norm_ops._NORM_CHANNELS // vec)
    assert rows % per_iter == 0
    _covers_once(splits, rows, hw)
    groups = b * -(-c // norm_ops._NORM_CHANNELS)
    if groups >= max_blocks:
        assert splits == 1          # the plain launch, of any size
    else:
        assert 1 <= splits and groups * splits <= max_blocks


def test_norm_backward_grid_at_the_resblock_sites():
    # bf16 at 3 blocks per SM on 132 SMs (the kernel's 66-68 registers):
    # (8, 64, 64, 256) is 32 groups of (sample, 64 channels) and 128
    # iterations of 32 rows: 12 chunks of 11 iterations, 384 blocks
    assert norm_ops._norm_bwd_grid(8, 4096, 256, 8, 396) == (12, 352)
    # (8, 256, 256, 64): 8 groups, 2048 iterations: 49 chunks of 42
    assert norm_ops._norm_bwd_grid(8, 65536, 64, 8, 396) == (49, 1344)


def test_norm_backward_grid_raises_when_the_groups_do_not_fit():
    """It no longer raises: where the groups do not fit one cooperative
    launch, the backward takes the forward's mode -- one split, one block
    per group over the whole of HW, the plain launch."""
    assert norm_ops._norm_bwd_grid(64, 16, 2048, 8, 1000) == (1, 32)
    # batch 128 at the resblocks: 512 groups, 396 co-resident blocks
    assert norm_ops._norm_bwd_grid(128, 4096, 256, 8, 396) == (1, 4096)


# the forward also runs at serving's bucket 64 (more groups than the card
# holds at once: one split, the plain launch) and bucket 1 (one group at
# the 256x256 site); and HW of 17 and 32.8 iterations (the least chunk)
NORM_FWD_CASES = NORM_CASES + [(64, 64 * 64, 256, 8), (1, 256 * 256, 64, 8),
                               (1, 17 * 32, 64, 8), (1, 33 * 32 - 5, 64, 8)]
# (stash bytes, co-resident blocks): a stash sized for one block per SM on
# an H100, and for two as councilx_instance_norm_fwd_plan gives it there;
# no stash; one block
FWD_PLANS = [(225280, 132), (108544, 264), (0, 132), (4096, 1)]


def _esize(vec: int) -> int:
    """bf16 where a 16-byte vector holds 8, f32 where it holds 4; scalar
    loads in bf16."""
    return {8: 2, 4: 4, 1: 2}[vec]


@pytest.mark.parametrize("b,hw,c,vec", NORM_FWD_CASES)
@pytest.mark.parametrize("stash_bytes,capacity", FWD_PLANS)
def test_norm_forward_grid_fits_the_card_and_the_stash(b, hw, c, vec,
                                                       stash_bytes,
                                                       capacity):
    esize = _esize(vec)
    splits, rows, stash = norm_ops._norm_fwd_grid(b, hw, c, vec, esize,
                                                  stash_bytes, capacity)
    per_iter = norm_ops._NORM_THREADS // (norm_ops._NORM_CHANNELS // vec)
    assert rows % per_iter == 0
    _covers_once(splits, rows, hw)
    # the stash: whole iterations of the chunk, within the budget
    assert 0 <= stash * per_iter <= rows
    assert stash * norm_ops._NORM_THREADS * vec * esize <= stash_bytes
    groups = b * -(-c // norm_ops._NORM_CHANNELS)
    if groups >= capacity:
        assert splits == 1          # the plain launch, of any size
    else:
        assert 1 <= splits and groups * splits <= capacity
    # no chunk split off shorter than the least the kernel is given
    if splits > 1:
        assert rows >= norm_ops._FWD_MIN_ITERS * per_iter


def test_norm_forward_grid_at_the_path_shapes():
    # one block per SM, 55 iterations of 32 bf16 rows (220 KB) stashed:
    # (8, 64, 64, 256) is 32 groups of 4 chunks of 1024 rows, all kept
    assert norm_ops._norm_fwd_grid(8, 4096, 256, 8, 2, 225280, 132) == (
        4, 1024, 32)
    # two per SM: 8 chunks of 512 rows, all kept in 64 of the 106 KB
    assert norm_ops._norm_fwd_grid(8, 4096, 256, 8, 2, 108544, 264) == (
        8, 512, 16)
    # (8, 256, 256, 64): 8 groups of 16 chunks; 1760 of 4096 rows kept
    assert norm_ops._norm_fwd_grid(8, 65536, 64, 8, 2, 225280, 132) == (
        16, 4096, 55)
    # batch 1 at 256x256: one group over 128 blocks, every row kept; at two
    # blocks per SM no more, for chunks of at least 16 iterations
    assert norm_ops._norm_fwd_grid(1, 65536, 64, 8, 2, 225280, 132) == (
        128, 512, 16)
    assert norm_ops._norm_fwd_grid(1, 65536, 64, 8, 2, 108544, 264) == (
        128, 512, 16)
    # bucket 64 at the resblocks: 256 groups, one block each, plain launch
    assert norm_ops._norm_fwd_grid(64, 4096, 256, 8, 2, 225280, 132) == (
        1, 4096, 55)


@pytest.mark.parametrize("b", [1, 2, 8, 33, 64, 99, 100, 128])
def test_norm_forward_grid_takes_any_batch(b):
    """Unlike the backward's, the forward's grid never raises: where the
    groups reach the card's capacity it takes one split per group."""
    for hw, c in ((64 * 64, 256), (128 * 128, 128), (256 * 256, 64)):
        for stash_bytes, capacity in FWD_PLANS[:2]:
            splits, rows, _ = norm_ops._norm_fwd_grid(b, hw, c, 8, 2,
                                                      stash_bytes, capacity)
            _covers_once(splits, rows, hw)
            if b * -(-c // 64) >= capacity:
                assert splits == 1


def _chan(parts):
    """Chunk moments (count, mean (C,), M2 (C,)) combined in f32 with
    Chan's formula, in the order given."""
    n = mean = m2 = np.float32(0)
    for nb, mb, m2b in parts:
        if nb == 0:
            continue
        tot = np.float32(n + nb)
        d = mb - mean
        w = np.float32(nb) / tot
        mean = mean + d * w
        m2 = m2 + (m2b + d * d * n * w)
        n = tot
    return n, mean, m2


def _kernel_merge(parts):
    """The forward kernel's merge of its S chunk partials: four runs of
    ceil(S / 4) in order, then the four runs in order."""
    per = -(-len(parts) // 4)
    return _chan([_chan(parts[k * per:(k + 1) * per]) for k in range(4)])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("offset", [1.0, 64.0])
def test_norm_forward_chan_merge_matches_two_pass_statistics(seed, offset):
    """Chunk statistics (two-pass f32 sums within each chunk) merged in the
    kernel's fixed order over random chunk splits of HW give the plain
    version's two-pass f32 mean and rstd, also far from zero mean (offset
    64), where E[x^2] - E[x]^2 in f32 would not."""
    rng = np.random.default_rng(seed)
    b, hw, c, eps = 2, 4096, 64, 1e-5
    x = (rng.standard_normal((b, hw, c)) * 3 + offset).astype(np.float32)
    ref_mean, ref_rstd = (t.numpy() for t in
                          norm_ops.instance_norm_forward_reference(
                              torch.from_numpy(x).view(b, 64, 64, c))[1:])
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, hw), rng.integers(0, 130),
                                  replace=False))
        parts = []
        for chunk in np.split(x[i], cuts):
            # (C, rows) contiguous: numpy sums each row pairwise in f32
            ct = np.ascontiguousarray(chunk.T)
            m = ct.mean(axis=1, dtype=np.float32)
            parts.append((np.float32(ct.shape[1]), m,
                          ((ct - m[:, None]) ** 2).sum(axis=1,
                                                       dtype=np.float32)))
        n, mean, m2 = _kernel_merge(parts)
        assert n == hw
        rstd = (1 / np.sqrt(m2 / n + np.float32(eps))).astype(np.float32)
        # f32 sums of 4096 values in another order (E[x^2] - E[x]^2 misses
        # rstd by ~1e-3 at offset 64)
        np.testing.assert_allclose(mean, ref_mean[i], rtol=0,
                                   atol=1e-6 * np.abs(ref_mean[i]).max())
        np.testing.assert_allclose(rstd, ref_rstd[i], rtol=0,
                                   atol=1e-6 * np.abs(ref_rstd[i]).max())


@pytest.mark.parametrize("dtype,c,want", [(torch.bfloat16, 256, 8),
                                          (torch.bfloat16, 24, 8),
                                          (torch.bfloat16, 20, 1),
                                          (torch.float32, 20, 4),
                                          (torch.float32, 6, 1)])
def test_norm_backward_vector_width(dtype, c, want):
    t = torch.zeros(2, 3, 5, c, dtype=dtype)
    assert norm_ops._norm_vec(t, t, t) == want
    # an operand off the 16-byte grid takes scalar loads
    off = torch.zeros(2 * 3 * 5 * c + 1, dtype=dtype)[1:].view(2, 3, 5, c)
    assert norm_ops._norm_vec(t, off, t) == 1


def test_chip_smoke_builds_every_cuda_source():
    sources = sorted(os.path.splitext(os.path.basename(p))[0]
                     for p in glob.glob(os.path.join(_build.CSRC_DIR,
                                                     "*.cu")))
    assert sorted(chip_smoke.CUDA_SOURCES) == sources
    assert {"instance_norm_fwd", "instance_norm_bwd"} <= set(sources)


def test_nothing_of_the_port_imports_triton():
    """Every kernel of the port is CUDA C++: no module of councilx_torch,
    and not chip_smoke.py or profile_port.py, imports Triton."""
    root = os.path.dirname(_build.CSRC_DIR)
    paths = glob.glob(os.path.join(root, "**", "*.py"), recursive=True)
    repo = os.path.dirname(root)
    paths += [os.path.join(repo, f) for f in ("chip_smoke.py",
                                              "profile_port.py")]
    pattern = re.compile(r"^\s*(import|from)\s+triton\b", re.M)
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path
