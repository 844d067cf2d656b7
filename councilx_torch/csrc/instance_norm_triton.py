"""Triton kernel: instance norm with an optional per-(sample, channel)
affine, forward. (The backward is CUDA C++, csrc/instance_norm_bwd.cu.)

Replaces councilx/ops/pallas_norm.py::_fwd_kernel and ::_fwd_affine_kernel.
Imported only at first use, by councilx_torch/ops/_build.py, because
``triton`` exists only on a machine with a GPU.

For x (B, HW, C) contiguous (NHWC with H and W flattened), per (b, c):

* forward: f32 statistics whatever the input type; the mean first, then
  the biased variance of the centred values (two passes); rstd =
  1/sqrt(var + eps); y = (x - mean) * rstd, then * gamma + beta in f32 when
  an affine is given; one cast to the output type at the end. mean and rstd
  are stored (B, C) f32 for the backward, as ``_in_core_fwd`` saves them.

What bounds it on the H100: memory. It does a few FLOPs per element. The
TPU kernel held a whole (HW, C-block) tile in VMEM, which Hopper's shared
memory cannot (a (65536, 64) f32 tile is 16 MB), so the forward reads x
three times (sum, centred sum of squares, normalize) and writes y once. At
the (8, 4096, 256) resblock sites x (16.8 MB in bf16) mostly stays in the
50 MB L2 between passes.

Design: one program per (sample, block of BLOCK_C channels); it walks HW
in (BLOCK_HW, BLOCK_C) tiles. Channels are contiguous in NHWC, so the
threads of a tile row read neighbouring addresses. BLOCK_C is chosen by
the wrapper to give enough programs to fill the card.
"""

import triton
import triton.language as tl


@triton.jit
def instance_norm_kernel(x_ptr, y_ptr, g_ptr, b_ptr, mean_ptr, rstd_ptr,
                         HW, C, eps, HAS_AFFINE: tl.constexpr,
                         BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
    pid_b = tl.program_id(0)
    pid_c = tl.program_id(1)
    cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = pid_b.to(tl.int64) * HW * C
    rows0 = tl.arange(0, BLOCK_HW)

    acc = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    for start in range(0, HW, BLOCK_HW):
        rows = start + rows0
        mask = (rows[:, None] < HW) & cmask[None, :]
        offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        acc += x
    mean = tl.sum(acc, axis=0) / HW

    acc = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    for start in range(0, HW, BLOCK_HW):
        rows = start + rows0
        mask = (rows[:, None] < HW) & cmask[None, :]
        offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xc = tl.where(mask, x - mean[None, :], 0.0)
        acc += xc * xc
    var = tl.sum(acc, axis=0) / HW
    rstd = 1.0 / tl.sqrt(var + eps)
    tl.store(mean_ptr + pid_b * C + cols, mean, mask=cmask)
    tl.store(rstd_ptr + pid_b * C + cols, rstd, mask=cmask)

    if HAS_AFFINE:
        g = tl.load(g_ptr + pid_b * C + cols, mask=cmask, other=0.0)
        bt = tl.load(b_ptr + pid_b * C + cols, mask=cmask, other=0.0)
    for start in range(0, HW, BLOCK_HW):
        rows = start + rows0
        mask = (rows[:, None] < HW) & cmask[None, :]
        offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * rstd[None, :]
        if HAS_AFFINE:
            y = y * g[None, :] + bt[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
