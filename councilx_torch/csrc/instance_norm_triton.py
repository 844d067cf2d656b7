"""Triton kernels: instance norm with an optional per-(sample, channel)
affine, forward and backward.

Replace councilx/ops/pallas_norm.py::_fwd_kernel, ::_fwd_affine_kernel,
::_bwd_kernel and ::_bwd_affine_kernel. Imported only at first use, by
councilx_torch/ops/_build.py, because ``triton`` exists only on a machine
with a GPU.

For x (B, HW, C) contiguous (NHWC with H and W flattened), per (b, c):

* forward: f32 statistics whatever the input type; the mean first, then
  the biased variance of the centred values (two passes); rstd =
  1/sqrt(var + eps); y = (x - mean) * rstd, then * gamma + beta in f32 when
  an affine is given; one cast to the output type at the end. mean and rstd
  are stored (B, C) f32 for the backward, as ``_in_core_fwd`` saves them.
* backward, from the saved mean/rstd: x_hat = (x - mean) * rstd,
  dy' = dy * gamma (or dy), dx = rstd * (dy' - mean(dy') - x_hat *
  mean(dy' * x_hat)); with the affine also dgamma = sum dy * x_hat and
  dbeta = sum dy, (B, C) f32. gamma is constant over HW, so both means
  follow from the two sums sum(dy) and sum(dy * x_hat).

What bounds them on the H100: memory. They do a few FLOPs per element. The
TPU kernels held a whole (HW, C-block) tile in VMEM, which Hopper's shared
memory cannot (a (65536, 64) f32 tile is 16 MB), so the forward reads x
three times (sum, centred sum of squares, normalize) and writes y once, and
the backward reads dy and x twice (the two sums, then dx) and writes dx
once. At the (8, 4096, 256) resblock sites x and dy (16.8 MB each in bf16)
mostly stay in the 50 MB L2 between passes.

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


@triton.jit
def instance_norm_bwd_kernel(dy_ptr, x_ptr, mean_ptr, rstd_ptr, g_ptr,
                             dx_ptr, dg_ptr, db_ptr, HW, C,
                             HAS_AFFINE: tl.constexpr, BLOCK_HW: tl.constexpr,
                             BLOCK_C: tl.constexpr):
    pid_b = tl.program_id(0)
    pid_c = tl.program_id(1)
    cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = pid_b.to(tl.int64) * HW * C
    rows0 = tl.arange(0, BLOCK_HW)
    mean = tl.load(mean_ptr + pid_b * C + cols, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + pid_b * C + cols, mask=cmask, other=0.0)

    acc_dy = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    acc_dyx = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    for start in range(0, HW, BLOCK_HW):
        rows = start + rows0
        mask = (rows[:, None] < HW) & cmask[None, :]
        offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * rstd[None, :]
        acc_dy += dy
        acc_dyx += dy * xhat
    s_dy = tl.sum(acc_dy, axis=0)
    s_dyx = tl.sum(acc_dyx, axis=0)

    if HAS_AFFINE:
        g = tl.load(g_ptr + pid_b * C + cols, mask=cmask, other=0.0)
        tl.store(dg_ptr + pid_b * C + cols, s_dyx, mask=cmask)
        tl.store(db_ptr + pid_b * C + cols, s_dy, mask=cmask)
        m_dy = g * s_dy / HW
        m_dyx = g * s_dyx / HW
    else:
        m_dy = s_dy / HW
        m_dyx = s_dyx / HW

    for start in range(0, HW, BLOCK_HW):
        rows = start + rows0
        mask = (rows[:, None] < HW) & cmask[None, :]
        offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * rstd[None, :]
        if HAS_AFFINE:
            dy = dy * g[None, :]
        dx = rstd[None, :] * (dy - m_dy[None, :] - xhat * m_dyx[None, :])
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
