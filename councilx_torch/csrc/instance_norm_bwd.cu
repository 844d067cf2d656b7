// Backward of instance norm with an optional per-(sample, channel) affine
// (AdaIN), on NHWC input, for Hopper: one launch per call, cooperative
// where HW is split.
//
// Replaces councilx/ops/pallas_norm.py::_bwd_kernel and ::_bwd_affine_kernel
// (pallas_calls at :158 and :166). For x, dy (B, HW, C) contiguous (NHWC
// with H and W flattened), per (b, c), from the forward's saved (B, C) f32
// mean and rstd:
//   x_hat = (x - mean) * rstd;  dy' = dy * gamma (or dy);
//   dx = rstd * (dy' - mean(dy') - x_hat * mean(dy' * x_hat)),
// and with the affine dgamma = sum dy * x_hat, dbeta = sum dy over HW, (B, C)
// f32. gamma is constant over HW, so both means follow from the two sums
// sum(dy) and sum(dy * x_hat). f32 arithmetic; dx is written in dy's type.
//
// What bounds it on the H100: memory. It does ~11-13 FLOPs per element, and
// must read dy and x and write dx: 50.3 MB at (8, 64, 64, 256) in bf16, 15.0
// us at 3.35 TB/s. The TPU kernel held a whole (HW, C-block) tile in VMEM;
// Hopper's shared memory cannot, and a kernel with one block per (sample,
// channel block) -- which must finish its HW reduction before it writes dx
// -- puts at most B*C/16 blocks on the card (128 at that shape, 64 at
// (8, 256, 256, 64)).
//
// Design: split HW, and wait across blocks once.
//   * Groups of (sample, 64 channels); each group is split into S chunks of
//     HW, one block (256 threads) per chunk. A thread owns VEC channels of a
//     pixel row (16-byte loads: 8 bf16 or 4 f32; VEC = 1 where C is not a
//     multiple of that), so a row of 64 channels is 128 (bf16) or 256 (f32)
//     contiguous bytes and a block covers 32 (bf16) or 16 (f32) rows per
//     iteration. The wrapper sizes S from cudaOccupancyMaxActiveBlocksPer-
//     Multiprocessor x the SM count (ops/instance_norm.py::
//     _norm_bwd_grid), so every block is co-resident: in bf16 a thread
//     holds 66-68 registers, 3 blocks per SM, 396 on 132 SMs, so at (8, 64,
//     64, 256) 8 x 4 groups x 12 chunks of 11 iterations run.
//   * Pass 1: each block sums dy and dy * x_hat over its chunk (per thread,
//     then over the block's rows in a fixed order in shared memory) into f32
//     partials (B, S, C, 2) in scratch.
//   * One grid-wide barrier: cooperative_groups::this_grid().sync(), under
//     cudaLaunchCooperativeKernel, which refuses a grid that does not fit.
//   * Plain mode (S = 1), as the forward's: where the groups alone fill the
//     card (B * C / 64 >= the co-resident blocks, e.g. B >= 99 at C = 256
//     in bf16), one block per group sums its whole HW and goes straight on
//     to pass 2 after a block barrier; no scratch, no grid barrier, a plain
//     launch of any size. Its sums are the block's own, in the same fixed
//     order, so it too is bit-deterministic.
//   * Pass 2: every block of a group sums the group's S partials in the
//     order s = 0..S-1, so every block (and every run) gets the same sums,
//     then writes its chunk's dx; block s = 0 writes dgamma and dbeta. No
//     float atomics, no spin loops: two calls are bit-equal.
//   * Pass 2 reads the chunk again, in reverse order: the rows pass 1 read
//     last are the likeliest still in the 50 MB L2 (dy + x is 33.5 MB at
//     (8, 64, 64, 256) bf16, 67 MB at (8, 256, 256, 64)).

#include <cooperative_groups.h>

#include "norm.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace inorm;

// Grid: B * cgroups * splits blocks (splits = 1 in plain mode); block
// (group, s) = (bid / splits, bid % splits), group = (b, channel block).
// Chunk s covers rows [s * rows_per_split, +rows_per_split) of HW, a
// multiple of the rows per iteration. part: (B, splits, C, 2) f32 scratch,
// used only if COOP. gamma, dgamma, dbeta are read or written only if
// AFFINE.
template <typename T, int VEC, bool AFFINE, bool COOP>
__global__ void __launch_bounds__(THREADS)
instance_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const float* __restrict__ gamma, T* __restrict__ dx,
                         float* __restrict__ dgamma,
                         float* __restrict__ dbeta, float* part,
                         int HW, int C, int cgroups, int splits,
                         int rows_per_split) {
  constexpr int TPR = CB / VEC;           // threads per pixel row
  constexpr int RPI = THREADS / TPR;      // rows per iteration
  __shared__ float red[RPI][CB][2];
  __shared__ float sums[CB][2];

  const int s = COOP ? blockIdx.x % splits : 0;
  const int grp = COOP ? blockIdx.x / splits : blockIdx.x;
  const int b = grp / cgroups;
  const int c0 = (grp - b * cgroups) * CB;
  const int lc = threadIdx.x % TPR;       // this thread's VEC channels
  const int r0 = threadIdx.x / TPR;       // its row in each iteration
  const int c = c0 + lc * VEC;
  const bool c_ok = c < C;                // C % VEC == 0: all VEC or none
  const int row_begin = s * rows_per_split;
  const int row_end = min(HW, row_begin + rows_per_split);
  const size_t base = static_cast<size_t>(b) * HW * C + c;

  float mu[VEC], rs[VEC], gm[VEC], s_dy[VEC], s_dyx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = c_ok ? mean[b * C + c + i] : 0.0f;
    rs[i] = c_ok ? rstd[b * C + c + i] : 0.0f;
    gm[i] = (AFFINE && c_ok) ? gamma[b * C + c + i] : 1.0f;
    s_dy[i] = 0.0f;
    s_dyx[i] = 0.0f;
  }

  // pass 1: sum(dy) and sum(dy * x_hat) over this chunk
  if (c_ok) {
#pragma unroll 4
    for (int row = row_begin + r0; row < row_end; row += RPI) {
      float d[VEC], xv[VEC];
      load_vec<T, VEC>(dy + base + static_cast<size_t>(row) * C, d);
      load_vec<T, VEC>(x + base + static_cast<size_t>(row) * C, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s_dy[i] += d[i];
        s_dyx[i] += d[i] * ((xv[i] - mu[i]) * rs[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[r0][lc * VEC + i][0] = s_dy[i];
    red[r0][lc * VEC + i][1] = s_dyx[i];
  }
  __syncthreads();
  // over the block's rows in a fixed order: thread (k, ch) for k in {0, 1}
  const int ch = threadIdx.x % CB;
  const int k = threadIdx.x / CB;
  if (k < 2) {
    float acc = 0.0f;
    for (int r = 0; r < RPI; ++r) acc += red[r][ch][k];
    if constexpr (COOP) {
      if (c0 + ch < C)
        part[((static_cast<size_t>(b) * splits + s) * C + c0 + ch) * 2 +
             k] = acc;
    } else {
      // plain mode: this block's chunk is the whole of HW
      sums[ch][k] = acc;
      if (AFFINE && c0 + ch < C)
        (k == 0 ? dbeta : dgamma)[b * C + c0 + ch] = acc;
    }
  }

  if constexpr (COOP) {
    cg::this_grid().sync();

    // pass 2: the group's sums, in the order s = 0..splits-1
    if (k < 2) {
      float acc = 0.0f;
      if (c0 + ch < C) {
#pragma unroll 8
        for (int j = 0; j < splits; ++j)
          acc += part[((static_cast<size_t>(b) * splits + j) * C + c0 +
                       ch) * 2 + k];
      }
      sums[ch][k] = acc;
      if (AFFINE && s == 0 && c0 + ch < C)
        (k == 0 ? dbeta : dgamma)[b * C + c0 + ch] = acc;
    }
  }
  __syncthreads();
  if (!c_ok) return;
  float m_dy[VEC], m_dyx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    m_dy[i] = gm[i] * sums[lc * VEC + i][0] / HW;
    m_dyx[i] = gm[i] * sums[lc * VEC + i][1] / HW;
  }
  // the chunk again, last rows first (the likeliest still in L2)
  const int iters = (row_end - row_begin + RPI - 1) / RPI;
  for (int it = iters - 1; it >= 0; --it) {
    const int row = row_begin + it * RPI + r0;
    if (row >= row_end) continue;
    const size_t off = base + static_cast<size_t>(row) * C;
    float d[VEC], xv[VEC], out[VEC];
    load_vec<T, VEC>(dy + off, d);
    load_vec<T, VEC>(x + off, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xh = (xv[i] - mu[i]) * rs[i];
      out[i] = rs[i] * (d[i] * gm[i] - m_dy[i] - xh * m_dyx[i]);
    }
    store_vec<T, VEC>(dx + off, out);
  }
}

template <typename T, int VEC, bool COOP>
const void* pick_affine(int affine) {
  return affine ? (const void*)instance_norm_bwd_kernel<T, VEC, true, COOP>
                : (const void*)instance_norm_bwd_kernel<T, VEC, false, COOP>;
}

template <typename T, int VEC>
const void* pick_mode(int affine, int coop) {
  return coop ? pick_affine<T, VEC, true>(affine)
              : pick_affine<T, VEC, false>(affine);
}

// The kernel for (dtype, vec, affine, coop): dtype 0 = float32, 1 =
// bfloat16; vec 16 / sizeof(element) or 1; coop: the cooperative (split)
// mode, else the plain one. nullptr for anything else.
const void* pick(int dtype, int vec, int affine, int coop) {
  if (dtype == 1 && vec == 8)
    return pick_mode<__nv_bfloat16, 8>(affine, coop);
  if (dtype == 1 && vec == 1)
    return pick_mode<__nv_bfloat16, 1>(affine, coop);
  if (dtype == 0 && vec == 4) return pick_mode<float, 4>(affine, coop);
  if (dtype == 0 && vec == 1) return pick_mode<float, 1>(affine, coop);
  return nullptr;
}

}  // namespace

// How many blocks of the cooperative (dtype, vec, affine) kernel the
// current device holds at once: its occupancy per SM x the SM count, into
// *blocks. 0 or a CUDA error code.
extern "C" int councilx_instance_norm_bwd_max_blocks(int dtype, int vec,
                                                     int affine,
                                                     int* blocks) {
  const void* fn = pick(dtype, vec, affine, 1);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(co_resident_blocks(fn, 0, blocks));
}

// dy, x, dx (B, HW, C) of one dtype (0 = float32, 1 = bfloat16); mean,
// rstd (B, C) f32; gamma (B, C) f32 or null (no affine), and then dgamma
// and dbeta unused; part (B, splits, C, 2) f32 scratch when splits > 1.
// vec: 16 / element size (C a multiple of it, every tensor 16-byte
// aligned) or 1. splits > 1: one cooperative launch of B * ceil(C / 64) *
// splits blocks; splits = 1: one plain launch of B * ceil(C / 64) blocks.
// On `stream`; does not synchronise; returns the launch's error code (0 on
// success).
extern "C" int councilx_instance_norm_bwd(
    const void* dy, const void* x, const float* mean, const float* rstd,
    const float* gamma, void* dx, float* dgamma, float* dbeta, float* part,
    int B, int HW, int C, int dtype, int vec, int splits, int rows_per_split,
    void* stream) {
  const int coop = splits > 1;
  const void* fn = pick(dtype, vec, gamma != nullptr, coop);
  if (fn == nullptr || splits < 1 || rows_per_split < 1 ||
      (coop && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int cgroups = (C + CB - 1) / CB;
  void* args[] = {(void*)&dy, (void*)&x, (void*)&mean, (void*)&rstd,
                  (void*)&gamma, &dx, &dgamma, &dbeta, &part, &HW, &C,
                  &cgroups, &splits, &rows_per_split};
  const dim3 grid(static_cast<unsigned>(B * cgroups * splits));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coop)
    return static_cast<int>(cudaLaunchCooperativeKernel(
        fn, grid, dim3(THREADS), args, 0, st));
  return static_cast<int>(
      cudaLaunchKernel(fn, grid, dim3(THREADS), args, 0, st));
}
