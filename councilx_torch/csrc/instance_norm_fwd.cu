// Forward of instance norm with an optional per-(sample, channel) affine
// (AdaIN), on NHWC input, for Hopper: one launch per call.
//
// Replaces councilx/ops/pallas_norm.py::_fwd_kernel and ::_fwd_affine_kernel
// (pallas_calls at :98 and :107). For x (B, HW, C) contiguous (NHWC with H
// and W flattened), per (b, c): f32 statistics over HW whatever x's type --
// the mean, then the biased variance of the centred values (Welford and
// Chan, never E[x^2] - E[x]^2); rstd = rsqrt(var + eps); y = (x - mean) *
// rstd, then * gamma + beta in f32 with the affine; one cast to x's type.
// mean and rstd are stored (B, C) f32 for the backward
// (csrc/instance_norm_bwd.cu).
//
// What bounds it on the H100: memory. It does a few FLOPs per element and
// must read x and write y: 33.5 MB at (8, 64, 64, 256) in bf16, 10.0 us at
// 3.35 TB/s. The TPU kernel held a whole (HW, C-block) tile in VMEM and read
// x once; a block's 227 KB of shared memory cannot hold a (HW, 64) tile at
// 256x256 (8 MB in bf16), and one block per (sample, channel block) puts
// too few blocks on the card (8 at batch 1 at that shape).
//
// Design: split HW over the card, and keep what fits of each chunk in
// shared memory across one wait.
//   * Groups of (sample, 64 channels), each split into S chunks of HW, one
//     block (256 threads) per chunk. A thread owns VEC channels of a pixel
//     row (one 16-byte vector: 8 bf16 or 4 f32; VEC = 1 where C or an
//     address is off the 16-byte grid), so a 64-channel row is 128 (bf16)
//     or 256 (f32) contiguous bytes and a block covers 32 (bf16) or 16 (f32)
//     rows per iteration.
//   * Pass 1: each thread reads its rows, UNROLL vectors in flight, into f32
//     Welford moments (count, mean, M2), and copies the first stash_iters
//     iterations of the chunk as raw vectors into dynamic shared memory
//     (loaded evict-first: nothing reads them from memory again). The
//     moments are merged with Chan's formula over the rows of a warp
//     (shuffles), then over the block's warps, in a fixed order.
//   * Cooperative mode (S > 1): each block writes its chunk's moments to
//     (B, S, C, 3) f32 scratch; one cooperative_groups::this_grid().sync()
//     under cudaLaunchCooperativeKernel (the wrapper sizes S from the
//     occupancy query at the kernel's shared-memory size x the SM count,
//     ops/instance_norm.py::_norm_fwd_grid); then every block of a group
//     merges the S partials in the order s = 0..S-1 (four runs, then the
//     runs in order), so all blocks, and all runs, get bit-equal mean and
//     rstd. No float atomics, no spin loops. Block s = 0 stores them.
//   * Plain mode (S = 1): when the groups alone fill the card (B * ceil(C /
//     64) at or above what it holds at once, as serving at bucket 64 does),
//     each block owns a whole group and needs no wait: the same kernel
//     without the grid sync, under a plain launch of any size.
//   * Pass 2 writes y: first the stashed rows from shared memory, then the
//     rest of the chunk read again from device memory, last rows first (the
//     likeliest still in the 50 MB L2). At (8, 64, 64, 256) in bf16 every
//     chunk fits: x is read once and y written once, the bound's traffic.

#include <cooperative_groups.h>

#include "norm.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace inorm;

constexpr int UNROLL = 8;               // vectors in flight per thread
constexpr int RUNS = THREADS / CB;      // threads per channel merging partials
// blocks per SM the stash is sized for: each keeps up to ~106 KB of its
// chunk (one block per SM with ~220 KB was 7-9% slower at batch 8)
constexpr int BLOCKS_PER_SM = 2;

template <typename R>
__device__ __forceinline__ R load_evict_first(const R* p) {
  return *p;
}
template <>
__device__ __forceinline__ uint4 load_evict_first<uint4>(const uint4* p) {
  return __ldcs(p);
}

// (count, mean, M2) of a set of values.
struct Moments {
  float n, mean, m2;
};

// Chan's formula: a becomes the moments of a's values and a set of nb
// values with mean mb and M2 m2b.
__device__ __forceinline__ void chan(Moments& a, float nb, float mb,
                                     float m2b) {
  if (nb == 0.0f) return;
  const float n = a.n + nb;
  const float d = mb - a.mean;
  const float w = nb / n;
  a.mean += d * w;
  a.m2 += m2b + d * d * a.n * w;
  a.n = n;
}

// Grid: B * cgroups * splits blocks (splits = 1 in plain mode); block
// (group, s) = (bid / splits, bid % splits), group = (b, channel block).
// Chunk s covers rows [s * rows_per_split, +rows_per_split) of HW, a
// multiple of the rows per iteration; its first stash_iters iterations are
// kept in dynamic shared memory (stash_iters * THREADS vectors). part: (B,
// splits, C, 3) f32 scratch, used only if COOP. gamma, beta: (B, C) f32,
// read only if AFFINE.
template <typename T, int VEC, bool AFFINE, bool COOP>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
instance_norm_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         float* __restrict__ mean, float* __restrict__ rstd,
                         float* part, int HW, int C, int cgroups, int splits,
                         int rows_per_split, int stash_iters, float eps) {
  using R = Raw<T, VEC>;
  constexpr int TPR = CB / VEC;                  // threads per pixel row
  constexpr int RPI = THREADS / TPR;             // rows per iteration
  constexpr int RPW = TPR < 32 ? 32 / TPR : 1;   // rows per warp
  constexpr int SLOTS = RPI / RPW;               // row partials per block
  static_assert(SLOTS >= RUNS, "red holds the runs' partials too");
  extern __shared__ uint4 smem[];
  R* stash = reinterpret_cast<R*>(smem);
  __shared__ float red[SLOTS][CB][3];
  __shared__ float stats[CB][2];

  const int s = COOP ? blockIdx.x % splits : 0;
  const int grp = COOP ? blockIdx.x / splits : blockIdx.x;
  const int b = grp / cgroups;
  const int c0 = (grp - b * cgroups) * CB;
  const int lc = threadIdx.x % TPR;      // this thread's VEC channels
  const int r0 = threadIdx.x / TPR;      // its row in each iteration
  const int c = c0 + lc * VEC;
  const bool c_ok = c < C;               // C % VEC == 0: all VEC or none
  const int row_begin = s * rows_per_split;
  const int row_end = min(HW, row_begin + rows_per_split);
  const int iters = (row_end - row_begin + RPI - 1) / RPI;
  const int kept = min(stash_iters, iters);
  const size_t base = static_cast<size_t>(b) * HW * C + c;
  // this thread's element offset, and whether it has a row, at iteration it
  auto at = [&](int it) {
    return base + static_cast<size_t>(row_begin + it * RPI + r0) * C;
  };
  auto valid = [&](int it) {
    return c_ok && row_begin + it * RPI + r0 < row_end;
  };

  // pass 1: Welford moments of this thread's rows; the first rows stashed
  float cnt = 0.0f, mu[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mu[i] = m2[i] = 0.0f;
  for (int it0 = 0; it0 < iters; it0 += UNROLL) {
    R v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 + u;
      if (valid(it)) {
        const R* p = reinterpret_cast<const R*>(x + at(it));
        v[u] = it < kept ? load_evict_first(p) : *p;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 + u;
      if (!valid(it)) continue;
      if (it < kept) stash[it * THREADS + threadIdx.x] = v[u];
      float f[VEC];
      unpack<T, VEC>(v[u], f);
      cnt += 1.0f;
      const float inv = __frcp_rn(cnt);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = f[i] - mu[i];
        mu[i] += d * inv;
        m2[i] += d * (f[i] - mu[i]);
      }
    }
  }
  // over the rows of a warp: lanes TPR apart hold the same channels
#pragma unroll
  for (int off = TPR; off < 32; off *= 2) {
    const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float mb = __shfl_xor_sync(0xffffffffu, mu[i], off);
      const float m2b = __shfl_xor_sync(0xffffffffu, m2[i], off);
      Moments a = {cnt, mu[i], m2[i]};
      chan(a, nb, mb, m2b);
      mu[i] = a.mean;
      m2[i] = a.m2;
    }
    cnt += nb;
  }
  if (r0 % RPW == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float* r = red[r0 / RPW][lc * VEC + i];
      r[0] = cnt;
      r[1] = mu[i];
      r[2] = m2[i];
    }
  }
  __syncthreads();
  // over the block's warps in order: thread (k, ch), k = 0 merges
  const int ch = threadIdx.x % CB;
  const int k = threadIdx.x / CB;
  Moments tot = {0.0f, 0.0f, 0.0f};
  if (k == 0) {
    for (int j = 0; j < SLOTS; ++j)
      chan(tot, red[j][ch][0], red[j][ch][1], red[j][ch][2]);
  }

  if constexpr (COOP) {
    const size_t stride = static_cast<size_t>(C) * 3;
    const float* grp_part =
        part + (static_cast<size_t>(b) * splits * C + c0 + ch) * 3;
    if (k == 0 && c0 + ch < C) {
      float* p = part + ((static_cast<size_t>(b) * splits + s) * C + c0 +
                         ch) * 3;
      p[0] = tot.n;
      p[1] = tot.mean;
      p[2] = tot.m2;
    }

    cg::this_grid().sync();

    // the group's S partials in the order s = 0..S-1: thread k merges run
    // k, then k = 0 merges the runs in order (red is free: every read of
    // it came before the grid sync)
    const int per = (splits + RUNS - 1) / RUNS;
    const int lo = min(splits, k * per);
    const int hi = min(splits, lo + per);
    tot = {0.0f, 0.0f, 0.0f};
    if (c0 + ch < C) {
      // UNROLL partials loaded at once: the merge is a serial chain, its
      // loads need not be
      for (int j0 = lo; j0 < hi; j0 += UNROLL) {
        float q[UNROLL][3];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (j0 + u < hi) {
            const float* p = grp_part + (j0 + u) * stride;
            q[u][0] = p[0];
            q[u][1] = p[1];
            q[u][2] = p[2];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (j0 + u < hi) chan(tot, q[u][0], q[u][1], q[u][2]);
      }
    }
    red[k][ch][0] = tot.n;
    red[k][ch][1] = tot.mean;
    red[k][ch][2] = tot.m2;
    __syncthreads();
    if (k == 0) {
      tot = {0.0f, 0.0f, 0.0f};
      for (int j = 0; j < RUNS; ++j)
        chan(tot, red[j][ch][0], red[j][ch][1], red[j][ch][2]);
    }
  }

  if (k == 0) {
    const float rs = rsqrtf(tot.m2 / tot.n + eps);
    stats[ch][0] = tot.mean;
    stats[ch][1] = rs;
    if (s == 0 && c0 + ch < C) {
      mean[b * C + c0 + ch] = tot.mean;
      rstd[b * C + c0 + ch] = rs;
    }
  }
  __syncthreads();
  if (!c_ok) return;

  // pass 2: y from the stash, then from the rest of the chunk
  float mu2[VEC], rs2[VEC], gm[VEC], bt[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu2[i] = stats[lc * VEC + i][0];
    rs2[i] = stats[lc * VEC + i][1];
    gm[i] = AFFINE ? gamma[b * C + c + i] : 1.0f;
    bt[i] = AFFINE ? beta[b * C + c + i] : 0.0f;
  }
  auto normalize = [&](const R& r) {
    float f[VEC];
    unpack<T, VEC>(r, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      f[i] = (f[i] - mu2[i]) * rs2[i];
      if (AFFINE) f[i] = f[i] * gm[i] + bt[i];
    }
    return pack<T, VEC>(f);
  };
#pragma unroll 4
  for (int it = 0; it < kept; ++it) {
    if (valid(it))
      *reinterpret_cast<R*>(y + at(it)) =
          normalize(stash[it * THREADS + threadIdx.x]);
  }
  // last rows first: the likeliest still in L2
  for (int it0 = iters - 1; it0 >= kept; it0 -= UNROLL) {
    R v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 - u;
      if (it >= kept && valid(it))
        v[u] = *reinterpret_cast<const R*>(x + at(it));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 - u;
      if (it >= kept && valid(it))
        *reinterpret_cast<R*>(y + at(it)) = normalize(v[u]);
    }
  }
}

template <typename T, int VEC, bool AFFINE>
const void* pick_mode(int coop) {
  return coop ? (const void*)instance_norm_fwd_kernel<T, VEC, AFFINE, true>
              : (const void*)instance_norm_fwd_kernel<T, VEC, AFFINE, false>;
}

template <typename T, int VEC>
const void* pick_affine(int affine, int coop) {
  return affine ? pick_mode<T, VEC, true>(coop)
                : pick_mode<T, VEC, false>(coop);
}

// The kernel for (dtype, vec, affine, coop): dtype 0 = float32, 1 =
// bfloat16; vec 16 / sizeof(element) or 1. nullptr for anything else.
const void* pick(int dtype, int vec, int affine, int coop) {
  if (dtype == 1 && vec == 8) return pick_affine<__nv_bfloat16, 8>(affine, coop);
  if (dtype == 1 && vec == 1) return pick_affine<__nv_bfloat16, 1>(affine, coop);
  if (dtype == 0 && vec == 4) return pick_affine<float, 4>(affine, coop);
  if (dtype == 0 && vec == 1) return pick_affine<float, 1>(affine, coop);
  return nullptr;
}

}  // namespace

// For the (dtype, vec, affine) kernels on the current device, at
// BLOCKS_PER_SM blocks on each SM: the bytes of x a block may keep in
// shared memory (*stash_bytes, a multiple of 1 KB) and how many blocks of
// the cooperative kernel with that stash the device holds at once
// (*capacity). Raises both modes' dynamic shared-memory limit to the most a
// block may have. 0 or a CUDA error code.
extern "C" int councilx_instance_norm_fwd_plan(int dtype, int vec,
                                               int affine, int* stash_bytes,
                                               int* capacity) {
  const void* fns[2] = {pick(dtype, vec, affine, 1),
                        pick(dtype, vec, affine, 0)};
  if (fns[0] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int sm_smem = 0, optin = 0, reserved = 0;
  cudaFuncAttributes fa;
  cudaError_t err = device_attribute(
      cudaDevAttrMaxSharedMemoryPerMultiprocessor, &sm_smem);
  if (err == cudaSuccess)
    err = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (err == cudaSuccess)
    err = device_attribute(cudaDevAttrReservedSharedMemoryPerBlock,
                           &reserved);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fns[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  // both modes declare the same static shared memory
  const int fixed = static_cast<int>(fa.sharedSizeBytes);
  for (const void* fn : fns) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin - fixed);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int budget = sm_smem / BLOCKS_PER_SM - reserved - fixed;
  budget = (budget < optin - fixed ? budget : optin - fixed) / 1024 * 1024;
  if (budget < 0) return static_cast<int>(cudaErrorInvalidValue);
  err = co_resident_blocks(fns[0], budget, capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  *stash_bytes = budget;
  return 0;
}

// x, y (B, HW, C) of one dtype (0 = float32, 1 = bfloat16); gamma, beta
// (B, C) f32, or both null (no affine); mean, rstd (B, C) f32 out; part
// (B, splits, C, 3) f32 scratch when splits > 1. vec: 16 / element size (C
// a multiple of it, x and y 16-byte aligned) or 1. splits > 1: one
// cooperative launch of B * ceil(C / 64) * splits blocks; splits = 1: one
// plain launch of B * ceil(C / 64) blocks. Each block has stash_iters *
// 256 * vec elements of dynamic shared memory, within what
// councilx_instance_norm_fwd_plan allowed. On `stream`; does not
// synchronise; returns the launch's error code (0 on success).
extern "C" int councilx_instance_norm_fwd(
    const void* x, const float* gamma, const float* beta, void* y,
    float* mean, float* rstd, float* part, int B, int HW, int C, int dtype,
    int vec, int splits, int rows_per_split, int stash_iters, float eps,
    void* stream) {
  const int coop = splits > 1;
  const void* fn = pick(dtype, vec, gamma != nullptr, coop);
  if (fn == nullptr || splits < 1 || rows_per_split < 1 || stash_iters < 0 ||
      (coop && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int cgroups = (C + CB - 1) / CB;
  const size_t smem = static_cast<size_t>(stash_iters) * THREADS * vec *
                      (dtype == 1 ? 2 : 4);
  void* args[] = {(void*)&x,   (void*)&gamma, (void*)&beta, &y,
                  &mean,       &rstd,         &part,        &HW,
                  &C,          &cgroups,      &splits,      &rows_per_split,
                  &stash_iters, &eps};
  const dim3 grid(static_cast<unsigned>(B * cgroups * splits));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coop)
    return static_cast<int>(cudaLaunchCooperativeKernel(
        fn, grid, dim3(THREADS), args, smem, st));
  return static_cast<int>(
      cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, st));
}
