// Int8 implicit-GEMM VALID convolution with the W8A8 rescale (Q1), for
// Hopper: x (B, Hp, Wp, C) int8 NHWC (already padded, by csrc/
// quant_act.cu), w (O, kh, kw, C) int8 -> y (B, Ho, Wo, O), stride s:
//   acc[m, o] = sum_{r, t, c} x[b, oh s + r, ow s + t, c] w[o, r, t, c]
// in exact int32, then, in f32 and in this order (no fused multiply-add),
//   y = acc * (a_s[b] * w_s[o]) + bias[o]
// cast to bf16 or f32 (or acc itself, stored as int32).
//
// Replaces the conv of councilx/ops/quant.py::conv_w8a8 (:95): XLA's
// conv_general_dilated with preferred_element_type=int32 and its rescale
// (:99-102), not a Pallas kernel. PyTorch has no int8 convolution on CUDA.
//
// What bounds it on the H100: the tensor cores. At the resblock site (8,
// 66, 66, 256) x (256, 3, 3, 256) it does 38.65 G int8 operations, 19.5 us
// at 1,979 TOPS, against 26 MB of traffic (7.9 us at 3.35 TB/s).
//
// Design (a first, simple kernel): the implicit GEMM M = B Ho Wo output
// pixels by N = O channels by K = kh kw C, both operands K-contiguous (C
// a multiple of 16, so each 16-byte chunk of a K row lies in one tap).
//   * Block tile 128 x 128 x 64 bytes of K, 256 threads (8 warps of 64 x
//     32), two blocks per SM.
//   * A 4-stage cp.async ring in shared memory: each thread copies two
//     16-byte chunks of A (its output pixels' rows, the tap and channel
//     offset from k) and two of B per stage, zero-filled past M, N and K.
//     Rows are padded to 80 bytes, so ldmatrix reads them without bank
//     conflicts.
//   * ldmatrix.x4 feeds mma.sync m16n8k32 s8 x s8 -> s32.
//   * The epilogue rescales in registers and stores pairs of outputs.
// The TMA + wgmma (s8) form of csrc/hopper.cuh's bf16 pattern is the
// planned redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;                    // padded row, bytes
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;             // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two outputs n, n + 1 of row m at y + o.
template <int OUT>
__device__ __forceinline__ void store2(void* y, size_t o, int v0, int v1,
                                       float s0, float s1, float b0,
                                       float b1, bool has_bias) {
  if (OUT == 2) {
    *reinterpret_cast<int2*>(static_cast<int*>(y) + o) = make_int2(v0, v1);
    return;
  }
  float y0 = __fmul_rn(__int2float_rn(v0), s0);
  float y1 = __fmul_rn(__int2float_rn(v1), s1);
  if (has_bias) {
    y0 = __fadd_rn(y0, b0);
    y1 = __fadd_rn(y1, b1);
  }
  if (OUT == 0)
    *reinterpret_cast<float2*>(static_cast<float*>(y) + o) =
        make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + o) =
        __floats2bfloat162_rn(y0, y1);
}

// OUT: 0 f32, 1 bf16, 2 the int32 accumulator. Grid (ceil(M / BM),
// ceil(O / BN)).
template <int OUT>
__global__ void __launch_bounds__(THREADS, 2)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ a_s, int a_per_image,
                 const float* __restrict__ w_s,
                 const float* __restrict__ bias, void* __restrict__ y,
                 int Hp, int Wp, int C, int O, int kw, int stride, int Ho,
                 int Wo, int M, int K) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw = Ho * Wo;

  // this thread's copies: rows lrow and lrow + 64 of A and of B, the
  // 16-byte chunk lcol of each stage's 64 bytes of K
  const int lrow = tid >> 2, lcol = (tid & 3) * 16;
  const int8_t* a_src[2];
  const int8_t* b_src[2];
  bool a_ok[2], b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + lrow + 64 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int b = mm / hw, p = mm - b * hw;
    const int oh = p / Wo, ow = p - oh * Wo;
    a_src[i] = x + ((static_cast<size_t>(b) * Hp + oh * stride) * Wp +
                    ow * stride) * C;
    const int n = n0 + lrow + 64 * i;
    b_ok[i] = n < O;
    b_src[i] = w + static_cast<size_t>(b_ok[i] ? n : 0) * K;
  }
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  auto load_tile = [&](int kt, int stage) {
    const int k = kt * BK + lcol;
    const bool k_ok = k < K;
    int off = 0;
    if (k_ok) {
      const int tap = k / C, c = k - tap * C;
      const int r = tap / kw, t = tap - r * kw;
      off = (r * Wp + t) * C + c;
    }
    const uint32_t sa = base + stage * STAGE_BYTES;
    const uint32_t sb = sa + BM * LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t row = (lrow + 64 * i) * LDS + lcol;
      cp_async16(sa + row, a_src[i] + off, a_ok[i] && k_ok);
      cp_async16(sb + row, b_src[i] + (k_ok ? k : 0), b_ok[i] && k_ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_tile(next, next % STAGES);
    cp_async_commit();
    const uint32_t sa = base + (kt % STAGES) * STAGE_BYTES;
    const uint32_t sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = warp_m * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], sa + row * LDS + kk + (lane >> 4) * 16);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int row =
            warp_n * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bf[nj], sb + row * LDS + kk + ((lane >> 3) & 1) * 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                 bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: c0, c1 at row g, columns 2 tig, 2 tig + 1; c2, c3
  // at row g + 8
  const int g = lane >> 2, tig = lane & 3;
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 64 + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const float as = OUT == 2 ? 0.0f : a_s[a_per_image ? m / hw : 0];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + warp_n * 32 + ni * 8 + tig * 2;
        if (n >= O) continue;
        float s0 = 0.0f, s1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
        if (OUT != 2) {
          s0 = __fmul_rn(as, w_s[n]);
          s1 = __fmul_rn(as, w_s[n + 1]);
          if (has_bias) {
            b0 = bias[n];
            b1 = bias[n + 1];
          }
        }
        store2<OUT>(y, static_cast<size_t>(m) * O + n,
                    acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1], s0, s1,
                    b0, b1, has_bias);
      }
    }
  }
}

template <int OUT>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* a_s,
                   int a_per_image, const float* w_s, const float* bias,
                   void* y, int B, int Hp, int Wp, int C, int O, int kh,
                   int kw, int stride, int Ho, int Wo, cudaStream_t st) {
  // the dynamic shared memory above 48 KB, once per device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(conv_int8_kernel<OUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int M = B * Ho * Wo, K = kh * kw * C;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  conv_int8_kernel<OUT><<<grid, THREADS, SMEM_BYTES, st>>>(
      x, w, a_s, a_per_image, w_s, bias, y, Hp, Wp, C, O, kw, stride, Ho, Wo,
      M, K);
  return cudaGetLastError();
}

}  // namespace

// x (B, Hp, Wp, C) int8, w (O, kh, kw, C) int8 -> y (B, Ho, Wo, O):
// out_dtype 0 f32, 1 bf16 (rescaled by a_s (B values if a_per_image, else
// one) and w_s (O), plus bias (O) unless null), 2 the int32 accumulator.
// C a multiple of 16, O a multiple of 8; every pointer 16-byte aligned.
extern "C" int councilx_conv_int8(const int8_t* x, const int8_t* w,
                                  const float* a_s, int a_per_image,
                                  const float* w_s, const float* bias,
                                  void* y, int B, int Hp, int Wp, int C,
                                  int O, int kh, int kw, int stride, int Ho,
                                  int Wo, int out_dtype, void* stream) {
  if (B < 1 || C < 16 || C % 16 || O < 8 || O % 8 || kh < 1 || kw < 1 ||
      stride < 1 || Ho < 1 || Wo < 1 || (Ho - 1) * stride + kh > Hp ||
      (Wo - 1) * stride + kw > Wp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_dtype == 0)
    err = launch<0>(x, w, a_s, a_per_image, w_s, bias, y, B, Hp, Wp, C, O,
                    kh, kw, stride, Ho, Wo, st);
  else if (out_dtype == 1)
    err = launch<1>(x, w, a_s, a_per_image, w_s, bias, y, B, Hp, Wp, C, O,
                    kh, kw, stride, Ho, Wo, st);
  else if (out_dtype == 2)
    err = launch<2>(x, w, a_s, a_per_image, w_s, bias, y, B, Hp, Wp, C, O,
                    kh, kw, stride, Ho, Wo, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
