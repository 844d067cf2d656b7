// Weight gradient of the VALID 3x3 stride-1 convolution, for Hopper.
//
// Replaces councilx/ops/pallas_conv.py::_wgrad_kernel (_conv3x3_wgrad):
//   dk[dy,dx,c,o] = sum_{b,i,j} xp[b,i+dy,j+dx,c] * g[b,i,j,o]
// with xp (B, H+2, W+2, C) NHWC contiguous, g (B, H, W, O) contiguous and
// dk (3, 3, C, O) HWIO. Sums in f32; the result is written in the output
// type (the conv weight's) with one rounding at the end.
//
// What bounds it on the H100: it is a GEMM dk_cat (9C, O) = A^T G with
// A = the im2col matrix (B*H*W, 9C) and G = g viewed as (B*H*W, O). At the
// training shape (B*H*W = 32768, C = O = 256) that is M' = 2304, N' = 256,
// K' = 32768: 38.7 GFLOP against ~36 MB of bf16 input, ~1000 FLOP per byte,
// so it is bound by the tensor cores -- if the card is filled. The output is
// small: 128x128 tiles give only 18 x 2 = 36 tiles for 132 SMs.
//
// Design (bf16): the TPU kernel accumulated into one (9C, O) f32 block over a
// sequential grid. Hopper's blocks run in parallel and in no order, so the
// K' = B*H*W reduction is split into S ranges of pixels; block (n, m, s)
// computes the 128x128 tile (m, n) of range s into an f32 partial
// part[s] (S x 9C x O, scratch from the wrapper), and a second kernel sums
// the S partials in fixed order s = 0..S-1 and casts once. No atomics, so
// two runs on the same inputs are bit-identical. Inside a block: K' steps of
// 32 pixels; the A^T tile (32 pixels x 128 taps*channels) and the G tile
// (32 pixels x 128 outputs) are copied global->shared with 16-byte cp.async
// (zero-filled past the edges; 8 channels never straddle a tap since
// C % 8 == 0), double-buffered, and multiplied with WMMA 16x16x16 bf16
// fragments (A read column-major from the pixel-major tile), f32
// accumulators. 8 warps each own 64 x 32 of the tile. No im2col in global
// memory. wgmma, TMA and a persistent schedule are left for later work.
//
// f32 (parity mode) uses a plain shared-memory tiled FMA kernel with the
// same split and the same reduction: it exists for exactness, not speed.
//
// Gate (checked by the Python wrapper, which raises on anything else):
// C % 8 == 0, O % 8 == 0, H, W >= 1, the pixels per split a multiple of the
// kernel's K' step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;   // rows of dk_cat (tap*C + c)
constexpr int BN = 128;   // outputs o
constexpr int BK = 32;    // pixels per K' step
constexpr int PAD = 8;    // row padding (elements) against bank conflicts
constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// index of the top-left tap of output pixel p in the padded input, in pixels
__device__ __forceinline__ long long tap0_pixel(long long p, int H, int W) {
  const long long hw = static_cast<long long>(H) * W;
  const long long b = p / hw;
  const long long rem = p - b * hw;
  const long long i = rem / W;
  const long long j = rem - i * W;
  return (b * (H + 2) + i) * (W + 2) + j;
}

__global__ void __launch_bounds__(THREADS)
wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ xp,
                  const __nv_bfloat16* __restrict__ g,
                  float* __restrict__ part, int B, int H, int W, int C,
                  int O, long long pix_per_split) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BK][BM + PAD];
  __shared__ __align__(128) __nv_bfloat16 Gs[2][BK][BN + PAD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;  // 0..1: 64-row slice of the tile
  const int wn = warp % 4;  // 0..3: 32-col slice
  const int M = 9 * C;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long P = static_cast<long long>(B) * H * W;
  const long long p_begin = static_cast<long long>(blockIdx.z) * pix_per_split;
  const long long p_end =
      P < p_begin + pix_per_split ? P : p_begin + pix_per_split;
  const int Wp = W + 2;

  // each thread copies two 16-byte chunks of each tile per step: pixel rows
  // r0 and r0 + 16, chunk q of the 16 in a 128-wide row. Its A chunk is the
  // same 8 (tap, channel) columns at every step, so its tap shift is fixed.
  const int r0 = tid / 16;
  const int q = tid % 16;
  const int a_col = m0 + q * 8;
  const bool a_col_ok = a_col < M;
  const int tap = a_col_ok ? a_col / C : 0;
  const int a_c = a_col_ok ? a_col - tap * C : 0;
  const long long a_shift = static_cast<long long>(tap / 3) * Wp + tap % 3;
  const int g_col = n0 + q * 8;
  const bool g_col_ok = g_col < O;

  auto load_tile = [&](long long p0, int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + r * 16;
      const long long p = p0 + row;
      const bool p_ok = p < p_end;
      const long long pp = p_ok ? p : 0;
      const bool a_ok = p_ok && a_col_ok;
      const __nv_bfloat16* asrc =
          a_ok ? xp + (tap0_pixel(pp, H, W) + a_shift) * C + a_c : xp;
      cp_async16(&As[buf][row][q * 8], asrc, a_ok);
      const bool g_ok = p_ok && g_col_ok;
      const __nv_bfloat16* gsrc = g_ok ? g + pp * O + g_col : g;
      cp_async16(&Gs[buf][row][q * 8], gsrc, g_ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const long long steps = (p_end - p_begin + BK - 1) / BK;
  if (steps > 0) {
    load_tile(p_begin, 0);
    cp_async_commit();
  }
  for (long long kt = 0; kt < steps; ++kt) {
    const int buf = static_cast<int>(kt & 1);
    if (kt + 1 < steps) {
      load_tile(p_begin + (kt + 1) * BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A^T (rows = tap*C + c, cols = pixels) read column-major from the
      // pixel-major tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][kk][wm * 64 + i * 16],
                               BM + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Gs[buf][kk][wn * 32 + j * 16],
                               BN + PAD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

  // epilogue: stage each 16x16 fragment through this warp's shared slot and
  // write the f32 partial with the M/N edges masked
  float* out = part + static_cast<long long>(blockIdx.z) * M * O;
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 64 + i * 16 + e / 16;
        const int n = n0 + wn * 32 + j * 16 + e % 16;
        if (m < M && n < O) out[static_cast<long long>(m) * O + n] = cs[e];
      }
      __syncwarp();
    }
  }
}

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;

__global__ void __launch_bounds__(THREADS)
wgrad_f32_kernel(const float* __restrict__ xp, const float* __restrict__ g,
                 float* __restrict__ part, int B, int H, int W, int C, int O,
                 long long pix_per_split) {
  __shared__ float As[FBK][FBM + 4];
  __shared__ float Gs[FBK][FBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int M = 9 * C;
  const int m0 = blockIdx.y * FBM;
  const int n0 = blockIdx.x * FBN;
  const long long P = static_cast<long long>(B) * H * W;
  const long long p_begin = static_cast<long long>(blockIdx.z) * pix_per_split;
  const long long p_end =
      P < p_begin + pix_per_split ? P : p_begin + pix_per_split;
  const int Wp = W + 2;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (long long p0 = p_begin; p0 < p_end; p0 += FBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int id = tid + e * THREADS;
      const int row = id / FBM;   // pixel in the step
      const int col = id % FBM;   // tap*C + c, contiguous in memory per tap
      const long long p = p0 + row;
      const int m = m0 + col;
      float v = 0.0f;
      if (p < p_end && m < M) {
        const int t = m / C;
        const int c = m - t * C;
        v = xp[(tap0_pixel(p, H, W) + (t / 3) * Wp + t % 3) * C + c];
      }
      As[row][col] = v;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int id = tid + e * THREADS;
      const int row = id / FBN;
      const int col = id % FBN;
      const long long p = p0 + row;
      const int n = n0 + col;
      Gs[row][col] = (p < p_end && n < O) ? g[p * O + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Gs[kk][tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * M * O;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < O) out[static_cast<long long>(m) * O + n] = acc[r][c];
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// dk[e] = sum_{s=0..S-1} part[s][e], in this fixed order, cast once
template <typename T>
__global__ void __launch_bounds__(THREADS)
sum_splits_kernel(const float* __restrict__ part, T* __restrict__ dk,
                  long long n, int S) {
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * THREADS) {
    float s = 0.0f;
    for (int k = 0; k < S; ++k) s += part[k * n + e];
    store_out(dk + e, s);
  }
}

}  // namespace

// in_dtype (xp and g): 0 = float32, 1 = bfloat16; out_dtype (dk): the same
// codes. part holds splits * 9C * O floats; split s covers output pixels
// [s * pix_per_split, (s + 1) * pix_per_split). Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launches.
extern "C" int councilx_conv3x3_wgrad(const void* xp, const void* g,
                                      void* part, void* dk, int B, int H,
                                      int W, int C, int O, int in_dtype,
                                      int out_dtype, int splits,
                                      long long pix_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = 9 * C;
  if (in_dtype == 1) {
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, splits);
    wgrad_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xp),
        static_cast<const __nv_bfloat16*>(g), static_cast<float*>(part), B,
        H, W, C, O, pix_per_split);
  } else if (in_dtype == 0) {
    dim3 grid((O + FBN - 1) / FBN, (M + FBM - 1) / FBM, splits);
    wgrad_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(g),
        static_cast<float*>(part), B, H, W, C, O, pix_per_split);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(M) * O;
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (out_dtype == 1) {
    sum_splits_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk), n,
        splits);
  } else if (out_dtype == 0) {
    sum_splits_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(dk), n, splits);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
