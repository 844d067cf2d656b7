// VALID 3x3 stride-1 convolution on a pre-padded NHWC input, for Hopper.
//
// Replaces councilx/ops/pallas_conv.py::_conv_kernel_rows (the forward of
// conv3x3_valid): y[b,i,j,o] = sum_{dy,dx,c} xp[b,i+dy,j+dx,c] * w[dy,dx,c,o]
// with xp (B, H+2, W+2, C) NHWC contiguous, w (3, 3, C, O) HWIO contiguous,
// y (B, H, W, O). Sums in f32, one cast to the input type at the end. The
// caller does the reflect pad and adds the bias, as in the JAX package.
//
// The same kernel is the dgrad of the conv, as _bwd_rule runs the TPU
// kernel (pallas_conv.py:279): the cotangent zero-padded by 2,
// (B, H+4, W+4, O), convolved with the flipped, in/out-swapped weight gives
// d(xp) (B, H+2, W+2, C); the wrapper (ops/conv3x3.py::conv3x3_dgrad) pads
// and flips. At the training shape that is M = 8*66*66 = 34848, N = 256,
// K = 2304, ~41 GFLOP, bound like the forward.
//
// What bounds it on the H100: at the serving shape (B*64*64 pixels,
// C = O = 256) it is an implicit GEMM with M = B*4096, N = 256, K = 9C =
// 2304: 2*M*N*K = 4.8 GFLOP per image against ~2.2 MB of bf16 traffic per
// image, about 2000 FLOP per byte, far above the card's ~295 FLOP/byte
// ridge. It is bound by the tensor cores.
//
// Design (bf16): the TPU kernel built a (rows*W, 9C) im2col matrix in VMEM
// and issued one dot. Shared memory is too small for that here, so the
// 9 shifted windows are gathered tile by tile instead: each 128x128 output
// tile walks K = 9C in steps of 32; the A tile (128 output pixels x 32 taps
// of one (dy,dx) window) and the B tile (32 x 128 of the HWIO weight) are
// copied global->shared with 16-byte cp.async (zero-filled past the edges),
// double-buffered so the next tile's copies overlap this tile's math, and
// multiplied with WMMA 16x16x16 bf16 fragments (mma.sync on the tensor
// cores), accumulating in f32 registers. 8 warps each own a 64x32 slice of
// the output tile. No im2col is ever materialised in global memory.
// wgmma, TMA and a persistent schedule are left for later work.
//
// f32 (parity mode) uses a plain shared-memory tiled FMA kernel with the
// same indexing: it exists for exactness, not speed.
//
// Gate (checked by the Python wrapper, which raises on anything else):
// C % 8 == 0 and O % 8 == 0 (16-byte bf16 chunks never straddle a tap or
// the edge of a row), H, W >= 1; edges in M, N and K are masked here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int APAD = 8;   // row padding (elements) against bank conflicts
constexpr int BPAD = 8;
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

__global__ void __launch_bounds__(THREADS)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ xp,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y,
                    int B, int H, int W, int C, int O) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][BK + APAD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][BN + BPAD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;  // 0..1: 64-row slice
  const int wn = warp % 4;  // 0..3: 32-col slice
  const long long M = static_cast<long long>(B) * H * W;
  const int K = 9 * C;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int Wp = W + 2;

  // each thread copies two 16-byte A chunks per K step: rows r0 and r0+64,
  // chunk q of the 4 in a 32-wide K slice
  const int a_row0 = tid / 4;
  const int a_q = tid % 4;
  long long a_pix[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    long long m = m0 + a_row0 + r * 64;
    a_ok[r] = m < M;
    long long mm = a_ok[r] ? m : 0;
    long long b = mm / (static_cast<long long>(H) * W);
    long long rem = mm - b * H * W;
    long long i = rem / W;
    long long j = rem - i * W;
    a_pix[r] = (b * (H + 2) + i) * Wp + j;  // top-left tap's pixel index
  }
  // two 16-byte B chunks per K step: (row, 8-col chunk) of a 32x128 tile
  const int b_row0 = tid / 16;
  const int b_q = tid % 16;

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * BK;
    {
      const int k = k0 + a_q * 8;
      const bool k_ok = k < K;
      const int tap = k_ok ? k / C : 0;
      const int c = k_ok ? k - tap * C : 0;
      const long long shift = static_cast<long long>(tap / 3) * Wp + tap % 3;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = a_ok[r] && k_ok;
        const __nv_bfloat16* src =
            ok ? xp + (a_pix[r] + shift) * C + c : xp;
        cp_async16(&As[buf][a_row0 + r * 64][a_q * 8], src, ok);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = b_row0 + r * 16;
      const int k = k0 + row;
      const int n = n0 + b_q * 8;
      const bool ok = k < K && n < O;
      const __nv_bfloat16* src =
          ok ? w + static_cast<long long>(k) * O + n : w;
      cp_async16(&Bs[buf][row][b_q * 8], src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {
      load_tile(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][wm * 64 + i * 16][kk],
                               BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[buf][kk][wn * 32 + j * 16],
                               BN + BPAD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

  // epilogue: stage each 16x16 fragment through this warp's shared slot,
  // cast once, write with the M/N edges masked
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long m = m0 + wm * 64 + i * 16 + e / 16;
        const int n = n0 + wn * 32 + j * 16 + e % 16;
        if (m < M && n < O) y[m * O + n] = __float2bfloat16(cs[e]);
      }
      __syncwarp();
    }
  }
}

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;

__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                   float* __restrict__ y, int B, int H, int W, int C, int O) {
  __shared__ float As[FBK][FBM + 4];
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long M = static_cast<long long>(B) * H * W;
  const int K = 9 * C;
  const long long m0 = static_cast<long long>(blockIdx.y) * FBM;
  const int n0 = blockIdx.x * FBN;
  const int Wp = W + 2;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int id = tid + e * THREADS;
      const int row = id / FBK;
      const int kk = id % FBK;
      const long long m = m0 + row;
      const int k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < K) {
        const long long b = m / (static_cast<long long>(H) * W);
        const long long rem = m - b * H * W;
        const long long i = rem / W;
        const long long j = rem - i * W;
        const int tap = k / C;
        const int c = k - tap * C;
        v = xp[((b * (H + 2) + i + tap / 3) * Wp + j + tap % 3) * C + c];
      }
      As[kk][row] = v;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int id = tid + e * THREADS;
      const int kk = id / FBN;
      const int col = id % FBN;
      const int k = k0 + kk;
      const int n = n0 + col;
      Bs[kk][col] =
          (k < K && n < O) ? w[static_cast<long long>(k) * O + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < O) y[m * O + n] = acc[r][c];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int councilx_conv3x3_valid(const void* xp, const void* w, void* y,
                                      int B, int H, int W, int C, int O,
                                      int dtype, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((O + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
    conv3x3_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xp),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), B, H, W, C, O);
  } else if (dtype == 0) {
    dim3 grid((O + FBN - 1) / FBN, static_cast<unsigned>((M + FBM - 1) / FBM));
    conv3x3_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(w),
        static_cast<float*>(y), B, H, W, C, O);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
