// Activation quantize of the W8A8 serving convs (Q2), for Hopper: bf16 or
// f32 NHWC x (B, H, W, C) -> the int8 codes of x padded by `pad`,
// (B, H + 2 pad, W + 2 pad, Cq) with Cq = C rounded up to 16, zeros beyond
// C, as csrc/conv_int8.cu takes them.
//
// Replaces the activation half of councilx/ops/quant.py (XLA elementwise
// and reduce work there, not a Pallas kernel): quantize_act_per_image
// (:56) and quantize_act_static (:65). Codes are
//   q = clip(rint(x / a_s), -127, 127)
// with a true IEEE division (never a multiply by the reciprocal), rounding
// half to even, never -128; the scale is
//   static:  a_s = max(a_scale, 1e-12), a_scale read from a device scalar
//            (no host sync);
//   dynamic: a_s[b] = max(max |x[b]|, 1e-12) / 127 per image, from a first
//            launch (absmax_kernel) that writes per-chunk maxima; the
//            quantize launch reduces them (a max is exact in any order).
// The quantize writes a_s (B values, or one) for the conv's rescale.
//
// The pad is the one nn/blocks.py::pad2d makes (zero, reflect without the
// edge, replicate), taken as an index into the unpadded x: a pad only
// copies values, so max |pad(x)| = max |x| and quantizing commutes with
// it. The JAX package pads, then quantizes: the same codes, without the
// padded bf16 copy.
//
// What bounds it on the H100: memory. At the resblock site (8, 64, 64, 256)
// in bf16 it reads 16.8 MB and writes 8.9 MB of int8, 7.7 us at 3.35
// TB/s; the dynamic mode reads x once more (its absmax pass). Design: a
// thread owns 8 channels of one padded pixel: one 16-byte load (bf16; two
// for f32) and one 8-byte store, neighbouring threads on neighbouring
// addresses; a grid-stride loop over each image's pixels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;            // channels per thread and iteration

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// GROUP consecutive elements at p (16-byte aligned) into f32.
__device__ __forceinline__ void load_group(const __nv_bfloat16* p,
                                           float (&v)[GROUP]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < GROUP; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load_group(const float* p,
                                           float (&v)[GROUP]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Largest value over the block (every thread gets it).
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) m = fmaxf(m, warp_max[i]);
  __syncthreads();
  return m;
}

// Per image b (blockIdx.y) and chunk s (blockIdx.x) of its n elements:
// partial[b * splits + s] = max |x| over the chunk. Chunks start on
// multiples of GROUP elements; `vec`: n and x's address allow 16-byte
// loads.
template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const T* __restrict__ x, float* __restrict__ partial,
              long long n, int splits, int vec) {
  const int b = blockIdx.y, s = blockIdx.x;
  const T* xb = x + static_cast<size_t>(b) * n;
  const long long per =
      ((n + splits - 1) / splits + GROUP - 1) / GROUP * GROUP;
  const long long lo = s * per;
  const long long hi = lo + per < n ? lo + per : n;
  float m = 0.0f;
  if (vec) {
    for (long long i = lo + static_cast<long long>(threadIdx.x) * GROUP;
         i < hi; i += static_cast<long long>(THREADS) * GROUP) {
      float v[GROUP];
      load_group(xb + i, v);
#pragma unroll
      for (int k = 0; k < GROUP; ++k) m = fmaxf(m, fabsf(v[k]));
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS)
      m = fmaxf(m, fabsf(to_f32(xb[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partial[static_cast<size_t>(b) * splits + s] = m;
}

// Source row (column) of padded index i in [-pad, n + pad): reflect
// (without the edge; pad < n), replicate, or -1 for a zero.
__device__ __forceinline__ int source(int i, int n, int pad_type) {
  if (i >= 0 && i < n) return i;
  if (pad_type == 1) return i < 0 ? -i : 2 * (n - 1) - i;
  if (pad_type == 2) return i < 0 ? 0 : n - 1;
  return -1;
}

// Image b = blockIdx.y: the scale (static from scale_in[0]; dynamic from
// the `splits` partial maxima of absmax_kernel in scale_in), stored to
// a_s_out by the image's first block; then the codes of every group of
// GROUP channels of every padded pixel, grid-stride over blockIdx.x.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
             const float* __restrict__ scale_in, float* __restrict__ a_s_out,
             int splits, int H, int W, int C, int Cq, int pad, int pad_type,
             int vec) {
  const int b = blockIdx.y;
  float a_s;
  if (splits > 0) {
    float m = 0.0f;
    for (int i = threadIdx.x; i < splits; i += THREADS)
      m = fmaxf(m, scale_in[static_cast<size_t>(b) * splits + i]);
    a_s = __fdiv_rn(fmaxf(block_max(m), 1e-12f), 127.0f);
  } else {
    a_s = fmaxf(scale_in[0], 1e-12f);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && (splits > 0 || b == 0))
    a_s_out[splits > 0 ? b : 0] = a_s;

  const int Hp = H + 2 * pad, Wp = W + 2 * pad, G = Cq / GROUP;
  const long long total = static_cast<long long>(Hp) * Wp * G;
  for (long long idx = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * THREADS) {
    const int g = static_cast<int>(idx % G);
    const long long pix = idx / G;
    const int wp = static_cast<int>(pix % Wp), hp = static_cast<int>(pix / Wp);
    const int h = source(hp - pad, H, pad_type);
    const int w = source(wp - pad, W, pad_type);
    const int c0 = g * GROUP;
    float v[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) v[i] = 0.0f;
    if (h >= 0 && w >= 0 && c0 < C) {
      const T* src = x + ((static_cast<size_t>(b) * H + h) * W + w) * C + c0;
      if (vec) {                  // C a multiple of GROUP: the whole group
        load_group(src, v);
      } else {
#pragma unroll
        for (int i = 0; i < GROUP; ++i)
          if (c0 + i < C) v[i] = to_f32(src[i]);
      }
    }
    union {
      int8_t c[GROUP];
      uint2 u;
    } out;
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const float r = rintf(__fdiv_rn(v[i], a_s));
      out.c[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
    *reinterpret_cast<uint2*>(
        q + ((static_cast<size_t>(b) * Hp + hp) * Wp + wp) * Cq + c0) = out.u;
  }
}

template <typename T>
cudaError_t launch_absmax(const void* x, float* partial, int B, long long n,
                          int splits, cudaStream_t st) {
  const int vec = n % GROUP == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  absmax_kernel<T><<<dim3(splits, B), THREADS, 0, st>>>(
      static_cast<const T*>(x), partial, n, splits, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant(const void* x, int8_t* q, const float* scale_in,
                         float* a_s_out, int splits, int B, int H, int W,
                         int C, int Cq, int pad, int pad_type,
                         cudaStream_t st) {
  const int vec = C % GROUP == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long total = static_cast<long long>(H + 2 * pad) *
                          (W + 2 * pad) * (Cq / GROUP);
  long long blocks = (total + THREADS - 1) / THREADS;
  // about 2048 blocks over the card, every thread a few iterations
  const long long cap = 2048 / B > 1 ? 2048 / B : 1;
  if (blocks > cap) blocks = cap;
  quant_kernel<T><<<dim3(static_cast<unsigned>(blocks), B), THREADS, 0,
                    st>>>(static_cast<const T*>(x), q, scale_in, a_s_out,
                          splits, H, W, C, Cq, pad, pad_type, vec);
  return cudaGetLastError();
}

}  // namespace

// Per-chunk absolute maxima of each image of x (B images of n elements,
// dtype 0 f32, 1 bf16) into partial (B, splits) f32.
extern "C" int councilx_quant_absmax(const void* x, float* partial, int B,
                                     long long n, int dtype, int splits,
                                     void* stream) {
  if (B < 1 || n < 1 || splits < 1 || splits > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_absmax<__nv_bfloat16>(x, partial, B, n, splits, st);
  else if (dtype == 0)
    err = launch_absmax<float>(x, partial, B, n, splits, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// x (B, H, W, C) -> q (B, H+2pad, W+2pad, Cq) int8 and a_s_out: static
// (splits = 0) with scale_in one f32 a_scale; dynamic with scale_in the
// (B, splits) maxima of councilx_quant_absmax. pad_type 0 zero, 1 reflect,
// 2 replicate; dtype 0 f32, 1 bf16; Cq a multiple of 16, at least C.
extern "C" int councilx_quant_act(const void* x, int8_t* q,
                                  const float* scale_in, float* a_s_out,
                                  int splits, int B, int H, int W, int C,
                                  int Cq, int pad, int pad_type, int dtype,
                                  void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || Cq < C ||
      Cq % 16 || pad < 0 || pad_type < 0 || pad_type > 2 || splits < 0 ||
      (pad_type == 1 && (pad >= H || pad >= W)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_quant<__nv_bfloat16>(x, q, scale_in, a_s_out, splits, B, H,
                                      W, C, Cq, pad, pad_type, st);
  else if (dtype == 0)
    err = launch_quant<float>(x, q, scale_in, a_s_out, splits, B, H, W, C,
                              Cq, pad, pad_type, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
