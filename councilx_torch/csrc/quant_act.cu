// Activation quantize of the W8A8 serving convs (Q2), for Hopper: bf16 or
// f32 NHWC x (B, H, W, C) -> the int8 codes of x padded by `pad`,
// (B, H + 2 pad, W + 2 pad, Cq) with Cq = C rounded up to 16, zeros beyond
// C, as csrc/conv_int8.cu takes them. One launch in either mode.
//
// Replaces the activation half of councilx/ops/quant.py (XLA elementwise
// and reduce work there, not a Pallas kernel): quantize_act_per_image
// (:56) and quantize_act_static (:65). Codes are
//   q = clip(rint(x / a_s), -127, 127)
// with rint of the correctly rounded IEEE quotient (__fdiv_rn), rounding
// half to even, never -128; the scale is
//   static:  a_s = max(a_scale, 1e-12), a_scale read from a device scalar
//            (no host sync);
//   per image: a_s[b] = max(max |x[b]|, 1e-12) / 127.
// The kernel writes a_s (B values, or one) for the conv's rescale.
//
// The pad is the one nn/blocks.py::pad2d makes (zero, reflect without the
// edge, replicate), taken as an index into the unpadded x: a pad only
// copies values, so max |pad(x)| = max |x| and quantizing commutes with
// it. The JAX package pads, then quantizes: the same codes, without the
// padded bf16 copy.
//
// What bounds it on the H100: memory. At the resblock site (8, 64, 64, 256)
// in bf16 it must read 16.8 MB and write 8.9 MB of int8, 7.7 us at 3.35
// TB/s, in either mode.
//
// Design. An item is 16 channels of one padded output pixel: one 16-byte
// store of codes, 32 (bf16) or 64 (f32) bytes of x read as 16-byte vectors
// (scalar loads where C or x's address is off that grid); neighbouring
// threads take neighbouring items. Each image's Hp Wp Cq / 16 items are
// split into `splits` chunks of whole iterations (256 items each), one
// block per chunk; the item's pixel and source index are worked out once
// per item in 32-bit arithmetic, the 16 channels then run straight.
//   * The code without a division per element (code_of): the IEEE
//     division, rint and the float-to-int conversion took more issue slots
//     than the bytes took time. With r = RN(1/a_s), t = RN(x r) is within
//     2^-23 |x/a_s| of the quotient, so within 2^-16 of it (and within
//     1.5 2^-16 of RN(x / a_s)) wherever |x/a_s| < 128. t is clipped to
//     +-127 first (exact: rint is monotone, +-127 are integers). rint
//     changes value only at half-integers: where t is more than 2^-12 from
//     one, rint(t) = rint(RN(x / a_s)), taken with the 1.5 2^23 trick
//     (t + 1.5 2^23 rounds t to an integer, half to even, and the sum's low
//     byte is that integer's); within 2^-12 of one the element is divided
//     as before (__fdiv_rn). Only full-rate f32 adds, multiplies and
//     min/max and byte permutes remain. Where r is not a normal float (a
//     static a_s above 2^126) every element is divided. A NaN clips to
//     -127, as fmaxf made it before.
//   * static: a plain launch of B * splits blocks of two iterations each
//     (ops/quant.py::_quant_split), which the card runs as they fit; each
//     thread quantizes its items, UNROLL in flight.
//   * per image, as csrc/instance_norm_fwd.cu does for K3: pass 1 reads the
//     chunk's items, UNROLL in flight, into the block's max |x|, keeping
//     the first stash_iters iterations raw in dynamic shared memory
//     (loaded evict-first). With splits > 1 each block writes its max to
//     (B, splits) f32 scratch, and one cooperative_groups::this_grid()
//     .sync() under cudaLaunchCooperativeKernel (splits from the
//     occupancy query, ops/quant.py::_quant_split) lets every block read
//     its image's maxima (a max is exact in any order); with splits = 1
//     (the images alone fill the card) the block owns its image and needs
//     no grid wait: a plain launch. Pass 2 quantizes the stash, then
//     re-reads the rest of the chunk, last iterations first (the likeliest
//     still in L2). At (8, 64, 64, 256) in bf16 every chunk fits: x is read
//     once, as in the static mode.

#include <cooperative_groups.h>

#include "norm.cuh"

namespace cg = cooperative_groups;

namespace {

using inorm::device_attribute;
using inorm::to_f32;

constexpr int THREADS = 256;          // ops/quant.py's _QUANT_THREADS
constexpr int GROUP = 16;             // channels per item
constexpr int BLOCKS_PER_SM = 3;      // the stash is sized for three
constexpr float ROUND = 12582912.0f;  // 1.5 * 2^23
constexpr float TIE_MARGIN = 1.0f / 4096.0f;

enum Mode { STATIC = 0, PER_IMAGE_GRID = 1, PER_IMAGE_BLOCK = 2 };

// One item's 16 raw elements as 16-byte vectors.
template <typename T>
struct Item {
  static constexpr int NV = GROUP * sizeof(T) / 16;
  uint4 v[NV];
  __device__ __forceinline__ float at(int k) const {
    return to_f32(reinterpret_cast<const T*>(v)[k]);
  }
};

// Source row (column) of padded index i in [-pad, n + pad): reflect
// (without the edge; pad < n), replicate, or -1 for a zero.
__device__ __forceinline__ int source(int i, int n, int pad_type) {
  if (i >= 0 && i < n) return i;
  if (pad_type == 1) return i < 0 ? -i : 2 * (n - 1) - i;
  if (pad_type == 2) return i < 0 ? 0 : n - 1;
  return -1;
}

// Where item i of image b reads (src, null for zeros; its channels below
// C in n) and writes (dst, byte offset of its codes in q).
template <typename T>
struct Where {
  const T* src;
  int n;
  size_t dst;
};

template <typename T>
__device__ __forceinline__ Where<T> locate(const T* x, int b, int i, int H,
                                           int W, int C, int Cq, int pad,
                                           int pad_type) {
  const int G = Cq / GROUP;
  const int Wp = W + 2 * pad;
  const int p = i / G;
  const int c0 = (i - p * G) * GROUP;
  const int hp = p / Wp;
  const int wp = p - hp * Wp;
  const int h = source(hp - pad, H, pad_type);
  const int w = source(wp - pad, W, pad_type);
  Where<T> r;
  r.dst = (static_cast<size_t>(b) * (H + 2 * pad) + hp) * Wp + wp;
  r.dst = r.dst * Cq + c0;
  r.n = C - c0 < GROUP ? C - c0 : GROUP;
  r.src = h >= 0 && w >= 0 && r.n > 0
              ? x + ((static_cast<size_t>(b) * H + h) * W + w) * C + c0
              : nullptr;
  return r;
}

// The item at src (zeros past n channels, or everywhere without src).
// VEC: C a multiple of 16 and x 16-byte aligned, so an item is whole
// vectors.
template <typename T, bool VEC, bool EVICT_FIRST>
__device__ __forceinline__ Item<T> load_item(const Where<T>& wh) {
  Item<T> it;
#pragma unroll
  for (int k = 0; k < Item<T>::NV; ++k) it.v[k] = make_uint4(0, 0, 0, 0);
  if (wh.src == nullptr) return it;
  if (VEC) {
    const uint4* p = reinterpret_cast<const uint4*>(wh.src);
#pragma unroll
    for (int k = 0; k < Item<T>::NV; ++k)
      it.v[k] = EVICT_FIRST ? __ldcs(p + k) : p[k];
  } else {
    T* e = reinterpret_cast<T*>(it.v);
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (k < wh.n) e[k] = wh.src[k];
  }
  return it;
}

template <typename T>
__device__ __forceinline__ float item_absmax(const Item<T>& it, float m) {
#pragma unroll
  for (int k = 0; k < GROUP; ++k) m = fmaxf(m, fabsf(it.at(k)));
  return m;
}

// The scale and its reciprocal: what code_of needs of a_s.
struct Scale {
  float a_s, r;
  bool recip;     // r is a normal float: the multiply is exact enough
};

__device__ __forceinline__ Scale make_scale(float a_s) {
  const float r = __frcp_rn(a_s);
  return {a_s, r, r >= 1.17549435e-38f && r <= 3.40282347e38f};
}

// clip(rint(RN(x / a_s)), -127, 127) in the low byte (two's complement)
// of the returned bits, by the reciprocal where that is exact and by
// __fdiv_rn elsewhere (see the header). Clipping t before rounding is
// exact: rint is monotone and +-127 are integers.
__device__ __forceinline__ uint32_t code_bits(float x, const Scale& s) {
  const float t = fminf(fmaxf(__fmul_rn(x, s.r), -127.0f), 127.0f);
  float u = __fadd_rn(t, ROUND);                  // rint(t) + 1.5 * 2^23
  const float d = fabsf(__fsub_rn(t, __fsub_rn(u, ROUND)));   // exact
  if (!s.recip || !(fabsf(__fsub_rn(d, 0.5f)) > TIE_MARGIN))
    u = __fadd_rn(fminf(fmaxf(rintf(__fdiv_rn(x, s.a_s)), -127.0f), 127.0f),
                  ROUND);
  return __float_as_uint(u);
}

// The codes of an item, one 16-byte store.
template <typename T>
__device__ __forceinline__ void store_codes(int8_t* q, size_t dst,
                                            const Item<T>& it,
                                            const Scale& s) {
  uint32_t w[GROUP / 4];
#pragma unroll
  for (int j = 0; j < GROUP / 4; ++j)
    w[j] = __byte_perm(__byte_perm(code_bits(it.at(4 * j), s),
                                   code_bits(it.at(4 * j + 1), s), 0x0040),
                       __byte_perm(code_bits(it.at(4 * j + 2), s),
                                   code_bits(it.at(4 * j + 3), s), 0x0040),
                       0x5410);
  *reinterpret_cast<uint4*>(q + dst) = make_uint4(w[0], w[1], w[2], w[3]);
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

// Grid: B * splits blocks, block (b, s) = (bid / splits, bid % splits).
// Chunk s covers items [s * items_per_split, +items_per_split) of the
// image's Hp Wp Cq / 16 (a multiple of THREADS); thread t takes item
// chunk + it * THREADS + t at iteration it. scale_in: the static a_scale
// (STATIC); part: (B, splits) f32 scratch (PER_IMAGE_GRID). The first
// stash_iters iterations are kept in dynamic shared memory, vector k of
// iteration it at stash[(it * NV + k) * THREADS + t] (per image only).
template <typename T, bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
             const float* __restrict__ scale_in,
             float* __restrict__ a_s_out, float* part, int H, int W, int C,
             int Cq, int pad, int pad_type, int splits, int items_per_split,
             int stash_iters) {
  using I = Item<T>;
  constexpr int NV = I::NV;
  constexpr int UNROLL = sizeof(T) == 2 ? 4 : 2;   // 128 bytes in flight
  extern __shared__ uint4 stash[];
  const int s = blockIdx.x % splits;
  const int b = blockIdx.x / splits;
  const int total = (H + 2 * pad) * (W + 2 * pad) * (Cq / GROUP);
  const int lo = s * items_per_split;
  const int hi = min(total, lo + items_per_split);
  const int iters = (hi - lo + THREADS - 1) / THREADS;
  const int t = static_cast<int>(threadIdx.x);
  auto item = [&](int it) { return lo + it * THREADS + t; };
  auto where = [&](int i) {
    return locate<T>(x, b, i, H, W, C, Cq, pad, pad_type);
  };

  if constexpr (MODE == STATIC) {
    const float a_s = fmaxf(scale_in[0], 1e-12f);
    if (blockIdx.x == 0 && threadIdx.x == 0) a_s_out[0] = a_s;
    const Scale sc = make_scale(a_s);
    for (int it0 = 0; it0 < iters; it0 += UNROLL) {
      I v[UNROLL];
      Where<T> wh[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (item(it0 + u) < hi) {
          wh[u] = where(item(it0 + u));
          v[u] = load_item<T, VEC, false>(wh[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (item(it0 + u) < hi) store_codes(q, wh[u].dst, v[u], sc);
    }
    return;
  }

  // pass 1: the chunk's max |x|, its first iterations stashed
  const int kept = min(stash_iters, iters);
  float m = 0.0f;
  for (int it0 = 0; it0 < iters; it0 += UNROLL) {
    I v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 + u;
      if (item(it) < hi) {
        const Where<T> wh = where(item(it));
        v[u] = it < kept ? load_item<T, VEC, true>(wh)
                         : load_item<T, VEC, false>(wh);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 + u;
      if (item(it) >= hi) continue;
      if (it < kept) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
          stash[(it * NV + k) * THREADS + threadIdx.x] = v[u].v[k];
      }
      m = item_absmax(v[u], m);
    }
  }
  m = block_max(m);
  if constexpr (MODE == PER_IMAGE_GRID) {
    if (threadIdx.x == 0) part[b * splits + s] = m;
    cg::this_grid().sync();
    float mm = 0.0f;
    for (int j = threadIdx.x; j < splits; j += THREADS)
      mm = fmaxf(mm, __ldcg(part + b * splits + j));
    m = block_max(mm);
  }
  const float a_s = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
  if (s == 0 && threadIdx.x == 0) a_s_out[b] = a_s;
  const Scale sc = make_scale(a_s);

  // pass 2: the stash, then the rest of the chunk, last iterations first
  for (int it = 0; it < kept; ++it) {
    if (item(it) >= hi) continue;
    I v;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      v.v[k] = stash[(it * NV + k) * THREADS + threadIdx.x];
    store_codes(q, where(item(it)).dst, v, sc);
  }
  for (int it0 = iters - 1; it0 >= kept; it0 -= UNROLL) {
    I v[UNROLL];
    Where<T> wh[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 - u;
      if (it >= kept && item(it) < hi) {
        wh[u] = where(item(it));
        v[u] = load_item<T, VEC, false>(wh[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = it0 - u;
      if (it >= kept && item(it) < hi) store_codes(q, wh[u].dst, v[u], sc);
    }
  }
}

template <typename T, bool VEC>
const void* pick_mode(int mode) {
  if (mode == STATIC) return (const void*)quant_kernel<T, VEC, STATIC>;
  if (mode == PER_IMAGE_GRID)
    return (const void*)quant_kernel<T, VEC, PER_IMAGE_GRID>;
  return (const void*)quant_kernel<T, VEC, PER_IMAGE_BLOCK>;
}

// The kernel for (dtype, vec, mode): dtype 0 = float32, 1 = bfloat16.
const void* pick(int dtype, int vec, int mode) {
  if (mode < 0 || mode > 2 || dtype < 0 || dtype > 1) return nullptr;
  if (dtype == 1)
    return vec ? pick_mode<__nv_bfloat16, true>(mode)
               : pick_mode<__nv_bfloat16, false>(mode);
  return vec ? pick_mode<float, true>(mode) : pick_mode<float, false>(mode);
}

}  // namespace

// For the (dtype, vec) kernels on the current device, at BLOCKS_PER_SM
// blocks on each SM: the bytes of x a block may keep in shared memory
// (*stash_bytes, a multiple of 1 KB) and how many blocks of the
// cooperative per-image kernel with that stash the device holds at once
// (*capacity). Raises the per-image kernels' dynamic shared-memory limit
// to the most a block may have. 0 or a CUDA error code.
extern "C" int councilx_quant_act_plan(int dtype, int vec, int* stash_bytes,
                                       int* capacity) {
  const void* fns[2] = {pick(dtype, vec, PER_IMAGE_GRID),
                        pick(dtype, vec, PER_IMAGE_BLOCK)};
  if (fns[0] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int sm_smem = 0, optin = 0, reserved = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes fa;
  cudaError_t err = device_attribute(
      cudaDevAttrMaxSharedMemoryPerMultiprocessor, &sm_smem);
  if (err == cudaSuccess)
    err = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (err == cudaSuccess)
    err = device_attribute(cudaDevAttrReservedSharedMemoryPerBlock,
                           &reserved);
  if (err == cudaSuccess)
    err = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fns[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  // both per-image modes declare the same static shared memory
  const int fixed = static_cast<int>(fa.sharedSizeBytes);
  for (const void* fn : fns) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin - fixed);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int budget = sm_smem / BLOCKS_PER_SM - reserved - fixed;
  budget = (budget < optin - fixed ? budget : optin - fixed) / 1024 * 1024;
  if (budget < 0) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[0],
                                                      THREADS, budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  *stash_bytes = budget;
  *capacity = per_sm * sms;
  return 0;
}

// x (B, H, W, C) -> q (B, H+2pad, W+2pad, Cq) int8 and a_s_out: static
// (per_image 0) with scale_in one f32 a_scale and a_s_out one value; per
// image (per_image 1) with a_s_out B values and, when splits > 1, part
// (B, splits) f32 scratch. pad_type 0 zero, 1 reflect, 2 replicate; dtype
// 0 f32, 1 bf16; vec 1 where C % 16 == 0 and x is 16-byte aligned; Cq a
// multiple of 16, at least C. Grid B * splits blocks, each over
// items_per_split items (a multiple of 256) of 16 channels of a padded
// pixel; per image with splits > 1 it is one cooperative launch, which the
// device must hold at once (councilx_quant_act_plan's capacity), with
// stash_iters * 256 items of dynamic shared memory per block. On `stream`;
// does not synchronise; returns the launch's error code (0 on success).
extern "C" int councilx_quant_act(const void* x, int8_t* q,
                                  const float* scale_in, float* a_s_out,
                                  float* part, int per_image, int B, int H,
                                  int W, int C, int Cq, int pad,
                                  int pad_type, int dtype, int vec,
                                  int splits, int items_per_split,
                                  int stash_iters, void* stream) {
  const int mode = !per_image ? STATIC
                   : splits > 1 ? PER_IMAGE_GRID : PER_IMAGE_BLOCK;
  const void* fn = pick(dtype, vec, mode);
  const long long items =
      static_cast<long long>(H + 2 * pad) * (W + 2 * pad) * (Cq / GROUP);
  if (fn == nullptr || B < 1 || H < 1 || W < 1 || C < 1 || Cq < C ||
      Cq % GROUP || pad < 0 || pad_type < 0 || pad_type > 2 ||
      (pad_type == 1 && (pad >= H || pad >= W)) || splits < 1 ||
      items_per_split < THREADS || items_per_split % THREADS ||
      static_cast<long long>(splits) * items_per_split < items ||
      items > 0x7fffffffLL || stash_iters < 0 ||
      (mode == STATIC && stash_iters != 0) ||
      (mode == PER_IMAGE_GRID && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stash_iters) * THREADS * GROUP *
                      (dtype == 1 ? 2 : 4);
  void* args[] = {(void*)&x,     &q,          (void*)&scale_in, &a_s_out,
                  &part,         &H,          &W,               &C,
                  &Cq,           &pad,        &pad_type,        &splits,
                  &items_per_split, &stash_iters};
  const long long blocks = static_cast<long long>(B) * splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == PER_IMAGE_GRID)
    return static_cast<int>(cudaLaunchCooperativeKernel(
        fn, grid, dim3(THREADS), args, smem, st));
  return static_cast<int>(
      cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, st));
}
