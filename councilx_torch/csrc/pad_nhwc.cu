// The reflect and replicate pad of NHWC activations (P1) and its backward,
// the fold (P1'), for Hopper.
//
// Replaces no TPU kernel: the JAX package pads with jnp.pad
// (councilx/nn/blocks.py::pad2d), which XLA fuses into the reads of the op
// that follows. The port ran ATen's advanced-index gather there
// (x[:, ih, iw], now ops/pad.py::pad_reference) and, under autograd, its
// index_put_(accumulate=True) backward, which sorts the indices before a
// scatter-add. Every reflect or replicate pad of the port on a CUDA tensor
// of bf16 or f32 runs these two kernels instead (nn/blocks.py::pad2d).
//
//   P1:  x (B, H, W, C), any strides -> y (B, H + 2p, W + 2p, C),
//        contiguous: y[b, i, j] = x[b, src(i - p, H), src(j - p, W)] with
//          reflect    src(i, n) = -i for i < 0, 2 (n - 1) - i for i >= n
//                     (p < n: the edge is not repeated);
//          replicate  src(i, n) = clamp(i, 0, n - 1).
//   P1': dy (B, H + 2p, W + 2p, C), any strides -> dx (B, H, W, C),
//        contiguous: dx[b, h, w] = the sum of dy[b, i, j] over the padded
//        positions (i, j) whose source is (h, w), in f32 in a fixed order,
//        rounded once. Reflect gives a pixel at most 3 rows x 3 columns (2
//        x 2 where 2p + 1 < n), replicate a border pixel whole ranges, (p + 1)^2
//        at a corner. No atomics: bit-deterministic.
//
// What bounds them on the H100: memory. At the resblock site of serving's
// bucket 64, (64, 64, 64, 256) bf16 with p = 1, P1 reads 134 MB and writes
// 143 MB, 82.6 us at 3.35 TB/s; P1' moves the same bytes the other way.
//
// Design. Both move whole words: 16, 8, 4 or 2 bytes, the largest that
// divides a pixel's C x element size, every pointer and every stride
// (ops/pad.py::_word_bytes): 16 bytes wherever C is a multiple of 8 (bf16)
// or 4 (f32), narrower at the image's C = 3 and the council
// discriminator's C = 6. A row of the output (b, i) is given to 2^lg
// threads (256, or fewer where the row has fewer words, so that thin
// slices fill the block with several rows), in as many blocks as it takes
// for a launch of few rows to fill the card; neighbouring threads take
// neighbouring words, so every load of an interior span and every store is
// coalesced and each output word is written once. A row's source row (P1)
// or its row taps (P1') are worked out once; a thread's pixel and word
// advance by constant steps, with no division in the loop; UNROLL words
// are loaded before any is stored. P1' reads each word of dy once: a dx
// word starts from its first tap and adds the others of its row and column
// (none in the interior). Offsets into x and dy are 64-bit; rows, a row's
// words and the dimensions are int32 (ops/pad.py refuses more than 2^30).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "norm.cuh"

namespace {

using inorm::from_f32;
using inorm::to_f32;

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
// threads a launch should have at least, where its rows allow: an H100
// holds 132 x 2048 at once
constexpr int MIN_THREADS = 1 << 18;
constexpr int REFLECT = 1;           // ops/pad.py's _PAD_CODES
constexpr int REPLICATE = 2;

// Source index of padded index i in [-p, n + p).
__device__ __forceinline__ int source(int i, int n, int type) {
  if (i < 0) return type == REFLECT ? -i : 0;
  if (i >= n) return type == REFLECT ? 2 * (n - 1) - i : n - 1;
  return i;
}

// The padded indices, from 0 in [0, n + 2p), whose source is h: the range
// [lo, hi] and up to two more, a and b (-1: none). lo is the first.
struct Taps {
  int lo, hi, a, b;
};

__device__ __forceinline__ Taps taps(int h, int n, int p, int type) {
  Taps t{h + p, h + p, -1, -1};
  if (type == REFLECT) {
    if (h >= 1 && h <= p) t.a = p - h;                    // i = -h
    if (h <= n - 2 && h >= n - 1 - p) t.b = 2 * (n - 1) - h + p;
  } else {
    if (h == 0) t.lo = 0;                                 // i in [-p, 0]
    if (h == n - 1) t.hi = n - 1 + 2 * p;                 // [n-1, n-1+p]
  }
  return t;
}

template <typename F>
__device__ __forceinline__ void each_tap(const Taps& t, F f) {
  for (int i = t.lo; i <= t.hi; ++i) f(i);
  if (t.a >= 0) f(t.a);
  if (t.b >= 0) f(t.b);
}

// A thread's place in its row: word j of the row is pixel px, word cw of
// that pixel; step() moves it on by the row's threads in all blocks.
struct Cursor {
  int j, px, cw;
  __device__ __forceinline__ Cursor(int j0, int words) {
    j = j0;
    px = j0 / words;
    cw = j0 - px * words;
  }
  __device__ __forceinline__ void step(int by, int dpx, int dcw,
                                       int words) {
    j += by;
    px += dpx;
    cw += dcw;
    if (cw >= words) {
      cw -= words;
      ++px;
    }
  }
};

// P1. rows = B (H + 2p); `words` words a pixel; strides in words (sc in
// elements, 1 wherever a word holds more than one).
template <typename Word>
__global__ void __launch_bounds__(THREADS)
pad_nhwc_kernel(const Word* __restrict__ x, Word* __restrict__ y, int rows,
                int H, int W, int words, long long sb, long long sh,
                long long sw, long long sc, int p, int type, int lg) {
  const int tpr = 1 << lg;
  const int row = blockIdx.x * (THREADS >> lg) + (threadIdx.x >> lg);
  if (row >= rows) return;
  const int Hp = H + 2 * p;
  const int n = (W + 2 * p) * words;
  const int b = row / Hp;
  const Word* src = x + b * sb + source(row - b * Hp - p, H, type) * sh;
  Word* dst = y + static_cast<long long>(row) * n;
  const int step = tpr * gridDim.y;
  const int dpx = step / words, dcw = step - dpx * words;
  Cursor at(blockIdx.y * tpr + (threadIdx.x & (tpr - 1)), words);
  while (at.j < n) {
    Word v[UNROLL];
    int j[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      j[u] = at.j;
      if (at.j < n) v[u] = src[source(at.px - p, W, type) * sw + at.cw * sc];
      at.step(step, dpx, dcw, words);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (j[u] < n) dst[j[u]] = v[u];
  }
}

template <typename T, int VEC, typename Word>
__device__ __forceinline__ void unpack(const Word& w, float (&acc)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = to_f32(e[i]);
}

template <typename T, int VEC, typename Word>
__device__ __forceinline__ void accumulate(const Word& w, float (&acc)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += to_f32(e[i]);
}

template <typename T, int VEC, typename Word>
__device__ __forceinline__ Word pack(const float (&acc)[VEC]) {
  Word w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f32(e + i, acc[i]);
  return w;
}

// P1'. rows = B H; dy's strides in words (sc in elements, as P1's).
template <typename T, typename Word>
__global__ void __launch_bounds__(THREADS)
pad_fold_kernel(const Word* __restrict__ dy, Word* __restrict__ dx,
                int rows, int H, int W, int words, long long sb,
                long long sh, long long sw, long long sc, int p, int type,
                int lg) {
  constexpr int VEC = sizeof(Word) / sizeof(T);
  const int tpr = 1 << lg;
  const int row = blockIdx.x * (THREADS >> lg) + (threadIdx.x >> lg);
  if (row >= rows) return;
  const int n = W * words;
  const int b = row / H;
  const Taps rt = taps(row - b * H, H, p, type);
  const Word* src = dy + b * sb;
  Word* dst = dx + static_cast<long long>(row) * n;
  const int step = tpr * gridDim.y;
  const int dpx = step / words, dcw = step - dpx * words;
  Cursor at(blockIdx.y * tpr + (threadIdx.x & (tpr - 1)), words);
  while (at.j < n) {
    Word v[UNROLL];
    Taps ct[UNROLL];
    int j[UNROLL], cw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      j[u] = at.j;
      cw[u] = at.cw;
      if (at.j < n) {
        ct[u] = taps(at.px, W, p, type);
        v[u] = src[rt.lo * sh + ct[u].lo * sw + at.cw * sc];
      }
      at.step(step, dpx, dcw, words);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j[u] >= n) continue;
      float acc[VEC];
      unpack<T, VEC>(v[u], acc);
      const Taps c = ct[u];
      const long long off = cw[u] * sc;
      each_tap(rt, [&](int r) {
        each_tap(c, [&](int k) {
          if (r != rt.lo || k != c.lo)
            accumulate<T, VEC>(src[r * sh + k * sw + off], acc);
        });
      });
      dst[j[u]] = pack<T, VEC, Word>(acc);
    }
  }
}

// log2 of the threads a row takes: the least power of two from 32 to 256
// that covers its words.
int row_lg(int words) {
  int lg = 5;
  while (lg < 8 && (1 << lg) < words) ++lg;
  return lg;
}

// The grid: rows of 2^lg threads, THREADS / 2^lg of them a block, each row
// split over gridDim.y blocks where the rows alone make fewer than
// MIN_THREADS threads (a step of UNROLL words a thread at least).
dim3 grid_for(int rows, int row_words, int lg) {
  const int per_block = THREADS >> lg;
  const long long threads = static_cast<long long>(rows) << lg;
  const long long want = (MIN_THREADS + threads - 1) / threads;
  const long long most = (row_words + (UNROLL << lg) - 1) / (UNROLL << lg);
  long long splits = want < most ? want : most;
  splits = splits < 1 ? 1 : splits > 65535 ? 65535 : splits;
  return dim3((rows + per_block - 1) / per_block,
              static_cast<unsigned>(splits));
}

template <typename Word>
int launch_pad(const void* x, void* y, int B, int H, int W, int words,
               long long sb, long long sh, long long sw, long long sc,
               int p, int type, cudaStream_t stream) {
  const int rows = B * (H + 2 * p);
  const int row_words = (W + 2 * p) * words;
  const int lg = row_lg(row_words);
  pad_nhwc_kernel<Word><<<grid_for(rows, row_words, lg), THREADS, 0,
                          stream>>>(
      static_cast<const Word*>(x), static_cast<Word*>(y), rows, H, W, words,
      sb, sh, sw, sc, p, type, lg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Word>
int launch_fold(const void* dy, void* dx, int B, int H, int W, int words,
                long long sb, long long sh, long long sw, long long sc,
                int p, int type, cudaStream_t stream) {
  const int rows = B * H;
  const int lg = row_lg(W * words);
  pad_fold_kernel<T, Word><<<grid_for(rows, W * words, lg), THREADS, 0,
                             stream>>>(
      static_cast<const Word*>(dy), static_cast<Word*>(dx), rows, H, W,
      words, sb, sh, sw, sc, p, type, lg);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int p, int type) {
  return p < 1 || (type != REFLECT && type != REPLICATE);
}

}  // namespace

// P1: x -> y (see the header). `words` words of word_bytes each make a
// pixel's C channels; sb, sh, sw are x's strides in words, sc its channel
// stride in elements. 0 or a CUDA error code.
extern "C" int councilx_pad_nhwc(const void* x, void* y, int B, int H, int W,
                                 int words, long long sb, long long sh,
                                 long long sw, long long sc, int p, int type,
                                 int word_bytes, cudaStream_t stream) {
  if (bad_args(p, type)) return static_cast<int>(cudaErrorInvalidValue);
  switch (word_bytes) {
    case 16:
      return launch_pad<uint4>(x, y, B, H, W, words, sb, sh, sw, sc, p,
                               type, stream);
    case 8:
      return launch_pad<uint2>(x, y, B, H, W, words, sb, sh, sw, sc, p,
                               type, stream);
    case 4:
      return launch_pad<uint32_t>(x, y, B, H, W, words, sb, sh, sw, sc, p,
                                  type, stream);
    case 2:
      return launch_pad<uint16_t>(x, y, B, H, W, words, sb, sh, sw, sc, p,
                                  type, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P1': dy -> dx, dtype 0 = float32, 1 = bfloat16; the other arguments as
// councilx_pad_nhwc's, with H and W those of dx and the strides dy's.
extern "C" int councilx_pad_nhwc_fold(const void* dy, void* dx, int B,
                                      int H, int W, int words, long long sb,
                                      long long sh, long long sw,
                                      long long sc, int p, int type,
                                      int dtype, int word_bytes,
                                      cudaStream_t stream) {
  if (bad_args(p, type)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (word_bytes) {
      case 16:
        return launch_fold<float, uint4>(dy, dx, B, H, W, words, sb, sh, sw,
                                         sc, p, type, stream);
      case 8:
        return launch_fold<float, uint2>(dy, dx, B, H, W, words, sb, sh, sw,
                                         sc, p, type, stream);
      case 4:
        return launch_fold<float, uint32_t>(dy, dx, B, H, W, words, sb, sh,
                                            sw, sc, p, type, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (word_bytes) {
      case 16:
        return launch_fold<__nv_bfloat16, uint4>(dy, dx, B, H, W, words, sb,
                                                 sh, sw, sc, p, type, stream);
      case 8:
        return launch_fold<__nv_bfloat16, uint2>(dy, dx, B, H, W, words, sb,
                                                 sh, sw, sc, p, type, stream);
      case 4:
        return launch_fold<__nv_bfloat16, uint32_t>(dy, dx, B, H, W, words,
                                                    sb, sh, sw, sc, p, type,
                                                    stream);
      case 2:
        return launch_fold<__nv_bfloat16, uint16_t>(dy, dx, B, H, W, words,
                                                    sb, sh, sw, sc, p, type,
                                                    stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
