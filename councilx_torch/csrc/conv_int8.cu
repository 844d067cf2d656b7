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
// Design: csrc/conv3x3.cu's TMA + wgmma pipeline in int8. The implicit
// GEMM is M = B Ho Wo output pixels by N = O channels by K = kh kw C; both
// operands are K-contiguous, so both are K-major in shared memory (s8
// wgmma takes no transpose).
//   * A, TMA im2col mode: one load brings 128 output pixels x BK channels
//     (BK bytes) of one tap. The map's bounding box is the range of window
//     corners, [0, Wp - kw] in W and [0, Hp - kh] in H (pad 0: Q2 padded
//     x), walked with a traversal stride of s in W and H, so the stride-2
//     downsamples load through the same path; the tap (t, r) enters as the
//     im2col offset. Pixels past the last image and channels past C
//     zero-fill.
//   * B, TMA tiled mode, from w viewed as (C, kh kw, O): a (BK, 1, BN) box
//     of one tap, K-major, BN rows of BK bytes; channels past C and rows
//     past O zero-fill, so no K step reads into the next tap.
//   * BK = 128 bytes (the 128-byte swizzle) where C is a multiple of 128,
//     else 64 bytes (the 64-byte swizzle: down 1, C = 64); smaller or
//     ragged C run whole BK steps over the zero fill. K steps: kh kw
//     ceil(C / BK), 18 at the resblock site.
//   * wgmma.mma_async m64nBNk32 s32.s8.s8, BK / 32 per K step: two
//     consumer warpgroups of 64 pixel rows each (a 128 x BN tile), one
//     producer warp issuing the TMA loads, a ring of stages with full and
//     empty mbarriers, one wgmma group in flight.
//   * Persistent: as many blocks as the card holds (one per SM at BN =
//     256, two at BN = 128), each walking tiles k, k + grid, ... with one
//     K-step count over all of them, so the producer loads the next tile
//     while the consumers run this one's epilogue, and the bf16 stores of
//     a tile drain while the next one computes (each warpgroup has its own
//     output tile in shared memory beside the ring). The wrapper picks BN
//     (ops/quant.py::_conv_tiles).
//   * Epilogue: the rescale of every accumulator in the order above
//     (__int2float_rn, __fmul_rn by __fmul_rn(a_s, w_s), __fadd_rn of the
//     bias), a_s taken per row from the row's image (a tile may straddle
//     two). bf16 goes through stmatrix into the warpgroup's output tile
//     and a TMA store that clips the M and N edges (hopper.cuh's K1
//     epilogue); f32 and the int32 accumulator are stored from registers,
//     8 bytes a thread.
//   * The three tensor maps are encoded on the host at every call and
//     passed as __grid_constant__ parameters, as K1 does.
//
// Gate (the Python wrapper raises on anything else): C a multiple of 16,
// O of 8, kh, kw, s in [1, 8], Ho = (Hp - kh) / s + 1 and Wo likewise,
// every pointer 16-byte aligned.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;            // output pixels per block
constexpr int CONSUMERS = 2;       // warpgroups, 64 pixel rows each
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp

// BN = 256: one block per SM; BN = 128: two (so one block's epilogue runs
// beside the other's main loop). Each block's shared memory is a ring of
// STAGES (A, B) stages and its two warpgroups' bf16 output tiles, ~208 KB
// per SM in all.
template <int BK, int BN>
struct Tile {
  static constexpr int BLOCKS_PER_SM = BN == 256 ? 1 : 2;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int EPI_BYTES = 64 * BN * 2;  // a warpgroup's bf16 tile
  static constexpr int RING_BYTES =
      208 * 1024 / BLOCKS_PER_SM - CONSUMERS * EPI_BYTES;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES =
      RING + CONSUMERS * EPI_BYTES + 1024;  // + alignment
  static_assert(STAGES >= 2, "a ring of two stages at least");
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k32_s8(d, da, db);
  else
    wgmma_m64n128k32_s8(d, da, db);
}

// xmap: im2col map of x (C, Wp, Hp, B); wmap: tiled map of w as (C,
// taps, Op); ymap: tiled bf16 map of y as (Op, M), read only when out = 1.
// out: 0 f32, 1 bf16, 2 int32. cch = ceil(C / BK). Persistent: block k
// takes tiles k, k + gridDim.x, ... of the tiles_m x tiles_n tiles (N
// fastest), and one K-step counter runs over all of them, so the producer
// fills the ring for the next tile while the consumers run the epilogue.
template <int BK, int BN>
__global__ void __launch_bounds__(THREADS, Tile<BK, BN>::BLOCKS_PER_SM)
conv_int8_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap ymap,
                 const float* __restrict__ a_s, int a_per_image,
                 const float* __restrict__ w_s,
                 const float* __restrict__ bias, void* __restrict__ y,
                 int out, int M, int Ho, int Wo, int Op, int kw, int stride,
                 int taps, int cch, int tiles, int tiles_n) {
  using T = Tile<BK, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[T::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[T::STAGES];
  __shared__ float s_ws[2][BN];      // by the parity of the block's tile
  __shared__ float s_bias[2][BN];
  // the swizzle repeats every 1024 (128-byte) or 512 bytes: align to 1024
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hw = Ho * Wo;
  const int KT = taps * cch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], CONSUMERS * 4);   // lane 0 of each warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one thread keeps the ring full, across tiles
    if (lane == 0) {
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM;
        const int n0 = (tile % tiles_n) * BN;
        const int b = m0 / hw;
        const int rem = m0 - b * hw;
        const int i = rem / Wo;
        const int j = rem - i * Wo;
        for (int ks = 0; ks < KT; ++ks, ++g) {
          const int s = g % T::STAGES;
          if (g >= T::STAGES)
            mbar_wait(&empty_bar[s], ((g / T::STAGES) - 1) & 1);
          uint8_t* a = smem + s * T::STAGE_BYTES;
          mbar_arrive_expect_tx(&full_bar[s], T::STAGE_BYTES);
          const int tap = ks / cch;
          const int c0 = (ks - tap * cch) * BK;
          const int r = tap / kw;
          tma_load_im2col(a, &xmap, &full_bar[s], c0, j * stride,
                          i * stride, b, static_cast<uint16_t>(tap - r * kw),
                          static_cast<uint16_t>(r));
          tma_load_3d(a + T::A_BYTES, &wmap, &full_bar[s], c0, tap, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of each
  // tile, and its own bf16 output tile in shared memory
  const int tid = threadIdx.x;
  const int wg = warp / 4;
  uint8_t* outp = smem + T::RING + wg * T::EPI_BYTES;
  const uint32_t out_u32 = smem_u32(outp);
  // this thread's rows (the m64nN fragment: lane / 4 and lane / 4 + 8 of
  // its warp's 16) and columns (8 j + 2 (lane % 4) + {0, 1})
  const int wrow = (warp % 4) * 16 + lane / 4;
  const int cbase = 2 * (lane % 4);
  const int q = lane / 8;
  const int srow = (warp % 4) * 16 + (q & 1) * 8 + lane % 8;
  const bool has_bias = bias != nullptr;
  int g = 0;
  int local = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
    const int m0 = (tile / tiles_n) * BM;
    const int n0 = (tile % tiles_n) * BN;
    const int buf = local & 1;
    // the tile's scales and biases: read after the barrier below; the
    // buffer of this parity was last read two tiles ago, before both
    // warpgroups passed the previous tile's barrier
    if (out != 2) {
      for (int n = tid; n < BN; n += CONSUMERS * 128) {
        const bool ok = n0 + n < Op;
        s_ws[buf][n] = ok ? w_s[n0 + n] : 0.0f;
        s_bias[buf][n] = ok && has_bias ? bias[n0 + n] : 0.0f;
      }
    }
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    for (int ks = 0; ks < KT; ++ks, ++g) {
      const int s = g % T::STAGES;
      mbar_wait(&full_bar[s], (g / T::STAGES) & 1);
      const uint32_t a =
          smem_u32(smem + s * T::STAGE_BYTES) + wg * (64 * BK);
      const uint32_t bt = smem_u32(smem + s * T::STAGE_BYTES + T::A_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, kmajor_desc<BK>(a + kk * 32),
                     kmajor_desc<BK>(bt + kk * 32));
      wgmma_commit();
      fence_acc(acc);
      // the previous step's group is done: release its stage
      wgmma_wait<1>();
      fence_acc(acc);
      if (ks > 0 && lane == 0)
        mbar_arrive(&empty_bar[(g - 1) % T::STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty_bar[(g - 1) % T::STAGES]);
    named_barrier(1, CONSUMERS * 128);   // the tile's scales are in

    const int m_lo = m0 + wg * 64 + wrow;
    const int m_hi = m_lo + 8;
    if (out == 2) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + cbase;
        if (n >= Op) continue;
        int* yi = static_cast<int*>(y);
        if (m_lo < M)
          *reinterpret_cast<int2*>(yi + static_cast<size_t>(m_lo) * Op + n) =
              make_int2(acc[4 * j], acc[4 * j + 1]);
        if (m_hi < M)
          *reinterpret_cast<int2*>(yi + static_cast<size_t>(m_hi) * Op + n) =
              make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      continue;
    }

    const float as_lo = m_lo < M ? a_s[a_per_image ? m_lo / hw : 0] : 0.0f;
    const float as_hi = m_hi < M ? a_s[a_per_image ? m_hi / hw : 0] : 0.0f;
    const float* ws = s_ws[buf];
    const float* bs = s_bias[buf];
    // acc * (a_s * w_s) [+ bias] in f32, the plain version's order
    auto rescale = [&](int v, float as, int col) {
      const float r = __fmul_rn(__int2float_rn(v), __fmul_rn(as, ws[col]));
      return has_bias ? __fadd_rn(r, bs[col]) : r;
    };

    if (out == 0) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + cbase;
        if (n0 + col >= Op) continue;
        float* yf = static_cast<float*>(y) + n0 + col;
        if (m_lo < M)
          *reinterpret_cast<float2*>(yf + static_cast<size_t>(m_lo) * Op) =
              make_float2(rescale(acc[4 * j], as_lo, col),
                          rescale(acc[4 * j + 1], as_lo, col + 1));
        if (m_hi < M)
          *reinterpret_cast<float2*>(yf + static_cast<size_t>(m_hi) * Op) =
              make_float2(rescale(acc[4 * j + 2], as_hi, col),
                          rescale(acc[4 * j + 3], as_hi, col + 1));
      }
      continue;
    }

    // bf16: 8-column chunks 2 jp and 2 jp + 1 through one stmatrix.x4 into
    // BN / 64 swizzled 64 x 64 slabs of 8 KB (as hopper::stage_tile_bf16),
    // then one TMA store per slab, left in flight until the warpgroup's
    // next tile needs the buffer
    if (tid % 128 == 0) tma_store_wait_read();
    named_barrier(2 + wg, 128);
#pragma unroll
    for (int jp = 0; jp < BN / 16; ++jp) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = 16 * jp + 8 * (e >> 2) + cbase + (e & 1);
        v[e] = rescale(acc[8 * jp + e], (e >> 1) & 1 ? as_hi : as_lo, col);
      }
      const int chunk = 2 * jp + (q >> 1);
      const uint32_t addr = out_u32 + (chunk / 8) * 8192 + srow * 128 +
                            (((chunk % 8) ^ (srow % 8)) * 16);
      stmatrix_x4(addr, pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                  pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (tid % 128 == 0 && m0 + wg * 64 < M) {
#pragma unroll
      for (int slab = 0; slab < BN / 64; ++slab)
        if (n0 + slab * 64 < Op)
          tma_store_2d(&ymap, outp + slab * 8192, n0 + slab * 64,
                       m0 + wg * 64);
      tma_store_commit();
    }
  }
  // the last stores must have read the output tiles before the block ends
  if (out == 1 && tid % 128 == 0) tma_store_drain();
}

struct Maps {
  CUtensorMap x, w, y;
};

// Before the first launch of a kernel in each thread, and again after a
// change of device: raise its shared-memory limit, a runtime call that
// also makes the device's context current in a thread that has made no
// runtime call yet, which libcuda's encode functions need. 0 or a CUDA
// error code.
// *sms: the device's SM count. 0 or a CUDA error code.
template <int BK, int BN>
int prepare_thread(int* sms) {
  static thread_local int ready_device = -1;
  static thread_local int ready_sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != ready_device) {
    err = cudaFuncSetAttribute(conv_int8_kernel<BK, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<BK, BN>::SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&ready_sms,
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) ready_device = dev;
  }
  *sms = ready_sms;
  return static_cast<int>(err);
}

// Encode the three tensor maps of one call (y's only for bf16); 0 or a
// CUDA error code.
int encode_maps(Maps* maps, const void* x, const void* w, void* y, int B,
                int Hp, int Wp, int C, int O, int kh, int kw, int stride,
                int M, int bk, int bn, int out) {
  int err = encode_im2col_s8(&maps->x, x, B, Hp, Wp, C, kh, kw, stride, bk,
                             BM);
  if (err != 0) return err;
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(kh) * kw,
                              static_cast<cuuint64_t>(O)};
  const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(C),
                                 static_cast<cuuint64_t>(C) * kh * kw};
  const cuuint32_t wbox[3] = {static_cast<cuuint32_t>(bk), 1,
                              static_cast<cuuint32_t>(bn)};
  err = encode_tiled_s8(&maps->w, w, 3, wdim, wstride, wbox);
  if (err != 0 || out != 1) return err;
  const cuuint64_t ydim[2] = {static_cast<cuuint64_t>(O),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t ystride[1] = {static_cast<cuuint64_t>(O) * 2};
  const cuuint32_t ybox[2] = {64, 64};
  return encode_tiled_bf16(&maps->y, y, 2, ydim, ystride, ybox,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
}

template <int BK, int BN>
int launch(const void* x, const void* w, const float* a_s, int a_per_image,
           const float* w_s, const float* bias, void* y, int B, int Hp,
           int Wp, int C, int O, int kh, int kw, int stride, int Ho, int Wo,
           int M, int out, cudaStream_t st) {
  int sms = 0;
  int err = prepare_thread<BK, BN>(&sms);
  if (err != 0) return err;
  Maps maps = {};
  err = encode_maps(&maps, x, w, y, B, Hp, Wp, C, O, kh, kw, stride, M, BK,
                    BN, out);
  if (err != 0) return err;
  const int tiles_n = (O + BN - 1) / BN;
  const long long tiles =
      static_cast<long long>((M + BM - 1) / BM) * tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long resident =
      static_cast<long long>(sms) * Tile<BK, BN>::BLOCKS_PER_SM;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  conv_int8_kernel<BK, BN><<<grid, THREADS, Tile<BK, BN>::SMEM_BYTES, st>>>(
      maps.x, maps.w, maps.y, a_s, a_per_image, w_s, bias, y, out, M, Ho,
      Wo, O, kw, stride, kh * kw, (C + BK - 1) / BK,
      static_cast<int>(tiles), tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, Hp, Wp, C) int8, w (O, kh, kw, C) int8 -> y (B, Ho, Wo, O):
// out_dtype 0 f32, 1 bf16 (rescaled by a_s (B values if a_per_image, else
// one) and w_s (O), plus bias (O) unless null), 2 the int32 accumulator.
// bk: bytes of K per step, 128 or 64; bn: output channels per block, 256
// or 128. C a multiple of 16, O of 8, Ho = (Hp - kh) / stride + 1 and Wo
// likewise; every pointer 16-byte aligned. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (or the
// error that kept it from launching).
extern "C" int councilx_conv_int8(const void* x, const void* w,
                                  const float* a_s, int a_per_image,
                                  const float* w_s, const float* bias,
                                  void* y, int B, int Hp, int Wp, int C,
                                  int O, int kh, int kw, int stride, int Ho,
                                  int Wo, int bk, int bn, int out_dtype,
                                  void* stream) {
  if (B < 1 || C < 16 || C % 16 || O < 8 || O % 8 || kh < 1 || kh > 8 ||
      kw < 1 || kw > 8 || stride < 1 || stride > 8 || Hp < kh || Wp < kw ||
      Ho != (Hp - kh) / stride + 1 || Wo != (Wp - kw) / stride + 1 ||
      (bk != 128 && bk != 64) || (bn != 256 && bn != 128) || out_dtype < 0 ||
      out_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(B) * Ho * Wo;
  if (m > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(m);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk == 128 && bn == 256)
    return launch<128, 256>(x, w, a_s, a_per_image, w_s, bias, y, B, Hp, Wp,
                            C, O, kh, kw, stride, Ho, Wo, M, out_dtype, st);
  if (bk == 128)
    return launch<128, 128>(x, w, a_s, a_per_image, w_s, bias, y, B, Hp, Wp,
                            C, O, kh, kw, stride, Ho, Wo, M, out_dtype, st);
  if (bn == 256)
    return launch<64, 256>(x, w, a_s, a_per_image, w_s, bias, y, B, Hp, Wp,
                           C, O, kh, kw, stride, Ho, Wo, M, out_dtype, st);
  return launch<64, 128>(x, w, a_s, a_per_image, w_s, bias, y, B, Hp, Wp, C,
                         O, kh, kw, stride, Ho, Wo, M, out_dtype, st);
}
