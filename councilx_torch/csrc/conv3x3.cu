// 3x3 stride-1 convolution of an NHWC input with an implicit zero pad, for
// Hopper: the resblock conv's forward and its dgrad.
//
// Replaces councilx/ops/pallas_conv.py::_conv_kernel_rows (the forward of
// conv3x3_valid) and its use as the dgrad in _bwd_rule. Both calls take the
// forward's weight wf (3, 3, O, C): per tap, one row of input channels per
// output channel. With x (B, Hin, Win, Cx) NHWC contiguous and zero
// outside it, tap t = 3 dy + dx and y (B, Ho, Wo, N), Ho = Hin + 2*pad - 2:
//   forward (dgrad 0): x = the reflect-padded input xp (B, H+2, W+2, C),
//     pad 0, Cx = C, N = O:
//       y[b,i,j,n] = sum_{t,c} x[b, i+dy, j+dx, c] * wf[t, n, c];
//     or x = the unpadded input (B, H, W, C) at pad 1: the zero-padded
//     "same" conv, the interior of ops/pad_conv.py's strips engine
//     (councilx/ops/pad_conv.py:187, an XLA conv there);
//   dgrad (dgrad 1): x = the cotangent g (B, H, W, O), pad 2, Cx = O,
//     N = C, and wf read with flipped taps and transposed, which is the
//     flipped, in/out-swapped weight of _bwd_rule:
//       y[b,i,j,n] = sum_{t,o} x[b, i+dy-2, j+dx-2, o] * wf[8-t, o, n],
//     d(xp) (B, H+2, W+2, C). Neither the zero pad of _bwd_rule
//     (pallas_conv.py:277-279) nor the flipped weight is ever materialised.
//     The dgrad of the pad-1 forward is the same call at pad 1: d(x)
//     (B, H, W, C).
// Sums in f32, one cast to the input type at the end. The caller does the
// reflect pad and the bias, as ops/conv3x3.py does.
//
// What bounds it on the H100: at the main path's shapes (M = B*64*64 =
// 32768 output pixels, or 34848 for the dgrad; N = 256; K = 9*256 = 2304)
// it is an implicit GEMM of 38.65 GFLOP against ~36 MB of bf16 traffic,
// ~1080 FLOP per byte, far above the card's ~295 FLOP/byte ridge: it is
// bound by the tensor cores (0.039 ms at 989 TFLOP/s).
//
// Design (bf16). The TPU kernel built a (rows*W, 9C) im2col matrix in
// VMEM; shared memory is far too small for that, so each K step loads one
// tap's shifted window instead:
//   * A, TMA im2col mode: one cp.async.bulk.tensor ... .im2col load brings
//     128 output pixels x 64 channels of tap (dy, dx). The tensor map's
//     bounding box is the range of window corners ([-pad, Win-3+pad] in W,
//     likewise in H), the load walks the 128 pixels over (W, H, B) from the
//     tile's first output pixel, and the tap enters as the im2col offset
//     (dx, dy). Coordinates outside x zero-fill: that is the dgrad's pad,
//     the M edge of the last tile and channels past a ragged Cx. Chosen over
//     a tiled 4-D box (64 ch, W, H, 1): a 2 x 64 box is exact for the
//     64-wide forward, but on the 66-wide dgrad output 2 x 64 boxes waste
//     48% of each tile and 8 x 16 boxes 24%; im2col wastes nothing but the
//     M edge of the last tile.
//   * B, TMA tiled mode, from wf (9, O, C) in both calls. The forward reads
//     a (64 ch, 256 outputs, 1 tap) box: K-major, 256 rows of 128 bytes.
//     The dgrad's K is wf's O axis and its N the C axis, which is the
//     contiguous one: it reads four (64 outputs, 64 ch, 1 tap) boxes,
//     MN-major, each 64 rows of 128 bytes, and wgmma takes B transposed.
//     So the dgrad needs no relayout of the weight.
//   * Every box lands with the 128-byte swizzle (a 64-wide bf16 row is 128
//     bytes), which is the wgmma descriptor's SWIZZLE_128B layout.
//   * A ring of STAGES stages, each with a "full" mbarrier (TMA bytes
//     arrived) and an "empty" one (both consumer warpgroups done reading).
//     One producer warp issues the loads; two consumer warpgroups each run
//     wgmma.mma_async m64n256k16 on their 64 pixel rows, 128 f32
//     accumulators per thread, one wgmma group kept in flight.
//   * Epilogue: one cast to bf16, stmatrix into a swizzled shared tile (the
//     ring, free once both warpgroups finish), then a TMA store, which
//     clips the M and N edges. No scalar stores.
//   * Tile 128 x 256 (all 256 output channels of the resblock conv, so each
//     A window is loaded once), BK = 64, K = 9 * ceil(Cx/64) steps (36 at
//     Cx = 256), 4 stages of 48 KB, one block per SM, no persistent
//     schedule. In a one-off comparison on the H100 it beat 128 x 128
//     tiles with 3 or 4 stages at one or two blocks per SM, and 128 x 256
//     with 3 stages, for the forward and the dgrad. Wave quantization on
//     132 SMs: the forward's 256 blocks are 1.94 waves; the dgrad's
//     M = 34848 gives 273 blocks, 2.07 waves, so its third wave runs 9
//     blocks, and it takes ~1.46x the forward's time for 1.06x the work.
//   * The tensor maps are encoded on the host at every call (three encodes)
//     and passed as __grid_constant__ parameters. libcuda's encode
//     functions come from the runtime's entry-point lookup, so the library
//     needs no link to libcuda. The TMA, mbarrier, wgmma and stmatrix
//     helpers are hopper.cuh's, shared with conv3x3_wgrad.cu.
//
// f32 (parity mode) uses a plain shared-memory tiled FMA kernel with the
// same indexing and bounds-checked loads: it exists for exactness, not
// speed.
//
// Gate (checked by the Python wrapper, which raises on anything else):
// C % 8 == 0 and O % 8 == 0 (TMA strides are multiples of 16 bytes),
// pad in {0, 1, 2}; ragged C, O and M are zero-filled and clipped here.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;            // output pixels per block
constexpr int BN = 256;            // output channels per block
constexpr int BK = 64;             // channels per K step: one 128-byte row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;       // warpgroups, 64 pixel rows each
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int B_ATOM = 64 * BK * 2;  // the dgrad's B: one 64 x 64 box
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment
constexpr int EPI_BYTES = 64 * BN * 2;    // one warpgroup's output tile
static_assert(CONSUMERS * EPI_BYTES <= STAGES * STAGE_BYTES,
              "the epilogue tiles reuse the ring");

// xmap: im2col map of x (Cx, Win, Hin, B); wmap: tiled map of wf, as
// (Cx, N, 9) for the forward and as (N, Cx, 9) for the dgrad; ymap: tiled
// map of y as (N, M). cch = ceil(Cx / 64).
template <int DGRAD>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap ymap, int M, int Ho,
                    int Wo, int N, int pad, int cch) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to that
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int KT = 9 * cch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], CONSUMERS * 4);   // lane 0 of each warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const int hw = Ho * Wo;
      const int b = m0 / hw;
      const int rem = m0 - b * hw;
      const int i = rem / Wo;
      const int j = rem - i * Wo;
      for (int ks = 0; ks < KT; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(&empty_bar[s], ((ks / STAGES) - 1) & 1);
        uint8_t* a = smem + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full_bar[s], STAGE_BYTES);
        const int tap = ks / cch;
        const int c0 = (ks - tap * cch) * BK;
        tma_load_im2col(a, &xmap, &full_bar[s], c0, j - pad, i - pad, b,
                        static_cast<uint16_t>(tap % 3),
                        static_cast<uint16_t>(tap / 3));
        if (DGRAD) {
          // four MN-major 64 x 64 boxes of the flipped tap, B_ATOM apart
          for (int nb = 0; nb < BN / 64; ++nb)
            tma_load_3d(a + A_BYTES + nb * B_ATOM, &wmap, &full_bar[s],
                        n0 + nb * 64, c0, 8 - tap);
        } else {
          tma_load_3d(a + A_BYTES, &wmap, &full_bar[s], c0, n0, tap);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int ks = 0; ks < KT; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full_bar[s], (ks / STAGES) & 1);
    const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + wg * (64 * 128);
    const uint32_t bt = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16<0, DGRAD>(
          acc, sw128_desc(a + kk * 32),
          DGRAD ? sw128_desc(bt + kk * 2048, B_ATOM)
                : sw128_desc(bt + kk * 32));
    wgmma_commit();
    fence_acc(acc);
    // the previous step's group is done: release its stage
    wgmma_wait<1>();
    fence_acc(acc);
    if (ks > 0 && lane == 0) mbar_arrive(&empty_bar[(ks - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: every consumer is past its last wgmma and every load has
  // landed, so the ring is free for the two output tiles
  fence_proxy_async();
  named_barrier(1, CONSUMERS * 128);
  uint8_t* out = smem + wg * EPI_BYTES;     // BN/64 slabs of 64 x 64, 8 KB
  stage_tile_bf16(acc, smem_u32(out), warp % 4, lane);
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if (threadIdx.x % 128 == 0 && m0 + wg * 64 < M) {
#pragma unroll
    for (int slab = 0; slab < BN / 64; ++slab)
      if (n0 + slab * 64 < N)
        tma_store_2d(&ymap, out + slab * 8192, n0 + slab * 64, m0 + wg * 64);
    tma_store_drain();
  }
}

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;
constexpr int FTHREADS = 256;

// x (B, Hin, Win, C), y (B, Ho, Wo, O); w as councilx_conv3x3 takes it.
__global__ void __launch_bounds__(FTHREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int B, int Hin, int Win, int C,
                   int O, int pad, int dgrad) {
  __shared__ float As[FBK][FBM + 4];
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int Ho = Hin + 2 * pad - 2;
  const int Wo = Win + 2 * pad - 2;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const int K = 9 * C;
  const long long m0 = static_cast<long long>(blockIdx.x) * FBM;
  const int n0 = blockIdx.y * FBN;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int id = tid + e * FTHREADS;
      const int row = id / FBK;
      const int kk = id % FBK;
      const long long m = m0 + row;
      const int k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < K) {
        const long long b = m / (static_cast<long long>(Ho) * Wo);
        const long long rem = m - b * Ho * Wo;
        const int i = static_cast<int>(rem / Wo);
        const int j = static_cast<int>(rem - static_cast<long long>(i) * Wo);
        const int tap = k / C;
        const int c = k - tap * C;
        const int ih = i + tap / 3 - pad;
        const int iw = j + tap % 3 - pad;
        if (ih >= 0 && ih < Hin && iw >= 0 && iw < Win)
          v = x[((b * Hin + ih) * Win + iw) * C + c];
      }
      As[kk][row] = v;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // consecutive threads read consecutive k of one output channel
      // (contiguous in the forward's weight; the dgrad's reads stride)
      const int id = tid + e * FTHREADS;
      const int kk = id % FBK;
      const int col = id / FBK;
      const int k = k0 + kk;
      const int n = n0 + col;
      float v = 0.0f;
      if (k < K && n < O) {
        const int tap = k / C;
        const int c = k - tap * C;
        v = dgrad ? w[(static_cast<long long>(8 - tap) * C + c) * O + n]
                  : w[(static_cast<long long>(tap) * O + n) * C + c];
      }
      Bs[kk][col] = v;
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

struct Maps {
  CUtensorMap x, w, y;
};

// Encode the three tensor maps of one bf16 call; 0 or a CUDA error code.
int encode_maps(Maps* maps, const void* x, const void* w, void* y, int B,
                int Hin, int Win, int C, int O, int pad, int dgrad) {
  const int Ho = Hin + 2 * pad - 2;
  const int Wo = Win + 2 * pad - 2;
  // window corners run over [-pad, dim - 3 + pad]: Wo (Ho) of them
  int err = encode_im2col_bf16(&maps->x, x, B, Hin, Win, C, pad, BM);
  if (err != 0) return err;

  // the forward reads w (9, O, C) in (64 ch, BN outputs) boxes, the dgrad
  // w (9, C, O) in (64 outputs, 64 ch) boxes
  const cuuint64_t c2 = static_cast<cuuint64_t>(C) * 2;
  const cuuint64_t o2 = static_cast<cuuint64_t>(O) * 2;
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(dgrad ? O : C),
                              static_cast<cuuint64_t>(dgrad ? C : O), 9};
  const cuuint64_t wstride[2] = {dgrad ? o2 : c2, c2 * O};
  const cuuint32_t wbox[3] = {dgrad ? 64u : static_cast<cuuint32_t>(BK),
                              dgrad ? static_cast<cuuint32_t>(BK)
                                    : static_cast<cuuint32_t>(BN), 1};
  err = encode_tiled_bf16(&maps->w, w, 3, wdim, wstride, wbox,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (err != 0) return err;

  const cuuint64_t ydim[2] = {static_cast<cuuint64_t>(O),
                              static_cast<cuuint64_t>(B) * Ho * Wo};
  const cuuint64_t ystride[1] = {o2};
  const cuuint32_t ybox[2] = {64, 64};
  return encode_tiled_bf16(&maps->y, y, 2, ydim, ystride, ybox,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
}

// Before the first encode in each thread, and again after a change of
// device: raise the bf16 kernels' shared-memory limit, a runtime call that
// also makes the device's context current in a thread that has made no
// runtime call yet (autograd's backward worker), which libcuda's encode
// functions need. 0 or a CUDA error code.
int prepare_thread() {
  static thread_local int ready_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != ready_device) {
    err = cudaFuncSetAttribute(conv3x3_bf16_kernel<0>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(conv3x3_bf16_kernel<1>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err == cudaSuccess) ready_device = dev;
  }
  return static_cast<int>(err);
}

}  // namespace

// x (B, Hin, Win, C) NHWC, y (B, Ho, Wo, O) with Ho = Hin + 2*pad - 2, and
// w the weight of the forward conv: (3, 3, O, C), read as w[t][o][c], with
// dgrad 0; (3, 3, C, O), read as w[8-t][c][o], with dgrad 1. dtype:
// 0 = float32, 1 = bfloat16. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (or the error that kept
// it from launching).
extern "C" int councilx_conv3x3(const void* x, const void* w, void* y, int B,
                                int Hin, int Win, int C, int O, int pad,
                                int dgrad, int dtype, void* stream) {
  const int Ho = Hin + 2 * pad - 2;
  const int Wo = Win + 2 * pad - 2;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    int err = prepare_thread();
    if (err != 0) return err;
    Maps maps;
    err = encode_maps(&maps, x, w, y, B, Hin, Win, C, O, pad, dgrad);
    if (err != 0) return err;
    dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (O + BN - 1) / BN);
    const int cch = (C + BK - 1) / BK;
    if (dgrad)
      conv3x3_bf16_kernel<1><<<grid, THREADS, SMEM_BYTES, s>>>(
          maps.x, maps.w, maps.y, static_cast<int>(M), Ho, Wo, O, pad, cch);
    else
      conv3x3_bf16_kernel<0><<<grid, THREADS, SMEM_BYTES, s>>>(
          maps.x, maps.w, maps.y, static_cast<int>(M), Ho, Wo, O, pad, cch);
  } else if (dtype == 0) {
    dim3 grid(static_cast<unsigned>((M + FBM - 1) / FBM), (O + FBN - 1) / FBN);
    conv3x3_f32_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), B, Hin, Win, C, O, pad, dgrad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
