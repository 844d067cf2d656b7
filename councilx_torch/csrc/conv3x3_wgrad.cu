// Weight gradient of the VALID 3x3 stride-1 convolution, for Hopper.
//
// Replaces councilx/ops/pallas_conv.py::_wgrad_kernel (_conv3x3_wgrad,
// pallas_call at :213):
//   dk[dy,dx,c,o] = sum_{b,i,j} xp[b,i+dy,j+dx,c] * g[b,i,j,o]
// with xp (B, H+2, W+2, C) NHWC contiguous, g (B, H, W, O) contiguous and
// dk (3, 3, C, O) HWIO. Sums in f32; the result is written in the output
// type (the conv weight's) with one rounding at the end. With pad 1 the
// input is the unpadded x (B, H, W, C) of the zero-padded "same" conv
// (conv3x3.cu at pad 1), and xp is x zero-padded by 1, never materialised:
// the loads zero-fill the border.
//
// What bounds it on the H100: it is a GEMM dk_cat (9C, O) = A^T G over
// K' = B*H*W pixels, with A the im2col matrix (K', 9C) and G = g viewed as
// (K', O). At the training shape (K' = 32768, C = O = 256) that is 38.65
// GFLOP against ~36 MB of bf16 input, ~1000 FLOP per byte: bound by the
// tensor cores, 0.0391 ms at 989 TFLOP/s. Its output is small (2304 x 256),
// so K' has to be split over blocks to fill the card, and the splits' f32
// partials are traffic the bound does not count.
//
// Design (bf16): the forward's pipeline (conv3x3.cu) turned on its side.
//   * Tile 128 rows of dk_cat (one tap, 128 channels) x 256 outputs (all of
//     O at the resblock conv), so each A box is loaded once for every
//     output: 9 * ceil(C/128) * ceil(O/256) tiles, 18 at C = O = 256.
//   * A, TMA im2col mode, the forward's A box: one load brings 64 pixels
//     (one K' step) x 64 channels of tap (dy, dx) of xp, the tap entering
//     as the im2col offset, at pad 0 or 1 (the window corners start at
//     -pad, as conv3x3.cu's); pixels past the last image, the pad's border
//     and channels past C zero-fill. Two loads per step, one per consumer warpgroup's 64
//     channels. The channels are wgmma's M and the contiguous dimension, so
//     A is MN-major and wgmma takes it with its transpose bit.
//   * B, TMA tiled mode, g as 2-D (O, B*H*W): four 64 x 64 boxes per step,
//     MN-major (O is contiguous), as the dgrad's B in conv3x3.cu.
//   * A ring of 4 stages of 48 KB, each with a "full" mbarrier (TMA bytes
//     arrived) and an "empty" one; one producer warp issues the loads (one
//     division per step, by one thread); two consumer warpgroups run
//     wgmma.mma_async m64n256k16 on their 64 channels, 128 f32
//     accumulators per thread, one wgmma group in flight.
//   * K' split: S splits of whole 64-pixel steps, S = floor(132 SMs /
//     tiles) (ops/conv3x3.py::_wgrad_split). At the training shape: 18
//     tiles x S = 7 = 126 blocks, one wave at one block per SM, 74 steps
//     each. (S = 22 would fill three whole waves, but triple the partials.)
//   * The fixed-order sum is in the same launch. Each block writes its f32
//     partial (128 KB) with 16-byte stores in a layout that follows its
//     registers (float4 q of consumer thread t at [q][t], so a warp stores
//     512 contiguous bytes), then takes a ticket from its tile's int32
//     counter. The block that draws ticket S-1 resets the counter to 0 for
//     the next launch (the wrapper keeps the counters zeroed per device and
//     stream, so no memset launch), reads the S partials back through L2 in
//     the order s = 0..S-1 and sums them: two launches on the same inputs
//     are bit-equal, and nothing uses float atomics. S = 1 skips all this.
//     The partials are S x 2.36 MB written and read, 16.5 MB at S = 7,
//     within the 50 MB L2.
//   * Epilogue of the summing block: bf16 dk by stmatrix into the swizzled
//     ring (hopper.cuh, as the forward) and TMA stores of (64 outputs, 64
//     channels, 1 tap) boxes of dk viewed as (O, C, 9), which clip a ragged
//     C and O; f32 dk (bf16 inputs with an f32 weight) by 8-byte stores.
//
// f32 (parity mode) uses a plain shared-memory tiled FMA kernel with its
// own split and a second, fixed-order summing kernel: it exists for
// exactness, not speed.
//
// Gate (checked by the Python wrapper, which raises on anything else):
// C % 8 == 0, O % 8 == 0 (TMA strides are multiples of 16 bytes), H, W >=
// 1, B*H*W < 2^31, the pixels per split a multiple of the kernel's K' step,
// pad in {0, 1}.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;            // rows of dk_cat: one tap, 128 channels
constexpr int BN = 256;            // outputs per block
constexpr int BK = 64;             // pixels per K' step
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;       // warpgroups, 64 channels each
constexpr int CTHREADS = CONSUMERS * 128;
constexpr int THREADS = CTHREADS + 32;   // + one producer warp
constexpr int BOX_BYTES = BK * 128;      // 64 pixel rows of 64 bf16
constexpr int A_BYTES = CONSUMERS * BOX_BYTES;
constexpr int B_BYTES = (BN / 64) * BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment
constexpr int EPI_BYTES = 64 * BN * 2;   // one warpgroup's bf16 output tile
constexpr int ACC = BN / 2;              // f32 accumulators per thread
constexpr int CHUNKS = ACC / 4;          // the same as float4
static_assert(BM == CONSUMERS * 64, "one 64-channel A box per warpgroup");
static_assert(CONSUMERS * EPI_BYTES <= STAGES * STAGE_BYTES,
              "the epilogue tiles reuse the ring");

// xmap: im2col map of the input (C, W+2-2pad, H+2-2pad, B) at `pad`,
// 64-pixel boxes; gmap:
// tiled map of g as (O, P); kmap: tiled map of dk as (O, C, 9), for a bf16
// dk (dk32 null), else unused. Grid (9 * cblocks, ceil(O / BN), S): block
// (t, n, s) computes rows [128 (t % cblocks), +128) of tap t / cblocks and
// outputs [BN n, +BN) over pixels [s * pix_per_split, +pix_per_split).
// part holds S * tiles partial tiles, counters one int per tile.
__global__ void __launch_bounds__(THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap kmap,
                   float* __restrict__ part, int* __restrict__ counters,
                   float* __restrict__ dk32, int H, int W, int C, int O,
                   int P, int pix_per_split, int cblocks, int pad) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int is_last;
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to that
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tap = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x - tap * cblocks) * BM;
  const int o0 = blockIdx.y * BN;
  const int splits = gridDim.z;
  const int split = blockIdx.z;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int p_begin = split * pix_per_split;
  const int p_end = min(P, p_begin + pix_per_split);
  const int steps = (p_end - p_begin + BK - 1) / BK;

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
      const int hw = H * W;
      for (int ks = 0; ks < steps; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(&empty_bar[s], ((ks / STAGES) - 1) & 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full_bar[s], STAGE_BYTES);
        const int p0 = p_begin + ks * BK;
        const int b = p0 / hw;
        const int rem = p0 - b * hw;
        const int i = rem / W;
        const int j = rem - i * W;
        for (int wg = 0; wg < CONSUMERS; ++wg)
          tma_load_im2col(st + wg * BOX_BYTES, &xmap, &full_bar[s],
                          c0 + wg * 64, j - pad, i - pad, b,
                          static_cast<uint16_t>(tap % 3),
                          static_cast<uint16_t>(tap / 3));
        for (int nb = 0; nb < BN / 64; ++nb)
          tma_load_2d(st + A_BYTES + nb * BOX_BYTES, &gmap, &full_bar[s],
                      o0 + nb * 64, p0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns channels [c0 + 64 wg, +64) of the tile
  const int wg = warp / 4;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

  for (int ks = 0; ks < steps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full_bar[s], (ks / STAGES) & 1);
    const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + wg * BOX_BYTES;
    const uint32_t bt = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
    fence_acc(acc);
    wgmma_fence();
    // both operands MN-major: K (pixels) runs along the rows, 16 rows of
    // 128 bytes per wgmma
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16<1, 1>(acc, sw128_desc(a + kk * 2048),
                             sw128_desc(bt + kk * 2048, BOX_BYTES));
    wgmma_commit();
    fence_acc(acc);
    // the previous step's group is done: release its stage
    wgmma_wait<1>();
    fence_acc(acc);
    if (ks > 0 && lane == 0) mbar_arrive(&empty_bar[(ks - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const int t = threadIdx.x;               // consumer thread, 0..CTHREADS-1
  if (splits > 1) {
    float4* base = reinterpret_cast<float4*>(part) + t;
    float4* mine =
        base + (static_cast<size_t>(split) * tiles + tile) * CHUNKS * CTHREADS;
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q)
      mine[q * CTHREADS] = make_float4(acc[4 * q], acc[4 * q + 1],
                                       acc[4 * q + 2], acc[4 * q + 3]);
    // publish the partial before the ticket (the threadFenceReduction
    // pattern); the block with the last ticket sums them all
    __threadfence();
    named_barrier(1, CTHREADS);
    if (t == 0) {
      const int ticket = atomicAdd(&counters[tile], 1);
      is_last = ticket == splits - 1;
      if (is_last) counters[tile] = 0;
    }
    named_barrier(1, CTHREADS);
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
    for (int k = 0; k < splits; ++k) {
      const float4* src =
          base + (static_cast<size_t>(k) * tiles + tile) * CHUNKS * CTHREADS;
#pragma unroll
      for (int q = 0; q < CHUNKS; ++q) {
        const float4 v = __ldcg(src + q * CTHREADS);
        acc[4 * q] += v.x;
        acc[4 * q + 1] += v.y;
        acc[4 * q + 2] += v.z;
        acc[4 * q + 3] += v.w;
      }
    }
  }

  if (dk32 != nullptr) {
    // f32 dk (9, C, O): acc[4j + 2h + {0, 1}] is row 16 warp + lane/4 + 8h
    // of the warpgroup, columns 8j + 2 (lane % 4) + {0, 1}
    const int row = c0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = o0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = row + 8 * h;
        if (c < C && o < O)
          *reinterpret_cast<float2*>(
              dk32 + (static_cast<size_t>(tap) * C + c) * O + o) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }
  // bf16 dk: every consumer is past its last wgmma and every load has
  // landed, so the ring is free for the two output tiles
  fence_proxy_async();
  named_barrier(1, CTHREADS);
  uint8_t* out = smem + wg * EPI_BYTES;     // BN/64 slabs of 64 x 64, 8 KB
  stage_tile_bf16(acc, smem_u32(out), warp % 4, lane);
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if (t % 128 == 0 && c0 + wg * 64 < C) {
#pragma unroll
    for (int slab = 0; slab < BN / 64; ++slab)
      if (o0 + slab * 64 < O)
        tma_store_3d(&kmap, out + slab * 8192, o0 + slab * 64, c0 + wg * 64,
                     tap);
    tma_store_drain();
  }
}

// x[b, i+dy-pad, j+dx-pad, c] for output pixel p = (b, i, j) and tap t,
// zero outside x (B, H+2-2pad, W+2-2pad, C)
__device__ __forceinline__ float tap_value(const float* __restrict__ x,
                                           long long p, int t, int c, int H,
                                           int W, int C, int pad) {
  const long long hw = static_cast<long long>(H) * W;
  const long long b = p / hw;
  const long long rem = p - b * hw;
  const int ih = static_cast<int>(rem / W) + t / 3 - pad;
  const int iw = static_cast<int>(rem % W) + t % 3 - pad;
  const int Hx = H + 2 - 2 * pad;
  const int Wx = W + 2 - 2 * pad;
  if (ih < 0 || ih >= Hx || iw < 0 || iw >= Wx) return 0.0f;
  return x[((b * Hx + ih) * Wx + iw) * C + c];
}

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;
constexpr int FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
wgrad_f32_kernel(const float* __restrict__ xp, const float* __restrict__ g,
                 float* __restrict__ part, int B, int H, int W, int C, int O,
                 int pad, long long pix_per_split) {
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

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (long long p0 = p_begin; p0 < p_end; p0 += FBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int id = tid + e * FTHREADS;
      const int row = id / FBM;   // pixel in the step
      const int col = id % FBM;   // tap*C + c, contiguous in memory per tap
      const long long p = p0 + row;
      const int m = m0 + col;
      float v = 0.0f;
      if (p < p_end && m < M) {
        const int t = m / C;
        const int c = m - t * C;
        v = tap_value(xp, p, t, c, H, W, C, pad);
      }
      As[row][col] = v;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int id = tid + e * FTHREADS;
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
__global__ void __launch_bounds__(FTHREADS)
sum_splits_kernel(const float* __restrict__ part, T* __restrict__ dk,
                  long long n, int S) {
  for (long long e = blockIdx.x * static_cast<long long>(FTHREADS) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * FTHREADS) {
    float s = 0.0f;
    for (int k = 0; k < S; ++k) s += part[k * n + e];
    store_out(dk + e, s);
  }
}

// Before the first launch in each thread, and again after a change of
// device: raise the bf16 kernel's shared-memory limit, a runtime call that
// also makes the device's context current in a thread that has made no
// runtime call yet (autograd's backward worker), which libcuda's encode
// functions need. 0 or a CUDA error code.
int prepare_thread() {
  static thread_local int ready_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != ready_device) {
    err = cudaFuncSetAttribute(wgrad_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err == cudaSuccess) ready_device = dev;
  }
  return static_cast<int>(err);
}

// The bf16 kernel: encode its maps and launch it; 0 or a CUDA error code.
int launch_bf16(const void* xp, const void* g, float* part, int* counters,
                void* dk, int out_bf16, int B, int H, int W, int C, int O,
                int pad, int splits, int pix_per_split, cudaStream_t stream) {
  int err = prepare_thread();
  if (err != 0) return err;
  CUtensorMap xmap, gmap, kmap{};
  err = encode_im2col_bf16(&xmap, xp, B, H + 2 - 2 * pad, W + 2 - 2 * pad, C,
                           pad, BK);
  if (err != 0) return err;
  const long long P = static_cast<long long>(B) * H * W;
  const cuuint64_t o2 = static_cast<cuuint64_t>(O) * 2;
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(O),
                              static_cast<cuuint64_t>(P)};
  const cuuint64_t gstride[1] = {o2};
  const cuuint32_t gbox[2] = {64, BK};
  err = encode_tiled_bf16(&gmap, g, 2, gdim, gstride, gbox,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (err != 0) return err;
  if (out_bf16) {
    const cuuint64_t kdim[3] = {static_cast<cuuint64_t>(O),
                                static_cast<cuuint64_t>(C), 9};
    const cuuint64_t kstride[2] = {o2, o2 * C};
    const cuuint32_t kbox[3] = {64, 64, 1};
    err = encode_tiled_bf16(&kmap, dk, 3, kdim, kstride, kbox,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE);
    if (err != 0) return err;
  }
  const int cblocks = (C + BM - 1) / BM;
  dim3 grid(9 * cblocks, (O + BN - 1) / BN, splits);
  wgrad_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      xmap, gmap, kmap, part, counters,
      out_bf16 ? nullptr : static_cast<float*>(dk), H, W, C, O,
      static_cast<int>(P), pix_per_split, cblocks, pad);
  return 0;
}

}  // namespace

// xp (B, H+2-2pad, W+2-2pad, C), read zero-padded by pad (0 or 1), g (B,
// H, W, O). in_dtype (xp and g): 0 = float32, 1 = bfloat16; out_dtype (dk):
// the same codes. Split s covers output pixels [s * pix_per_split, (s + 1) *
// pix_per_split). bf16: part holds splits * tiles * 128 * 256 floats (none
// needed for one split) and counters one zeroed int32 per tile (9 *
// ceil(C/128) * ceil(O/256)), which the kernel leaves zeroed; one launch.
// f32: part holds splits * 9C * O floats, counters is unused; two launches.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launches (or the error that kept one from launching).
extern "C" int councilx_conv3x3_wgrad(const void* xp, const void* g,
                                      void* part, void* counters, void* dk,
                                      int B, int H, int W, int C, int O,
                                      int pad, int in_dtype, int out_dtype,
                                      int splits, long long pix_per_split,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((out_dtype != 0 && out_dtype != 1) || pad < 0 || pad > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == 1) {
    const int err = launch_bf16(xp, g, static_cast<float*>(part),
                                static_cast<int*>(counters), dk, out_dtype,
                                B, H, W, C, O, pad, splits,
                                static_cast<int>(pix_per_split), s);
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
  }
  if (in_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int M = 9 * C;
  dim3 grid((O + FBN - 1) / FBN, (M + FBM - 1) / FBM, splits);
  wgrad_f32_kernel<<<grid, FTHREADS, 0, s>>>(
      static_cast<const float*>(xp), static_cast<const float*>(g),
      static_cast<float*>(part), B, H, W, C, O, pad, pix_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(M) * O;
  const long long want = (n + FTHREADS - 1) / FTHREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (out_dtype == 1) {
    sum_splits_kernel<__nv_bfloat16><<<blocks, FTHREADS, 0, s>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk), n,
        splits);
  } else {
    sum_splits_kernel<float><<<blocks, FTHREADS, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(dk), n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
