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
//   dgrad (dgrad 1): x = the cotangent g (B, H, W, O), pad 2, Cx = O,
//     N = C, and wf read with flipped taps and transposed, which is the
//     flipped, in/out-swapped weight of _bwd_rule:
//       y[b,i,j,n] = sum_{t,o} x[b, i+dy-2, j+dx-2, o] * wf[8-t, o, n],
//     d(xp) (B, H+2, W+2, C). Neither the zero pad of _bwd_rule
//     (pallas_conv.py:277-279) nor the flipped weight is ever materialised.
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
//     needs no link to libcuda.
//
// f32 (parity mode) uses a plain shared-memory tiled FMA kernel with the
// same indexing and bounds-checked loads: it exists for exactness, not
// speed.
//
// Gate (checked by the Python wrapper, which raises on anything else):
// C % 8 == 0 and O % 8 == 0 (TMA strides are multiples of 16 bytes),
// pad in {0, 2}; ragged C, O and M are zero-filled and clipped here.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Spin until the phase of the given parity has completed. A barrier that
// never completes traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (spin > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n, uint16_t off_w,
                                                uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n), "h"(off_w),
         "h"(off_h)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a tile with the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO). K-major (A, and the
// forward's B): LBO is unused, and advancing K by 16 bf16 adds 32 bytes to
// the start. MN-major (the dgrad's B): the rows run along K, LBO is the
// distance between the 64-wide N blocks, and advancing K by 16 adds 16
// rows, 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Tell the compiler the accumulators may change under it (wgmma writes
// them asynchronously), so it neither reorders nor caches them across the
// fence/commit/wait calls.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 256, f32) += A (64 x 16, K-major smem) * B (16 x 256 in smem,
// K-major, or MN-major if TRANS_B)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.x4.m8n8.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
      wgmma_m64n256k16<DGRAD>(
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
  const uint32_t out_u32 = smem_u32(out);
  const int q = lane / 8;
  const int row = (warp % 4) * 16 + (q & 1) * 8 + lane % 8;
#pragma unroll
  for (int jp = 0; jp < BN / 16; ++jp) {
    // accumulator chunk j (8 columns): acc[4j..4j+1] at row lane/4,
    // acc[4j+2..4j+3] at row lane/4 + 8, columns 8j + 2(lane%4) + {0, 1}
    const uint32_t r0 = pack_bf16(acc[8 * jp + 0], acc[8 * jp + 1]);
    const uint32_t r1 = pack_bf16(acc[8 * jp + 2], acc[8 * jp + 3]);
    const uint32_t r2 = pack_bf16(acc[8 * jp + 4], acc[8 * jp + 5]);
    const uint32_t r3 = pack_bf16(acc[8 * jp + 6], acc[8 * jp + 7]);
    const int chunk = 2 * jp + (q >> 1);          // 8-column chunk
    const int slab = chunk / 8;
    const uint32_t addr = out_u32 + slab * 8192 + row * 128 +
                          (((chunk % 8) ^ (row % 8)) * 16);
    stmatrix_x4(addr, r0, r1, r2, r3);
  }
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if (threadIdx.x % 128 == 0 && m0 + wg * 64 < M) {
#pragma unroll
    for (int slab = 0; slab < BN / 64; ++slab)
      if (n0 + slab * 64 < N)
        tma_store_2d(&ymap, out + slab * 8192, n0 + slab * 64, m0 + wg * 64);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// libcuda's tensor-map encoders, looked up once through the runtime.
typedef CUresult (*EncodeIm2col)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

struct Encoders {
  EncodeIm2col im2col = nullptr;
  EncodeTiled tiled = nullptr;
};

void* libcuda_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                       &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q) !=
          cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
#endif
  return fn;
}

const Encoders& encoders() {
  static const Encoders e = [] {
    Encoders r;
    r.im2col = reinterpret_cast<EncodeIm2col>(
        libcuda_entry("cuTensorMapEncodeIm2col"));
    r.tiled = reinterpret_cast<EncodeTiled>(
        libcuda_entry("cuTensorMapEncodeTiled"));
    return r;
  }();
  return e;
}

struct Maps {
  CUtensorMap x, w, y;
};

// Encode the three tensor maps of one bf16 call; 0 or a CUDA error code.
int encode_maps(Maps* maps, const void* x, const void* w, void* y, int B,
                int Hin, int Win, int C, int O, int pad, int dgrad) {
  const Encoders& enc = encoders();
  if (enc.im2col == nullptr || enc.tiled == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  const int Ho = Hin + 2 * pad - 2;
  const int Wo = Win + 2 * pad - 2;
  const cuuint64_t c2 = static_cast<cuuint64_t>(C) * 2;
  const cuuint32_t ones[4] = {1, 1, 1, 1};

  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(Win),
                              static_cast<cuuint64_t>(Hin),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t xstride[3] = {c2, c2 * Win, c2 * Win * Hin};
  // window corners run over [-pad, dim - 3 + pad]: Wo (Ho) of them
  const int lower[2] = {-pad, -pad};
  const int upper[2] = {pad - 2, pad - 2};
  if (enc.im2col(&maps->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                 const_cast<void*>(x), xdim, xstride, lower, upper, BK, BM,
                 ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  // the forward reads w (9, O, C) in (64 ch, BN outputs) boxes, the dgrad
  // w (9, C, O) in (64 outputs, 64 ch) boxes
  const cuuint64_t o2 = static_cast<cuuint64_t>(O) * 2;
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(dgrad ? O : C),
                              static_cast<cuuint64_t>(dgrad ? C : O), 9};
  const cuuint64_t wstride[2] = {dgrad ? o2 : c2, c2 * O};
  const cuuint32_t wbox[3] = {dgrad ? 64u : static_cast<cuuint32_t>(BK),
                              dgrad ? static_cast<cuuint32_t>(BK)
                                    : static_cast<cuuint32_t>(BN), 1};
  if (enc.tiled(&maps->w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(w), wdim, wstride, wbox, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const cuuint64_t ydim[2] = {static_cast<cuuint64_t>(O),
                              static_cast<cuuint64_t>(B) * Ho * Wo};
  const cuuint64_t ystride[1] = {static_cast<cuuint64_t>(O) * 2};
  const cuuint32_t ybox[2] = {64, 64};
  if (enc.tiled(&maps->y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, ydim,
                ystride, ybox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
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
