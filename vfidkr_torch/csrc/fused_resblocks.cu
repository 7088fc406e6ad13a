// K4 fused_resblocks: one 3x3 128->128 convolution of the rectifier's residual trunk
// (the bf16 eval lane) for NHWC bf16 activations on Hopper (sm_90a), with its
// epilogue: the optional residual added in the f32 accumulator, ReLU, the cast to
// bf16.  The wrapper (vfidkr_torch/ops/rectify.py) launches it six times a call,
// conv1 and conv2 of blocks 2, 3 and 4:
//   t = relu(conv(h, w[2k]))           -> bf16
//   h = relu(conv(t, w[2k+1]) + h)     -> bf16   (k = 0, 1, 2)
//
// Replaces: vfidkr_tpu/ops/pallas/rectify_kernel.py:fused_resblocks.  The TPU kernel
// keeps the whole (H, W, 128) activation in VMEM and runs the six convs as 9 shifted
// tap-dots each on the MXU; its gate fused_resblocks_ok refuses frames whose
// activations do not fit.  A Hopper SM has 227 KB of shared memory, so here each conv
// is one launch over tiles of the frame, the activations go through device memory
// (and the 50 MB L2) between the launches, and any N, H, W is taken.
//
// Semantics (as the TPU kernel's): bf16 operands, exact products, f32 sums; the
// residual is the bf16 block input, added to the f32 accumulator before ReLU; each
// conv's output is rounded to bf16 (round to nearest even).  Zero padding of 1.
//
// Layouts: x, res, out are (N,H,W,128) bf16, channels contiguous (a (N,128,H,W)
// tensor in torch.channels_last), so a pixel is one 256-byte row of the GEMM's K.
// w is one conv's taps packed as (9,128,128) bf16 [dy*3+dx][co][ci]
// (rectify.pack_trunk_weights).  res may be NULL and may alias out: a tile's
// residual is read before its results are stored, and no block reads out as conv
// input.
//
// What bounds it on the H100: operations.  A conv at (1,128,256,448) is 33.8 GFLOP
// (34.2 us at 989 TFLOP/s bf16) against 29.4 MB in and out (8.8 us at 3.35 TB/s).
//
// Design: an implicit GEMM on wgmma, M = output pixels, N = 128 output channels,
// K = 2 channel halves x 9 taps x 64 input channels, in persistent blocks (one an
// SM) that walk tiles of 4 x 64 output pixels.  Three warpgroups a block:
// - producer (setmaxnreg 40).  One thread streams the weights as 18 K-slices of 64
//   input x 128 output channels (16 KB, one tap of one channel half, 128-byte
//   swizzled) through a 3-stage ring by TMA, with full/empty mbarriers; it runs
//   ahead across tiles.  A second thread loads each tile's 6 x 66 input halo by
//   TMA, coordinates outside the frame reading as zeros (the padding and the ragged
//   edges cost nothing), one channel half as soon as the consumers are done with
//   the last tile's: the next tile's half 0 loads while they work on half 1.  A
//   third warp loads the tile's residual into the output tile and stores the
//   results by TMA once the consumers hand them over.
// - two consumers (setmaxnreg 232), two 64-pixel tile rows each: per k16 step
//   two wgmma.mma_async m64n128k16, A and B from shared memory, f32 accumulators
//   in registers (128 a thread); one step stays in flight behind the next.  The
//   halo is laid out without a swizzle, as 16 planes of 8 channels, each pixel
//   16 bytes: a tap's A operand is the halo shifted by whole pixels, which a
//   descriptor takes as it is (8 consecutive pixels make one 128-byte core
//   matrix, the next 8 follow, the next 8 channels lie one plane on).  A 128-byte
//   swizzle ties the layout to 8-pixel atoms, which a one-pixel shift leaves.
// - epilogue: the residual in f32, ReLU and the bf16 cast in the output tile in
//   shared memory (128-byte swizzled: a warp's 32 words land on 32 banks), handed
//   to the store warp by a named barrier; the consumers go on to the next tile
//   while the store drains.
// Shared memory: 100 KB halo + 48 KB ring + 64 KB output tile, one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;                        // channels in and out
constexpr int TH = 4;                         // output rows of a tile
constexpr int TW = 64;                        // output columns of a tile
constexpr int HR = TH + 2;                    // halo rows
constexpr int HC = TW + 2;                    // halo columns
constexpr int PLANE_BYTES = HR * HC * 16;     // 8 channels of the halo
constexpr int PLANE_STRIDE = (PLANE_BYTES + 127) / 128 * 128;
constexpr int HALF_STRIDE = 8 * PLANE_STRIDE;  // 64 channels of the halo
constexpr int KSLICES = 18;                   // 2 channel halves x 9 taps
constexpr int STAGES = 3;                     // weight ring
constexpr int STAGE_BYTES = 64 * C * 2;       // 64 input x 128 output channels
constexpr int OUT_HALF = TH * TW * 128;       // 64 channels of the output tile
constexpr int CONSUMERS = 2;                  // warpgroups of 128 output pixels
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int RING_OFF = 2 * HALF_STRIDE;
constexpr int OUT_OFF = RING_OFF + STAGES * STAGE_BYTES;
constexpr int BAR_OFF = OUT_OFF + 2 * OUT_HALF;
constexpr int N_BARS = 2 * STAGES + 5;
constexpr int SMEM_BYTES = BAR_OFF + N_BARS * 8 + 1024;  // + alignment slack

static_assert(TW == 64 && CONSUMERS * 2 == TH, "a 64-pixel slice is a tile row");
static_assert(HALF_STRIDE % 1024 == 0 && RING_OFF % 1024 == 0 &&
                  OUT_OFF % 1024 == 0, "swizzled buffers on 1024-byte atoms");
static_assert(SMEM_BYTES <= 232448, "227 KB of shared memory a block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed; a wait that never
// ends (a broken pipeline, not a slow one) stops the kernel with an error
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++spins == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a K-major operand descriptor: start >> 4, leading (K) and stride (M or N,
// between 8-row groups) byte offsets >> 4, and the layout: 0 no swizzle (core
// matrices of 8 rows x 16 bytes), 1 the 128-byte swizzle (8-row atoms of 128-byte
// rows, as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes them)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads and writes across a wgmma
// fence or wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) (+)= a (64 x 16 bf16) x b (16 x 128 bf16), both in shared
// memory; scale_d == 0 starts d at 0
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a_desc,
                                         uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

struct Tile {
  int n, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  const int per_image = tiles_x * tiles_y;
  const int rem = t % per_image;
  return {t / per_image, (rem / tiles_x) * TH, (rem % tiles_x) * TW};
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_resblocks_kernel(const __grid_constant__ CUtensorMap tmap_x,
                           const __grid_constant__ CUtensorMap tmap_w,
                           const __grid_constant__ CUtensorMap tmap_res,
                           const __grid_constant__ CUtensorMap tmap_out,
                           int has_res, int tiles_x, int tiles_y, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: every buffer starts on that boundary
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);
  const uint32_t halo = base;  // 8-channel plane c at halo + c * PLANE_STRIDE
  const uint32_t ring = base + RING_OFF;
  const uint32_t tile_out = base + OUT_OFF;  // the output tile, two halves
  const uint32_t bars = base + BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto halo_full = [&](int k) { return bars + 8u * (2 * STAGES + k); };
  auto halo_empty = [&](int k) { return bars + 8u * (2 * STAGES + 2 + k); };
  const uint32_t out_full = bars + 8u * (2 * STAGES + 4);  // residual in

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // one arrival a consumer warp
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(halo_full(k), 1);
      mbar_init(halo_empty(k), CONSUMERS * 4);
    }
    mbar_init(out_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // ---- producer warpgroup: two threads and a warp issue the TMA copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == CONSUMERS * 4 && lane == 0) {
      // the weight ring, ahead across tiles: K-slice ks is channel half
      // ks / 9 of tap ks % 9
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        for (int ks = 0; ks < KSLICES; ++ks) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), STAGE_BYTES);
          tma_load_3d(ring + stage * STAGE_BYTES, &tmap_w, full(stage),
                      (ks / 9) * 64, 0, ks % 9);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (warp == CONSUMERS * 4 + 1 && lane == 0) {
      // each tile's halo, a channel half (8 planes) as soon as the consumers
      // are done with the last tile's
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile = tile_at(t, tiles_x, tiles_y);
        for (int k = 0; k < 2; ++k) {
          mbar_wait(halo_empty(k), phase ^ 1);
          mbar_expect_tx(halo_full(k), 8 * PLANE_BYTES);
          for (int c = 8 * k; c < 8 * k + 8; ++c)
            tma_load_4d(halo + c * PLANE_STRIDE, &tmap_x, halo_full(k), c * 8,
                        tile.x0 - 1, tile.y0 - 1, tile.n);
        }
        phase ^= 1;
      }
    } else if (warp == CONSUMERS * 4 + 2) {
      // the output tile: each tile's residual in (without a residual only the
      // signal), then, once the consumers have written the results over it,
      // the tile out to the frame (its edge clips the store); the next
      // residual goes in once the store has read the tile
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile = tile_at(t, tiles_x, tiles_y);
        if (lane == 0) {
          if (has_res) {
            mbar_expect_tx(out_full, 2 * OUT_HALF);
            for (int k = 0; k < 2; ++k)
              tma_load_4d(tile_out + k * OUT_HALF, &tmap_res, out_full, k * 64,
                          tile.x0, tile.y0, tile.n);
          } else {
            mbar_arrive(out_full);
          }
        }
        __syncwarp();
        asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128 + 32) : "memory");
        if (lane == 0) {
          for (int k = 0; k < 2; ++k)
            tma_store_4d(&tmap_out, tile_out + k * OUT_HALF, k * 64, tile.x0,
                         tile.y0, tile.n);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        }
        __syncwarp();
      }
      if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  } else {
    // ---- two consumer warpgroups: wgmma, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;  // tile rows 2 wg and 2 wg + 1
    const int wq = warp % 4;  // 16 pixels of each row
    float acc[2][64];
    int stage = 0, last = 0;
    uint32_t phase = 0, tile_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
#pragma unroll 1
      for (int ks = 0; ks < KSLICES; ++ks) {
        const int tap = ks % 9;
        // the halo pixel of output pixel (row 2 wg + ms, column 0) at this tap;
        // plane 8 (ks / 9) + 2 kk holds k 0-7 of step kk, the next plane k 8-15
        const uint32_t a0 = halo + (ks / 9) * HALF_STRIDE +
                            ((2 * wg + tap / 3) * HC + tap % 3) * 16;
        if (tap == 0) mbar_wait(halo_full(ks / 9), tile_phase);
        mbar_wait(full(stage), phase);
        const uint32_t w_tile = ring + stage * STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint64_t a[2];
#pragma unroll
          for (int ms = 0; ms < 2; ++ms)
            a[ms] = make_desc(a0 + 2 * kk * PLANE_STRIDE + ms * HC * 16,
                              PLANE_STRIDE, 128, 0);
          uint64_t b = make_desc(w_tile + kk * 32, 16, 1024, 1);
          int scale_d = (ks | kk) != 0;  // the tile's first step starts at 0
          // every input of the wgmmas defined before the fence
          asm volatile("" : "+l"(a[0]), "+l"(a[1]), "+l"(b), "+r"(scale_d));
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          wgmma_fence();
          wgmma_ss(acc[0], a[0], b, scale_d);
          wgmma_ss(acc[1], a[1], b, scale_d);
          wgmma_commit();
          // the step before this one is done: at the first step of a K-slice,
          // the last K-slice's weights are free (and after the ninth, channel
          // half 0 of the halo)
          wgmma_wait<1>();
          if (kk == 0 && ks > 0 && lane == 0) {
            mbar_arrive(empty(last));
            if (ks == 9) mbar_arrive(halo_empty(0));
          }
        }
        last = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) {
        mbar_arrive(empty(last));
        mbar_arrive(halo_empty(1));  // the next tile's half 1 loads meanwhile
      }

      // epilogue into the output tile (128-byte swizzled, as TMA stores it):
      // thread (warp wq, lane) holds pixels wq*16 + lane/4 (+8) of tile rows
      // 2 wg + ms, channels 8 j + 2 (lane % 4) + {0, 1} in acc[ms][4 j + {0, 1}]
      // (+8 pixels: acc[ms][4 j + {2, 3}]); a warp's 32 four-byte words of one j
      // fall on 32 different banks.  The residual, where there is one, is there.
      mbar_wait(out_full, tile_phase);
#pragma unroll
      for (int ms = 0; ms < 2; ++ms) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = (2 * wg + ms) * TW + wq * 16 + (lane >> 2) + hh * 8;
          unsigned char* const row = base_ptr + OUT_OFF + r * 128 + 4 * (lane & 3);
          auto word = [&](int j) {
            return reinterpret_cast<uint32_t*>(row + (j >> 3) * OUT_HALF +
                                               (((j & 7) ^ (r & 7)) << 4));
          };
          uint32_t rv[16];  // the residual's bf16 pairs, all read before a write
#pragma unroll
          for (int j = 0; j < 16; ++j) rv[j] = has_res ? *word(j) : 0u;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 r2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&rv[j]));
            const float v0 = acc[ms][4 * j + 2 * hh] + r2.x;
            const float v1 = acc[ms][4 * j + 2 * hh + 1] + r2.y;
            const __nv_bfloat162 o = __floats2bfloat162_rn(v0 < 0.0f ? 0.0f : v0,
                                                           v1 < 0.0f ? 0.0f : v1);
            *word(j) = *reinterpret_cast<const uint32_t*>(&o);
          }
        }
      }
      // the tile's words are written: make them visible to TMA, and hand the
      // tile to the store warp without waiting for it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.arrive 1, %0;" ::"n"(CONSUMERS * 128 + 32) : "memory");
      tile_phase ^= 1;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// Returns 0, a CUDA runtime error, 1999 when the driver has no
// cuTensorMapEncodeTiled, or 2000 + the CUresult of a refused tensor map.
extern "C" int vfidkr_fused_resblocks(const void* x, const void* w, const void* res,
                                      void* out, int n, int h, int width,
                                      cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_resblocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 1999;
  // an (N, H, W, 128) bf16 activation in boxes of box_c channels x box_w x box_h;
  // coordinates outside the frame read as zeros and are clipped from stores
  auto activation_map = [&](CUtensorMap* map, const void* ptr, cuuint32_t box_c,
                            cuuint32_t box_w, cuuint32_t box_h,
                            CUtensorMapSwizzle swizzle) {
    const cuuint64_t dim[4] = {C, (cuuint64_t)width, (cuuint64_t)h, (cuuint64_t)n};
    const cuuint64_t stride[3] = {C * 2, (cuuint64_t)width * C * 2,
                                  (cuuint64_t)h * width * C * 2};
    const cuuint32_t box[4] = {box_c, box_w, box_h, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                  dim, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUtensorMap tmap_x, tmap_w, tmap_res, tmap_out;
  // the halo: one 8-channel plane a box, not swizzled
  CUresult r = activation_map(&tmap_x, x, 8, HC, HR, CU_TENSOR_MAP_SWIZZLE_NONE);
  // the output tile: 64 channels a box, 128-byte swizzled
  if (r == CUDA_SUCCESS)
    r = activation_map(&tmap_out, out, 64, TW, TH, CU_TENSOR_MAP_SWIZZLE_128B);
  // without a residual its map is never read: any valid map will do
  if (r == CUDA_SUCCESS)
    r = activation_map(&tmap_res, res != nullptr ? res : out, 64, TW, TH,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != CUDA_SUCCESS) return 2000 + (int)r;
  // w: (9, 128 co, 128 ci), a box of 64 ci x 128 co of one tap
  const cuuint64_t w_dim[3] = {C, C, 9};
  const cuuint64_t w_stride[2] = {C * 2, C * C * 2};
  const cuuint32_t w_box[3] = {64, C, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  r = encode(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
             w_dim, w_stride, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 2000 + (int)r;

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (width + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const int n_tiles = tiles_x * tiles_y * n;
  const int grid = n_tiles < sms ? n_tiles : sms;
  fused_resblocks_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      tmap_x, tmap_w, tmap_res, tmap_out, res != nullptr, tiles_x, tiles_y,
      n_tiles);
  return (int)cudaGetLastError();
}
