// K11 flow_head: one of PWC-Net's flow heads in float32, conv2d(x, w, b) for a 3x3 kernel
// at stride 1 and padding 1, from C input channels to 2, on the CUDA cores (FFMA) of
// Hopper (sm_90a).  x is (N, C, H, W) and out (N, 2, H, W), both NCHW and contiguous: x
// is the level's dense buffer as vfidkr_torch/models/pwcnet.py:_dense returns it (C =
// 529, 661, 629, 597, 565 at levels 6 to 2), read in place.  w is (2, C, 3, 3) and b
// (2), as predict_flow{lvl} holds them.  The wrapper is vfidkr_torch/ops/flow_head.py.
//
// Replaces no TPU kernel: the JAX package's heads are XLA convs
// (vfidkr_tpu/models/pwcnet.py).  It takes the place of cuDNN's float32 conv and bias
// add for the five heads of a PWC-Net forward, where cuDNN's heuristic picks FFT tiling
// (a complex GEMM) for the 597 -> 2 head at 40 x 64 and generic convs for the others,
// at about 1 % of the bound below.
//
// What bounds it on the H100: bytes.  A head reads its level's whole buffer once and
// writes 2 channels: 2 * 9 * C * 2 operations a pixel against 4 C bytes, 9 operations a
// byte, under half the card's 20 (67 TFLOP/s f32 over 3.35 TB/s).  Level 2 of a 512 x
// 320 pair (2 x 80 x 128 pixels, C = 565) is 46.3 MB: 13.8 us at 3.35 TB/s.  True
// float32 throughout: no TF32, no tensor cores.
//
// Design: every buffer value leaves device memory once; the 3x3 reuse comes from shared
// memory and registers.
// - A block of 128 threads owns a tile of TH x 32 output pixels (TH = 16, or 8 for small
//   maps) and both output channels: a lane a column, a warp TH / 4 consecutive rows, a
//   thread's 2 x TH / 4 sums in registers.
// - The input channels run 8 a stage through a 3-stage ring in shared memory filled by
//   cp.async: each channel's (TH + 2) x 40 halo (frame columns x0 - 4 .. x0 + 35, zeros
//   outside the frame) by 16-byte copies where W is a multiple of 4 (4-byte copies of
//   the 34 columns used otherwise), and its 18 weights.  For each halo row a thread
//   loads 3 values (a warp reads 34 consecutive floats: no bank conflicts), which feed
//   the 6 x (rows in reach) FFMAs of its pixels: a channel is 3 (TH / 4 + 2) shared
//   loads and 18 TH / 4 FFMAs a thread.
// - The small levels.  Level 6 of a 512 x 320 pair is 80 pixels, one tile of each
//   direction, and level 3 twelve tiles: too few blocks to fill 132 SMs or to keep
//   enough bytes in flight.  So the wrapper splits the input channels over the S blocks
//   of a thread-block cluster (S <= 16; the tile and S chosen from the shape: N, H, W,
//   C and the SM count).  Block r sums its own contiguous run of the channels from zero
//   and writes its partial tile to its shared memory; after a cluster barrier, block r
//   sums its 1/S of the tile from the S partials through distributed shared memory in
//   rank order (0, 1, ..., S - 1), adds the bias and stores (unsplit, S = 1, the same
//   path).  No scratch buffer in device memory and no atomics: each output is summed in
//   one fixed order for its shape (channel, kernel row, kernel column within a block;
//   blocks in rank order), so two runs give the same bits.
// C only sets the trip count of the channel loop; H, W and N take any value.  Shared
// memory: 3 stages of 23,680 bytes (TH = 16) or 13,440 (TH = 8) a block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int TW = 32;                  // output columns of a tile: a lane a column
constexpr int THREADS = 128;            // 4 warps, each PY rows of the tile
constexpr int WARPS = THREADS / 32;
constexpr int CO = 2;                   // output channels
constexpr int KS = 3;                   // kernel size
constexpr int TAPS = KS * KS;
constexpr int CK = 8;                   // input channels a stage
constexpr int STAGES = 3;
constexpr int LEAD = 4;                 // halo column of the tile's first column
constexpr int HS = TW + 2 * LEAD;       // halo row: frame columns x0 - 4 .. x0 + TW + 3
constexpr int CHUNKS = HS / 4;          // 16-byte copies a halo row
constexpr int WS = 20;                  // a channel's CO x TAPS weights, padded to 16 bytes
constexpr int MAX_SPLIT = 16;           // the largest cluster (non-portable)

static_assert(CO * TAPS <= WS && WS % 4 == 0, "a channel's weights in 16-byte loads");

// The two tiles: PY rows a warp, so TH = 4 PY rows x 32 columns.
template <int PY>
struct Tile {
  static constexpr int TH = WARPS * PY;                 // output rows
  static constexpr int HR = TH + KS - 1;                // halo rows
  static constexpr int HALO = HR * HS;                  // floats a channel
  static constexpr int STAGE = CK * (HALO + WS);        // floats
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PART = CO * TH * TW;             // [channel][row][column]
  static constexpr int SMEM_BYTES = 4 * (RING > PART ? RING : PART);
  static constexpr int QUADS = PART / 4;                // float4s of a tile
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy input channels c0 .. c0 + nc - 1 into stage s: their halos and their weights,
// transposed on the way in to [channel][output channel, tap].
template <int PY>
__device__ __forceinline__ void load_stage(float* s, const float* __restrict__ xn,
                                           size_t plane, const float* __restrict__ wt,
                                           int c, int c0, int nc, int h, int w, int y0,
                                           int x0, int vec, int tid) {
  using T = Tile<PY>;
  if (vec) {
    // W % 4 == 0 and x0 % 4 == 0: a 16-byte chunk lies wholly inside or outside a row
    constexpr int PER_CH = T::HR * CHUNKS;
    for (int p = tid; p < nc * PER_CH; p += THREADS) {
      const int cc = p / PER_CH, rem = p - cc * PER_CH;
      const int hr = rem / CHUNKS, q = rem - hr * CHUNKS;
      const int y = y0 - 1 + hr, xs = x0 - LEAD + 4 * q;
      const bool ok = (unsigned)y < (unsigned)h && (unsigned)xs < (unsigned)w;
      // outside the frame: a zero fill, reading nothing
      cp_async16(s + cc * T::HALO + hr * HS + 4 * q,
                 ok ? xn + (size_t)(c0 + cc) * plane + (size_t)y * w + xs : xn, ok ? 16 : 0);
    }
  } else {
    // the 34 columns the taps read, x0 - 1 .. x0 + 32
    constexpr int HC = TW + KS - 1;
    constexpr int PER_CH = T::HR * HC;
    for (int p = tid; p < nc * PER_CH; p += THREADS) {
      const int cc = p / PER_CH, rem = p - cc * PER_CH;
      const int hr = rem / HC, hc = rem - hr * HC;
      const int y = y0 - 1 + hr, xx = x0 - 1 + hc;
      const bool ok = (unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w;
      cp_async4(s + cc * T::HALO + hr * HS + LEAD - 1 + hc,
                ok ? xn + (size_t)(c0 + cc) * plane + (size_t)y * w + xx : xn, ok ? 4 : 0);
    }
  }
  // w[o][c0 + cc][tap] -> [cc][o * 9 + tap]
  float* sw = s + CK * T::HALO;
  for (int p = tid; p < nc * CO * TAPS; p += THREADS) {
    const int cc = p / (CO * TAPS), k = p - cc * (CO * TAPS);
    const int o = k / TAPS, tap = k - o * TAPS;
    cp_async4(sw + cc * WS + k, wt + ((size_t)o * c + c0 + cc) * TAPS + tap, 4);
  }
}

// One input channel into a thread's sums: sa is its column's halo at its first row's
// upper neighbour and kernel column 0, sw the channel's weights.
template <int PY>
__device__ __forceinline__ void channel(const float* sa, const float* sw,
                                        float (&acc)[CO][PY]) {
  float wv[WS];
#pragma unroll
  for (int m = 0; m < WS / 4; ++m) {
    const float4 v = *reinterpret_cast<const float4*>(sw + 4 * m);
    wv[4 * m] = v.x;
    wv[4 * m + 1] = v.y;
    wv[4 * m + 2] = v.z;
    wv[4 * m + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < PY + KS - 1; ++k) {
    const float a0 = sa[k * HS], a1 = sa[k * HS + 1], a2 = sa[k * HS + 2];
#pragma unroll
    for (int i = 0; i < PY; ++i) {
      const int ky = k - i;
      if (ky < 0 || ky >= KS) continue;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const float* wk = wv + o * TAPS + ky * KS;
        acc[o][i] = fmaf(a0, wk[0], acc[o][i]);
        acc[o][i] = fmaf(a1, wk[1], acc[o][i]);
        acc[o][i] = fmaf(a2, wk[2], acc[o][i]);
      }
    }
  }
}

template <int PY>
__global__ void __launch_bounds__(THREADS)
    flow_head_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                     const float* __restrict__ bias, float* __restrict__ out, int c, int h,
                     int w, int tiles_x, int vec) {
  using T = Tile<PY>;
  constexpr int TH = T::TH;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid & 31, r0 = (tid >> 5) * PY;
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;
  const int ty = (int)blockIdx.y / tiles_x, txi = (int)blockIdx.y - ty * tiles_x;
  const int n = (int)blockIdx.z;
  const int y0 = ty * TH, x0 = txi * TW;
  const size_t plane = (size_t)h * w;
  const float* xn = x + (size_t)n * c * plane;

  // this block's run of the input channels, in stages of CK
  const int chunks = (c + CK - 1) / CK;
  const int k_lo = rank * chunks / split, k_hi = (rank + 1) * chunks / split;
  const int nst = k_hi - k_lo;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) {
      const int c0 = (k_lo + s) * CK;
      load_stage<PY>(smem + s * T::STAGE, xn, plane, wt, c, c0, min(CK, c - c0), h, w, y0,
                     x0, vec, tid);
    }
    cp_async_commit();
  }

  float acc[CO][PY];
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int i = 0; i < PY; ++i) acc[o][i] = 0.0f;

#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage consumed in the last iteration: every thread is past it
    const int nx = t + STAGES - 1;
    if (nx < nst) {
      const int c0 = (k_lo + nx) * CK;
      load_stage<PY>(smem + (nx % STAGES) * T::STAGE, xn, plane, wt, c, c0,
                     min(CK, c - c0), h, w, y0, x0, vec, tid);
    }
    cp_async_commit();

    const float* s = smem + (t % STAGES) * T::STAGE;
    const float* sa = s + r0 * HS + LEAD - 1 + tx;
    const float* sw = s + CK * T::HALO;
    // the last block's last stage holds C % 8 channels where 8 does not divide C
    const int nc = min(CK, c - (k_lo + t) * CK);
#pragma unroll
    for (int cc = 0; cc < CK; ++cc)
      if (cc < nc) channel<PY>(sa + cc * T::HALO, sw + cc * WS, acc);
  }

  // the partial tile into this block's shared memory (over the ring)
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();
  __syncthreads();
  float* part = smem;
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int i = 0; i < PY; ++i) part[(o * TH + r0 + i) * TW + tx] = acc[o][i];
  cluster.sync();

  // this block's share of the tile: the partials summed in rank order, the bias, the
  // store
  const int q_lo = rank * T::QUADS / split, q_hi = (rank + 1) * T::QUADS / split;
  for (int f = q_lo + tid; f < q_hi; f += THREADS) {
    const int o = f / (TH * TW / 4);
    const int row = (f / (TW / 4)) % TH;
    const int c4 = f % (TW / 4);
    const int off = (o * TH + row) * TW + 4 * c4;
    // every partial's load in flight at once, then the sums in rank order
    float4 u[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split)
        u[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + off);
    float4 v = u[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < split) {
        v.x += u[q].x;
        v.y += u[q].y;
        v.z += u[q].z;
        v.w += u[q].w;
      }
    }
    const int y = y0 + row, xb = x0 + 4 * c4;
    if (y >= h || xb >= w) continue;
    const float bo = bias[o];
    const float r[4] = {v.x + bo, v.y + bo, v.z + bo, v.w + bo};
    float* dst = out + ((size_t)n * CO + o) * plane + (size_t)y * w + xb;
    if (vec && xb + 4 <= w) {
      *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (xb + e < w) dst[e] = r[e];
    }
  }
  // no block leaves while another reads its shared memory
  cluster.sync();
}

// The kernels' dynamic shared-memory limits, set once for each device (CUDA keeps
// function attributes per device; one bit a device ordinal, set by any thread).
cudaError_t configure_device(int device) {
  static std::atomic<unsigned long long> configured{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0ULL;
  if (bit != 0 && (configured.load() & bit)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flow_head_kernel<2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<2>::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flow_head_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<4>::SMEM_BYTES);
  // clusters of more than 8 blocks (Hopper takes 16)
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flow_head_kernel<2>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flow_head_kernel<4>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

template <int PY>
cudaError_t launch(const float* x, const float* w, const float* b, float* out, int n, int c,
                   int h, int width, int split, cudaStream_t stream) {
  const int tiles_x = (width + TW - 1) / TW, tiles_y = (h + Tile<PY>::TH - 1) / Tile<PY>::TH;
  if ((long long)tiles_x * tiles_y > 65535 || n > 65535) return cudaErrorInvalidValue;
  const int vec = width % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles_x * tiles_y, n);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<PY>::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flow_head_kernel<PY>, x, w, b, out, c, h, width, tiles_x,
                            vec);
}

}  // namespace

// x (N, C, H, W), w (2, C, 3, 3), b (2), out (N, 2, H, W): float32, contiguous, x and
// out disjoint; rows 8 or 16 (the tile); split in 1 .. 16 and at most ceil(C / 8).
// Returns 0 or a CUDA runtime error.
extern "C" int vfidkr_flow_head(const float* x, const float* w, const float* b, float* out,
                                int n, int c, int h, int width, int rows, int split,
                                cudaStream_t stream) {
  if (n < 1 || c < 1 || h < 1 || width < 1 || (rows != 8 && rows != 16) || split < 1 ||
      split > MAX_SPLIT || split > (c + CK - 1) / CK)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = configure_device(device);
  if (err == cudaSuccess)
    err = rows == 8 ? launch<2>(x, w, b, out, n, c, h, width, split, stream)
                    : launch<4>(x, w, b, out, n, c, h, width, split, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
