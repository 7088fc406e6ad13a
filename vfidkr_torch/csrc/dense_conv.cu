// K10 dense_conv: one conv of PWC-Net's dense blocks in float32,
// leaky_relu(conv2d(x, w, b), 0.1) for a 3x3 kernel at stride 1 and padding 1, from Cin
// input channels to Cout (a multiple of 32), on the CUDA cores (FFMA) of Hopper (sm_90a).
// x is (N, Cin, H, W) and out (N, Cout, H, W), each with contiguous channel planes and a
// batch stride of its own, so both may be channel ranges of one larger NCHW tensor: the
// level's dense buffer, where conv i reads the buffer's channel suffix and writes its
// output just before it (vfidkr_torch/models/pwcnet.py:_dense).  w is (Cout, Cin, 3, 3)
// and b (Cout), as conv{lvl}_{i}.0 holds them.  The wrapper is
// vfidkr_torch/ops/dense_conv.py (dense_conv, dense_conv_into).
//
// Replaces no TPU kernel: the JAX package's dense convs are XLA convs
// (vfidkr_tpu/models/pwcnet.py:71-79, whose dense_impl="split" also drops the joins).
// It takes the place of cuDNN's float32 conv, LeakyReLU and torch.cat for the 25 dense
// convs of a PWC-Net forward, where cuDNN's heuristic picks FFT tiling at the 448x256
// cells' sizes (a complex GEMM at under 9 % of the f32 peak).
//
// What bounds it on the H100: operations.  A conv is 2 * 9 * Cin * Cout operations a
// pixel; level 2 of a 512 x 320 frame pair (2 x 80 x 128 pixels) is 47.6 GFLOP over its
// five convs (0.71 ms at 67 TFLOP/s, the f32 peak outside the tensor cores) against
// about 0.1 GB of activations and weights: some 400 operations a byte.  True float32
// throughout: no TF32, no tensor cores.
//
// Design: an implicit GEMM on the CUDA cores, M = output pixels, N = output channels,
// K = 9 Cin.
// - A block of 128 threads computes a tile of PX x 32 output pixels x 32 output
//   channels; a thread PX consecutive pixels of one row x 8 channels.  Two tiles: PX = 8
//   (64 accumulators, 168 registers, three blocks an SM) and PX = 16 (128 accumulators,
//   221 registers, two blocks an SM; each weight load feeds twice the FFMAs), for
//   frames large enough to fill the card with it.  A quarter warp shares its 8 channels
//   (the weights' loads broadcast) and spans rows x column groups that the halo rows'
//   stride of 36 floats puts on distinct bank groups.
// - The K loop walks the input channels 8 a stage through a 3-stage ring in shared
//   memory filled by cp.async: each channel's (PX + 2) x 34 halo (zeros outside the
//   frame) and its 9 x 32 weights, transposed on the way in to [channel, tap][out
//   channel].  For each kernel row a thread loads PX + 4 halo values (16-byte loads)
//   and for each kernel column its 8 weights (2 16-byte loads), then makes 8 PX FFMAs:
//   the column shift is a shift of registers.  4 channels a stage in 4 stages ran no
//   faster; unrolling the loop over a stage's channels ran 25-40 % slower (H100).
// - Split K.  A level of a small frame has too few tiles to fill 132 SMs (level 3 of a
//   512 x 320 pair: 20 tiles x Cout / 32), so the wrapper may split the input channels
//   over the S blocks of a thread-block cluster (S <= 16; the tile and S chosen from the
//   shape: N, H, W, Cin, Cout).  Block r sums its own contiguous run of the channels,
//   from zero.  Each block then writes its partial tile to its shared memory; after a
//   cluster barrier, block r reduces its 1/S of the tile by reading the S partials
//   through distributed shared memory in rank order (0, 1, ..., S - 1), adds the bias,
//   applies LeakyReLU(0.1) and stores.  No scratch buffer in device memory and no
//   atomics: each output is summed in one fixed order for its shape (channel, kernel
//   row, kernel column within a block; blocks in rank order), so two runs give the same
//   bits.
// - Epilogue: 16-byte stores of 4 pixels (4-byte ones on a ragged edge or where the
//   layout is not 16-byte aligned).
// Cin only sets the trip count of the K loop; H, W and N take any value.  Shared
// memory: 65,664 bytes a block (PX = 8) or 93,312 (PX = 16).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int TW = 32;                       // output columns of a tile
constexpr int CT = 8;                        // a thread's output channels
constexpr int CO_T = 32;                     // output channels of a block
constexpr int THREADS = 128;                 // 32 pixel groups x 4 channel groups
constexpr int CK = 8;                        // input channels a stage
constexpr int STAGES = 3;
constexpr int KS = 3;                        // kernel size
constexpr int TAPS = KS * KS;
constexpr int HC = TW + KS - 1;              // halo columns
constexpr int HS = 36;                       // halo row stride, floats
constexpr int WS = CO_T + 4;                 // weight row stride, floats
constexpr int WROWS = CK * TAPS;             // weight rows a stage: [channel, tap]
constexpr int PS = TW + 4;                   // partial tile row stride, floats
constexpr int MAX_SPLIT = 16;                // the largest cluster (non-portable)
constexpr float SLOPE = 0.1f;
constexpr int W_COPIES = WROWS * CO_T / THREADS;  // a thread's weight copies, a stage

static_assert(HS % 32 == 4, "the rows of a quarter warp on distinct bank groups");
static_assert(WROWS * CO_T == W_COPIES * THREADS, "weights copied evenly");

// The two tiles: a thread's PX consecutive pixels of one row x 8 channels, so a tile of
// PX rows x 32 columns x 32 channels; PX = 8 for small maps (more tiles), 16 where the
// map is large (each weight load feeds twice the FFMAs).
template <int PX>
struct Tile {
  static constexpr int TH = PX;                        // rows: 32 pixel groups
  static constexpr int HR = TH + KS - 1;               // halo rows
  static constexpr int AREG = PX + 4;                  // halo values loaded a row
  static constexpr int HALO = HR * HS;
  static constexpr int STAGE = CK * HALO + WROWS * WS;  // floats
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PART = CO_T * TH * PS;          // [channel][row][column]
  static constexpr int SMEM_BYTES = 4 * (RING > PART ? RING : PART);
  static constexpr int HALO_COPIES = (HR * HC + THREADS - 1) / THREADS;
  static constexpr int QUADS = CO_T * TH * TW / 4;     // float4s of a tile
  static constexpr int MIN_BLOCKS = PX == 8 ? 3 : 2;   // blocks an SM
  static_assert((TW / PX) * TH == 32, "32 pixel groups");
  static_assert(HS >= TW - PX + AREG, "halo rows hold the loads");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
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

// Copy input channels c0 .. c0 + CK - 1 (those below cin) into stage s: their halos
// and their weights.
template <int PX>
__device__ __forceinline__ void load_stage(float* s, const float* __restrict__ xn,
                                           size_t plane, const float* __restrict__ wt,
                                           int cin, int c0, int co_base, int h, int w,
                                           int y0, int x0, int tid) {
  using T = Tile<PX>;
  // the halo positions are the same for every channel of the stage
#pragma unroll
  for (int i = 0; i < T::HALO_COPIES; ++i) {
    const int p = tid + i * THREADS;
    if (p < T::HR * HC) {
      const int hr = p / HC, hc = p - hr * HC;
      const int y = y0 - 1 + hr, x = x0 - 1 + hc;
      const bool in = (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
      const size_t off = in ? (size_t)y * w + x : 0;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const bool ok = in && c0 + c < cin;
        // outside the frame or past the last channel: a zero fill, reading nothing
        cp_async4(s + c * T::HALO + hr * HS + hc,
                  ok ? xn + (size_t)(c0 + c) * plane + off : xn, ok ? 4 : 0);
      }
    }
  }
  // w[co][ci][tap] -> [ci - c0][tap][co]: the stage's 36 weights of an output channel
  // are contiguous in device memory
  float* sw = s + CK * T::HALO;
  const size_t krow = (size_t)cin * TAPS;
  const float* src = wt + (size_t)co_base * krow + (size_t)c0 * TAPS;
  const int kmax = (cin - c0) * TAPS;
  int co = tid / WROWS, k = tid - co * WROWS;
#pragma unroll
  for (int j = 0; j < W_COPIES; ++j) {
    const bool ok = k < kmax;
    cp_async4(sw + k * WS + co, ok ? src + co * krow + k : wt, ok ? 4 : 0);
    // the next element, THREADS further: THREADS = 3 * 36 + 20
    co += THREADS / WROWS;
    k += THREADS % WROWS;
    if (k >= WROWS) {
      k -= WROWS;
      ++co;
    }
  }
}

template <int PX>
__global__ void __launch_bounds__(THREADS, Tile<PX>::MIN_BLOCKS)
    dense_conv_kernel(const float* __restrict__ x, long long xs, const float* __restrict__ wt,
                      const float* __restrict__ bias, float* __restrict__ out, long long os,
                      int cin, int ctiles, int h, int w, int tiles_x, int vec) {
  using T = Tile<PX>;
  constexpr int TH = T::TH;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cgp = lane >> 3;                    // channel group: 8 channels
  const int pg = warp * 8 + (lane & 7);         // pixel group: PX pixels of a row
  const int r = pg / (TW / PX), col0 = (pg % (TW / PX)) * PX;
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;
  const int ty = (int)blockIdx.y / tiles_x, tx = (int)blockIdx.y - ty * tiles_x;
  const int n = (int)blockIdx.z / ctiles, co_base = ((int)blockIdx.z - n * ctiles) * CO_T;
  const int y0 = ty * TH, x0 = tx * TW;
  const size_t plane = (size_t)h * w;
  const float* xn = x + (size_t)n * xs;

  // this block's run of the input channels, in stages of CK
  const int chunks = (cin + CK - 1) / CK;
  const int k_lo = rank * chunks / split, k_hi = (rank + 1) * chunks / split;
  const int nst = k_hi - k_lo;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_stage<PX>(smem + s * T::STAGE, xn, plane, wt, cin, (k_lo + s) * CK, co_base, h,
                     w, y0, x0, tid);
    cp_async_commit();
  }

  float acc[PX][CT];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;

#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage consumed in the last iteration: every thread is past it
    const int nx = t + STAGES - 1;
    if (nx < nst)
      load_stage<PX>(smem + (nx % STAGES) * T::STAGE, xn, plane, wt, cin, (k_lo + nx) * CK,
                     co_base, h, w, y0, x0, tid);
    cp_async_commit();

    const float* s = smem + (t % STAGES) * T::STAGE;
    const int c0 = (k_lo + t) * CK;
    const int nc = cin - c0 < CK ? cin - c0 : CK;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const float* sa = s + cc * T::HALO + r * HS + col0;
      const float* sb = s + CK * T::HALO + cc * TAPS * WS + cgp * CT;
#pragma unroll
      for (int ky = 0; ky < KS; ++ky) {
        float a[T::AREG];
#pragma unroll
        for (int m = 0; m < T::AREG / 4; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(sa + ky * HS + 4 * m);
          a[4 * m] = v.x;
          a[4 * m + 1] = v.y;
          a[4 * m + 2] = v.z;
          a[4 * m + 3] = v.w;
        }
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          const float* bp = sb + (ky * KS + kx) * WS;
          const float4 b0 = *reinterpret_cast<const float4*>(bp);
          const float4 b1 = *reinterpret_cast<const float4*>(bp + 4);
          const float b[CT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < PX; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[kx + i], b[j], acc[i][j]);
        }
      }
    }
  }

  // the partial tile into this block's shared memory (over the ring)
  cp_async_wait<0>();
  __syncthreads();
  float* part = smem;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    float4* p = reinterpret_cast<float4*>(part + ((cgp * CT + j) * TH + r) * PS + col0);
#pragma unroll
    for (int m = 0; m < PX / 4; ++m)
      p[m] = make_float4(acc[4 * m][j], acc[4 * m + 1][j], acc[4 * m + 2][j],
                         acc[4 * m + 3][j]);
  }
  cluster.sync();

  // this block's share of the tile: the partials summed in rank order, the bias,
  // LeakyReLU(0.1), the store
  const int q_lo = rank * T::QUADS / split, q_hi = (rank + 1) * T::QUADS / split;
  for (int f = q_lo + tid; f < q_hi; f += THREADS) {
    const int co = f / (TH * TW / 4);
    const int row = (f / (TW / 4)) % TH;
    const int c4 = f % (TW / 4);
    const int off = (co * TH + row) * PS + 4 * c4;
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
    const int cog = co_base + co;
    const float bc = bias[cog];
    float o[4] = {v.x + bc, v.y + bc, v.z + bc, v.w + bc};
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = o[e] > 0.0f ? o[e] : o[e] * SLOPE;  // a NaN stays NaN
    float* dst = out + (size_t)n * os + (size_t)cog * plane + (size_t)y * w + xb;
    if (vec && xb + 4 <= w) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (xb + e < w) dst[e] = o[e];
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
  cudaError_t err = cudaFuncSetAttribute(dense_conv_kernel<8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<8>::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_conv_kernel<16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<16>::SMEM_BYTES);
  // clusters of more than 8 blocks (Hopper takes 16)
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_conv_kernel<8>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_conv_kernel<16>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

template <int PX>
cudaError_t launch(const float* x, long long xs, const float* w, const float* b, float* out,
                   long long os, int n, int cin, int cout, int h, int width, int split,
                   cudaStream_t stream) {
  const int tiles_x = (width + TW - 1) / TW, tiles_y = (h + Tile<PX>::TH - 1) / Tile<PX>::TH;
  const int ctiles = cout / CO_T;
  if ((long long)tiles_x * tiles_y > 65535 || (long long)n * ctiles > 65535)
    return cudaErrorInvalidValue;
  const int vec = width % 4 == 0 && os % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles_x * tiles_y, n * ctiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<PX>::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dense_conv_kernel<PX>, x, xs, w, b, out, os, cin, ctiles, h,
                            width, tiles_x, vec);
}

}  // namespace

// x (N, Cin, H, W) with batch stride xs, w (Cout, Cin, 3, 3), b (Cout), out (N, Cout,
// H, W) with batch stride os: float32, channel planes contiguous, x and out disjoint;
// Cout a multiple of 32; rows 8 or 16 (the tile); split in 1 .. 16 and at most
// ceil(Cin / 4).  Returns 0 or a CUDA runtime error.
extern "C" int vfidkr_dense_conv(const float* x, long long xs, const float* w, const float* b,
                                 float* out, long long os, int n, int cin, int cout, int h,
                                 int width, int rows, int split, cudaStream_t stream) {
  if (n < 1 || cin < 1 || h < 1 || width < 1 || cout < CO_T || cout % CO_T != 0 ||
      (rows != 8 && rows != 16) || split < 1 || split > MAX_SPLIT ||
      split > (cin + CK - 1) / CK)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = configure_device(device);
  if (err == cudaSuccess)
    err = rows == 8 ? launch<8>(x, xs, w, b, out, os, n, cin, cout, h, width, split, stream)
                    : launch<16>(x, xs, w, b, out, os, n, cin, cout, h, width, split, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
