// K13 correlation: PWC-Net's cost volume through its LeakyReLU, forward and backward, in
// float32 on the CUDA cores (FFMA) of Hopper (sm_90a).  f1 and f2 are (N, C, H, W), out
// (N, 81, H, W), all NCHW and contiguous; f2 is the other image's features, warped by the
// coarser flow (vfidkr_torch/models/pwcnet.py:_decode).  The wrapper is
// vfidkr_torch/ops/correlation.py.
//
//   out[n, d, y, x] = lrelu(sum_c f1[n, c, y, x] * f2[n, c, y + dy, x + dx] / C, 0.1)
//
// for d = (dy + 4) * 9 + (dx + 4), dy and dx in -4 .. 4, f2 zero outside the frame.  The
// backward takes G = g * (out > 0 ? 1 : 0.1) / C (the LeakyReLU's slope read from the sign
// of the saved output, which is the sign of its input) and computes both gradients as
// gathers, the terms whose pixel leaves the frame dropped:
//
//   grad_f1[c, p] = sum_d G[d, p] * f2[c, p + d]
//   grad_f2[c, q] = sum_d G[d, q - d] * f1[c, q - d]
//
// Replaces no TPU kernel: vfidkr_tpu/ops/correlation.py is plain XLA.  It takes the place of
// PyTorch's materialised (N, C, 9, 9, H, W) product of an unfold view of the padded f2 with
// f1, its channel sum, the division by C and the LeakyReLU (five launches and two passes
// over a tensor 81 times the features), and of autograd's backward of that chain
// (unfold_backward and two more products of the same size).
//
// What bounds it on the H100: bytes.  The forward reads f1 and f2 once and writes 81
// channels: (2 C + 81) * 4 bytes a pixel against 2 * 81 * C operations, 6.5 to 16.8
// operations a byte at C = 32 to 196, under the card's 20 (67 TFLOP/s f32 over 3.35 TB/s).
// Level 2 of a 1984 x 1152 pair (2 x 288 x 496 pixels, C = 32) is 166 MB: 49.5 us.  The
// backward reads g and out (81 channels each), f1 and f2, and writes both gradients.  True
// float32 throughout: no TF32, no tensor cores.
//
// Design: every value leaves device memory once a block; the 81-fold reuse comes from
// shared memory and registers, and the product never exists in device memory.
// - A block of 288 threads owns a tile of 4 x 32 output pixels of one image.  Its 9 warps
//   are one displacement row dy each: a lane owns 4 consecutive pixels of a row and the 9
//   dx of its warp's dy, 36 sums in registers.
// - The channels run 8 a stage (4 in the backward) through a 3-stage ring in shared memory
//   filled by cp.async: f1's tile and f2's halo, the tile widened by the 4-pixel reach of
//   the displacements on every side (12 x 40 values a channel, zeros outside the frame), by
//   16-byte copies where W is a multiple of 4 (4-byte copies otherwise).  The halo is the
//   only value read more than once, by the neighbouring tiles, and from L2.  For a channel
//   a lane loads its 4 f1 values and 12 values of the f2 row at its dy (a warp reads 8
//   consecutive float4s a row: no bank conflicts) and runs 36 FFMAs.
// - One tile and one ring for every level: a tile of 8 rows (18 warps a block) and rings
//   of 5 and 8 stages, timed on an H100 at the 25 PWC-Net level shapes of the benchmark's
//   cells, were more than 5 % faster at one shape only (PERF.md, K13).
// - The epilogue divides by C, applies the LeakyReLU and stores each displacement's 4
//   values as a float4, a warp writing 4 rows of 128 bytes.
// - The backward runs the same tiles, twice (grad_f1 over f2's halo, grad_f2 over f1's):
//   each lane holds the 36 values of G its sums need (G at its own pixels for grad_f1, at
//   its pixels less each displacement for grad_f2), read once a block; per channel it sums
//   its 9 dx for its 4 pixels, the 9 dy warps' partials meet in shared memory and are
//   summed in dy order.  No atomics, no scratch in device memory: each output is summed in
//   one fixed order for its shape, so two runs give the same bits.
// C only sets the trip count of the channel loop; N, H and W take any value.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MD = 4;                   // max displacement
constexpr int DW = 2 * MD + 1;          // displacements along an axis
constexpr int ND = DW * DW;             // output channels
constexpr float SLOPE = 0.1f;           // the LeakyReLU's
constexpr int TW = 32;                  // tile columns
constexpr int QW = 4;                   // columns a lane
constexpr int QUADS = TW / QW;          // lanes a tile row
constexpr int HS = TW + 2 * MD;         // halo row: frame columns x0 - 4 .. x0 + 35
constexpr int TH = 32 / QUADS;          // tile rows: a warp covers the tile
constexpr int THREADS = DW * 32;        // a warp for each dy
constexpr int HR = TH + 2 * MD;         // halo rows
constexpr int TILE = TH * TW;           // floats of a channel's tile
constexpr int HALO = HR * HS;           // floats of a channel's halo
constexpr int STAGES = 3;
constexpr int CK = 8;                   // channels a stage, forward
constexpr int CKB = 4;                  // channels a stage, backward
constexpr int FWD_STAGE = CK * (TILE + HALO);   // f1's tiles, then f2's halos
constexpr int FWD_SMEM = 4 * STAGES * FWD_STAGE;
constexpr int BWD_STAGE = CKB * HALO;
constexpr int PART = DW * CKB * TILE;           // [dy][channel][row][column]
constexpr int BWD_SMEM = 4 * (STAGES * BWD_STAGE + PART);

static_assert(QW + 2 * MD == 12, "a lane reads 12 halo values: three float4s");

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

// Copy a ROWS x COLS box at frame row yb and column xb (xb a multiple of 4) of channels
// c0 .. c0 + nc - 1 of xn into s, channel cc at s + cc * stride; zeros outside the frame.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_box(float* s, int stride, const float* __restrict__ xn,
                                         size_t plane, int c0, int nc, int h, int w, int yb,
                                         int xb, int vec, int tid) {
  if (vec) {
    // W % 4 == 0: a 16-byte chunk lies wholly inside or outside a row
    constexpr int CH = COLS / 4, PER = ROWS * CH;
    for (int p = tid; p < nc * PER; p += THREADS) {
      const int cc = p / PER, rem = p - cc * PER;
      const int r = rem / CH, k = rem - r * CH;
      const int y = yb + r, x = xb + 4 * k;
      const bool ok = (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
      // outside the frame: a zero fill, reading nothing
      cp_async16(s + cc * stride + r * COLS + 4 * k,
                 ok ? xn + (size_t)(c0 + cc) * plane + (size_t)y * w + x : xn, ok ? 16 : 0);
    }
  } else {
    constexpr int PER = ROWS * COLS;
    for (int p = tid; p < nc * PER; p += THREADS) {
      const int cc = p / PER, rem = p - cc * PER;
      const int r = rem / COLS, k = rem - r * COLS;
      const int y = yb + r, x = xb + k;
      const bool ok = (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
      cp_async4(s + cc * stride + r * COLS + k,
                ok ? xn + (size_t)(c0 + cc) * plane + (size_t)y * w + x : xn, ok ? 4 : 0);
    }
  }
}

// A lane's 12 halo values from b: three float4s.
__device__ __forceinline__ void load12(const float* b, float (&v)[12]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(b + 4 * k);
    v[4 * k] = u.x;
    v[4 * k + 1] = u.y;
    v[4 * k + 2] = u.z;
    v[4 * k + 3] = u.w;
  }
}

__global__ void __launch_bounds__(THREADS)
    correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       float* __restrict__ out, int c, int h, int w, int tiles_x, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int dyi = tid >> 5;                              // the warp's dy + 4
  const int row = lane / QUADS, q = lane % QUADS;        // the lane's tile row, quad
  const int ty = (int)blockIdx.x / tiles_x, txi = (int)blockIdx.x - ty * tiles_x;
  const int n = (int)blockIdx.y;
  const int y0 = ty * TH, x0 = txi * TW;
  const size_t plane = (size_t)h * w;
  const float* f1n = f1 + (size_t)n * c * plane;
  const float* f2n = f2 + (size_t)n * c * plane;
  const int nst = (c + CK - 1) / CK;

  auto load = [&](int t) {
    float* s = smem + (t % STAGES) * FWD_STAGE;
    const int c0 = t * CK, nc = min(CK, c - c0);
    load_box<TH, TW>(s, TILE, f1n, plane, c0, nc, h, w, y0, x0, vec, tid);
    load_box<HR, HS>(s + CK * TILE, HALO, f2n, plane, c0, nc, h, w, y0 - MD, x0 - MD, vec,
                     tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }

  float acc[DW][QW];
#pragma unroll
  for (int j = 0; j < DW; ++j)
#pragma unroll
    for (int i = 0; i < QW; ++i) acc[j][i] = 0.0f;

#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage consumed in the last iteration: every thread is past it
    if (t + STAGES - 1 < nst) load(t + STAGES - 1);
    cp_async_commit();

    const float* s = smem + (t % STAGES) * FWD_STAGE;
    const float* a_base = s + row * TW + QW * q;
    // f2's halo row of the lane's row at its dy; column 0 of v is frame column x - 4
    const float* b_base = s + CK * TILE + (row + dyi) * HS + QW * q;
    const int nc = min(CK, c - t * CK);
#pragma unroll
    for (int cc = 0; cc < CK; ++cc) {
      if (cc < nc) {
        const float4 a4 = *reinterpret_cast<const float4*>(a_base + cc * TILE);
        const float a[QW] = {a4.x, a4.y, a4.z, a4.w};
        float v[12];
        load12(b_base + cc * HALO, v);
#pragma unroll
        for (int j = 0; j < DW; ++j)
#pragma unroll
          for (int i = 0; i < QW; ++i) acc[j][i] = fmaf(a[i], v[i + j], acc[j][i]);
      }
    }
  }

  const int y = y0 + row, x = x0 + QW * q;
  if (y >= h || x >= w) return;
  const float cf = (float)c;
  float* dst = out + ((size_t)n * ND + dyi * DW) * plane + (size_t)y * w + x;
#pragma unroll
  for (int j = 0; j < DW; ++j, dst += plane) {
    float r[QW];
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const float u = acc[j][i] / cf;
      r[i] = u > 0.0f ? u : u * SLOPE;
    }
    if (vec) {
      // W % 4 == 0, so x + 3 < W
      *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int i = 0; i < QW; ++i)
        if (x + i < w) dst[i] = r[i];
    }
  }
}

// MODE 0: grad_f1 = x's gradient for x = f1, reading f2's halo (src) and G at the lane's
// own pixels.  MODE 1: grad_f2, reading f1's halo and G at the lane's pixels less each
// displacement.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    correlation_bwd_kernel(const float* __restrict__ src, const float* __restrict__ g,
                    const float* __restrict__ out, float* __restrict__ grad, int c, int h,
                    int w, int tiles_x, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int dyi = tid >> 5;
  const int row = lane / QUADS, q = lane % QUADS;
  const int ty = (int)blockIdx.x / tiles_x, txi = (int)blockIdx.x - ty * tiles_x;
  const int n = (int)blockIdx.y;
  const int y0 = ty * TH, x0 = txi * TW;
  const int y = y0 + row, x = x0 + QW * q;
  const size_t plane = (size_t)h * w;
  const float* srcn = src + (size_t)n * c * plane;
  const int nst = (c + CKB - 1) / CKB;

  auto load = [&](int t) {
    const int c0 = t * CKB;
    load_box<HR, HS>(smem + (t % STAGES) * BWD_STAGE, HALO, srcn, plane, c0,
                     min(CKB, c - c0), h, w, y0 - MD, x0 - MD, vec, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }

  // the lane's G: 9 dx x 4 pixels, 0 where the pixel it is read at leaves the frame
  const float cf = (float)c;
  float gr[DW][QW];
#pragma unroll
  for (int j = 0; j < DW; ++j) {
    const size_t base = ((size_t)n * ND + dyi * DW + j) * plane;
    const int py = MODE == 0 ? y : y - (dyi - MD);
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const int px = MODE == 0 ? x + i : x + i - (j - MD);
      float v = 0.0f;
      if ((unsigned)py < (unsigned)h && (unsigned)px < (unsigned)w) {
        const size_t o = base + (size_t)py * w + px;
        const float gg = __ldg(g + o);
        v = (__ldg(out + o) > 0.0f ? gg : gg * SLOPE) / cf;
      }
      gr[j][i] = v;
    }
  }

  float* part = smem + STAGES * BWD_STAGE;
  // the halo row the lane reads: its row shifted by +dy (MODE 0) or -dy (MODE 1)
  const int hrow = MODE == 0 ? row + dyi : row + 2 * MD - dyi;
  float* mine = part + dyi * CKB * TILE + row * TW + QW * q;

#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < nst) load(t + STAGES - 1);
    cp_async_commit();

    const float* b_base = smem + (t % STAGES) * BWD_STAGE + hrow * HS + QW * q;
    const int nc = min(CKB, c - t * CKB);
#pragma unroll
    for (int cc = 0; cc < CKB; ++cc) {
      if (cc < nc) {
        float v[12];
        load12(b_base + cc * HALO, v);
        float p[QW];
#pragma unroll
        for (int i = 0; i < QW; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < DW; ++j)
            s = fmaf(gr[j][i], v[MODE == 0 ? i + j : i + 2 * MD - j], s);
          p[i] = s;
        }
        *reinterpret_cast<float4*>(mine + cc * TILE) = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
    __syncthreads();

    // the 9 dy warps' partials summed in dy order, a float4 a thread
    const int c0 = t * CKB;
    constexpr int Q4 = TILE / 4;
    for (int f = tid; f < nc * Q4; f += THREADS) {
      const int cc = f / Q4, rem = f - cc * Q4;
      const int r = rem / QUADS, k = rem - r * QUADS;
      const float* pp = part + cc * TILE + r * TW + QW * k;
      float4 sum = *reinterpret_cast<const float4*>(pp);
#pragma unroll
      for (int j = 1; j < DW; ++j) {
        const float4 u = *reinterpret_cast<const float4*>(pp + j * CKB * TILE);
        sum.x += u.x;
        sum.y += u.y;
        sum.z += u.z;
        sum.w += u.w;
      }
      const int yy = y0 + r, xx = x0 + QW * k;
      if (yy >= h || xx >= w) continue;
      float* dst = grad + ((size_t)n * c + c0 + cc) * plane + (size_t)yy * w + xx;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = sum;
      } else {
        const float r4[QW] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int i = 0; i < QW; ++i)
          if (xx + i < w) dst[i] = r4[i];
      }
    }
  }
}

// The kernels' dynamic shared-memory limits, set once for each device (CUDA keeps
// function attributes per device; one bit a device ordinal, set by any thread).
cudaError_t configure_device(int device) {
  static std::atomic<unsigned long long> configured{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0ULL;
  if (bit != 0 && (configured.load() & bit)) return cudaSuccess;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(correlation_kernel, a, FWD_SMEM);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(correlation_bwd_kernel<0>, a, BWD_SMEM);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(correlation_bwd_kernel<1>, a, BWD_SMEM);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

bool aligned(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t prepare(int n, int c, int h, int w) {
  if (n < 1 || n > 65535 || c < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? configure_device(device) : err;
}

}  // namespace

// f1, f2 (N, C, H, W), out (N, 81, H, W): float32, contiguous, out disjoint from the
// inputs.  Returns 0 or a CUDA runtime error.
extern "C" int vfidkr_correlation(const float* f1, const float* f2, float* out, int n, int c,
                                  int h, int w, cudaStream_t stream) {
  cudaError_t err = prepare(n, c, h, w);
  if (err != cudaSuccess) return (int)err;
  const int vec = w % 4 == 0 && aligned(f1) && aligned(f2) && aligned(out);
  const int tiles_x = (w + TW - 1) / TW;
  const dim3 grid(tiles_x * ((h + TH - 1) / TH), n);
  correlation_kernel<<<grid, THREADS, FWD_SMEM, stream>>>(f1, f2, out, c, h, w, tiles_x, vec);
  return (int)cudaGetLastError();
}

// f1, f2 (N, C, H, W) and out, g (N, 81, H, W) as the forward saw and gave them, g the
// gradient of out; gf1, gf2 (N, C, H, W) the gradients of f1 and f2, each NULL where it is
// not wanted (its kernel is not launched).  float32, contiguous.
extern "C" int vfidkr_correlation_bwd(const float* f1, const float* f2, const float* out,
                                      const float* g, float* gf1, float* gf2, int n, int c,
                                      int h, int w, cudaStream_t stream) {
  cudaError_t err = prepare(n, c, h, w);
  if (err != cudaSuccess) return (int)err;
  const int vec = w % 4 == 0 && aligned(f1) && aligned(f2) && aligned(gf1) && aligned(gf2);
  const int tiles_x = (w + TW - 1) / TW;
  const dim3 grid(tiles_x * ((h + TH - 1) / TH), n);
  if (gf1 != nullptr)
    correlation_bwd_kernel<0><<<grid, THREADS, BWD_SMEM, stream>>>(f2, g, out, gf1, c, h, w,
                                                                   tiles_x, vec);
  if (gf2 != nullptr)
    correlation_bwd_kernel<1><<<grid, THREADS, BWD_SMEM, stream>>>(f1, g, out, gf2, c, h, w,
                                                                   tiles_x, vec);
  return (int)cudaGetLastError();
}
