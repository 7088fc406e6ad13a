// K14 adacof: AdaCoF's output in float32, both frames' adaptive collaboration of flows and
// their occlusion blend in one launch, on the CUDA cores of Hopper (sm_90a):
//
//   out[n, c, y, x] = V T_0 + (1 - V) T_2,  V = occ[n, 0, y, x],
//   T_k[c] = sum_{t < F*F} W_k[t] * bilinear(P_k[c], y + i D + alpha_k[t], x + j D + beta_k[t])
//
// with t = i F + j, P_k frame k replication-padded by pad = D (F - 1) / 2 (never materialised:
// the frame is read with clamped coordinates), the offset split at its floor (A = floor(alpha),
// a = alpha - A) and each of the four corners clamped to the padded frame.  Frames and out
// are (N, 3, H, W), the weights and offsets (N, F*F, H, W), occ (N, 1, H, W), all NCHW,
// contiguous, float32, as models/adacof.py makes them.  The wrapper is
// vfidkr_torch/ops/adacof.py:adacof_pair; its plain version is adacof_pair_plain.
//
// Replaces no TPU kernel: the JAX package has no AdaCoF.  It was added for AdaCoF+, whose
// sampling as plain PyTorch is 121 gathers of four corners a frame.
//
// What bounds it on the H100: bytes.  A pixel reads 3 F^2 floats a frame (W, alpha, beta:
// 1,452 bytes at F = 11), each once; at 1984 x 1152 the pair moves 6.73 GB (2.0 ms at
// 3.35 TB/s) against 2 x 121 x 12 frame values a pixel, about 6.6 G multiply-adds (0.2 ms
// at 67 TFLOP/s).  The frame values are gathered at learned, sub-pixel positions, so they
// must come from on-chip memory, not from HBM a tap.
//
// Design.  A block of 256 threads owns a tile of 8 x 32 output pixels, a thread a pixel.
// - The tile's box of the padded frame, its F x F window widened by MARGIN px on every
//   side (3 planes of (8 + (F-1) D + 2 MARGIN + 1) x (32 + (F-1) D + 2 MARGIN + 1) floats,
//   42,924 bytes at F = 11, D = 2), is staged in shared memory, a warp a box row, one
//   frame after the other.  A tap whose corners leave the box (an offset past MARGIN px)
//   reads them from global memory through L1.
// - W, alpha and beta stream from HBM once, a plane a tap: each warp's loads are 128
//   contiguous bytes, evict-first (`__ldcs`), issued DEPTH taps ahead of their use so that
//   3 x DEPTH loads a thread are in flight.
// - Per tap the thread forms the four corners' weights (W times the bilinear weights) and
//   adds them times the 3 channels' corner values: 12 multiply-adds from 12 shared loads.
// - Both frames' sums stay in 6 registers; the blend with V is the epilogue.  Each output
//   is summed in one fixed order and no atomics are used: two runs give the same bits.
// ptxas: 64 registers, no spills, 4 blocks an SM.  At 1984 x 1152, F = 11, D = 2 it takes
// 3.18-3.23 ms on an H100 80GB HBM3 (62-63 % of the bytes bound; 65 % in the benchmark's
// traced pairs).  H, W, N, F (odd) and D take any value whose box fits in shared memory.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int C = 3;                     // channels
constexpr int TH = 8;                    // output rows of a tile
constexpr int TW = 32;                   // output columns of a tile
constexpr int THREADS = TH * TW;         // 256, a thread a pixel
constexpr int MARGIN = 10;               // staged px on every side beyond the window
constexpr int DEPTH = 4;                 // taps loaded ahead

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

struct Geometry {
  int h, w, f, dil, pad, hp, wp;         // frame, taps a side, dilation, pad, padded frame
  int box_rows, box_cols;                // the staged box
};

// Stage frame `img`'s box (padded coordinates from (br, bc)) in shared memory, a warp a
// box row at a time, each value read from the frame at clamped coordinates.
__device__ __forceinline__ void stage_box(float* box, const float* __restrict__ img,
                                          const Geometry& g, int br, int bc, int tid) {
  const size_t plane = (size_t)g.h * g.w;
  const int lane = tid & 31, warp = tid >> 5;
  for (int row = warp; row < C * g.box_rows; row += THREADS / 32) {
    const int c = row / g.box_rows, r = row - c * g.box_rows;
    const float* src = img + c * plane + (size_t)clampi(br + r - g.pad, g.h - 1) * g.w;
    float* dst = box + row * g.box_cols;
    for (int col = lane; col < g.box_cols; col += 32)
      dst[col] = __ldg(src + clampi(bc + col - g.pad, g.w - 1));
  }
}

// One tap of one frame: acc[c] += W * bilinear(P[c], corners of (r0, c0)), (r0, c0) the
// padded coordinates of the unclamped top-left corner.
__device__ __forceinline__ void tap(float (&acc)[C], const float* box, const float* __restrict__ img,
                                    const Geometry& g, int br, int bc, int r0, int c0, float wt,
                                    float ta, float tb) {
  const int r0c = clampi(r0, g.hp - 1), r1c = clampi(r0 + 1, g.hp - 1);
  const int c0c = clampi(c0, g.wp - 1), c1c = clampi(c0 + 1, g.wp - 1);
  const float k00 = wt * (1.0f - ta) * (1.0f - tb), k01 = wt * (1.0f - ta) * tb;
  const float k10 = wt * ta * (1.0f - tb), k11 = wt * ta * tb;
  const int lr = r0c - br, lc = c0c - bc;
  if (lr >= 0 && r1c - br < g.box_rows && lc >= 0 && c1c - bc < g.box_cols) {
    const int plane = g.box_rows * g.box_cols;
    const float* p = box + lr * g.box_cols + lc;
    const int dx = c1c - c0c, dy = (r1c - r0c) * g.box_cols;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* q = p + c * plane;
      acc[c] = fmaf(k00, q[0], acc[c]);
      acc[c] = fmaf(k01, q[dx], acc[c]);
      acc[c] = fmaf(k10, q[dy], acc[c]);
      acc[c] = fmaf(k11, q[dy + dx], acc[c]);
    }
  } else {
    const size_t plane = (size_t)g.h * g.w;
    const int fr0 = clampi(r0c - g.pad, g.h - 1), fr1 = clampi(r1c - g.pad, g.h - 1);
    const int fc0 = clampi(c0c - g.pad, g.w - 1), fc1 = clampi(c1c - g.pad, g.w - 1);
    const float* p0 = img + (size_t)fr0 * g.w;
    const float* p1 = img + (size_t)fr1 * g.w;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] = fmaf(k00, __ldg(p0 + c * plane + fc0), acc[c]);
      acc[c] = fmaf(k01, __ldg(p0 + c * plane + fc1), acc[c]);
      acc[c] = fmaf(k10, __ldg(p1 + c * plane + fc0), acc[c]);
      acc[c] = fmaf(k11, __ldg(p1 + c * plane + fc1), acc[c]);
    }
  }
}

// The sum of one frame at pixel (y, x): its F*F taps, their maps loaded DEPTH taps ahead.
// `wt`, `al`, `be` point at the pixel in the maps' first plane.
__device__ __forceinline__ void frame_sum(float (&acc)[C], const float* box,
                                          const float* __restrict__ img,
                                          const float* __restrict__ wt,
                                          const float* __restrict__ al,
                                          const float* __restrict__ be, const Geometry& g, int br,
                                          int bc, int y, int x) {
  const size_t plane = (size_t)g.h * g.w;
  const int taps = g.f * g.f;
  float qw[DEPTH], qa[DEPTH], qb[DEPTH];
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    const bool live = k < taps;
    qw[k] = live ? __ldcs(wt + k * plane) : 0.0f;
    qa[k] = live ? __ldcs(al + k * plane) : 0.0f;
    qb[k] = live ? __ldcs(be + k * plane) : 0.0f;
  }
  int i = 0, j = 0;
#pragma unroll 1
  for (int t0 = 0; t0 < taps; t0 += DEPTH) {
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int t = t0 + k;
      if (t >= taps) break;
      const float wv = qw[k], av = qa[k], bv = qb[k];
      const int tn = t + DEPTH;
      if (tn < taps) {
        qw[k] = __ldcs(wt + tn * plane);
        qa[k] = __ldcs(al + tn * plane);
        qb[k] = __ldcs(be + tn * plane);
      }
      const float fa = floorf(av), fb = floorf(bv);
      // the corner's row and column as ints: the floor clamped first, so that no offset
      // overflows (a clamped floor still clamps the corner to the padded frame's edge)
      const int ia = __float2int_rz(fminf(fmaxf(fa, -(float)g.hp), (float)g.hp));
      const int ib = __float2int_rz(fminf(fmaxf(fb, -(float)g.wp), (float)g.wp));
      tap(acc, box, img, g, br, bc, y + i * g.dil + ia, x + j * g.dil + ib, wv, av - fa,
          bv - fb);
      if (++j == g.f) {
        j = 0;
        ++i;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 4)
    adacof_kernel(const float* __restrict__ i0, const float* __restrict__ w0,
                  const float* __restrict__ a0, const float* __restrict__ b0,
                  const float* __restrict__ i2, const float* __restrict__ w2,
                  const float* __restrict__ a2, const float* __restrict__ b2,
                  const float* __restrict__ occ, float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) float box[];
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int y = y0 + tid / TW, x = x0 + tid % TW;
  const bool inside = y < g.h && x < g.w;
  const size_t plane = (size_t)g.h * g.w;
  const size_t maps = (size_t)n * g.f * g.f * plane + (inside ? (size_t)y * g.w + x : 0);
  // the box's first row and column in the padded frame: the tile's window starts at (y0, x0)
  const int br = y0 - MARGIN, bc = x0 - MARGIN;

  float acc[2][C];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.0f;

  // unrolled: acc[k] must stay in registers
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* img = (k == 0 ? i0 : i2) + (size_t)n * C * plane;
    if (k) __syncthreads();  // every thread is done with frame 0's box
    stage_box(box, img, g, br, bc, tid);
    __syncthreads();
    if (inside)
      frame_sum(acc[k], box, img, (k == 0 ? w0 : w2) + maps, (k == 0 ? a0 : a2) + maps,
                (k == 0 ? b0 : b2) + maps, g, br, bc, y, x);
  }

  if (!inside) return;
  const size_t px = (size_t)y * g.w + x;
  const float v = __ldg(occ + (size_t)n * plane + px);
  float* o = out + (size_t)n * C * plane + px;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * plane] = v * acc[0][c] + (1.0f - v) * acc[1][c];
}

// The kernel's dynamic shared-memory limit, set once for each device to the device's
// opt-in maximum (CUDA keeps function attributes per device; one bit a device ordinal).
cudaError_t configure_device(int device, int* optin) {
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ULL << device : 0ULL;
  if (bit != 0 && (configured.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(adacof_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

}  // namespace

// i0, i2 (N, 3, H, W), w0, a0, b0, w2, a2, b2 (N, F*F, H, W), occ (N, 1, H, W), out
// (N, 3, H, W): float32, contiguous; F odd, dilation >= 1.  Returns 0 or a CUDA runtime
// error (cudaErrorInvalidValue where the box does not fit in shared memory).
extern "C" int vfidkr_adacof(const float* i0, const float* w0, const float* a0, const float* b0,
                             const float* i2, const float* w2, const float* a2, const float* b2,
                             const float* occ, float* out, int n, int h, int width, int f,
                             int dilation, cudaStream_t stream) {
  if (n < 1 || h < 1 || width < 1 || f < 1 || f % 2 == 0 || dilation < 1)
    return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = configure_device(device, &optin);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  g.h = h;
  g.w = width;
  g.f = f;
  g.dil = dilation;
  g.pad = dilation * (f - 1) / 2;
  g.hp = h + 2 * g.pad;
  g.wp = width + 2 * g.pad;
  g.box_rows = TH + (f - 1) * dilation + 2 * MARGIN + 1;
  g.box_cols = TW + (f - 1) * dilation + 2 * MARGIN + 1;
  const size_t smem = (size_t)C * g.box_rows * g.box_cols * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const dim3 grid((width + TW - 1) / TW, (h + TH - 1) / TH, n);
  adacof_kernel<<<grid, THREADS, smem, stream>>>(i0, w0, a0, b0, i2, w2, a2, b2, occ, out, g);
  return (int)cudaGetLastError();
}
