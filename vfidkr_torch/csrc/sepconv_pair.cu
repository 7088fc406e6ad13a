// K9 sepconv_pair: SepConv's output in float32, both frames' separable local
// convolutions and their sum in one launch, on the CUDA cores (FFMA) of Hopper (sm_90a):
//
//   out[n, c, y, x] = sum over (P, v, h) in {(i0, v1, h1), (i2, v2, h2)} of
//                     sum_{j, i < 51} P[n, c, y + j - 25, x + i - 25] * v[n, j, y, x] * h[n, i, y, x]
//
// with P's coordinates clamped to the frame (the replication pad of 25 px, never
// materialised).  Frames and out are (N, 3, H, W), the filters (N, 51, H, W), all NCHW and
// contiguous, as models/sepconv.py makes them.  The wrapper is
// vfidkr_torch/ops/separable_conv.py:separable_conv_pair; its plain version is
// separable_conv_pair_plain.
//
// Replaces no TPU kernel: the JAX package computes separable_conv with static slices in
// XLA (vfidkr_tpu/ops/separable_conv.py), and no JAX model calls it.  It was added for
// SepConv, where the plain op is 51 x 51 slice products a frame, some 15,600 launches.
//
// What bounds it on the H100: operations.  A pixel of a frame and a channel is 51 x 51 +
// 51 multiply-adds; at 1984 x 1152 the pair is 72.7 GFLOP (1.09 ms at 67 TFLOP/s, the f32
// peak outside the tensor cores) against 1.95 GB of frames, filters and output (0.58 ms
// at 3.35 TB/s).  True float32 throughout: there is no tensor-core form of it at f32.
//
// Design.  The filters are per pixel, so no weight is shared between pixels; what is
// shared is the frame: a value of P is a tap of 51 x 51 pixels.  So a thread holds the
// horizontal taps of 4 neighbouring pixels of one row in registers and reads each frame
// value once from shared memory for all 4 of them:
// - A block of 192 threads computes a tile of 12 x 64 output pixels; a thread 4
//   consecutive pixels of one row (16 threads a row).  The frame's 62 x 114 patch of the
//   tile (clamped coordinates), 3 channels, is staged in shared memory by 4-byte
//   cp.async, a warp a patch row (rows padded to 116 floats), one frame after the other;
//   86,304 bytes, two blocks an SM.  The cp.async loader took the kernel from 2.72 to
//   2.45 ms at 1984 x 1152 against a thread an element through registers (H100).
// - The 51 horizontal taps go in three chunks (16, 16, 19): per chunk the thread keeps
//   the 4 pixels' taps of the chunk in registers (at most 76).  For each of the 51 rows
//   of taps and each channel it loads the row's 22 frame values it needs (16-byte
//   loads; chunk starts and the thread's column are multiples of 4), each used as it
//   arrives, makes the 4 row sums of the chunk (64 or 76 FFMAs) and adds each times its
//   pixel's vertical tap: out += v[j] * sum_i h[i] P[j][i] over the chunk.  The
//   vertical taps of the next row are loaded a row ahead.
// - One channel's 4 sums a pixel in 12 accumulators over both frames, then one write of
//   out (4-byte stores, guarded on the ragged edge).  Each output is summed in one
//   fixed order: two runs give the same bits.
// ptxas: 168 registers, no spills.  Tried and slower on the H100 at 1984 x 1152: 16-row
// tiles of 256 threads (128 registers, spills; 2.69-2.75 ms) or one block an SM (244
// registers; 3.09), more and smaller chunks (2.95-3.15), the two 16-tap chunks as one
// loop (2.63-2.67), and a thread of 2 x 4 pixels, which shares each frame value between
// two rows but spills at 255 registers (3.8-5.5).
// H, W and N take any value.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int C = 3;                     // channels
constexpr int FS = 51;                   // taps
constexpr int HALF = FS / 2;             // the replication pad
constexpr int TH = 12;                   // output rows of a tile
constexpr int TW = 64;                   // output columns of a tile
constexpr int PX = 4;                    // a thread's pixels, consecutive in one row
constexpr int THREADS = TH * TW / PX;    // 192
constexpr int PR = TH + FS - 1;          // patch rows (62)
constexpr int PC = TW + FS - 1;          // patch columns used (114)
constexpr int PS = 116;                  // patch row stride, floats
constexpr int PLANE = PR * PS;
constexpr int SMEM_BYTES = C * PLANE * 4;

static_assert(PS % 4 == 0 && PS >= PC, "patch rows hold the 16-byte loads");
static_assert(TW / PX == 16, "16 threads a row");

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Stage the tile's patch of frame f (clamped coordinates) in shared memory: a warp a
// patch row at a time, its lanes along the row, by 4-byte cp.async, and wait for it.
__device__ __forceinline__ void load_patch(float* sp, const float* __restrict__ f, int h, int w,
                                           int y0, int x0, int tid) {
  const size_t plane = (size_t)h * w;
  const int lane = tid & 31, warp = tid >> 5;
  int xs[(PS + 31) / 32];
#pragma unroll
  for (int k = 0; k < (PS + 31) / 32; ++k) xs[k] = clampi(x0 - HALF + lane + 32 * k, w - 1);
  for (int row = warp; row < C * PR; row += THREADS / 32) {
    const int c = row / PR, r = row - c * PR;
    const float* src = f + c * plane + (size_t)clampi(y0 - HALF + r, h - 1) * w;
    float* dst = sp + c * PLANE + r * PS;
#pragma unroll
    for (int k = 0; k < (PS + 31) / 32; ++k)
      if (lane + 32 * k < PS) cp_async4(dst + lane + 32 * k, src + xs[k]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One chunk of horizontal taps [I0, I0 + NI) of one frame: acc[c][p] +=
// sum_j v[j] * sum_{i in chunk} h[i] * P[c][j][i] for the thread's 4 pixels.  I0 is a
// multiple of 4 (the 16-byte loads).
template <int I0, int NI>
__device__ __forceinline__ void chunk(float (&acc)[C][PX], const float* sp,
                                      const float* __restrict__ vf, const float* __restrict__ hf,
                                      size_t plane, const bool (&inside)[PX]) {
  constexpr int SEG = (NI + PX - 1 + 3) / 4;  // 16-byte loads a row of taps
  float hr[PX][NI];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int p = 0; p < PX; ++p) hr[p][i] = inside[p] ? __ldg(hf + (I0 + i) * plane + p) : 0.0f;

  float v[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) v[p] = inside[p] ? __ldg(vf + p) : 0.0f;
#pragma unroll 1
  for (int j = 0; j < FS; ++j) {
    // the next row's vertical taps, loaded a row ahead
    float vn[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p)
      vn[p] = inside[p] && j + 1 < FS ? __ldg(vf + (j + 1) * plane + p) : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* row = sp + c * PLANE + j * PS + I0;
      // value k of the row is tap k - p of pixel p: each value is used as it
      // arrives, so few of them are live at once
      float t[PX] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < SEG; ++m) {
        const float4 q = *reinterpret_cast<const float4*>(row + 4 * m);
        const float a[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const int i = 4 * m + e - p;
            if (i >= 0 && i < NI) t[p] = fmaf(a[e], hr[p][i], t[p]);
          }
      }
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[c][p] = fmaf(v[p], t[p], acc[c][p]);
    }
#pragma unroll
    for (int p = 0; p < PX; ++p) v[p] = vn[p];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    sepconv_pair_kernel(const float* __restrict__ i0, const float* __restrict__ v1,
                        const float* __restrict__ h1, const float* __restrict__ i2,
                        const float* __restrict__ v2, const float* __restrict__ h2,
                        float* __restrict__ out, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lx = tid & 15, ly = tid >> 4;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int y = y0 + ly, x = x0 + PX * lx;
  const size_t plane = (size_t)h * w;
  bool inside[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) inside[p] = y < h && x + p < w;
  // this thread's pixel (y, x) in a filter plane; unread where it lies outside
  const size_t at = (y < h && x < w) ? (size_t)y * w + x : 0;
  // the thread's first patch value: row ly, column PX * lx (tap (0, 0) of pixel x)
  const float* sp = smem + ly * PS + PX * lx;

  float acc[C][PX];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[c][p] = 0.0f;

#pragma unroll 1
  for (int f = 0; f < 2; ++f) {
    const float* img = (f == 0 ? i0 : i2) + (size_t)n * C * plane;
    const float* vf = (f == 0 ? v1 : v2) + (size_t)n * FS * plane + at;
    const float* hf = (f == 0 ? h1 : h2) + (size_t)n * FS * plane + at;
    if (f) __syncthreads();  // every thread is done with frame 0's patch
    load_patch(smem, img, h, w, y0, x0, tid);
    __syncthreads();
    chunk<0, 16>(acc, sp, vf, hf, plane, inside);
    chunk<16, 16>(acc, sp, vf, hf, plane, inside);
    chunk<32, 19>(acc, sp, vf, hf, plane, inside);
  }

  if (y >= h) return;
  float* o = out + (size_t)n * C * plane + (size_t)y * w + x;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int p = 0; p < PX; ++p)
      if (x + p < w) o[c * plane + p] = acc[c][p];
}

// The kernel's dynamic shared-memory limit, set once for each device (CUDA keeps
// function attributes per device; one bit a device ordinal, set by any thread).
cudaError_t configure_device(int device) {
  static std::atomic<unsigned long long> configured{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0ULL;
  if (bit != 0 && (configured.load() & bit)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sepconv_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

}  // namespace

// i0, i2 (N, 3, H, W), v1, h1, v2, h2 (N, 51, H, W), out (N, 3, H, W): float32,
// contiguous.  Returns 0 or a CUDA runtime error.
extern "C" int vfidkr_sepconv_pair(const float* i0, const float* v1, const float* h1,
                                   const float* i2, const float* v2, const float* h2,
                                   float* out, int n, int h, int width, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = configure_device(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((width + TW - 1) / TW, (h + TH - 1) / TH, n);
  sepconv_pair_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(i0, v1, h1, i2, v2, h2, out, h,
                                                             width);
  return (int)cudaGetLastError();
}
