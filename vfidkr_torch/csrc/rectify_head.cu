// K8 rectify_head: the rectifier's head in float32, relu(conv2d(x, w, b)) for a 7x7
// kernel at stride 1 and padding 3, from C input channels to 128, on the CUDA cores
// (FFMA) of Hopper (sm_90a).  x is (N, C, H, W) and out (N, 128, H, W), both NCHW and
// contiguous; w is (128, C, 7, 7) and b (128), as block1.0 of MultipleBasicBlock
// holds them (vfidkr_torch/models/resblock.py).  The wrapper is
// vfidkr_torch/ops/conv_head.py:rectify_head.
//
// Replaces no TPU kernel: the JAX package's head is a plain XLA conv
// (vfidkr_tpu/models/resblock.py:78).  It takes the place of cuDNN's float32 conv for
// block1, for which cuDNN's heuristic picks its generic implicit_convolve_sgemm at
// about a third of the FFMA peak, at C = 45 (DAIN) and C = 437 (DAIN_slowmotion)
// alike: neither is a multiple of 8.  At C = 437 and 1344 x 768 that conv is the
// largest single operation of a slow-motion frame.
//
// What bounds it on the H100: operations.  At C = 437, (1, 437, 768, 1344) is
// 2 * 49 * 437 * 128 * 1,032,192 = 5.66 TFLOP (84.4 ms at 67 TFLOP/s, the f32 peak
// outside the tensor cores) against 2.33 GB in and out (0.7 ms at 3.35 TB/s): about
// 2,400 operations a byte.  True float32 throughout: no TF32, no tensor cores.
//
// Design: an implicit GEMM on the CUDA cores, M = output pixels, N = the 128 output
// channels, K = C x 49, with no buffer beyond the output (no im2col, no NHWC copy, no
// repacked weights, no split-K) and no atomics: every output is summed in one fixed
// order (input channel, then kernel row, then kernel column), so two runs give the
// same bits.
// - A block of 256 threads computes a tile of 8 x 32 output pixels x 128 channels.
//   Each thread holds 16 consecutive pixels of one row x 8 channels: 128 f32
//   accumulators in registers.
// - The K loop walks the input channels, one a stage, through a 6-stage ring in
//   shared memory filled by cp.async: the channel's 14 x 38 input halo (zeros
//   outside the frame: the padding and the ragged edges) and its 49 x 128 weights,
//   transposed on the way in to [tap][out channel] (rows padded to 132 floats, so
//   that the 4-byte copies of a warp land on 32 banks).  One __syncthreads a stage.
// - For each kernel row a thread loads its 22 halo values (6 16-byte loads; the
//   halo rows are padded to 44 floats so that 8 threads of a quarter warp hit 8
//   bank groups), and for each of the 7 kernel columns the 8 weights of its channels
//   (2 16-byte loads, a broadcast within the quarter warp), then makes 128 FFMAs:
//   the column shift is a shift of registers, so 20 shared loads feed 896 FFMAs.
// - Epilogue: the bias, ReLU, and 16-byte stores of each channel's 16 pixels (4-byte
//   stores on a ragged edge or where W is not a multiple of 4).
// C only sets the trip count of the K loop; H, W and N take any value.  Shared
// memory: 6 stages of 28,336 bytes, one block an SM.  ptxas gives 185 registers a
// thread with 5, 6 or 7 stages and 255 with 4 or 8, which ran 3-5 % slower on the
// H100 at both C = 45 and C = 437.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int CO = 128;                  // output channels
constexpr int KS = 7;                    // kernel size
constexpr int PAD = 3;
constexpr int TAPS = KS * KS;
constexpr int TH = 8;                    // output rows of a tile
constexpr int TW = 32;                   // output columns of a tile
constexpr int PX = 16;                   // a thread's pixels, consecutive in one row
constexpr int CT = 8;                    // a thread's output channels
constexpr int THREADS = 256;             // (TH * TW / PX) x (CO / CT)
constexpr int HR = TH + KS - 1;          // halo rows
constexpr int HC = TW + KS - 1;          // halo columns
constexpr int HS = 44;                   // halo row stride, floats
constexpr int AREG = PX + 8;             // halo values loaded a row (PX + KS - 1 used)
constexpr int WS = CO + 4;               // weight row stride, floats
constexpr int HALO = HR * HS;
constexpr int STAGE = HALO + TAPS * WS;  // floats
constexpr int STAGES = 6;
constexpr int SMEM_BYTES = STAGES * STAGE * 4;
constexpr int WCOPIES = 28;              // a thread's weight copies a stage (7 x 4)

static_assert(THREADS == (TH * TW / PX) * (CO / CT), "one thread a 16 x 8 tile");
static_assert(HS % 4 == 0 && HS >= TW - PX + AREG, "halo rows hold the loads");
static_assert(WCOPIES * THREADS >= 8 * 7 * CO && 8 * 6 < TAPS, "weights copied");

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

// Copy input channel ci's halo and weights into stage s.
__device__ __forceinline__ void load_stage(float* s, const float* __restrict__ xc,
                                           const float* __restrict__ wc, int c,
                                           int h, int w, int y0, int x0, int tid) {
  for (int e = tid; e < HR * HC; e += THREADS) {
    const int hr = e / HC, hc = e - hr * HC;
    const int y = y0 - PAD + hr, x = x0 - PAD + hc;
    const bool in = (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
    // outside the frame: a zero fill, reading nothing
    cp_async4(s + hr * HS + hc, in ? xc + (size_t)y * w + x : xc, in ? 4 : 0);
  }
  // w[co][ci][tap] -> [tap][co]: a warp copies 8 taps of 4 channels, 32-byte runs
  // in device memory and 32 distinct banks in shared memory
  float* sw = s + HALO;
  const int klo = tid & 7, co0 = tid >> 3;
  const size_t co_stride = (size_t)c * TAPS;
  const float* src = wc + co0 * co_stride + klo;
#pragma unroll
  for (int i = 0; i < WCOPIES; ++i) {
    const int k = (i >> 2) * 8 + klo;
    const int co = co0 + 32 * (i & 3);
    if (k < TAPS)
      cp_async4(sw + k * WS + co, src + 32 * (i & 3) * co_stride + (i >> 2) * 8, 4);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    rectify_head_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                        const float* __restrict__ bias, float* __restrict__ out, int c,
                        int h, int w) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // a warp: 8 pixel groups (4 rows x 2 halves) x 4 channel groups
  const int pg = (warp & 1) * 8 + (lane & 7);
  const int cg = (warp >> 1) * 4 + (lane >> 3);
  const int r = pg >> 1, tx0 = (pg & 1) * PX;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)h * w;
  const float* xn = x + (size_t)n * c * plane;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < c) load_stage(smem + s * STAGE, xn + s * plane, wt + s * TAPS, c, h, w, y0,
                          x0, tid);
    cp_async_commit();
  }

  float acc[PX][CT];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;

#pragma unroll 1
  for (int ci = 0; ci < c; ++ci) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage consumed in the last iteration: every thread is past it
    const int nx = ci + STAGES - 1;
    if (nx < c) load_stage(smem + (nx % STAGES) * STAGE, xn + nx * plane,
                           wt + nx * TAPS, c, h, w, y0, x0, tid);
    cp_async_commit();

    const float* s = smem + (ci % STAGES) * STAGE;
    const float* sa = s + r * HS + tx0;
    const float* sb = s + HALO + cg * CT;
#pragma unroll 1
    for (int ky = 0; ky < KS; ++ky) {
      float a[AREG];
#pragma unroll
      for (int m = 0; m < AREG / 4; ++m) {
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

  const int y = y0 + r;
  if (y >= h) return;
  const int xb = x0 + tx0;
  const bool vec = (w % 4 == 0) && xb + PX <= w;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int co = cg * CT + j;
    const float bj = bias[co];
    float* o = out + (((size_t)n * CO + co) * h + y) * w + xb;
    float v[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const float t = acc[i][j] + bj;
      v[i] = t < 0.0f ? 0.0f : t;  // as torch.relu: a NaN stays NaN
    }
    if (vec) {
#pragma unroll
      for (int m = 0; m < PX / 4; ++m)
        reinterpret_cast<float4*>(o)[m] =
            make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < PX; ++i)
        if (xb + i < w) o[i] = v[i];
    }
  }
}

// The kernel's dynamic shared-memory limit, set once for each device (CUDA keeps
// function attributes per device; one bit a device ordinal, set by any thread).
cudaError_t configure_device(int device) {
  static std::atomic<unsigned long long> configured{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0ULL;
  if (bit != 0 && (configured.load() & bit)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rectify_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

}  // namespace

// x (N, C, H, W), w (128, C, 7, 7), b (128), out (N, 128, H, W): float32, contiguous.
// Returns 0 or a CUDA runtime error.
extern "C" int vfidkr_rectify_head(const float* x, const float* w, const float* b,
                                   float* out, int n, int c, int h, int width,
                                   cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = configure_device(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((width + TW - 1) / TW, (h + TH - 1) / TH, n);
  rectify_head_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(x, w, b, out, c, h, width);
  return (int)cudaGetLastError();
}
