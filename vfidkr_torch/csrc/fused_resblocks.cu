// K4 fused_resblocks: one 3x3 128->128 convolution of the rectifier's residual trunk
// (the bf16 eval lane) for NCHW bf16 tensors on Hopper (sm_90a), with its epilogue:
// the optional residual added in the f32 accumulator, ReLU, the cast to bf16.  The
// wrapper (vfidkr_torch/ops/rectify.py) launches it six times a call, conv1 and conv2
// of blocks 2, 3 and 4:
//   t = relu(conv(h, w[2k]))           -> bf16
//   h = relu(conv(t, w[2k+1]) + h)     -> bf16   (k = 0, 1, 2)
//
// Replaces: vfidkr_tpu/ops/pallas/rectify_kernel.py:fused_resblocks.  The TPU kernel
// keeps the whole (H, W, 128) activation in VMEM (100 MB) and runs the six convs as
// 9 shifted tap-dots each on the MXU, ping-ponging two buffers; its gate
// fused_resblocks_ok refuses frames whose activations do not fit.  A Hopper SM has
// 227 KB of shared memory, so here each conv is one launch over tiles of the frame,
// the activations go through device memory (and L2) between the launches, and any
// N, H, W is taken.
//
// Semantics (as the TPU kernel's): bf16 operands, exact products, f32 sums; the
// residual is the bf16 block input, added to the f32 accumulator before ReLU; each
// conv's output is rounded to bf16 (round to nearest even).  Zero padding of 1.
//
// Layouts: x, res, out (N,128,H,W) bf16; w (3,3,128,128) bf16, one conv's taps as
// [dy][dx][ci][co] (the wrapper permutes PyTorch's (co,ci,kh,kw)).  res may be NULL
// and may alias out: each output element is read as residual and then written by
// the same thread.
//
// What bounds it on the H100: operations.  A conv at (1,128,256,448) is 33.8 GFLOP
// (34.2 us at 989 TFLOP/s bf16) against 29.4 MB in and out (8.8 us at 3.35 TB/s).
// Design: an implicit GEMM on the tensor cores, M = output pixels, N = 128 output
// channels, K = 9 taps x 128 input channels, through nvcuda::wmma bf16 fragments
// (16x16x16, f32 accumulators).  A block of 8 warps computes a 4 x 32 pixel tile for
// all 128 output channels: the 6 x 34 input tile with its one-pixel halo is
// transposed into shared memory pixel-major (channels contiguous), so each tap's
// A fragment is the tile shifted by whole pixel rows; one tap's 128 x 128 weights
// are staged in shared memory at a time.  Each warp holds a 32-pixel x 64-channel
// accumulator (8 fragments).  The accumulators go through shared memory to the
// epilogue, which writes rows of the tile coalesced.  95.6 KB of shared memory a
// block, two blocks an SM.  No wgmma, TMA, pipelining or whole-chain residency yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int C = 128;            // channels in and out
constexpr int TH = 4;             // output rows of a block's tile
constexpr int TW = 32;            // output columns of a block's tile
constexpr int HR = TH + 2;        // input tile rows with the halo
constexpr int HC = TW + 2;        // input tile columns with the halo
constexpr int LDA = C + 16;       // bf16 elements per pixel of the input tile
constexpr int LDB = C + 16;       // bf16 elements per input channel of the weights
constexpr int LDO = TH * TW + 8;  // floats per output channel of the f32 tile
constexpr int THREADS = 256;      // 8 warps: 4 tile rows x 2 halves of the channels
constexpr int IN_ELEMS = HR * HC * LDA;
constexpr int W_ELEMS = C * LDB;
constexpr int SMEM_IN_W = (IN_ELEMS + W_ELEMS) * 2;
constexpr int SMEM_OUT = C * LDO * 4;
constexpr int SMEM_BYTES = SMEM_IN_W > SMEM_OUT ? SMEM_IN_W : SMEM_OUT;

// wmma wants 32-byte aligned fragment pointers: every pixel row of the input tile,
// every 16-channel step and the weights' offset must keep that alignment
static_assert((LDA * 2) % 32 == 0 && (LDB * 2) % 32 == 0, "fragment alignment");
static_assert((IN_ELEMS * 2) % 32 == 0 && (LDO * 4) % 32 == 0, "fragment alignment");

__global__ void __launch_bounds__(THREADS, 2)
    fused_resblocks_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* res, __nv_bfloat16* out, int h,
                           int width) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = in_s + IN_ELEMS;
  float* out_s = reinterpret_cast<float*>(smem);  // after the last tap

  const long long plane = (long long)h * width;
  const long long batch = (long long)blockIdx.z * C * plane;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;

  // the input tile and its halo, zero outside the frame, pixel-major: one item is
  // 8 channels of one pixel, read as 8 loads (each coalesced across the warp along
  // x) and stored as one 16-byte word
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x) + batch;
  for (int item = threadIdx.x; item < (C / 8) * HR * HC; item += THREADS) {
    const int pix = item % (HR * HC);
    const int c8 = item / (HR * HC);
    const int gy = y0 - 1 + pix / HC;
    const int gx = x0 - 1 + pix % HC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < h && gx >= 0 && gx < width) {
      const unsigned short* src = xs + (long long)(c8 * 8) * plane +
                                  (long long)gy * width + gx;
      unsigned int q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = src[j * plane];
      v = make_uint4(q[0] | (q[1] << 16), q[2] | (q[3] << 16),
                     q[4] | (q[5] << 16), q[6] | (q[7] << 16));
    }
    *reinterpret_cast<uint4*>(in_s + pix * LDA + c8 * 8) = v;
  }

  const int warp = threadIdx.x / 32;
  const int row = warp % TH;         // the tile row of this warp's 32 pixels
  const int co0 = (warp / TH) * 64;  // the first of its 64 output channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4* wsrc = reinterpret_cast<const uint4*>(w);
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    __syncthreads();  // the input tile is written; the last tap's weights are used
    for (int i = threadIdx.x; i < C * C / 8; i += THREADS) {
      const int ci = i / (C / 8);
      *reinterpret_cast<uint4*>(w_s + ci * LDB + (i % (C / 8)) * 8) =
          wsrc[tap * (C * C / 8) + i];
    }
    __syncthreads();
    // output pixel (row, col) reads input tile pixel (row + dy, col + dx)
    const __nv_bfloat16* a_base = in_s + ((row + dy) * HC + dx) * LDA;
#pragma unroll 2
    for (int kc = 0; kc < C; kc += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::load_matrix_sync(a[0], a_base + kc, LDA);
      wmma::load_matrix_sync(a[1], a_base + 16 * LDA + kc, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w_s + kc * LDB + co0 + j * 16, LDB);
        wmma::mma_sync(acc[0][j], a[0], b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a[1], b, acc[1][j]);
      }
    }
  }

  __syncthreads();  // every warp is done with the tiles that out_s overwrites
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out_s + (co0 + j * 16) * LDO + row * TW + i * 16,
                              acc[i][j], LDO, wmma::mem_col_major);
  __syncthreads();

  for (int i = threadIdx.x; i < C * TH * TW; i += THREADS) {
    const int co = i / (TH * TW);
    const int p = i % (TH * TW);
    const int gy = y0 + p / TW;
    const int gx = x0 + p % TW;
    if (gy < h && gx < width) {
      const long long o = batch + (long long)co * plane + (long long)gy * width + gx;
      float v = out_s[co * LDO + p];
      if (res != nullptr) v += __bfloat162float(res[o]);
      out[o] = __float2bfloat16(v < 0.0f ? 0.0f : v);
    }
  }
}

}  // namespace

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
  const dim3 grid((width + TW - 1) / TW, (h + TH - 1) / TH, n);
  fused_resblocks_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), h,
      width);
  return (int)cudaGetLastError();
}
