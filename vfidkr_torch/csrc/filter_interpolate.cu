// K1 filter_interpolate_fwd: the deformable-kernel-region warp (FilterInterpolation
// "_ori" forward) for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces: vfidkr_tpu/ops/pallas/filter_bandmm_kernel.py:filter_bandmm_pallas,
// together with the preparation its caller does around it in
// vfidkr_tpu/ops/filter_interpolation.py (_window_geometry, _combined_weights and
// the invalid-pixel copy of _filter_interpolate_slab).  The TPU kernel expresses
// the 4x4 gather as banded one-hot matmuls on bf16 truncation limbs to suit the
// MXU; on this card a gather is a plain load, so none of that carries over.
//
// Per output pixel (x, y) with flow (fx, fy):
//   x2 = x + fx, y2 = y + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= H-1 && |fx| < W/2 && |fy| < H/2
//   invalid: out = image (the source pixel is copied)
//   valid:   ix = floor(x2), iy = floor(y2), alpha = x2 - ix, beta = y2 - iy
//            tap (dj, di) reads image[clamp(iy-1+dj), clamp(ix-1+di)] with weight
//            filt[dj*4+di] * (dj >= 2 ? beta : 1-beta) * (di >= 2 ? alpha : 1-alpha)
// The filter index is the unclamped window position; only the read is clamped.
//
// What bounds it on the H100: memory.  Per pixel it streams 4*(2 + 16 + C) bytes of
// flow, filter and image and writes 4*C bytes (96 bytes at C=3), against 16*C
// multiply-adds; the 16 tap reads per channel are gathers that mostly hit L1/L2,
// because neighbouring pixels land on neighbouring windows for smooth flows.
// Design: one thread per output pixel, threads laid along x so that the flow,
// filter and output accesses of a warp are coalesced; the 16 tap weights and
// offsets are computed once into registers and reused for every channel (C is a
// runtime argument, so the same kernel serves the 3-channel frames and wider
// feature maps).

#include <cuda_runtime.h>

namespace {

__global__ void filter_interpolate_fwd_kernel(const float* __restrict__ image,
                                              const float* __restrict__ flow,
                                              const float* __restrict__ filt,
                                              float* __restrict__ out,
                                              int n, int c, int h, int w) {
  const long long hw = (long long)h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * hw) return;
  const long long b = idx / hw;
  const long long p = idx - b * hw;
  const int y = (int)(p / w);
  const int x = (int)(p - (long long)y * w);

  const float fx = flow[(2 * b) * hw + p];
  const float fy = flow[(2 * b + 1) * hw + p];
  const float x2 = (float)x + fx;
  const float y2 = (float)y + fy;
  const float* img = image + b * c * hw;
  float* dst = out + b * c * hw;

  const bool valid = x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) &&
                     y2 <= (float)(h - 1) && fabsf(fx) < (float)w / 2.0f &&
                     fabsf(fy) < (float)h / 2.0f;
  if (!valid) {
    for (int ch = 0; ch < c; ++ch) dst[ch * hw + p] = img[ch * hw + p];
    return;
  }

  const float x0 = floorf(x2);
  const float y0 = floorf(y2);
  const float alpha = x2 - x0;
  const float beta = y2 - y0;
  const int ix = (int)x0;
  const int iy = (int)y0;

  const float* k = filt + (16 * b) * hw + p;
  float wgt[16];
  int off[16];
#pragma unroll
  for (int dj = 0; dj < 4; ++dj) {
    const float wy = dj >= 2 ? beta : 1.0f - beta;
    const int ty = min(max(iy - 1 + dj, 0), h - 1);
#pragma unroll
    for (int di = 0; di < 4; ++di) {
      const float wx = di >= 2 ? alpha : 1.0f - alpha;
      const int tx = min(max(ix - 1 + di, 0), w - 1);
      wgt[dj * 4 + di] = k[(dj * 4 + di) * hw] * wy * wx;
      off[dj * 4 + di] = ty * w + tx;
    }
  }

  for (int ch = 0; ch < c; ++ch) {
    const float* plane = img + ch * hw;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) acc += wgt[t] * plane[off[t]];
    dst[ch * hw + p] = acc;
  }
}

}  // namespace

extern "C" int vfidkr_filter_interpolate_fwd(const float* image, const float* flow,
                                             const float* filt, float* out, int n,
                                             int c, int h, int w,
                                             cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  filter_interpolate_fwd_kernel<<<blocks, threads, 0, stream>>>(image, flow, filt,
                                                                 out, n, c, h, w);
  return (int)cudaGetLastError();
}
