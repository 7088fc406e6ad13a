// K5 filter_interpolate_bwd: the backward of K1 filter_interpolate_fwd (the
// deformable-kernel-region warp) for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces: vfidkr_tpu/ops/pallas/filter_bandmm_bwd_kernel.py:filter_bandmm_bwd_pallas,
// together with the chain its caller runs around it in
// vfidkr_tpu/ops/filter_interpolation.py:_fi_slab_bwd_fast (T = dL/dkw pushed
// through _window_geometry and _combined_weights to grad->flow and grad->filter).
// The TPU kernel writes grad->image as a transposed banded one-hot matmul on bf16
// truncation limbs inside a slab, with a whole-call lax.cond to an XLA path for
// flows beyond the slab; here a scatter is an atomicAdd and has no slab.
//
// Per output pixel (x, y) with flow (fx, fy) and cotangent g[c]:
//   valid, ix, iy, alpha, beta, the 16 clamped taps and their weights as in K1
//   invalid: every gradient of this pixel is 0 (the forward copies the source
//            with no gradient, as the reference backward skips it)
//   valid:   T[t]      = sum_c g[c] * image[c, tap_t]                 (= dL/dkw[t])
//            gfilt[t]  = T[t] * wy(dj) * wx(di)
//            gfx       = sum_t T[t] * filt[t] * wy(dj) * (di >= 2 ? +1 : -1)
//            gfy       = sum_t T[t] * filt[t] * wx(di) * (dj >= 2 ? +1 : -1)
//            gimage[c, tap_t] += filt[t] * wy(dj) * wx(di) * g[c]    (atomicAdd)
// gfx/gfy are the reference's quadrant difference (filterinterpolation_cuda_kernel.cu
// :2965-3031).  A landing on the frame's edge (x2 == 0 or W-1, y2 == 0 or H-1) takes
// the full gradient, as the reference does; the clamped tap reads fold the edge
// padding into the edge pixels by themselves.
//
// What bounds it on the H100: memory and atomics.  Per pixel it streams
// 4*(2 + 16 + 2C) bytes of flow, filter and cotangent, gathers 16*C taps that mostly
// hit L1/L2 (neighbouring pixels land on neighbouring windows for smooth flows),
// writes 4*18 bytes and makes 16*C float atomicAdds that resolve in L2.  Design:
// one thread per output pixel, threads laid along x so that the flow, filter,
// cotangent and gradient accesses of a warp are coalesced; the 16 offsets, filter
// values and T sums stay in registers, and one pass over the channels feeds both T
// and the image scatter.  With gimage == nullptr the scatter is skipped (the caller
// needs no image gradient, as in DAIN training where the frames are inputs).  The
// atomic order makes gimage differ from run to run in the last bits; gflow and
// gfilt are deterministic.

#include <cuda_runtime.h>

namespace {

__global__ void filter_interpolate_bwd_kernel(const float* __restrict__ image,
                                              const float* __restrict__ flow,
                                              const float* __restrict__ filt,
                                              const float* __restrict__ g,
                                              float* __restrict__ gimage,
                                              float* __restrict__ gflow,
                                              float* __restrict__ gfilt, int n,
                                              int c, int h, int w) {
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
  float* gf = gflow + (2 * b) * hw + p;
  float* gk = gfilt + (16 * b) * hw + p;

  const bool valid = x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) &&
                     y2 <= (float)(h - 1) && fabsf(fx) < (float)w / 2.0f &&
                     fabsf(fy) < (float)h / 2.0f;
  if (!valid) {
    gf[0] = 0.0f;
    gf[hw] = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) gk[t * hw] = 0.0f;
    return;
  }

  const float x0 = floorf(x2);
  const float y0 = floorf(y2);
  const float alpha = x2 - x0;
  const float beta = y2 - y0;
  const int ix = (int)x0;
  const int iy = (int)y0;

  const float* k = filt + (16 * b) * hw + p;
  float kf[16];
  float wgt[16];
  float tsum[16];
  int off[16];
#pragma unroll
  for (int dj = 0; dj < 4; ++dj) {
    const float wy = dj >= 2 ? beta : 1.0f - beta;
    const int ty = min(max(iy - 1 + dj, 0), h - 1);
#pragma unroll
    for (int di = 0; di < 4; ++di) {
      const float wx = di >= 2 ? alpha : 1.0f - alpha;
      const int tx = min(max(ix - 1 + di, 0), w - 1);
      const int t = dj * 4 + di;
      kf[t] = k[t * hw];
      wgt[t] = kf[t] * wy * wx;
      off[t] = ty * w + tx;
      tsum[t] = 0.0f;
    }
  }

  const float* img = image + b * c * hw;
  const float* gp = g + b * c * hw + p;
  float* gi = gimage == nullptr ? nullptr : gimage + b * c * hw;
  for (int ch = 0; ch < c; ++ch) {
    const float gc = gp[ch * hw];
    const float* plane = img + ch * hw;
#pragma unroll
    for (int t = 0; t < 16; ++t) tsum[t] += gc * plane[off[t]];
    if (gi != nullptr) {
      float* gplane = gi + ch * hw;
#pragma unroll
      for (int t = 0; t < 16; ++t) atomicAdd(gplane + off[t], wgt[t] * gc);
    }
  }

  float gfx = 0.0f;
  float gfy = 0.0f;
#pragma unroll
  for (int dj = 0; dj < 4; ++dj) {
    const float wy = dj >= 2 ? beta : 1.0f - beta;
    const float sy = dj >= 2 ? 1.0f : -1.0f;
#pragma unroll
    for (int di = 0; di < 4; ++di) {
      const float wx = di >= 2 ? alpha : 1.0f - alpha;
      const float sx = di >= 2 ? 1.0f : -1.0f;
      const int t = dj * 4 + di;
      gk[t * hw] = tsum[t] * wy * wx;
      const float tk = tsum[t] * kf[t];
      gfx += tk * wy * sx;
      gfy += tk * wx * sy;
    }
  }
  gf[0] = gfx;
  gf[hw] = gfy;
}

}  // namespace

// gimage (N,C,H,W) must be zeroed by the caller, or be nullptr to skip the image
// gradient; gflow (N,2,H,W) and gfilt (N,16,H,W) are written in full.
extern "C" int vfidkr_filter_interpolate_bwd(const float* image, const float* flow,
                                             const float* filt, const float* g,
                                             float* gimage, float* gflow,
                                             float* gfilt, int n, int c, int h,
                                             int w, cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  filter_interpolate_bwd_kernel<<<blocks, threads, 0, stream>>>(
      image, flow, filt, g, gimage, gflow, gfilt, n, c, h, w);
  return (int)cudaGetLastError();
}
