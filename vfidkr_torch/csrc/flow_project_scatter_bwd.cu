// K6 flow_project_scatter_bwd: the backward of K2 flow_project_scatter (the
// 4-neighbour scatter-add of flow projection) for NCHW float32 tensors on Hopper
// (sm_90a).
//
// Replaces: vfidkr_tpu/ops/pallas/projection_band_kernel.py:scatter4_bwd_pallas,
// together with the landing prep of vfidkr_tpu/ops/flow_projection.py (_landing,
// _scatter_prep) and the chain of its caller _scatter4_bwd back to the flow.  The
// TPU kernel writes the scatter's transpose as banded one-hot matmuls inside a
// slab, with a whole-call lax.cond to an XLA transpose for landings beyond the
// slab; here it is four plain loads per channel and has no slab.
//
// Per source pixel (x, y) with flow (fx, fy) and the cotangent g (N,3,H,W) of the
// scatter sums:
//   x2 = x + fx, y2 = y + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= H-1               (as in K2)
//   ix_l = floor(x2), ix_r = min(ix_l+1, W-1), iy_t = floor(y2), iy_b = min(iy_t+1, H-1)
//   dvals[c] = g[c, tl] + g[c, tr] + g[c, bl] + g[c, br]
//   gflow = valid ? (-dvals[0], -dvals[1]) : (0, 0)
// At the right and bottom border two targets are the same cell, which is then
// counted twice, as the forward added to it twice.  The count channel (c = 2) adds
// 1 for every valid pixel and carries no gradient to the flow, so it is not read.
//
// What bounds it on the H100: memory.  Per source pixel it reads 8 bytes of flow
// and 8 cotangent values that mostly hit L1/L2 (a smooth flow sends neighbouring
// threads to neighbouring cells), and writes 8 bytes.  Design: one thread per
// source pixel, threads laid along x so that the flow and gradient accesses of a
// warp are coalesced.  It is a gather, not a scatter: no atomics, so the result is
// the same on every run.

#include <cuda_runtime.h>

namespace {

__global__ void flow_project_scatter_bwd_kernel(const float* __restrict__ flow,
                                                const float* __restrict__ g,
                                                float* __restrict__ gflow, int n,
                                                int h, int w) {
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
  if (!(x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) && y2 <= (float)(h - 1))) {
    gf[0] = 0.0f;
    gf[hw] = 0.0f;
    return;
  }

  const int ix_l = (int)floorf(x2);
  const int iy_t = (int)floorf(y2);
  const int ix_r = min(ix_l + 1, w - 1);
  const int iy_b = min(iy_t + 1, h - 1);
  const int tl = iy_t * w + ix_l;
  const int tr = iy_t * w + ix_r;
  const int bl = iy_b * w + ix_l;
  const int br = iy_b * w + ix_r;

  const float* gx = g + (3 * b) * hw;
  const float* gy = gx + hw;
  gf[0] = -(gx[tl] + gx[tr] + gx[bl] + gx[br]);
  gf[hw] = -(gy[tl] + gy[tr] + gy[bl] + gy[br]);
}

}  // namespace

// g (N,3,H,W) is the cotangent of flow_project_scatter's sums; gflow (N,2,H,W) is
// written in full.
extern "C" int vfidkr_flow_project_scatter_bwd(const float* flow, const float* g,
                                               float* gflow, int n, int h, int w,
                                               cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  flow_project_scatter_bwd_kernel<<<blocks, threads, 0, stream>>>(flow, g, gflow, n,
                                                                   h, w);
  return (int)cudaGetLastError();
}
