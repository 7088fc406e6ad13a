// K6 flow_project_scatter_bwd: the backward of K2 flow_project_scatter (the
// 4-neighbour scatter-add of flow projection) for NCHW float32 tensors on Hopper
// (sm_90a); and depth_flow_project_bwd, the backward of the depth-weighted
// projection (K2 with the weight, then the weighted average), further down.
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

// depth_flow_project_bwd: the reference's backward of the depth-weighted flow
// projection (depthflowprojection_cuda_kernel.cu), the 3-channel use of the TPU
// kernel.
//
// Replaces: vfidkr_tpu/ops/pallas/projection_band_kernel.py:scatter4_bwd_pallas
// at C = 3, as vfidkr_tpu/ops/flow_projection.py:_dfp_bwd calls it through
// _gather4_batched on the field [g_x/cnt, g_y/cnt, (g.out)/cnt], with the
// combination that follows.  Here the field is never written out: each source
// pixel forms it at its four target cells from g, cnt and out.
//
// Per source pixel (x, y) with flow (fx, fy) and weight d (the inverse depth),
// landing and cells as in the kernel above; for the cells n = tl, tr, bl, br, in
// that order (_four_neighbour_lin's):
//   a_n = g[n] / max(cnt[n], 1e-30)
//   s0 = sum a_n.x,  s1 = sum a_n.y,  s2 = sum (a_n.x*out_n.x + a_n.y*out_n.y)
//   gflow  = (-s0*d, -s1*d)
//   gdepth = -(s0*fx + s1*fy - s2)
// The reference's depth gradient has (f - out) where the autodiff of the forward
// would give (f + out); it is kept.  g is the cotangent of the unfilled average
// `out`: a hole fill, where the forward made one, takes no gradient.  An invalid
// pixel writes zeros and forms no quotient (the hole cells' g / 1e-30 never meets
// a 0 weight).  A valid pixel's four cells hold at least its own d > 0.
//
// What bounds it on the H100: memory.  Each input read once and each output
// written once is 44 bytes a pixel (flow 8, depth 4, g 8, cnt 4, out 8; gflow 8,
// gdepth 4); without gdepth `out` is not needed and it is 32.  Design: one thread
// per source pixel, threads along x, as K6; the cells' reads mostly hit L1/L2.  A
// gather, no atomics: the same result on every run.

namespace {

template <bool kDepth>
__global__ void depth_flow_project_bwd_kernel(
    const float* __restrict__ flow, const float* __restrict__ depth,
    const float* __restrict__ g, const float* __restrict__ cnt,
    const float* __restrict__ out, float* __restrict__ gflow,
    float* __restrict__ gdepth, int n, int h, int w) {
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
    if (kDepth) gdepth[b * hw + p] = 0.0f;
    return;
  }

  const int ix_l = (int)floorf(x2);
  const int iy_t = (int)floorf(y2);
  const int ix_r = min(ix_l + 1, w - 1);
  const int iy_b = min(iy_t + 1, h - 1);
  const int cells[4] = {iy_t * w + ix_l, iy_t * w + ix_r, iy_b * w + ix_l,
                        iy_b * w + ix_r};

  const float* gx = g + (2 * b) * hw;
  const float* gy = gx + hw;
  const float* cn = cnt + b * hw;
  const float* ox = out + (2 * b) * hw;
  const float* oy = ox + hw;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = cells[k];
    const float den = fmaxf(cn[c], 1e-30f);
    const float ax = gx[c] / den;
    const float ay = gy[c] / den;
    s0 += ax;
    s1 += ay;
    if (kDepth) s2 += ax * ox[c] + ay * oy[c];
  }
  const float d = depth[b * hw + p];
  gf[0] = -s0 * d;
  gf[hw] = -s1 * d;
  if (kDepth) gdepth[b * hw + p] = -(s0 * fx + s1 * fy - s2);
}

}  // namespace

// flow, g, out and gflow (N,2,H,W); depth, cnt and gdepth (N,H,W).  gflow is
// written in full; gdepth likewise, or it is NULL and the depth gradient (and
// `out`, which may then be NULL too) is skipped.
extern "C" int vfidkr_depth_flow_project_bwd(const float* flow, const float* depth,
                                             const float* g, const float* cnt,
                                             const float* out, float* gflow,
                                             float* gdepth, int n, int h, int w,
                                             cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (gdepth != nullptr) {
    depth_flow_project_bwd_kernel<true><<<blocks, threads, 0, stream>>>(
        flow, depth, g, cnt, out, gflow, gdepth, n, h, w);
  } else {
    depth_flow_project_bwd_kernel<false><<<blocks, threads, 0, stream>>>(
        flow, depth, g, cnt, out, gflow, gdepth, n, h, w);
  }
  return (int)cudaGetLastError();
}
