// K6: the transpose of K2 flow_project_scatter (the 4-neighbour scatter-add of
// flow projection), in its two uses, for NCHW float32 tensors on Hopper
// (sm_90a):
//   flow_project_scatter_bwd  the flow gradient of the plain scatter (C = 2);
//   depth_flow_project_bwd    the reference's backward of the depth-weighted
//                             projection (K2 with the weight, then the weighted
//                             average; C = 3), with or without the depth gradient.
//
// Replaces: vfidkr_tpu/ops/pallas/projection_band_kernel.py:scatter4_bwd_pallas,
// together with the landing prep of vfidkr_tpu/ops/flow_projection.py (_landing,
// _scatter_prep) and the chain of its callers back to the flow and depth:
// _scatter4_bwd, and _dfp_bwd, which gathers the field
// [g_x/cnt, g_y/cnt, (g.out)/cnt] through _gather4_batched.  The TPU kernel
// writes the transpose as banded one-hot matmuls inside a slab, with a
// whole-call lax.cond to an XLA transpose for landings beyond the slab; here it
// is a gather and has no slab.
//
// Per source pixel (x, y) with flow (fx, fy) and, for the depth projection,
// weight d (the inverse depth):
//   x2 = x + fx, y2 = y + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= H-1               (as in K2)
//   ix_l = floor(x2), ix_r = min(ix_l+1, W-1), iy_t = floor(y2), iy_b = min(iy_t+1, H-1)
//   s = a[tl] + a[tr] + a[bl] + a[br], summed in that order (_four_neighbour_lin's)
// where a is a per-cell term of the cotangent g:
//   flow_project_scatter_bwd: a = (g0, g1), g (N,3,H,W) the cotangent of the
//     scatter's sums (the count channel carries no gradient to the flow);
//     gflow = (-s0, -s1);
//   depth_flow_project_bwd: a = (g0, g1) / max(cnt, 1e-30), and with the depth
//     gradient a2 = a0*out0 + a1*out1; g (N,2,H,W) the cotangent of the unfilled
//     average out, cnt the weight sums;
//     gflow = (-s0*d, -s1*d), gdepth = -(s0*fx + s1*fy - s2).
// An invalid pixel writes zeros.  At the right and bottom border two cells are
// one, read twice, as the forward added to it twice.  The reference's depth
// gradient has (f - out) where the autodiff of the forward would give (f + out);
// it is kept.  A hole fill, where the forward made one, takes no gradient.  A
// valid pixel's four cells each hold its own weight (cnt >= d > 0); a hole's
// g / 1e-30 is never read.  A cell's quotients are g times one IEEE reciprocal
// of max(cnt, 1e-30), where the plain version divides twice: within two ulps of
// it, and faster at C = 3 than two divisions (tools/bench_k6.py).
//
// What bounds it on the H100: memory, at one wave's latency at N = 2.  Each input
// read once and each output written once is 24 bytes a pixel for the plain
// scatter's gradient (flow 8, g0 and g1 8, gflow 8), 32 for the depth
// projection's without gdepth (flow 8, depth 4, g 8, cnt 4; gflow 8) and 44 with
// it (out 8, gdepth 4): 1.64, 2.19 and 3.01 us at 2x256x448 and 3.35 TB/s.
// Design: a thread a source pixel, on a 2D grid of 8x32 tiles (a warp along a
// row, so that the flow's, the depth's and the outputs' accesses coalesce) with
// the batch on z: 32-bit index arithmetic inside a plane, and no division (the
// one-dimensional grid before took each pixel's batch, row and column by 64-bit
// divisions, a software routine on sm_90).  Each valid pixel asks for its four
// cells' inputs at once (8, 12 or 20 loads) and forms their terms after, in the
// plain version's order (tl, tr, bl, br).  On a smooth flow neighbouring pixels
// read neighbouring cells, so a cell, read by about four pixels, is loaded from
// L1 after the first.  Staging each tile's cells in shared memory instead, each
// cell's term formed once, ran slower at every shape measured: the reduction of
// the tile's box, two barriers and the lower occupancy cost more than the loads
// and divisions it saved (PERF.md).  A gather, no atomics: the result is the
// same on every run.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;              // tile columns: a warp
constexpr int TH = 8;               // tile rows: a warp each

// The per-cell term a source pixel sums, for MODE
//   0 flow_project_scatter_bwd, 1 depth_flow_project_bwd without gdepth,
//   2 depth_flow_project_bwd with gdepth;
// load() reads a cell's R inputs, term() forms its C channels from them.
template <int MODE>
struct Field {
  static constexpr int C = MODE == 2 ? 3 : 2;
  static constexpr int R = MODE == 0 ? 2 : (MODE == 1 ? 3 : 5);
  const float* g0;     // the cotangent's channels 0 and 1, one plane
  const float* g1;
  const float* cnt;    // the weight sums (MODE 1, 2)
  const float* o0;     // the unfilled average (MODE 2)
  const float* o1;

  __device__ __forceinline__ void load(int c, float (&v)[R]) const {
    v[0] = __ldg(g0 + c);
    v[1] = __ldg(g1 + c);
    if constexpr (MODE >= 1) v[2] = __ldg(cnt + c);
    if constexpr (MODE == 2) {
      v[3] = __ldg(o0 + c);
      v[4] = __ldg(o1 + c);
    }
  }

  __device__ static __forceinline__ void term(const float (&v)[R], float (&t)[C]) {
    if constexpr (MODE == 0) {
      t[0] = v[0];
      t[1] = v[1];
    } else {
      const float rcp = 1.0f / fmaxf(v[2], 1e-30f);
      t[0] = v[0] * rcp;
      t[1] = v[1] * rcp;
      if constexpr (MODE == 2) t[2] = t[0] * v[3] + t[1] * v[4];
    }
  }
};

template <int MODE>
__device__ __forceinline__ void gather4(const float* __restrict__ flow,
                                        const float* __restrict__ depth,
                                        Field<MODE> f, float* __restrict__ gflow,
                                        float* __restrict__ gdepth, int h, int w) {
  constexpr int C = Field<MODE>::C;
  constexpr int R = Field<MODE>::R;
  const int x = blockIdx.x * TW + threadIdx.x;
  const int y = blockIdx.y * TH + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const int hw = h * w;
  const int p = y * w + x;

  const float fx = flow[2LL * b * hw + p];
  const float fy = flow[(2LL * b + 1) * hw + p];
  const float d = MODE >= 1 ? depth[(long long)b * hw + p] : 1.0f;
  const float x2 = (float)x + fx;
  const float y2 = (float)y + fy;
  float* gf = gflow + 2LL * b * hw + p;
  float* gd = MODE == 2 ? gdepth + (long long)b * hw + p : nullptr;
  if (!(x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) && y2 <= (float)(h - 1))) {
    gf[0] = 0.0f;
    gf[hw] = 0.0f;
    if constexpr (MODE == 2) *gd = 0.0f;
    return;
  }

  const int ix_l = (int)floorf(x2);
  const int iy_t = (int)floorf(y2);
  const int ix_r = min(ix_l + 1, w - 1);
  const int iy_b = min(iy_t + 1, h - 1);
  const int cells[4] = {iy_t * w + ix_l, iy_t * w + ix_r, iy_b * w + ix_l,
                        iy_b * w + ix_r};
  float v[4][R];
#pragma unroll
  for (int k = 0; k < 4; ++k) f.load(cells[k], v[k]);
  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float t[C];
    Field<MODE>::term(v[k], t);
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] += t[c];
  }

  if constexpr (MODE == 0) {
    gf[0] = -s[0];
    gf[hw] = -s[1];
  } else {
    gf[0] = -s[0] * d;
    gf[hw] = -s[1] * d;
    if constexpr (MODE == 2) *gd = -(s[0] * fx + s[1] * fy - s[2]);
  }
}

__global__ void __launch_bounds__(TW * TH)
    flow_project_scatter_bwd_kernel(const float* __restrict__ flow,
                                    const float* __restrict__ g,
                                    float* __restrict__ gflow, int h, int w) {
  const long long hw = (long long)h * w;
  const float* g0 = g + 3LL * blockIdx.z * hw;
  gather4<0>(flow, nullptr, Field<0>{g0, g0 + hw, nullptr, nullptr, nullptr}, gflow,
             nullptr, h, w);
}

template <bool kDepth>
__global__ void __launch_bounds__(TW * TH)
    depth_flow_project_bwd_kernel(const float* __restrict__ flow,
                                  const float* __restrict__ depth,
                                  const float* __restrict__ g,
                                  const float* __restrict__ cnt,
                                  const float* __restrict__ out,
                                  float* __restrict__ gflow,
                                  float* __restrict__ gdepth, int h, int w) {
  const long long hw = (long long)h * w;
  const float* g0 = g + 2LL * blockIdx.z * hw;
  const float* cn = cnt + blockIdx.z * hw;
  if constexpr (kDepth) {
    const float* o0 = out + 2LL * blockIdx.z * hw;
    gather4<2>(flow, depth, Field<2>{g0, g0 + hw, cn, o0, o0 + hw}, gflow, gdepth, h,
               w);
  } else {
    gather4<1>(flow, depth, Field<1>{g0, g0 + hw, cn, nullptr, nullptr}, gflow,
               nullptr, h, w);
  }
}

bool grid_fits(int n, int h, int w) {
  return (h + TH - 1) / TH <= 65535 && n <= 65535 && (long long)h * w <= INT_MAX;
}

}  // namespace

// g (N,3,H,W) is the cotangent of flow_project_scatter's sums; gflow (N,2,H,W) is
// written in full.
extern "C" int vfidkr_flow_project_scatter_bwd(const float* flow, const float* g,
                                               float* gflow, int n, int h, int w,
                                               cudaStream_t stream) {
  if (!grid_fits(n, h, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  flow_project_scatter_bwd_kernel<<<grid, dim3(TW, TH), 0, stream>>>(flow, g, gflow, h,
                                                                     w);
  return (int)cudaGetLastError();
}

// flow, g, out and gflow (N,2,H,W); depth, cnt and gdepth (N,H,W).  gflow is
// written in full; gdepth likewise, or it is NULL and the depth gradient (and
// `out`, which may then be NULL too) is skipped.
extern "C" int vfidkr_depth_flow_project_bwd(const float* flow, const float* depth,
                                             const float* g, const float* cnt,
                                             const float* out, float* gflow,
                                             float* gdepth, int n, int h, int w,
                                             cudaStream_t stream) {
  if (!grid_fits(n, h, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  if (gdepth != nullptr) {
    depth_flow_project_bwd_kernel<true><<<grid, dim3(TW, TH), 0, stream>>>(
        flow, depth, g, cnt, out, gflow, gdepth, h, w);
  } else {
    depth_flow_project_bwd_kernel<false><<<grid, dim3(TW, TH), 0, stream>>>(
        flow, depth, g, cnt, out, gflow, gdepth, h, w);
  }
  return (int)cudaGetLastError();
}
