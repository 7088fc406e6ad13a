// K2 flow_project_scatter: the 4-neighbour scatter-add of flow projection, plain
// or depth-weighted, for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces: vfidkr_tpu/ops/pallas/projection_band_kernel.py:scatter4_band_pallas,
// together with the preparation in vfidkr_tpu/ops/flow_projection.py (_landing,
// _scatter_prep, and _depth_prep for the depth-weighted projection).  The TPU kernel turns the scatter into banded one-hot matmuls
// because a TPU serialises scatters; here atomicAdd is the reference CUDA op's own
// scheme (flowprojection_cuda_kernel.cu:29-93).
//
// Per source pixel (x, y) with flow (fx, fy) and weight d (weight[b, y, x], or 1
// where weight is NULL):
//   x2 = x + fx, y2 = y + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= H-1      (no |f| < W/2 term here)
//   ix_l = floor(x2), ix_r = min(ix_l+1, W-1), iy_t = floor(y2), iy_b = min(iy_t+1, H-1)
//   each of the 4 targets (iy_t|iy_b, ix_l|ix_r) gets += (-fx*d, -fy*d, d)
// At the right and bottom border two targets are the same cell, which then gets
// two adds: the reference does the same.  acc (N,3,H,W) must be zeroed by the
// caller; channel 2 is the hit count, or the weight sum.
//
// What bounds it on the H100: atomics.  Per source pixel it reads 8 bytes of flow
// (12 with the weight) and makes 12 float atomicAdds, which resolve in L2.
// Unweighted, the count channel adds whole numbers, so it is exact in any order;
// the flow sums, and a weight sum, depend on the atomic order to the last bits.  Design: one thread per source pixel, threads
// laid along x so that the flow reads are coalesced and a smooth flow sends
// neighbouring threads to neighbouring cells.

#include <cuda_runtime.h>

namespace {

__global__ void flow_project_scatter_kernel(const float* __restrict__ flow,
                                            const float* __restrict__ weight,
                                            float* __restrict__ acc, int n, int h,
                                            int w) {
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
  if (!(x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) && y2 <= (float)(h - 1)))
    return;
  const float d = weight != nullptr ? weight[b * hw + p] : 1.0f;

  const int ix_l = (int)floorf(x2);
  const int iy_t = (int)floorf(y2);
  const int ix_r = min(ix_l + 1, w - 1);
  const int iy_b = min(iy_t + 1, h - 1);
  const int targets[4] = {iy_t * w + ix_l, iy_t * w + ix_r, iy_b * w + ix_l,
                          iy_b * w + ix_r};

  float* ax = acc + (3 * b) * hw;
  float* ay = ax + hw;
  float* cnt = ay + hw;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    atomicAdd(ax + targets[t], -fx * d);
    atomicAdd(ay + targets[t], -fy * d);
    atomicAdd(cnt + targets[t], d);
  }
}

}  // namespace

// weight (N,H,W) may be NULL: every valid pixel then weighs 1.
extern "C" int vfidkr_flow_project_scatter(const float* flow, const float* weight,
                                           float* acc, int n, int h, int w,
                                           cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  flow_project_scatter_kernel<<<blocks, threads, 0, stream>>>(flow, weight, acc, n,
                                                               h, w);
  return (int)cudaGetLastError();
}
