// K3 flow_project_finalize: the count average and inference hole fill of flow
// projection for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces: vfidkr_tpu/ops/pallas/fillhole_kernel.py:fill_holes_pallas, together
// with the count average of vfidkr_tpu/ops/flow_projection.py:_finalize_batched.
// The TPU kernel runs the four "nearest filled cell" searches as doubling scans
// over a field held in VMEM; here each hole walks to its nearest filled cells, the
// reference CUDA op's own per-pixel search (flowprojection_cuda_kernel.cu:141-234).
//
// Input acc (N,3,H,W) from flow_project_scatter: summed (-fx, -fy) and the count.
// Per target cell:
//   cnt > 0: out = acc / cnt
//   else:    walk left, right, up and down to the nearest cell with cnt > 0 and
//            take that cell's acc / cnt; if any was found, out = sum / found,
//            summed in the order left, right, up, down; else out = 0.
//
// What bounds it on the H100: memory for filled cells, which read 12 bytes and
// write 8; a hole reads up to O(H + W) further cells, which hit L1/L2 since the
// holes of a row or column walk over the same cells.  For the flows of the main
// path holes are few.  Design: one thread per target cell, threads laid along x so
// that the plain accesses are coalesced; it runs after flow_project_scatter on the
// same stream.

#include <cuda_runtime.h>

namespace {

__global__ void flow_project_finalize_kernel(const float* __restrict__ acc,
                                             float* __restrict__ out, int n, int h,
                                             int w) {
  const long long hw = (long long)h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * hw) return;
  const long long b = idx / hw;
  const long long p = idx - b * hw;
  const int y = (int)(p / w);
  const int x = (int)(p - (long long)y * w);

  const float* sx = acc + (3 * b) * hw;
  const float* sy = sx + hw;
  const float* cnt = sy + hw;
  float* ox = out + (2 * b) * hw;
  float* oy = ox + hw;

  const float c0 = cnt[p];
  if (c0 > 0.0f) {
    ox[p] = sx[p] / c0;
    oy[p] = sy[p] / c0;
    return;
  }

  float nx = 0.0f, ny = 0.0f, den = 0.0f;
  const int row = y * w;
  for (int xi = x - 1; xi >= 0; --xi) {
    const float cq = cnt[row + xi];
    if (cq > 0.0f) {
      nx += sx[row + xi] / cq;
      ny += sy[row + xi] / cq;
      den += 1.0f;
      break;
    }
  }
  for (int xi = x + 1; xi < w; ++xi) {
    const float cq = cnt[row + xi];
    if (cq > 0.0f) {
      nx += sx[row + xi] / cq;
      ny += sy[row + xi] / cq;
      den += 1.0f;
      break;
    }
  }
  for (int yi = y - 1; yi >= 0; --yi) {
    const int q = yi * w + x;
    const float cq = cnt[q];
    if (cq > 0.0f) {
      nx += sx[q] / cq;
      ny += sy[q] / cq;
      den += 1.0f;
      break;
    }
  }
  for (int yi = y + 1; yi < h; ++yi) {
    const int q = yi * w + x;
    const float cq = cnt[q];
    if (cq > 0.0f) {
      nx += sx[q] / cq;
      ny += sy[q] / cq;
      den += 1.0f;
      break;
    }
  }
  ox[p] = den > 0.0f ? nx / den : 0.0f;
  oy[p] = den > 0.0f ? ny / den : 0.0f;
}

}  // namespace

extern "C" int vfidkr_flow_project_finalize(const float* acc, float* out, int n,
                                            int h, int w, cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  flow_project_finalize_kernel<<<blocks, threads, 0, stream>>>(acc, out, n, h, w);
  return (int)cudaGetLastError();
}
