// K7 filter_interpolate_ctx: the deformable-kernel-region warp (FilterInterpolation
// "_ori" forward) for wide NCHW float32 tensors on Hopper (sm_90a): DAIN_slowmotion's
// 196-channel context (the S2DF features and the log-depth).
//
// Replaces: vfidkr_tpu/ops/pallas/ctx_gather_kernel.py:ctx_gather_pallas, together
// with what its caller vfidkr_tpu/ops/filter_interpolation.py:_filter_interpolate_ctx
// does around it (_window_geometry, _combined_weights, the invalid-pixel copy).  The
// TPU kernel puts channels on sublanes and pixels on lanes, turns the horizontal
// tap select into lane gathers from 128-column slabs DMA'd into VMEM, folds the
// vertical select into 8-row weight tables, and bounds its row loop by the flow's
// spread, with a whole-call lax.cond to an exact XLA path for flows beyond the slab.
// On this card a tap is a plain load from device memory (through L1/L2), so there
// are no slabs, tables, row bounds or fallback.
//
// Per output pixel (x, y) with flow (fx, fy), as K1 (filter_interpolate.cu):
//   x2 = x + fx, y2 = y + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= H-1 && |fx| < W/2 && |fy| < H/2
//   invalid: out = image, all channels (the source pixel is copied)
//   valid:   ix = floor(x2), iy = floor(y2), alpha = x2 - ix, beta = y2 - iy
//            tap (dj, di) reads image[clamp(iy-1+dj), clamp(ix-1+di)] with weight
//            filt[dj*4+di] * (dj >= 2 ? beta : 1-beta) * (di >= 2 ? alpha : 1-alpha)
// The filter index is the unclamped window position; only the read is clamped.
//
// What bounds it on the H100: memory.  Per pixel it must read 4*(2 + 16 + C) bytes
// of flow, filter and image and write 4*C bytes: at 2x196x256x448 about 376 MB,
// 112 us at 3.35 TB/s, against 16*C multiply-adds (1.4 GFLOP, 21 us at 67 TFLOP/s
// f32).  The 16 tap reads per channel are gathers that mostly hit L1/L2, since
// neighbouring pixels land on neighbouring windows for smooth flows.
// Design: K1 gives each pixel one thread, which at C = 196 serialises 196*16 loads
// in each of only 229,376 threads, too few to hide the gathers' latency.  Here the
// channels are split into groups of CTX_GROUP: one thread per (pixel, group).  Each
// thread recomputes the pixel's 16 weights and offsets in registers (18 loads,
// against 16 per channel it warps) and then runs its group's channels.  A block
// holds 128 consecutive pixels of one group, so the flow, filter and output accesses
// of a warp are coalesced; the groups of one pixel block are adjacent block
// indices, so the flow and filter they share are read from L2.

#include <cuda_runtime.h>

namespace {

constexpr int CTX_GROUP = 28;  // channels per thread: 196 = 7 groups
constexpr int THREADS = 128;   // pixels per block

__global__ void __launch_bounds__(THREADS)
    filter_interpolate_ctx_kernel(const float* __restrict__ image,
                                  const float* __restrict__ flow,
                                  const float* __restrict__ filt,
                                  float* __restrict__ out, int n, int c, int h, int w,
                                  int groups) {
  const long long hw = (long long)h * w;
  const int group = blockIdx.x % groups;
  const long long idx = (long long)(blockIdx.x / groups) * THREADS + threadIdx.x;
  if (idx >= (long long)n * hw) return;
  const long long b = idx / hw;
  const long long p = idx - b * hw;
  const int y = (int)(p / w);
  const int x = (int)(p - (long long)y * w);
  const int c0 = group * CTX_GROUP;
  const int c1 = min(c0 + CTX_GROUP, c);

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
    for (int ch = c0; ch < c1; ++ch) dst[ch * hw + p] = img[ch * hw + p];
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

#pragma unroll 2
  for (int ch = c0; ch < c1; ++ch) {
    const float* plane = img + ch * hw;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) acc += wgt[t] * plane[off[t]];
    dst[ch * hw + p] = acc;
  }
}

}  // namespace

// image and out (N,C,H,W), flow (N,2,H,W), filt (N,16,H,W); any C >= 1.
extern "C" int vfidkr_filter_interpolate_ctx(const float* image, const float* flow,
                                             const float* filt, float* out, int n,
                                             int c, int h, int w,
                                             cudaStream_t stream) {
  const long long total = (long long)n * h * w;
  const int groups = (c + CTX_GROUP - 1) / CTX_GROUP;
  const unsigned blocks = (unsigned)(((total + THREADS - 1) / THREADS) * groups);
  filter_interpolate_ctx_kernel<<<blocks, THREADS, 0, stream>>>(image, flow, filt,
                                                                 out, n, c, h, w,
                                                                 groups);
  return (int)cudaGetLastError();
}
