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
// The taps are summed in order t = dj*4 + di = 0..15.
// A row-sharded frame (vfidkr_torch/parallel/spatial.py) runs this on a block of
// h rows whose local row 0 is global row row0 of a frame hg rows high; the row
// terms then hold in the frame's coordinates, as _window_geometry's do under a
// spatial frame (vfidkr_tpu/ops/filter_interpolation.py:43-86):
//   y2 = (y + row0) + fy       (the frame's row: rounded as the whole frame's is)
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= hg-1 && |fx| < W/2 && |fy| < hg/2
//   iy, beta from y2 clamped to the block's rows [row0, row0+h-1] (which binds
//   only for a flow past the block); iy is then made local
// and the tap clamp stays local: the halo rows replicate the frame's edge rows,
// which is what a clamped read of the whole frame gives.  Outside a sharded frame
// row0 = 0 and hg = h, and the terms reduce to those above.
//
// What bounds it on the H100: memory, and the taps' trips through L1.  Per pixel it
// must read 4*(2 + 16 + C) bytes of flow, filter and image and write 4*C bytes (96
// bytes at C = 3: 6.6 us at 2x3x256x448 and 3.35 TB/s), against 16*C multiply-adds.
// At that size the grid is resident in about one wave, so a thread's chain of
// dependent memory round trips sets the time: loaded one after another (the flow,
// then the filter once the landing is known valid, then the taps), a thread waits
// three round trips.
// Design: a block owns a tile of 4 rows x 32 pixels, a thread a pixel, a warp a
// row, so that every own-pixel access of a warp is one 128-byte line.  The flow and
// all 16 filter planes load before the validity test (the bound counts every
// filter byte anyway): a thread's own bytes arrive in one round trip, its taps
// follow in a second.  The filter is read once, so it streams past the caches
// (ld.global.cs, evict first) and leaves them to the image taps that neighbouring
// windows share; the output streams out the same way.  An invalid pixel reads no
// taps.  C is a runtime argument (<= 8 on the paths), a channel at a time.  What
// is left is the taps: 16 warp-wide gathers a channel, each over about two L1
// lines.  Two or four adjacent pixels a thread, with 8- or 16-byte accesses,
// were tried and are slower (about 13.1-13.7 and 18.5 us against 10.5-11.0 at
// 2x3x256x448 on an H100 80GB HBM3 at 700 W): four take 255 registers for their
// 64 filter weights and 32 tap offsets, and their taps wait in turn.  The image
// is not staged in shared memory yet, as K7 stages its 196 channels: the "no
// taps" ablation of tools/bench_k1_k2.py runs in 6.6 us, so the taps cost about
// 4 us of the 10.7 and staging them is the next step for this kernel.  The grid
// is 2D over the tiles, the batch on z: no 64-bit division.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;              // tile columns: a warp
constexpr int TH = 4;               // tile rows: a warp each

__global__ void __launch_bounds__(TW * TH)
    filter_interpolate_fwd_kernel(const float* __restrict__ image,
                                  const float* __restrict__ flow,
                                  const float* __restrict__ filt,
                                  float* __restrict__ out, int c, int h, int w,
                                  int row0, int hg) {
  const int x = blockIdx.x * TW + threadIdx.x;
  const int y = blockIdx.y * TH + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const long long hw = (long long)h * w;
  const long long p = (long long)y * w + x;

  // the pixel's own bytes, all in flight at once; the filter is read once, so
  // it streams (evict first)
  const float fx = __ldg(flow + 2LL * b * hw + p);
  const float fy = __ldg(flow + (2LL * b + 1) * hw + p);
  float wgt[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) wgt[t] = __ldcs(filt + (16LL * b + t) * hw + p);

  const float x2 = (float)x + fx;
  const float y2 = (float)(y + row0) + fy;
  const bool valid = x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) &&
                     y2 <= (float)(hg - 1) && fabsf(fx) < (float)w / 2.0f &&
                     fabsf(fy) < (float)hg / 2.0f;
  const float yc = fminf(fmaxf(y2, (float)row0), (float)(row0 + h - 1));
  const float xf = floorf(x2);
  const float yf = floorf(yc);
  const float alpha = x2 - xf;
  const float beta = yc - yf;
  const int ix = valid ? (int)xf : 0;
  const int iy = valid ? (int)yf - row0 : 0;
  int rows[4], cols[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    rows[d] = min(max(iy - 1 + d, 0), h - 1) * w;
    cols[d] = min(max(ix - 1 + d, 0), w - 1);
  }
#pragma unroll
  for (int dj = 0; dj < 4; ++dj) {
    const float wy = dj >= 2 ? beta : 1.0f - beta;
#pragma unroll
    for (int di = 0; di < 4; ++di) {
      const float wx = di >= 2 ? alpha : 1.0f - alpha;
      wgt[dj * 4 + di] = wgt[dj * 4 + di] * wy * wx;
    }
  }

  const float* img = image + (long long)b * c * hw;
  float* dst = out + (long long)b * c * hw;
  for (int ch = 0; ch < c; ++ch) {
    const float* plane = img + ch * hw;
    float acc = 0.0f;
    if (valid) {
#pragma unroll
      for (int dj = 0; dj < 4; ++dj) {
#pragma unroll
        for (int di = 0; di < 4; ++di)
          acc += wgt[dj * 4 + di] * __ldg(plane + rows[dj] + cols[di]);
      }
    } else {
      acc = __ldg(plane + p);
    }
    __stcs(dst + ch * hw + p, acc);
  }
}

}  // namespace

// image and out (N,C,H,W), flow (N,2,H,W), filt (N,16,H,W); any C >= 1.
// row0, hg: the block's place in a row-sharded frame (0 and h outside one).
extern "C" int vfidkr_filter_interpolate_fwd(const float* image, const float* flow,
                                             const float* filt, float* out, int n,
                                             int c, int h, int w, int row0, int hg,
                                             cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  filter_interpolate_fwd_kernel<<<grid, dim3(TW, TH), 0, stream>>>(
      image, flow, filt, out, c, h, w, row0, hg);
  return (int)cudaGetLastError();
}
