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
// None of that is kept: no slabs, lane tables, row bounds or whole-call fallback.
//
// Per output pixel (x, y) with flow (fx, fy), as K1 (filter_interpolate.cu):
//   x2 = x + fx, y2 = y + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= H-1 && |fx| < W/2 && |fy| < H/2
//   invalid: out = image, all channels (the source pixel is copied)
//   valid:   ix = floor(x2), iy = floor(y2), alpha = x2 - ix, beta = y2 - iy
//            tap (dj, di) reads image[clamp(iy-1+dj), clamp(ix-1+di)] with weight
//            filt[dj*4+di] * (dj >= 2 ? beta : 1-beta) * (di >= 2 ? alpha : 1-alpha)
// The filter index is the unclamped window position; only the read is clamped.
// The taps are summed in order t = dj*4 + di = 0..15.
// In a row-sharded frame (row0, hg: the block's first global row and the frame's
// height, as in K1) the row terms hold in the frame's coordinates:
//   y2 = (y + row0) + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= hg-1 && |fx| < W/2 && |fy| < hg/2
//   iy, beta from y2 clamped to the block's rows [row0, row0+h-1], iy made local
// and the staged box is that of the windows at this landing.  Outside a sharded
// frame row0 = 0 and hg = h.
//
// What bounds it on the H100: memory.  Per pixel it must read 4*(2 + 16 + C) bytes
// of flow, filter and image and write 4*C bytes: at 2x196x256x448 about 376 MB,
// 112 us at 3.35 TB/s, against 16*C multiply-adds (1.4 GFLOP, 21 us at 67 TFLOP/s
// f32).  Gathered straight from device memory, the 16 taps of a channel are 16
// loads a pixel, each warp-wide load unaligned to 128 bytes: about one L1
// wavefront an output value, so the load units, not the DRAM, bound a gather.
// Design: a block owns an output tile of 8 rows x 32 columns (a thread a pixel)
// and a range of at most CH_RANGE channels. Each thread computes its pixel's 16
// weights once. The block reduces, over the tile's valid pixels, the box of frame
// cells their clamped 4x4 windows read, widened to whole 16-byte groups, and
// stages that box, chunk of channels by chunk, into shared memory with 16-byte
// cp.async copies (4-byte ones where W is not a multiple of 4), NSTAGE deep:
// chunks k+1 and k+2 load while chunk k is summed. A tap is then a load from
// shared memory, at a fixed offset from the window's corner for a pixel whose
// window lies inside the frame (a pixel at the frame's edge clamps each tap); for
// smooth flow neighbouring lanes read neighbouring words, free of bank conflicts,
// and each source value leaves L2 about once a tile. A warp-wide cp.async costs
// about the same whatever it moves, so the copies of a chunk run as one list over
// all the block's lanes, not a warp a row. An invalid pixel's lane stages its own
// cells with the chunk (4-byte copies), so its copy waits on no load of its own.
// A tile whose box exceeds BOX_MAX cells (a flow discontinuity spreads the
// landings) gathers its taps straight from device memory instead, in the same
// kernel, and adds one to *direct_tiles where that pointer is set.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;              // tile columns: a warp
constexpr int TH = 8;               // tile rows: a warp each
constexpr int THREADS = TW * TH;
constexpr int NSTAGE = 3;           // chunks in flight or in use
constexpr int STAGE = 3840;         // floats a stage holds (15 KB)
constexpr int BOX_MAX = 2048;       // largest box staged; beyond it, the direct gather
constexpr int CH_RANGE = 64;        // at most this many channels a block
constexpr unsigned FULL = 0xffffffffu;

// global -> shared copies of VEC floats that complete on cp_async_wait
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VEC = 4 where W and the image's address are multiples of 4 floats, so box
// rows start on 16-byte boundaries and go by 16-byte copies; else 1.  Four
// blocks an SM: 64 registers a thread.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 4)
    filter_interpolate_ctx_kernel(const float* __restrict__ image,
                                  const float* __restrict__ flow,
                                  const float* __restrict__ filt,
                                  float* __restrict__ out, int c, int h, int w,
                                  int row0, int hg, int ranges, int per_range,
                                  int* direct_tiles) {
  __shared__ __align__(16) float stage[NSTAGE][STAGE];
  __shared__ int red[4][TH];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // blockIdx.x = tile * ranges + range: the ranges of a tile run side by side
  // and share its flow and filter reads in L2
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles = tiles_x * ((h + TH - 1) / TH);
  const int range = blockIdx.x % ranges;
  const int tile = blockIdx.x / ranges;
  const int b = tile / tiles;
  const int t = tile - b * tiles;
  const int tx0 = (t % tiles_x) * TW;
  const int ty0 = (t / tiles_x) * TH;
  const int x = tx0 + lane;
  const int y = ty0 + warp;
  const int c0 = range * per_range;
  const int c1 = min(c0 + per_range, c);
  const long long hw = (long long)h * w;
  const long long p = (long long)y * w + x;
  const bool inside = x < w && y < h;
  const float* img = image + (long long)b * c * hw;
  float* dst = out + (long long)b * c * hw;

  bool valid = false;
  int ix = 0, iy = 0;
  float wgt[16];
  if (inside) {
    // the filter's 16 taps load beside the flow, before the landing is known
    const float* k = filt + (16LL * b) * hw + p;
#pragma unroll
    for (int t = 0; t < 16; ++t) wgt[t] = k[t * hw];
    const float fx = flow[(2LL * b) * hw + p];
    const float fy = flow[(2LL * b + 1) * hw + p];
    const float x2 = (float)x + fx;
    const float y2 = (float)(y + row0) + fy;
    valid = x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) &&
            y2 <= (float)(hg - 1) && fabsf(fx) < (float)w / 2.0f &&
            fabsf(fy) < (float)hg / 2.0f;
    if (valid) {
      const float yc = fminf(fmaxf(y2, (float)row0), (float)(row0 + h - 1));
      const float xf = floorf(x2);
      const float yf = floorf(yc);
      const float alpha = x2 - xf;
      const float beta = yc - yf;
      ix = (int)xf;
      iy = (int)yf - row0;
#pragma unroll
      for (int dj = 0; dj < 4; ++dj) {
        const float wy = dj >= 2 ? beta : 1.0f - beta;
#pragma unroll
        for (int di = 0; di < 4; ++di) {
          const float wx = di >= 2 ? alpha : 1.0f - alpha;
          wgt[dj * 4 + di] = wgt[dj * 4 + di] * wy * wx;
        }
      }
    }
  }
  const bool invalid = inside && !valid;

  // the box of frame cells that the valid pixels' clamped windows read
  const int v0 = __reduce_min_sync(FULL, valid ? max(ix - 1, 0) : INT_MAX);
  const int v1 = __reduce_max_sync(FULL, valid ? min(ix + 2, w - 1) : INT_MIN);
  const int v2 = __reduce_min_sync(FULL, valid ? max(iy - 1, 0) : INT_MAX);
  const int v3 = __reduce_max_sync(FULL, valid ? min(iy + 2, h - 1) : INT_MIN);
  if (lane == 0) {
    red[0][warp] = v0;
    red[1][warp] = v1;
    red[2][warp] = v2;
    red[3][warp] = v3;
  }
  const bool any_invalid = __syncthreads_or(invalid);
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    bx0 = min(bx0, red[0][i]);
    bx1 = max(bx1, red[1][i]);
    by0 = min(by0, red[2][i]);
    by1 = max(by1, red[3][i]);
  }
  const bool any_valid = bx0 <= bx1;
  // rows of the box start on VEC-float boundaries
  bx0 &= ~(VEC - 1);
  const int bw = any_valid ? ((bx1 - bx0) | (VEC - 1)) + 1 : 0;
  const int bh = any_valid ? by1 - by0 + 1 : 0;
  const bool staged = any_valid && (long long)bw * bh <= BOX_MAX;

  if (!staged) {
    // the direct gather: taps from device memory (or, with no valid pixel in
    // the tile, only the invalid pixels' copies)
    if (any_valid && range == 0 && threadIdx.x == 0 && direct_tiles != nullptr)
      atomicAdd(direct_tiles, 1);
    if (!inside) return;
    if (!valid) {
      for (int ch = c0; ch < c1; ++ch) dst[ch * hw + p] = img[ch * hw + p];
      return;
    }
    int off[16];
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) {
      const int ty = min(max(iy - 1 + dj, 0), h - 1);
#pragma unroll
      for (int di = 0; di < 4; ++di)
        off[dj * 4 + di] = ty * w + min(max(ix - 1 + di, 0), w - 1);
    }
#pragma unroll 2
    for (int ch = c0; ch < c1; ++ch) {
      const float* plane = img + ch * hw;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) acc += wgt[t] * plane[off[t]];
      dst[ch * hw + p] = acc;
    }
    return;
  }

  // staged: a chunk holds cpc channels' boxes (bw x bh, row-major), then, in
  // a tile with invalid pixels, their own cells (a slot a thread)
  const int area = bw * bh;
  const int cpc = min(STAGE / (area + (any_invalid ? THREADS : 0)), c1 - c0);
  const int chunks = (c1 - c0 + cpc - 1) / cpc;
  const int vecs = bw / VEC;
  // a pixel whose window lies inside the frame reads its taps at fixed offsets
  // from its window's corner; one at the frame's edge clamps each tap
  const bool interior = ix >= 1 && ix + 2 <= w - 1 && iy >= 1 && iy + 2 <= h - 1;
  const int corner = (iy - 1 - by0) * bw + (ix - 1 - bx0);

  // e / vecs and rr / bh by a multiply: exact while e * vecs and rr * bh stay
  // under 2^32
  const unsigned long long inv_vecs = ((1ULL << 32) + vecs - 1) / vecs;
  const unsigned long long inv_bh = ((1ULL << 32) + bh - 1) / bh;
  auto issue = [&](int chunk) {
    const int ch0 = c0 + chunk * cpc;
    const int nch = min(cpc, c1 - ch0);
    float* buf = stage[chunk % NSTAGE];
    // the chunk's rows as one list of VEC-float copies, the block's threads
    // side by side: a warp-wide cp.async costs about the same whatever it
    // moves, so every lane of it moves a part of some row
    for (int e = threadIdx.x; e < nch * bh * vecs; e += THREADS) {
      const int rr = (int)((e * inv_vecs) >> 32);
      const int v = e - rr * vecs;
      const int cc = (int)((rr * inv_bh) >> 32);
      const int r = rr - cc * bh;
      cp_async<VEC>(buf + cc * area + r * bw + v * VEC,
                    img + (ch0 + cc) * hw + (long long)(by0 + r) * w + bx0 + v * VEC);
    }
    if (invalid) {
      float* own = buf + cpc * area + threadIdx.x;
      for (int cc = 0; cc < nch; ++cc)
        cp_async<1>(own + cc * THREADS, img + (ch0 + cc) * hw + p);
    }
    cp_async_commit();
  };

  // NSTAGE - 1 chunks ahead; a chunk past the last commits an empty group, so
  // that the wait below always leaves the newest NSTAGE - 1 groups in flight
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (k < chunks) issue(k);
    else cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    if (k + NSTAGE - 1 < chunks) issue(k + NSTAGE - 1);
    else cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const int ch0 = c0 + k * cpc;
    const int nch = min(cpc, c1 - ch0);
    const float* buf = stage[k % NSTAGE];
    if (valid && interior) {
      for (int cc = 0; cc < nch; ++cc) {
        const float* q = buf + cc * area + corner;
        float acc = 0.0f;
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) {
#pragma unroll
          for (int di = 0; di < 4; ++di) acc += wgt[dj * 4 + di] * q[dj * bw + di];
        }
        dst[(ch0 + cc) * hw + p] = acc;
      }
    } else if (valid) {
      int rows_off[4], cols_off[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        rows_off[d] = (min(max(iy - 1 + d, 0), h - 1) - by0) * bw;
        cols_off[d] = min(max(ix - 1 + d, 0), w - 1) - bx0;
      }
      for (int cc = 0; cc < nch; ++cc) {
        const float* q = buf + cc * area;
        float acc = 0.0f;
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) {
#pragma unroll
          for (int di = 0; di < 4; ++di)
            acc += wgt[dj * 4 + di] * q[rows_off[dj] + cols_off[di]];
        }
        dst[(ch0 + cc) * hw + p] = acc;
      }
    } else if (invalid) {
      const float* own = buf + cpc * area + threadIdx.x;
      for (int cc = 0; cc < nch; ++cc) dst[(ch0 + cc) * hw + p] = own[cc * THREADS];
    }
    __syncthreads();
  }
}

}  // namespace

// image and out (N,C,H,W), flow (N,2,H,W), filt (N,16,H,W); any C >= 1.
// row0, hg: the block's place in a row-sharded frame (0 and h outside one).
// direct_tiles (or NULL): gains the number of tiles that took the direct gather.
extern "C" int vfidkr_filter_interpolate_ctx(const float* image, const float* flow,
                                             const float* filt, float* out, int n,
                                             int c, int h, int w, int row0, int hg,
                                             int* direct_tiles, cudaStream_t stream) {
  const int ranges = (c + CH_RANGE - 1) / CH_RANGE;
  const int per_range = (c + ranges - 1) / ranges;
  const long long tiles = (long long)n * ((w + TW - 1) / TW) * ((h + TH - 1) / TH);
  const unsigned blocks = (unsigned)(tiles * ranges);
  if (w % 4 == 0 && reinterpret_cast<std::uintptr_t>(image) % 16 == 0)
    filter_interpolate_ctx_kernel<4><<<blocks, THREADS, 0, stream>>>(
        image, flow, filt, out, c, h, w, row0, hg, ranges, per_range, direct_tiles);
  else
    filter_interpolate_ctx_kernel<1><<<blocks, THREADS, 0, stream>>>(
        image, flow, filt, out, c, h, w, row0, hg, ranges, per_range, direct_tiles);
  return (int)cudaGetLastError();
}
