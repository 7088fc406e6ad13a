// K12 softmax_splat: Softmax Splatting's forward warp in float32 on Hopper (sm_90a),
// "Softmax Splatting for Video Frame Interpolation" (Niklaus and Liu, CVPR 2020), the
// public operator's 'soft' mode (github.com/sniklaus/softmax-splatting, softsplat.py).
//
// Per source pixel p = (x, y) of batch b with flow (fx, fy) and importance z:
//   q = (x + fx, y + fy), x0 = floor(qx), y0 = floor(qy), ax = qx - x0, ay = qy - y0
//   corner (y0, x0) weight (1 - ax)(1 - ay), (y0, x0 + 1) ax (1 - ay),
//          (y0 + 1, x0) (1 - ax) ay, (y0 + 1, x0 + 1) ax ay
//   each corner inside the frame gets += (x[c] e^z) w for c < C, and += e^z w in channel C
//   out[c] = acc[c] / (acc[C] + 1e-7)
// A corner outside the frame is skipped on its own; a flow that is not finite, or that
// lands a whole cell or more outside the frame, reaches no corner.  x and out are
// (N, C, H, W), flow (N, 2, H, W), z (N, 1, H, W), acc (N, C + 1, H, W) scratch, all NCHW
// and contiguous.  The wrapper is vfidkr_torch/ops/softsplat.py:softmax_splat; its plain
// version is softmax_splat_plain.  SoftSplat (models/softsplat.py) calls it once a level,
// both directions as the batch.
//
// Replaces no TPU kernel: the JAX package splats no features.  It was added for
// SoftSplat, whose 1080p pair splats 35, 64 and 96 channels at 1/1, 1/2 and 1/4 size.
//
// What bounds it on the H100: bytes, and the atomics that carry them.  A pixel reads C
// values, its flow and z, and writes C: (2C + 3) x 4 bytes, 2.16 GB a 1984 x 1152 pair
// (0.64 ms at 3.35 TB/s), against 4 (C + 1) multiply-adds, 3.3 GFLOP.  Made directly, it
// is 4 (C + 1) float atomic adds a pixel to device memory (about 1.1 G a pair), each
// resolved in L2.
// Design, after K2 (flow_project_scatter.cu): a block owns a tile of 8 rows x 32 source
// pixels (a warp a row).  It reduces the box of cells its pixels' corners cover; the box
// rows start and end on whole groups of VEC cells.  The C + 1 channels go in chunks as
// large as a 44 KB box holds (a near-uniform flow gives a box of about 9 x 36 cells: a
// chunk of up to 31 channels, evened out: 2 chunks at C = 35, 3 at 64, 4 at 96).  For
// each chunk the block zeroes the box, each pixel adds its chunk's values times its
// corners' weights to it with shared-memory atomics (each value of x read once, as it is
// used), and the box is flushed to acc once, a global atomic a cell and channel, four
// cells by one 16-byte vector reduction (atomicAdd on float4, compute capability 9.x)
// where W is a multiple of 4 and acc 16-byte aligned.  Neighbouring tiles' boxes overlap,
// so the flush stays atomic; a zero group is not flushed (adding +-0 to acc changes no
// bit of it).  A tile whose box holds fewer than MIN_CHUNK channels (a fold, a jump, a
// long flow at the tile's edge) adds straight to acc instead, in the same kernel, and
// adds one to *direct_tiles where that pointer is set.  A second kernel divides, four
// values a thread where H x W is a multiple of 4.  The entry point zeroes acc
// (cudaMemsetAsync) and launches both: two kernels a call.  The atomics add in any
// order: two runs agree to the last bits of a sum, not bit for bit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;               // tile columns: a warp
constexpr int TH = 8;                // tile rows: a warp each
constexpr int THREADS = TW * TH;
constexpr int BOX_FLOATS = 11264;    // the box of a chunk of channels (44 KB)
constexpr int MIN_CHUNK = 4;         // fewer channels a chunk: the direct adds
constexpr float EPS = 1e-7f;         // the normalisation's guard
constexpr unsigned FULL = 0xffffffffu;
constexpr int NORM_THREADS = 256;

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    softmax_splat_scatter_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                                 const float* __restrict__ z, float* __restrict__ acc, int c,
                                 int h, int w, int* direct_tiles) {
  __shared__ __align__(16) float box[BOX_FLOATS];
  __shared__ unsigned red[4][TH];

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * TW + lane;
  const int px = blockIdx.x * TW + lane;
  const int py = blockIdx.y * TH + row;
  const int b = blockIdx.z;
  const int c1 = c + 1;
  const long long hw = (long long)h * w;
  const long long p = (long long)py * w + px;

  bool live = false;                     // at least one corner inside the frame
  bool in[4] = {false, false, false, false};
  float wgt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ez = 0.0f;
  int x0 = 0, y0 = 0;
  if (px < w && py < h) {
    const float qx = (float)px + flow[2LL * b * hw + p];
    const float qy = (float)py + flow[(2LL * b + 1) * hw + p];
    // false for NaN and infinities: such a pixel lands nowhere
    if (qx > -1.0f && qx < (float)w && qy > -1.0f && qy < (float)h) {
      const float fx0 = floorf(qx), fy0 = floorf(qy);
      const float ax = qx - fx0, ay = qy - fy0;
      x0 = (int)fx0;
      y0 = (int)fy0;
      ez = expf(z[b * hw + p]);
      wgt[0] = (1.0f - ax) * (1.0f - ay);
      wgt[1] = ax * (1.0f - ay);
      wgt[2] = (1.0f - ax) * ay;
      wgt[3] = ax * ay;
      const bool left = x0 >= 0, right = x0 + 1 <= w - 1;
      const bool top = y0 >= 0, bottom = y0 + 1 <= h - 1;
      in[0] = top && left;
      in[1] = top && right;
      in[2] = bottom && left;
      in[3] = bottom && right;
      live = true;
    }
  }

  // the box of cells that the tile's corners inside the frame cover
  const int cx_lo = in[0] || in[2] ? x0 : x0 + 1, cx_hi = in[1] || in[3] ? x0 + 1 : x0;
  const int cy_lo = in[0] || in[1] ? y0 : y0 + 1, cy_hi = in[2] || in[3] ? y0 + 1 : y0;
  const unsigned r[4] = {__reduce_min_sync(FULL, live ? (unsigned)cx_lo : UINT_MAX),
                         __reduce_max_sync(FULL, live ? (unsigned)cx_hi : 0u),
                         __reduce_min_sync(FULL, live ? (unsigned)cy_lo : UINT_MAX),
                         __reduce_max_sync(FULL, live ? (unsigned)cy_hi : 0u)};
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[i][row] = r[i];
  }
  __syncthreads();
  unsigned m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = red[i][0];
#pragma unroll
    for (int j = 1; j < TH; ++j)
      m[i] = (i == 0 || i == 2) ? min(m[i], red[i][j]) : max(m[i], red[i][j]);
  }
  if (m[0] == UINT_MAX) return;          // no pixel of the tile lands
  const int bx0 = (int)m[0] & ~(VEC - 1);
  const int by0 = (int)m[2];
  const int bw = (((int)m[1] - bx0) | (VEC - 1)) + 1;
  const int bh = (int)m[3] - by0 + 1;
  const int cells = bw * bh;
  const int fit = min(c1, BOX_FLOATS / cells);

  float* ab = acc + (long long)b * c1 * hw;
  const float* xb = x + (long long)b * c * hw + p;   // read only where live
  if (fit < min(c1, MIN_CHUNK)) {
    // the direct branch: the adds straight to acc
    if (direct_tiles != nullptr && tid == 0) atomicAdd(direct_tiles, 1);
    if (!live) return;
    const long long t0 = (long long)y0 * w + x0;
    const long long targets[4] = {t0, t0 + 1, t0 + w, t0 + w + 1};
    for (int ch = 0; ch < c1; ++ch) {
      const float v = ch < c ? xb[ch * hw] * ez : ez;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (in[k]) atomicAdd(ab + ch * hw + targets[k], v * wgt[k]);
    }
    return;
  }

  // chunks of equal size (the last one smaller by less than the chunk count)
  const int chunks = (c1 + fit - 1) / fit;
  const int chunk = (c1 + chunks - 1) / chunks;
  const int t0 = (y0 - by0) * bw + (x0 - bx0);
  const int targets[4] = {t0, t0 + 1, t0 + bw, t0 + bw + 1};
  const int vecs = bw / VEC;
  for (int c0 = 0; c0 < c1; c0 += chunk) {
    const int cc = min(chunk, c1 - c0);
    for (int e = tid; e < cc * cells; e += THREADS) box[e] = 0.0f;
    __syncthreads();
    if (live) {
      for (int k = 0; k < cc; ++k) {
        const int ch = c0 + k;
        const float v = ch < c ? __ldg(xb + ch * hw) * ez : ez;
        float* bk = box + k * cells;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (in[t]) atomicAdd(bk + targets[t], v * wgt[t]);
      }
    }
    __syncthreads();
    // the flush: a box row's VEC-cell groups along the lanes
    const int per_channel = bh * vecs;
    for (int e = tid; e < cc * per_channel; e += THREADS) {
      const int k = e / per_channel;
      const int rem = e - k * per_channel;
      const int rr = rem / vecs;
      const int col = (rem - rr * vecs) * VEC;
      const float* s = box + k * cells + rr * bw + col;
      float* g = ab + (long long)(c0 + k) * hw + (long long)(by0 + rr) * w + bx0 + col;
      if constexpr (VEC == 4) {
        const float4 f = *reinterpret_cast<const float4*>(s);
        if (f.x != 0.0f || f.y != 0.0f || f.z != 0.0f || f.w != 0.0f)
          atomicAdd(reinterpret_cast<float4*>(g), f);
      } else {
        if (s[0] != 0.0f) atomicAdd(g, s[0]);
      }
    }
    __syncthreads();
  }
}

// out[b, ch] = acc[b, ch] / (acc[b, C] + EPS), VEC values a thread; (b, ch) on blockIdx.y
template <int VEC>
__global__ void __launch_bounds__(NORM_THREADS)
    softmax_splat_normalize_kernel(const float* __restrict__ acc, float* __restrict__ out,
                                   int c, long long hw) {
  const long long q = ((long long)blockIdx.x * NORM_THREADS + threadIdx.x) * VEC;
  if (q >= hw) return;
  const int b = blockIdx.y / c, ch = blockIdx.y - b * c;
  const float* a = acc + ((long long)b * (c + 1) + ch) * hw + q;
  const float* s = acc + ((long long)b * (c + 1) + c) * hw + q;
  float* o = out + (long long)blockIdx.y * hw + q;
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(a);
    const float4 d = *reinterpret_cast<const float4*>(s);
    *reinterpret_cast<float4*>(o) =
        make_float4(v.x / (d.x + EPS), v.y / (d.y + EPS), v.z / (d.z + EPS), v.w / (d.w + EPS));
  } else {
    o[0] = a[0] / (s[0] + EPS);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x (N, C, H, W), flow (N, 2, H, W), z (N, 1, H, W), acc (N, C + 1, H, W) scratch, out
// (N, C, H, W): float32, contiguous.  direct_tiles (or NULL) gains the number of tiles that
// took the direct adds.  Zeroes acc, then launches the scatter and the division.  Returns
// 0 or a CUDA runtime error.
extern "C" int vfidkr_softmax_splat(const float* x, const float* flow, const float* z,
                                    float* acc, float* out, int n, int c, int h, int w,
                                    int* direct_tiles, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  if (grid.y > 65535 || grid.z > 65535 || (long long)n * c > 65535)
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)h * w;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * n * (c + 1) * hw, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TW, TH);
  if (w % 4 == 0 && aligned16(acc))
    softmax_splat_scatter_kernel<4><<<grid, block, 0, stream>>>(x, flow, z, acc, c, h, w,
                                                                direct_tiles);
  else
    softmax_splat_scatter_kernel<1><<<grid, block, 0, stream>>>(x, flow, z, acc, c, h, w,
                                                                direct_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec = hw % 4 == 0 && aligned16(acc) && aligned16(out);
  const long long groups = vec ? hw / 4 : hw;
  const dim3 ngrid((unsigned)((groups + NORM_THREADS - 1) / NORM_THREADS), n * c);
  if (vec)
    softmax_splat_normalize_kernel<4><<<ngrid, NORM_THREADS, 0, stream>>>(acc, out, c, hw);
  else
    softmax_splat_normalize_kernel<1><<<ngrid, NORM_THREADS, 0, stream>>>(acc, out, c, hw);
  return (int)cudaGetLastError();
}
