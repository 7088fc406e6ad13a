// K2 flow_project_scatter: the 4-neighbour scatter-add of flow projection, plain
// or depth-weighted, for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces: vfidkr_tpu/ops/pallas/projection_band_kernel.py:scatter4_band_pallas,
// together with the preparation in vfidkr_tpu/ops/flow_projection.py (_landing,
// _scatter_prep, and _depth_prep for the depth-weighted projection).  The TPU kernel
// turns the scatter into banded one-hot matmuls because a TPU serialises scatters;
// here the sums are atomic adds, the reference CUDA op's own scheme
// (flowprojection_cuda_kernel.cu:29-93), made first in shared memory.
//
// Per source pixel (x, y) with flow (fx, fy) and weight d (weight[b, y, x], or 1
// where weight is NULL):
//   x2 = x + fx, y2 = y + fy
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= H-1      (no |f| < W/2 term here)
//   ix_l = floor(x2), ix_r = min(ix_l+1, W-1), iy_t = floor(y2), iy_b = min(iy_t+1, H-1)
//   each of the 4 targets (iy_t|iy_b, ix_l|ix_r) gets += (-fx*d, -fy*d, d)
// A row-sharded frame (vfidkr_torch/parallel/spatial.py) runs this on a block of
// h rows whose local row 0 is global row row0 (negative on the first shard, whose
// top halo rows replicate row 0) of a frame hg rows high; the row terms then hold
// in the frame's coordinates, as _landing's do under a spatial frame
// (vfidkr_tpu/ops/flow_projection.py:49-89):
//   y2 = (y + row0) + fy       (the frame's row: rounded as the whole frame's is)
//   valid = 0 <= x2 <= W-1 && 0 <= y2 <= hg-1 && 0 <= y+row0 <= hg-1
//   iy_t = min(max(floor(y2) - row0, 0), h-1), iy_b = min(iy_t+1, hg-1-row0, h-1)
// (the last term of valid masks the phantom rows outside the frame; the clamp of
// iy_t binds only for a flow that reaches past the block).  Outside a sharded frame
// row0 = 0 and hg = h, and the terms reduce to those above.
// At the right and bottom border two targets are the same cell, which then gets
// two adds: the reference does the same.  acc (N,3,H,W) must be zeroed by the
// caller; channel 2 is the hit count, or the weight sum.
//
// What bounds it on the H100: the atomics, not the bytes.  The function moves 8
// bytes of flow (12 with the weight) in and 12 bytes of sums out a pixel: 1.4 us at
// 2x256x448 and 3.35 TB/s.  Made directly, it is 12 float atomic adds a valid pixel,
// some 2.7 M a call, each resolved in L2, and where the flow compresses the lanes
// of a warp add into the same cells and serialise there.
// Design: a block owns a tile of 8 rows x 32 source pixels (a warp a row).  It
// reduces the box of cells its valid pixels' four targets cover; where that box
// holds at most BOX_MAX cells, it sums the tile's adds into a zeroed copy of the
// box in shared memory, then flushes the box to acc once:
// one global add a cell and channel, rows read along the lanes, four cells by one
// 16-byte vector reduction (atomicAdd on float4, compute capability 9.x) where W
// and acc are 16-byte aligned (the box then starts and ends on whole 16-byte
// groups).  A float atomicAdd to shared memory is a compare-and-swap loop on sm_90
// (ATOMS.CAST.SPIN), cheap while the lanes of one add meet in no cell and no bank,
// and retried when they do.  So a box row takes a whole number of 32-bank rows
// (a warp whose targets slant across rows then meets no other lane's bank), and
// each run of neighbouring lanes that land in the same cell (where the flow
// compresses) first sums its values into its first lane by shuffles.
// Neighbouring tiles' boxes overlap, so the flush stays atomic.  A sum of +-0 is
// not flushed: adding +-0 to acc changes no bit of it (acc holds +0 or a nonzero
// sum), so the skip is exact.  Unweighted, the count channel adds whole numbers,
// exact in any order (below 2^24); the flow sums and a weight sum depend on the
// order to the last bits.  A tile whose box exceeds BOX_MAX (a fold, a sharp
// discontinuity, a long flow at the tile's edge) makes its adds straight to acc
// instead, in the same kernel, and adds one to *direct_tiles where that pointer
// is set.  The grid is 2D over the tiles, the batch on z: no 64-bit division.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;              // tile columns: a warp
constexpr int TH = 8;               // tile rows: a warp each
constexpr int THREADS = TW * TH;
constexpr int BOX_MAX = 2048;       // largest box summed in shared memory (24 KB)
constexpr unsigned FULL = 0xffffffffu;

// VEC = 4 where W is a multiple of 4 and acc 16-byte aligned: the box is widened
// to whole 16-byte groups and flushed by float4 reductions; else 1.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    flow_project_scatter_kernel(const float* __restrict__ flow,
                                const float* __restrict__ weight,
                                float* __restrict__ acc, int h, int w, int row0,
                                int hg, int* direct_tiles) {
  __shared__ __align__(16) float box[3][BOX_MAX];
  __shared__ unsigned red[4][TH];

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * TW + lane;
  const int x = blockIdx.x * TW + lane;
  const int y = blockIdx.y * TH + row;
  const int b = blockIdx.z;
  const long long hw = (long long)h * w;
  const long long p = (long long)y * w + x;

  bool valid = false;
  float fx = 0.0f, fy = 0.0f, d = 1.0f;
  int ix_l = 0, ix_r = 0, iy_t = 0, iy_b = 0;
  if (x < w && y < h) {
    fx = flow[2LL * b * hw + p];
    fy = flow[(2LL * b + 1) * hw + p];
    if (weight != nullptr) d = weight[b * hw + p];
    const float x2 = (float)x + fx;
    const float y2 = (float)(y + row0) + fy;
    valid = x2 >= 0.0f && y2 >= 0.0f && x2 <= (float)(w - 1) &&
            y2 <= (float)(hg - 1) && y + row0 >= 0 && y + row0 <= hg - 1;
    if (valid) {
      ix_l = (int)floorf(x2);
      iy_t = min(max((int)floorf(y2) - row0, 0), h - 1);
      ix_r = min(ix_l + 1, w - 1);
      iy_b = min(min(iy_t + 1, hg - 1 - row0), h - 1);
    }
  }
  const float v[3] = {-fx * d, -fy * d, d};

  // the box of cells that the valid pixels' targets cover
  const unsigned r[4] = {
      __reduce_min_sync(FULL, valid ? (unsigned)ix_l : UINT_MAX),
      __reduce_max_sync(FULL, valid ? (unsigned)ix_r : 0u),
      __reduce_min_sync(FULL, valid ? (unsigned)iy_t : UINT_MAX),
      __reduce_max_sync(FULL, valid ? (unsigned)iy_b : 0u)};
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
  if (m[0] == UINT_MAX) return;     // no valid pixel in the tile
  const int bx0 = (int)m[0] & ~(VEC - 1);   // box rows start on VEC-float boundaries
  const int by0 = (int)m[2];
  const int bw = (((int)m[1] - bx0) | (VEC - 1)) + 1;
  const int bh = (int)m[3] - by0 + 1;
  // a box row takes a whole number of 32-word rows of banks, so that the lanes
  // of a warp whose targets slant across rows meet no other lane's bank
  const int pitch = (bw + 31) & ~31;

  float* ax = acc + 3LL * b * hw;
  if ((long long)pitch * bh > BOX_MAX) {
    // the direct branch: the adds straight to acc
    if (direct_tiles != nullptr && tid == 0) atomicAdd(direct_tiles, 1);
    if (!valid) return;
    const int targets[4] = {iy_t * w + ix_l, iy_t * w + ix_r, iy_b * w + ix_l,
                            iy_b * w + ix_r};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(ax + c * hw + targets[t], v[c]);
    }
    return;
  }

  for (int e = tid; e < pitch * bh; e += THREADS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) box[c][e] = 0.0f;
  }

  // Lanes whose pixels land in the same cell (where the flow compresses) would
  // serialise on it: a float atomicAdd to shared memory is a compare-and-swap
  // loop on sm_90.  So each run of neighbouring lanes with the same top-left
  // cell (the same four cells) sums its values into its first lane, the head,
  // and only heads add to the box.
  const int t0 = (iy_t - by0) * pitch - bx0;
  const int t1 = (iy_b - by0) * pitch - bx0;
  const int key = valid ? t0 + ix_l : -1 - lane;        // invalid: a run of one
  const int prev_key = __shfl_up_sync(FULL, key, 1);    // every lane shuffles
  const bool head = lane == 0 || prev_key != key;
  const unsigned heads = __ballot_sync(FULL, head);
  float sum[3] = {v[0], v[1], v[2]};
  if (heads != FULL) {
    const unsigned later = lane == TW - 1 ? 0u : heads & (FULL << (lane + 1));
    const int end = later ? __ffs(later) - 1 : TW;     // the next run's head
    for (int off = 1; off < TW; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float more = __shfl_down_sync(FULL, sum[c], off);
        if (lane + off < end) sum[c] += more;
      }
    }
  }
  __syncthreads();
  if (valid && head) {
    const int targets[4] = {t0 + ix_l, t0 + ix_r, t1 + ix_l, t1 + ix_r};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&box[c][targets[t]], sum[c]);
    }
  }
  __syncthreads();

  // the flush: a box row's VEC-cell groups along the lanes
  const int vecs = bw / VEC;
  for (int e = tid; e < bh * vecs; e += THREADS) {
    const int rr = e / vecs;
    const int col = (e - rr * vecs) * VEC;
    const int i = rr * pitch + col;
    float* g = ax + (long long)(by0 + rr) * w + bx0 + col;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float f[VEC];
      bool nonzero = false;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        f[k] = box[c][i + k];
        nonzero |= f[k] != 0.0f;
      }
      if (!nonzero) continue;
      if constexpr (VEC == 4)
        atomicAdd(reinterpret_cast<float4*>(g + c * hw), make_float4(f[0], f[1], f[2], f[3]));
      else
        atomicAdd(g + c * hw, f[0]);
    }
  }
}

}  // namespace

// flow (N,2,H,W); weight (N,H,W) may be NULL: every valid pixel then weighs 1.
// row0, hg: the block's place in a row-sharded frame (0 and h outside one).
// direct_tiles (or NULL): gains the number of tiles that took the direct adds.
extern "C" int vfidkr_flow_project_scatter(const float* flow, const float* weight,
                                           float* acc, int n, int h, int w, int row0,
                                           int hg, int* direct_tiles,
                                           cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(TW, TH);
  if (w % 4 == 0 && reinterpret_cast<std::uintptr_t>(acc) % 16 == 0)
    flow_project_scatter_kernel<4><<<grid, block, 0, stream>>>(
        flow, weight, acc, h, w, row0, hg, direct_tiles);
  else
    flow_project_scatter_kernel<1><<<grid, block, 0, stream>>>(
        flow, weight, acc, h, w, row0, hg, direct_tiles);
  return (int)cudaGetLastError();
}
