// K3 flow_project_finalize: the count average and inference hole fill of flow
// projection for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces: vfidkr_tpu/ops/pallas/fillhole_kernel.py:fill_holes_pallas, together
// with the count average of vfidkr_tpu/ops/flow_projection.py:_finalize_batched.
// The TPU kernel runs the four "nearest filled cell" searches as doubling scans
// over a field held in VMEM.  Here each search runs over filled bitmasks, 32
// cells a word, instead of cell by cell.
//
// Input acc (N,3,H,W) from flow_project_scatter: summed (-fx, -fy) and the count
// (or the weight sum).  Per target cell:
//   cnt > 0: out = acc / cnt
//   else:    take the nearest cell with cnt > 0 to the left, right, up and down,
//            each one's acc / cnt; if any was found, out = sum / found, summed in
//            the order left, right, up, down; else out = 0.
// The divisor is max(cnt, 1e-30), as the plain version's count average clamps.
//
// In a row-sharded frame (vfidkr_torch/parallel/spatial.py) the block holds its
// shard's interior rows [row_lo, row_hi) between halo rows whose sums miss the
// sources beyond the block, as JAX's sharded fill_holes has it
// (vfidkr_tpu/ops/flow_projection.py:312-345): the left and right searches cover
// whole rows of the block, the up and down searches interior rows only, and a
// column with no filled interior cell above (below) a hole takes carry_up
// (carry_down) where that carry exists: (N,3,W) rows of (mean x, mean y, 1 where
// some shard above (below) has a filled interior cell in the column, else 0), the
// nearest such shard's cell.  Outside a sharded frame row_lo = 0, row_hi = h and
// both carries are NULL: the search is the frame-global one above.
//
// What bounds it on the H100: memory, 12 bytes read and 8 written a cell (1.37
// us at 2x256x448), if a hole's search costs no more than a few loads.  Holes lie
// in bands along the frame's edges (a flow that moves away from an edge leaves
// whole columns or rows empty), so a search that walks cell by cell walks up to
// H or W cells, and the slowest lane holds up its warp.
// Design: one block per 32x32 tile, 1024 threads, a warp a row and a lane a
// column.  One coalesced read of the tile's sums gives each cell's mean (kept in
// shared memory) and each row's filled word by __ballot_sync; a ballot over those
// words gives each column's word.  A hole finds its nearest filled cell inside
// the tile with __clz/__ffs on its row and column words and reads that cell's
// mean from shared memory.  Where none lies inside the tile, the answer is the
// same for every hole of that row (or column): the row's warp reads SCAN_WORDS
// words of 32 cells at once along the row, both ways together, and the block
// reads SCAN_ROWS rows of the tile's 32 columns at once, up and down together,
// until a set bit turns up; the means of the cells found there load last, all
// holes' side by side.  So a search costs O((H + W) / 32) words, coalesced, in a
// few rounds of loads, and the bitmasks live in registers and shared memory: the
// entry needs no scratch buffer, and one kernel does it all.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;                    // a block's tile: 32 x 32 cells
constexpr int SCAN_WORDS = 4;               // words a row scan reads a round
constexpr int SCAN_ROW_WORDS = 4;           // rows a warp reads a column scan round
constexpr int SCAN_ROWS = TILE * SCAN_ROW_WORDS;  // rows a column scan round
constexpr unsigned FULL = 0xffffffffu;

// The mean of cell q of one frame's sums (sx, sy, count planes hw apart).
__device__ __forceinline__ float2 mean_at(const float* sums, int hw, int q) {
  const float* cell = sums + q;
  const float c = fmaxf(cell[2LL * hw], 1e-30f);
  return make_float2(cell[0] / c, cell[(long long)hw] / c);
}

// The nearest filled cells of row `row` left of x_left_end (if `left`) and at or
// right of x_right_begin (if `right`), or -1: both scans advance together, a
// round of SCAN_WORDS words each.  Called by a whole warp, with warp-uniform
// arguments.
__device__ int2 scan_row(const float* row, int x_left_end, int x_right_begin,
                         bool left, bool right, int w, int lane) {
  int xl = -1, xr = -1;
  for (int k0 = 0; left || right; k0 += SCAN_WORDS) {
    float vl[SCAN_WORDS], vr[SCAN_WORDS];
#pragma unroll
    for (int k = 0; k < SCAN_WORDS; ++k) {
      const int a = x_left_end - 32 * (k0 + k + 1) + lane;
      const int b = x_right_begin + 32 * (k0 + k) + lane;
      vl[k] = left && a >= 0 ? row[a] : 0.0f;
      vr[k] = right && b < w ? row[b] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < SCAN_WORDS; ++k) {
      const unsigned bl = __ballot_sync(FULL, vl[k] > 0.0f);
      const unsigned br = __ballot_sync(FULL, vr[k] > 0.0f);
      if (left && bl) {
        xl = x_left_end - 32 * (k0 + k + 1) + 31 - __clz(bl);
        left = false;
      }
      if (right && br) {
        xr = x_right_begin + 32 * (k0 + k) + __ffs(br) - 1;
        right = false;
      }
    }
    left = left && x_left_end - 32 * (k0 + SCAN_WORDS) > 0;
    right = right && x_right_begin + 32 * (k0 + SCAN_WORDS) < w;
  }
  return make_int2(xl, xr);
}

// Two blocks of 1024 threads fit an SM (32 registers a thread), so a frame of
// up to 2 x 132 tiles runs in one wave.
__global__ void __launch_bounds__(TILE * 32, 2)
    flow_project_finalize_kernel(const float* __restrict__ acc,
                                 float* __restrict__ out, int h, int w, int row_lo,
                                 int row_hi, const float* __restrict__ carry_up,
                                 const float* __restrict__ carry_down) {
  __shared__ float2 means[TILE][TILE];
  __shared__ unsigned rowbits[TILE], colbits[TILE];
  __shared__ unsigned scan_up[SCAN_ROWS], scan_down[SCAN_ROWS];
  __shared__ unsigned need_up, need_down;
  // the nearest filled cells beyond the tile, [0] left / up, [1] right /
  // down: a column per tile row, a row per tile column; -1 where none
  __shared__ int row_beyond[2][TILE], col_beyond[2][TILE];

  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 5;             // the warp's tile row
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int x = x0 + lane;
  const int hw = h * w;
  const float* sums = acc + 3LL * blockIdx.z * hw;
  const float* cnt = sums + 2LL * hw;
  float* ox = out + 2LL * blockIdx.z * hw;
  float* oy = ox + hw;
  const int q = (y0 + r) * w + x;

  if (threadIdx.x < TILE) {
    col_beyond[0][threadIdx.x] = col_beyond[1][threadIdx.x] = -1;
    if (threadIdx.x == 0) need_up = need_down = 0u;
  }

  // the cell's sums, its mean and the row's filled word
  const bool inside = x < w && y0 + r < h;
  float sx = 0.0f, sy = 0.0f, c = 0.0f;
  if (inside) {
    sx = sums[q];
    sy = sums[(long long)hw + q];
    c = cnt[q];
  }
  const bool filled = c > 0.0f;
  const bool hole = inside && !filled;
  const float cs = fmaxf(c, 1e-30f);
  const float2 m = make_float2(sx / cs, sy / cs);
  means[r][lane] = m;
  if (filled) {
    ox[q] = m.x;
    oy[q] = m.y;
  }
  const unsigned bits = __ballot_sync(FULL, filled);
  if (lane == 0) rowbits[r] = bits;

  // along the row, beyond the tile, where a hole needs it
  const bool need_l = __ballot_sync(FULL, hole && !(bits & ((1u << lane) - 1u))) && x0 > 0;
  const bool need_r =
      __ballot_sync(FULL, hole && !(bits & (lane == 31 ? 0u : FULL << (lane + 1)))) &&
      x0 + TILE < w;
  int2 xs = make_int2(-1, -1);
  if (need_l || need_r)
    xs = scan_row(cnt + (y0 + r) * w, x0, x0 + TILE, need_l, need_r, w, lane);
  if (lane == 0) {
    row_beyond[0][r] = xs.x;
    row_beyond[1][r] = xs.y;
  }
  __syncthreads();

  // along the column: the column's word from the interior row words
  const bool interior_row = y0 + lane >= row_lo && y0 + lane < row_hi;
  const unsigned col = __ballot_sync(FULL, interior_row && ((rowbits[lane] >> r) & 1u));
  if (lane == 0) colbits[r] = col;
  __syncthreads();
  const unsigned cbits = colbits[lane];
  const unsigned umask = cbits & ((1u << r) - 1u);
  const unsigned dmask = cbits & (r == 31 ? 0u : FULL << (r + 1));
  const unsigned nu = __ballot_sync(FULL, hole && !umask && y0 > row_lo);
  const unsigned nd = __ballot_sync(FULL, hole && !dmask && y0 + TILE < row_hi);
  if (lane == 0) {
    if (nu) atomicOr(&need_up, nu);
    if (nd) atomicOr(&need_down, nd);
  }
  __syncthreads();
  // beyond the tile: rounds of SCAN_ROWS rows up and down together; the warp
  // of row j resolves column j
  for (int k0 = 0;; k0 += SCAN_ROWS) {
    const unsigned todo_up = y0 - k0 > row_lo ? need_up : 0u;
    const unsigned todo_down = y0 + TILE + k0 < row_hi ? need_down : 0u;
    if (!(todo_up | todo_down)) break;
    float vu[SCAN_ROW_WORDS], vd[SCAN_ROW_WORDS];
#pragma unroll
    for (int k = 0; k < SCAN_ROW_WORDS; ++k) {
      const int yu = y0 - 1 - (k0 + r * SCAN_ROW_WORDS + k);
      const int yd = y0 + TILE + k0 + r * SCAN_ROW_WORDS + k;
      vu[k] = todo_up && yu >= row_lo && yu < row_hi && x < w ? cnt[yu * w + x] : 0.0f;
      vd[k] = todo_down && yd >= row_lo && yd < row_hi && x < w ? cnt[yd * w + x]
                                                                : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < SCAN_ROW_WORDS; ++k) {
      const unsigned bu = __ballot_sync(FULL, vu[k] > 0.0f);
      const unsigned bd = __ballot_sync(FULL, vd[k] > 0.0f);
      if (lane == 0) {
        scan_up[r * SCAN_ROW_WORDS + k] = bu;
        scan_down[r * SCAN_ROW_WORDS + k] = bd;
      }
    }
    __syncthreads();
    // the first set bit of column r in scan order is the nearest
    const int j = r;
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      if (!(((dir ? todo_down : todo_up) >> j) & 1u)) continue;
      const unsigned* rows = dir ? scan_down : scan_up;
#pragma unroll
      for (int part = 0; part < SCAN_ROW_WORDS; ++part) {
        const unsigned colw = __ballot_sync(FULL, (rows[part * 32 + lane] >> j) & 1u);
        if (colw) {
          if (lane == 0) {
            const int k = part * 32 + __ffs(colw) - 1;
            const int yy = dir ? y0 + TILE + k0 + k : y0 - 1 - (k0 + k);
            col_beyond[dir][j] = yy;
            atomicAnd(dir ? &need_down : &need_up, ~(1u << j));
          }
          break;
        }
      }
    }
    __syncthreads();
  }

  if (!hole) return;
  // the holes: left, right, up and down, summed in that order
  const unsigned lmask = bits & ((1u << lane) - 1u);
  const unsigned rmask = bits & (lane == 31 ? 0u : FULL << (lane + 1));
  float nx = 0.0f, ny = 0.0f, den = 0.0f;
  auto add = [&](float2 v) {
    nx += v.x;
    ny += v.y;
    den += 1.0f;
  };
  // a neighbour inside the tile from shared memory; one beyond it from device
  // memory, the four loads side by side
  const int row = (y0 + r) * w;
  const int xl = row_beyond[0][r], xr = row_beyond[1][r];
  const int yu = col_beyond[0][lane], yd = col_beyond[1][lane];
  float2 beyond[4];
  if (!lmask && xl >= 0) beyond[0] = mean_at(sums, hw, row + xl);
  if (!rmask && xr >= 0) beyond[1] = mean_at(sums, hw, row + xr);
  if (!umask && yu >= 0) beyond[2] = mean_at(sums, hw, yu * w + x);
  if (!dmask && yd >= 0) beyond[3] = mean_at(sums, hw, yd * w + x);
  // a column with no filled interior cell up (down) takes the carry, if any
  const long long cq = 3LL * blockIdx.z * w + x;
  const bool take_up = !umask && yu < 0 && carry_up != nullptr && carry_up[cq + 2LL * w] > 0.0f;
  const bool take_down =
      !dmask && yd < 0 && carry_down != nullptr && carry_down[cq + 2LL * w] > 0.0f;
  if (take_up) beyond[2] = make_float2(carry_up[cq], carry_up[cq + w]);
  if (take_down) beyond[3] = make_float2(carry_down[cq], carry_down[cq + w]);
  if (lmask) add(means[r][31 - __clz(lmask)]);
  else if (xl >= 0) add(beyond[0]);
  if (rmask) add(means[r][__ffs(rmask) - 1]);
  else if (xr >= 0) add(beyond[1]);
  if (umask) add(means[31 - __clz(umask)][lane]);
  else if (yu >= 0 || take_up) add(beyond[2]);
  if (dmask) add(means[__ffs(dmask) - 1][lane]);
  else if (yd >= 0 || take_down) add(beyond[3]);
  ox[q] = den > 0.0f ? nx / den : 0.0f;
  oy[q] = den > 0.0f ? ny / den : 0.0f;
}

}  // namespace

// Frames of fewer than 2^31 cells (the offsets inside a frame are 32-bit).
// row_lo, row_hi: the rows that the up and down searches cover (0 and h outside
// a row-sharded frame); carry_up, carry_down (N,3,W) or NULL: no carry.
extern "C" int vfidkr_flow_project_finalize(const float* acc, float* out, int n,
                                            int h, int w, int row_lo, int row_hi,
                                            const float* carry_up,
                                            const float* carry_down,
                                            cudaStream_t stream) {
  if ((long long)h * w > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (row_lo < 0 || row_hi > h || row_lo > row_hi) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  flow_project_finalize_kernel<<<grid, TILE * 32, 0, stream>>>(
      acc, out, h, w, row_lo, row_hi, carry_up, carry_down);
  return (int)cudaGetLastError();
}
