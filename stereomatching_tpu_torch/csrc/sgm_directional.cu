// K4: one SGM path recurrence, added into the aggregate, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_sgm.py:337
// sgm_directional_pallas (body _kernel, :83; _step_math, _min_over_d; the
// diagonals through lane_shift +-1, shift_carry :174-185), which
// aggregate_from_scan_major (:1249) drives once per path, 4 or 8 times.
// Semantics (ops/sgm.py _directional, _directional_diag): along one scan
// line of the cost volume C [B, H, W, D], walked forward or in reverse,
//     L[0] = C[0]
//     L[s, d] = C[s, d] + min(L[s-1, d], min(L[s-1, d-1], L[s-1, d+1]) + P1,
//                             m + P2) - m,        m = min_d' L[s-1, d'],
// with L[s-1, -1] = L[s-1, D] = 2^28.  A line is a row (direction 0), a
// column (1), or a diagonal stepping (y+1, x+1) (2) or (y+1, x-1) (3).  A
// diagonal starts on row 0 or on its first (2) or last (3) column, so a
// cell whose predecessor is outside the image starts its line (L = C, the
// JAX package's all-_BIG carry).  The bottom-to-top diagonals are the
// reverse walks of the same two families.  The kernel writes agg = L
// (accumulate = 0) or agg += L (accumulate = 1); four launches (rows and
// columns, both ways) give the 4-path sum, eight with the diagonals the
// 8-path sum.  The arithmetic is int32; C is stored int8, int16 or int32
// and the aggregate int16 or int32 (every L >= 0, so each partial sum is at
// most the final one, which the caller's bounds keep exact).
//
// Seed and carry (directions 1-3; the Pallas kernel's seed= / with_carry=,
// fused_sgm.py:403-412, :555-581, driven by the sharded tier's phased
// chain, stereomatching_tpu/parallel/modern.py:504-573): a row shard walks
// its columns (or diagonals) on from the shard before it.  With `seed`
// (int32 [B, W, D], the last row the previous shard scanned, unshifted),
// a line's first cell on the first scanned row (row 0, or row H-1 in
// reverse) takes L[s-1] = seed[x - sx] instead of starting, sx being the
// walk's x step (0, +1 or -1); where x - sx leaves [0, W) it starts as
// before (L = C, the all-2^28 carry).  A diagonal's start on its side
// column stays a start.  With `carry` (int32 [B, W, D]), each cell of the
// last scanned row (row H-1, or row 0 in reverse) also writes its L there,
// unshifted: the next shard's seed.  So a seeded launch continuing a
// carrying one gives the values of one launch over both shards, bit for
// bit (the JAX carry is stored in the volume's type; the values are equal).
// The seed and carry live in the kernel's CHAIN variant: a line's first and
// last scanned cells follow from its geometry, so the seed is read before
// the step loop and the carry written after it (the last step's L is still
// in registers), and the step loop is the plain kernel's.
//
// What bounds it on the H100: device memory, then latency.  Each step of a
// line reads D costs and (when accumulating) D aggregate values and writes
// D values, against ~10 integer ops per value; the chain of steps along a
// line is serial, so the card needs many lines in flight to hide each
// step's load latency.
//
// Design (simple and right first): one warp per scan line, D across the
// lanes, lane l holding the ND = ceil(D/32) consecutive disparities
// d = l*ND .. l*ND+ND-1 (so a step's D values are one contiguous run of
// memory, read and written coalesced).  In the [B, H, W, D] layout every
// line has a constant stride (D, W*D, (W+1)*D or (W-1)*D elements), so
// rows, columns and diagonals share the walk; only each line's start and
// length differ (a diagonal is 1 to min(H, W) steps long, so the corner
// lines finish early).  The carry L[s-1] stays in
// registers; d-1 and d+1 are register neighbours except at the lane edge,
// which one __shfl_up_sync and one __shfl_down_sync bring over; m is one
// __reduce_min_sync.  Lanes past D hold 2^28 and are never stored.  The
// next step's costs (and aggregate values) are loaded before the current
// step's arithmetic, so one step's load latency overlaps the previous
// step's work.  Launches run in order on one stream, so the paths never
// race on the aggregate.  None of the TPU structure is carried over (no
// scan-major relayouts, lane rolls, folds or chunk-major walks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // 8 warps, 8 lines per block
constexpr int BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;

// Lines of one direction per image: rows, columns, or diagonals (one per
// cell of row 0 and of the start column below it).
__host__ __device__ inline long long lines_per_image(int dir, int H, int W) {
  return dir == 0 ? H : dir == 1 ? W : (long long)W + H - 1;
}

// Start element, length and element stride of scan line `line` (image-major),
// and its first cell's row and column.
__device__ __forceinline__ void line_geometry(long long line, int dir, int H,
                                              int W, int D, long long& base,
                                              int& len, long long& step,
                                              int& y0, int& x0) {
  const long long n = lines_per_image(dir, H, W);
  const long long img = (line / n) * H * W * D;
  const int l = (int)(line % n);
  if (dir == 0) {  // the row y = l
    y0 = l; x0 = 0; len = W; step = D;
  } else if (dir == 1) {  // the column x = l
    y0 = 0; x0 = l; len = H; step = (long long)W * D;
  } else {  // the diagonal from (0, l), or from (l - W + 1, first/last column)
    const int dx = dir == 2 ? 1 : -1;
    if (l < W) {
      y0 = 0; x0 = l;
    } else {
      y0 = l - W + 1; x0 = dx > 0 ? 0 : W - 1;
    }
    len = min(H - y0, dx > 0 ? W - x0 : x0 + 1);
    step = (long long)(W + dx) * D;
  }
  base = img + ((long long)y0 * W + x0) * D;
}

template <typename TV, typename TA, int ND, bool CHAIN>
__global__ void __launch_bounds__(NT)
directional_kernel(const TV* __restrict__ vol, TA* __restrict__ agg,
                   long long n_lines, int dir, int H, int W, int D, int p1,
                   int p2, bool reverse, bool accumulate,
                   const int* __restrict__ seed, int* __restrict__ carry) {
  const long long line = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (line >= n_lines) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int d0 = lane * ND;
  long long base, step;
  int len, y0, x0;
  line_geometry(line, dir, H, W, D, base, len, step, y0, x0);
  const long long delta = reverse ? -step : step;
  long long pos = reverse ? base + (long long)(len - 1) * step : base;

  int cost[ND], acc[ND], prev[ND];
  bool seeded = false;
  int* carry_at = nullptr;  // the carry slot of the line's last scanned cell
  if constexpr (CHAIN) {
    // First and last scanned cells; the walk's x step is xs.
    const int dx = dir == 2 ? 1 : dir == 3 ? -1 : 0;
    const int y1 = y0 + len - 1, x1 = x0 + (len - 1) * dx;
    const int yf = reverse ? y1 : y0, xf = reverse ? x1 : x0;
    const int yl = reverse ? y0 : y1, xl = reverse ? x0 : x1;
    const int xs = reverse ? -dx : dx;
    const long long edge = line / lines_per_image(dir, H, W) * W * D;
    if (seed != nullptr && yf == (reverse ? H - 1 : 0) && xf - xs >= 0 && xf - xs < W) {
      seeded = true;
      const int* sp = seed + edge + (long long)(xf - xs) * D;
#pragma unroll
      for (int k = 0; k < ND; ++k) prev[k] = d0 + k < D ? sp[d0 + k] : BIG;
    }
    if (carry != nullptr && yl == (reverse ? 0 : H - 1))
      carry_at = carry + edge + (long long)xl * D;
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const bool in = d0 + k < D;
    cost[k] = in ? (int)vol[pos + d0 + k] : BIG;
    acc[k] = (in && accumulate) ? (int)agg[pos + d0 + k] : 0;
  }
  for (int s = 0; s < len; ++s) {
    int cost_n[ND], acc_n[ND];
    const long long pos_n = pos + delta;
    const bool more = s + 1 < len;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const bool in = more && d0 + k < D;
      cost_n[k] = in ? (int)vol[pos_n + d0 + k] : BIG;
      acc_n[k] = (in && accumulate) ? (int)agg[pos_n + d0 + k] : 0;
    }
    int L[ND];
    if (s == 0 && !seeded) {
#pragma unroll
      for (int k = 0; k < ND; ++k) L[k] = cost[k];  // path start: L = C
    } else {
      int lm = prev[0];
#pragma unroll
      for (int k = 1; k < ND; ++k) lm = min(lm, prev[k]);
      const int m = __reduce_min_sync(FULL, lm);
      int below = __shfl_up_sync(FULL, prev[ND - 1], 1);  // L[d0 - 1]
      int above = __shfl_down_sync(FULL, prev[0], 1);     // L[d0 + ND]
      if (lane == 0) below = BIG;
      if (lane == 31) above = BIG;
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        const int dn = k > 0 ? prev[k - 1] : below;
        const int up = k < ND - 1 ? prev[k + 1] : above;
        const int best = min(min(prev[k], min(up, dn) + p1), m + p2);
        L[k] = d0 + k < D ? cost[k] + best - m : BIG;
      }
    }
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      if (d0 + k < D) agg[pos + d0 + k] = (TA)(acc[k] + L[k]);
      prev[k] = L[k];
      cost[k] = cost_n[k];
      acc[k] = acc_n[k];
    }
    pos = pos_n;
  }
  if constexpr (CHAIN) {
    if (carry_at != nullptr) {
#pragma unroll
      for (int k = 0; k < ND; ++k)
        if (d0 + k < D) carry_at[d0 + k] = prev[k];
    }
  }
}

template <typename TV, typename TA, int ND>
cudaError_t launch_nd(const void* vol, void* agg, long long n_lines, int dir,
                      int H, int W, int D, int p1, int p2, bool reverse,
                      bool accumulate, const int* seed, int* carry,
                      cudaStream_t st) {
  const long long blocks = (n_lines + NT / 32 - 1) / (NT / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (seed != nullptr || carry != nullptr)
    directional_kernel<TV, TA, ND, true><<<(unsigned)blocks, NT, 0, st>>>(
        (const TV*)vol, (TA*)agg, n_lines, dir, H, W, D, p1, p2, reverse,
        accumulate, seed, carry);
  else
    directional_kernel<TV, TA, ND, false><<<(unsigned)blocks, NT, 0, st>>>(
        (const TV*)vol, (TA*)agg, n_lines, dir, H, W, D, p1, p2, reverse,
        accumulate, nullptr, nullptr);
  return cudaGetLastError();
}

template <typename TV, typename TA>
cudaError_t launch(int nd, const void* vol, void* agg, long long n_lines,
                   int dir, int H, int W, int D, int p1, int p2, bool reverse,
                   bool accumulate, const int* seed, int* carry,
                   cudaStream_t st) {
  switch (nd) {
    case 1: return launch_nd<TV, TA, 1>(vol, agg, n_lines, dir, H, W, D, p1, p2, reverse, accumulate, seed, carry, st);
    case 2: return launch_nd<TV, TA, 2>(vol, agg, n_lines, dir, H, W, D, p1, p2, reverse, accumulate, seed, carry, st);
    case 4: return launch_nd<TV, TA, 4>(vol, agg, n_lines, dir, H, W, D, p1, p2, reverse, accumulate, seed, carry, st);
    case 8: return launch_nd<TV, TA, 8>(vol, agg, n_lines, dir, H, W, D, p1, p2, reverse, accumulate, seed, carry, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TV>
cudaError_t launch_agg(int agg_bytes, int nd, const void* vol, void* agg,
                       long long n_lines, int dir, int H, int W, int D, int p1,
                       int p2, bool reverse, bool accumulate, const int* seed,
                       int* carry, cudaStream_t st) {
  switch (agg_bytes) {
    case 2: return launch<TV, int16_t>(nd, vol, agg, n_lines, dir, H, W, D, p1, p2, reverse, accumulate, seed, carry, st);
    case 4: return launch<TV, int32_t>(nd, vol, agg, n_lines, dir, H, W, D, p1, p2, reverse, accumulate, seed, carry, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// vol: [B, H, W, D] of `vol_bytes` (1, 2, 4: int8, int16, int32).
// agg: [B, H, W, D] of `agg_bytes` (2, 4: int16, int32), written
// (accumulate = 0) or added to (accumulate = 1).  direction: 0 walks rows
// (x), 1 columns (y), 2 the diagonals stepping (y+1, x+1), 3 those stepping
// (y+1, x-1); reverse: 1 starts at each line's last cell.  D <= 256.
// seed / carry: int32 [B, W, D] or NULL, directions 1-3 only (see the
// top of this file).  Launches on `stream`; returns cudaGetLastError().
int sgm_directional(const void* vol, int vol_bytes, void* agg, int agg_bytes,
                    int B, int H, int W, int D, int p1, int p2, int direction,
                    int reverse, int accumulate, const void* seed, void* carry,
                    void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || D > 256 || direction < 0 ||
      direction > 3 || (direction == 0 && (seed != nullptr || carry != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* sd = (const int*)seed;
  int* cr = (int*)carry;
  const int nd32 = (D + 31) / 32;
  const int nd = nd32 <= 1 ? 1 : nd32 <= 2 ? 2 : nd32 <= 4 ? 4 : 8;
  const long long n_lines = (long long)B * lines_per_image(direction, H, W);
  cudaStream_t st = (cudaStream_t)stream;
  const bool rev = reverse != 0, acc = accumulate != 0;
  switch (vol_bytes) {
    case 1: return (int)launch_agg<int8_t>(agg_bytes, nd, vol, agg, n_lines, direction, H, W, D, p1, p2, rev, acc, sd, cr, st);
    case 2: return (int)launch_agg<int16_t>(agg_bytes, nd, vol, agg, n_lines, direction, H, W, D, p1, p2, rev, acc, sd, cr, st);
    case 4: return (int)launch_agg<int32_t>(agg_bytes, nd, vol, agg, n_lines, direction, H, W, D, p1, p2, rev, acc, sd, cr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
