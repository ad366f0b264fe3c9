// K4: one SGM path recurrence, added into the aggregate, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_sgm.py:337
// sgm_directional_pallas (body _kernel, :83; _step_math, _min_over_d),
// which aggregate_from_scan_major (:1249) drives once per path.
// Semantics (ops/sgm.py _directional): along one scan line of the cost
// volume C [B, H, W, D] (a row for the horizontal paths, a column for the
// vertical ones, walked forward or in reverse),
//     L[0] = C[0]
//     L[s, d] = C[s, d] + min(L[s-1, d], min(L[s-1, d-1], L[s-1, d+1]) + P1,
//                             m + P2) - m,        m = min_d' L[s-1, d'],
// with L[s-1, -1] = L[s-1, D] = 2^28.  The kernel writes agg = L
// (accumulate = 0) or agg += L (accumulate = 1); four launches (lr, rl, tb,
// bt) give the 4-path sum.  The arithmetic is int32; C is stored int8,
// int16 or int32 and the aggregate int16 or int32 (the caller's bounds keep
// every value exact).
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
// memory, read and written coalesced).  The carry L[s-1] stays in
// registers; d-1 and d+1 are register neighbours except at the lane edge,
// which one __shfl_up_sync and one __shfl_down_sync bring over; m is one
// __reduce_min_sync.  Lanes past D hold 2^28 and are never stored.  The
// next step's costs (and aggregate values) are loaded before the current
// step's arithmetic, so one step's load latency overlaps the previous
// step's work.  Launches run in order on one stream, so the four paths
// never race on the aggregate.  None of the TPU structure is carried over
// (no scan-major relayouts, lane rolls, folds or chunk-major walks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // 8 warps, 8 lines per block
constexpr int BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;

template <typename TV, typename TA, int ND>
__global__ void __launch_bounds__(NT)
directional_kernel(const TV* __restrict__ vol, TA* __restrict__ agg,
                   long long n_lines, int len, long long inner,
                   long long outer_stride, long long step, int D, int p1,
                   int p2, bool reverse, bool accumulate) {
  const long long line = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (line >= n_lines) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int d0 = lane * ND;
  const long long base = (line / inner) * outer_stride + (line % inner) * D;
  const long long delta = reverse ? -step : step;
  long long pos = reverse ? base + (long long)(len - 1) * step : base;

  int cost[ND], acc[ND], prev[ND];
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
    if (s == 0) {
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
}

template <typename TV, typename TA, int ND>
cudaError_t launch_nd(const void* vol, void* agg, long long n_lines, int len,
                      long long inner, long long outer, long long step, int D,
                      int p1, int p2, bool reverse, bool accumulate,
                      cudaStream_t st) {
  const long long blocks = (n_lines + NT / 32 - 1) / (NT / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  directional_kernel<TV, TA, ND><<<(unsigned)blocks, NT, 0, st>>>(
      (const TV*)vol, (TA*)agg, n_lines, len, inner, outer, step, D, p1, p2,
      reverse, accumulate);
  return cudaGetLastError();
}

template <typename TV, typename TA>
cudaError_t launch(int nd, const void* vol, void* agg, long long n_lines,
                   int len, long long inner, long long outer, long long step,
                   int D, int p1, int p2, bool reverse, bool accumulate,
                   cudaStream_t st) {
  switch (nd) {
    case 1: return launch_nd<TV, TA, 1>(vol, agg, n_lines, len, inner, outer, step, D, p1, p2, reverse, accumulate, st);
    case 2: return launch_nd<TV, TA, 2>(vol, agg, n_lines, len, inner, outer, step, D, p1, p2, reverse, accumulate, st);
    case 4: return launch_nd<TV, TA, 4>(vol, agg, n_lines, len, inner, outer, step, D, p1, p2, reverse, accumulate, st);
    case 8: return launch_nd<TV, TA, 8>(vol, agg, n_lines, len, inner, outer, step, D, p1, p2, reverse, accumulate, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TV>
cudaError_t launch_agg(int agg_bytes, int nd, const void* vol, void* agg,
                       long long n_lines, int len, long long inner,
                       long long outer, long long step, int D, int p1, int p2,
                       bool reverse, bool accumulate, cudaStream_t st) {
  switch (agg_bytes) {
    case 2: return launch<TV, int16_t>(nd, vol, agg, n_lines, len, inner, outer, step, D, p1, p2, reverse, accumulate, st);
    case 4: return launch<TV, int32_t>(nd, vol, agg, n_lines, len, inner, outer, step, D, p1, p2, reverse, accumulate, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// vol: [B, H, W, D] of `vol_bytes` (1, 2, 4: int8, int16, int32).
// agg: [B, H, W, D] of `agg_bytes` (2, 4: int16, int32), written
// (accumulate = 0) or added to (accumulate = 1).  along_y: 0 walks rows
// (x), 1 walks columns (y); reverse: 1 starts at the last index.
// D <= 256.  Launches on `stream`; returns cudaGetLastError().
int sgm_directional(const void* vol, int vol_bytes, void* agg, int agg_bytes,
                    int B, int H, int W, int D, int p1, int p2, int along_y,
                    int reverse, int accumulate, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  const int nd32 = (D + 31) / 32;
  const int nd = nd32 <= 1 ? 1 : nd32 <= 2 ? 2 : nd32 <= 4 ? 4 : 8;
  const long long hwd = (long long)H * W * D;
  long long n_lines, inner, outer, step;
  int len;
  if (along_y) {  // one line per (b, x), stepping down the rows
    n_lines = (long long)B * W;
    inner = W;
    outer = hwd;
    step = (long long)W * D;
    len = H;
  } else {  // one line per (b, y), stepping along the row
    n_lines = (long long)B * H;
    inner = 1;
    outer = (long long)W * D;
    step = D;
    len = W;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool rev = reverse != 0, acc = accumulate != 0;
  switch (vol_bytes) {
    case 1: return (int)launch_agg<int8_t>(agg_bytes, nd, vol, agg, n_lines, len, inner, outer, step, D, p1, p2, rev, acc, st);
    case 2: return (int)launch_agg<int16_t>(agg_bytes, nd, vol, agg, n_lines, len, inner, outer, step, D, p1, p2, rev, acc, st);
    case 4: return (int)launch_agg<int32_t>(agg_bytes, nd, vol, agg, n_lines, len, inner, outer, step, D, p1, p2, rev, acc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
