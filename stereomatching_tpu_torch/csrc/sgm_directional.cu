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
// What bounds it on the H100: bytes per pass, and the bytes each line keeps
// in flight.  Every pass moves the whole aggregate through device memory:
// the written pass reads the volume and writes the aggregate (3 B per
// voxel at int8 / int16), each accumulating pass also reads the aggregate
// back (5 B), so at 8 x 1024^2 x 64 a pass cannot beat 0.48 ms (written)
// or 0.80 ms (accumulating) at 3.35 TB/s, against ~9 integer ops per voxel
// (0.29 ms at 16.7 T op/s).  The steps of one line are a serial chain, so
// the bytes in flight are the lines in flight times the steps each has
// issued ahead.  By Little's law 3.35 TB/s at HBM's loaded latency
// (~0.7-0.8 us) needs ~2.5 MB in flight, ~19 KB per SM: at one step ahead
// (192 B a line at D = 64, accumulating) that is ~100 lines per SM, more
// than the ~62 the bench shape's 8192 row or column lines give.  Next come
// the instructions: a step is ~50-70 of them per warp, so the 8.4 M
// warp-steps of a pass take ~0.4-0.5 ms of issue on the card's 528
// schedulers, close to the byte floor.
//
// Design: one warp per scan line, D across the lanes, lane l holding the
// ND = ceil(D/32) consecutive disparities d = l*ND .. l*ND+ND-1 (so a step's
// D values are one contiguous run of memory, read and written coalesced).
// In the [B, H, W, D] layout every line has a constant stride (D, W*D,
// (W+1)*D or (W-1)*D elements), so rows, columns and diagonals share the
// walk; only each line's start and length differ (a diagonal is 1 to
// min(H, W) steps long).  The carry L[s-1] stays in registers; d-1 and d+1
// are register neighbours except at the lane edge, which one
// __shfl_up_sync and one __shfl_down_sync bring over; m is one
// __reduce_min_sync.
//   * A ring of S = 8 steps in shared memory, filled by cp.async
//     (the mechanism: a ring in registers, tried first, held the loads in
//     flight in 54 registers a thread, halved the resident warps and lost
//     to the old loop; PERF.md).  Each warp owns S stages, each one step's
//     run of costs and (accumulating) of aggregate values.  Step s waits
//     only for its own stage (cp.async.wait_group S-1), reads it into
//     registers, and issues the copies of step s + S into that stage
//     before its arithmetic: each line keeps S steps in flight, 8 x 192 B
//     at D = 64, accumulating, in 12 KB of shared memory per block of 8
//     lines.  The step loop runs in rounds of S steps, so each step's stage
//     is a constant offset (no stage arithmetic), after a first step that
//     starts the path; the compiler then overlaps the round's steps (116
//     registers at the bench instance: 16 warps per SM, each with 1.5 KB
//     in flight).  S, the rounds and the natural order of the lines came
//     from measurements at the bench shape (PERF.md): S = 2 and 4, one
//     step at a time, longest diagonals first, and a cap of 64 registers
//     were all slower or no faster.  At D = 128 and 256 and on int16 and
//     int32 volumes the ring beats the element path too, and S = 8 is
//     within 2.5% of the best depth, so every aligned shape takes it.
//   * Vector accesses: the copies move 16-byte chunks (lane q takes chunk
//     q: at D = 64, int8 / int16, four lanes copy the costs and eight the
//     aggregate); a lane reads its ND costs from its stage as one access,
//     its ND aggregate values as one, and stores them as one.  The ring
//     needs a step's runs to be multiples of 16 bytes, both arrays 16-byte
//     aligned and D % ND == 0 (D a multiple of 16 at int8, of 8 at int16,
//     of 4 at int32, up to the D % ND rule); other shapes (D = 11, 37, 40
//     or 100 at int8, ...) take the element path: each lane loads its own
//     values, element by element, one step ahead (the kernel before this
//     ring), and values past D are held at 2^28.  In the ring every lane is
//     inside D or wholly past it; a lane past D is left out of the min and
//     of its neighbour's d + 1 instead, and never stored.
//   * Lines shorter than the ring, and a line's end, issue no copies past
//     the line's last step (each step still commits its, then empty, copy
//     group, so the wait counts stay in step).
// Launches run in order on one stream, so the paths never race on the
// aggregate.  None of the TPU structure is carried over (no scan-major
// relayouts, lane rolls, folds or chunk-major walks).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // 8 warps, 8 lines per block
constexpr int S = 8;  // the ring's depth in steps
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

// One lane's run of N values of one step: one access of N * sizeof(T)
// bytes (two of 16 at 32 bytes).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Run {
  T v[N];
};

// Load a lane's run of N values (aligned to it, in shared memory) as one
// access, widened to int.
template <typename T, int N>
__device__ __forceinline__ void load_run(int (&x)[N], const T* p) {
  const Run<T, N> r = *reinterpret_cast<const Run<T, N>*>(p);
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = r.v[k];
}

// Store a lane's run of N values as one access of N * sizeof(T) bytes (p
// aligned to it; two of 16 at 32 bytes), packed into 32-bit words.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* p, const int (&x)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES < 4) {  // one int16
    *p = (T)x[0];
  } else {
    constexpr int E = 4 / (int)sizeof(T), W = BYTES / 4;  // per word, words
    constexpr unsigned MASK = sizeof(T) == 4 ? 0xffffffffu : (1u << (8 * sizeof(T))) - 1;
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      w[i] = 0;
#pragma unroll
      for (int e = 0; e < E; ++e)
        w[i] |= ((uint32_t)x[i * E + e] & MASK) << (8 * sizeof(T) * e);
    }
    if constexpr (W == 1) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < W; i += 4)
        reinterpret_cast<uint4*>(p)[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    }
  }
}

// A warp's stage: one step's costs and aggregate values for all 32 lanes.
template <typename TV, typename TA, int ND>
struct Stage {
  static constexpr int COST = 32 * ND * (int)sizeof(TV);
  static constexpr int BYTES = COST + 32 * ND * (int)sizeof(TA);
};

// ASYNC: the ring of S stages in shared memory, filled by 16-byte
// cp.async copies (a step's runs of costs and aggregate values multiples
// of 16 bytes, both arrays 16-byte aligned, D % ND == 0).  Otherwise each
// lane loads its own values, element by element, one step ahead.
template <typename TV, typename TA, int ND, bool CHAIN, bool ASYNC>
__global__ void __launch_bounds__(NT)
directional_kernel(const TV* __restrict__ vol, TA* __restrict__ agg,
                   long long n_lines, int dir, int H, int W, int D, int p1,
                   int p2, bool reverse, bool accumulate,
                   const int* __restrict__ seed, int* __restrict__ carry) {
  using St = Stage<TV, TA, ND>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long line = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (line >= n_lines) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int d0 = lane * ND;
  long long base, step;
  int len, y0, x0;
  line_geometry(line, dir, H, W, D, base, len, step, y0, x0);
  const long long delta = reverse ? -step : step;
  long long pos = base + (reverse ? (long long)(len - 1) * step : 0);  // step s's run

  int prev[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) prev[k] = BIG;
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

  // One step of the recurrence from this lane's costs and aggregate values
  // (0 unless accumulating): out = acc + L, prev = L; `start` starts the
  // path (L = C).  In the ring every lane is wholly inside D or past it,
  // and a lane past D keeps whatever it computes: it is left out of the
  // min and of its neighbour's d + 1 (`last` is the last lane inside D).
  // Otherwise each value past D is held at 2^28.
  const int last = D / ND - 1;
  auto advance = [&](const int (&cost)[ND], const int (&acc)[ND], bool start, int (&out)[ND]) {
    int lm = prev[0];
#pragma unroll
    for (int k = 1; k < ND; ++k) lm = min(lm, prev[k]);
    if (ASYNC && lane > last) lm = BIG;
    const int m = __reduce_min_sync(FULL, lm);
    int below = __shfl_up_sync(FULL, prev[ND - 1], 1);  // L[d0 - 1]
    int above = __shfl_down_sync(FULL, prev[0], 1);     // L[d0 + ND]
    if (lane == 0) below = BIG;
    if (lane == (ASYNC ? last : 31)) above = BIG;
    int L[ND];
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const int dn = k > 0 ? prev[k - 1] : below;
      const int up = k < ND - 1 ? prev[k + 1] : above;
      const int best = min(min(prev[k], min(up, dn) + p1), m + p2);
      L[k] = start ? cost[k] : cost[k] + best - m;
      if (!ASYNC && d0 + k >= D) L[k] = BIG;
      out[k] = acc[k] + L[k];
    }
#pragma unroll
    for (int k = 0; k < ND; ++k) prev[k] = L[k];
  };

  if constexpr (ASYNC) {
    // A step's runs are n_chunks chunks of 16 bytes, the costs' then the
    // aggregate's.  Lane l copies chunks l + 32 c, c < CPL (a step's runs
    // are at most 32 * ND * 8 bytes); chunk c's source advances with the
    // walk (src[c], by src_step[c] bytes a step) and lands at offset
    // dst[c] of every stage.
    constexpr int CPL = ND > 2 ? ND / 2 : 1;
    const int cost_bytes = D * (int)sizeof(TV);
    const int n_chunks = (cost_bytes + (accumulate ? D * (int)sizeof(TA) : 0)) / 16;
    const unsigned char* src[CPL];
    long long src_step[CPL];
    int dst[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int b = (lane + 32 * c) * 16;
      const bool in_agg = b >= cost_bytes;
      const int off = in_agg ? b - cost_bytes : b;
      const int esz = in_agg ? (int)sizeof(TA) : (int)sizeof(TV);
      src[c] = (in_agg ? reinterpret_cast<const unsigned char*>(agg)
                       : reinterpret_cast<const unsigned char*>(vol)) + pos * esz + off;
      src_step[c] = delta * esz;
      dst[c] = (in_agg ? St::COST : 0) + off;
    }
    unsigned char* const ring = smem + (threadIdx.x / 32) * S * St::BYTES;
    // Copy the next step's runs into stage st (if `more`), one commit
    // group per step.
    auto fill = [&](int st, bool more) {
      unsigned char* const stage = ring + st * St::BYTES;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (more && lane + 32 * c < n_chunks) __pipeline_memcpy_async(stage + dst[c], src[c], 16);
        src[c] += src_step[c];
      }
      __pipeline_commit();
    };
#pragma unroll
    for (int j = 0; j < S; ++j) fill(j, j < len);
    TA* ap = agg + pos + d0;  // this lane's run of step s
    // Step s from stage st (s % S): wait for its copies, read them, send
    // step s + S's copies into the stage, then the arithmetic.
    auto step = [&](int s, int st, bool start) {
      __pipeline_wait_prior(S - 1);  // this lane's copies of step s are in
      __syncwarp();                  // and so are the other lanes'
      const unsigned char* const stage = ring + st * St::BYTES;
      int cost[ND], acc[ND], out[ND];
      load_run(cost, reinterpret_cast<const TV*>(stage) + d0);
#pragma unroll
      for (int k = 0; k < ND; ++k) acc[k] = 0;
      if (accumulate) load_run(acc, reinterpret_cast<const TA*>(stage + St::COST) + d0);
      __syncwarp();  // every lane has read the stage before it is refilled
      fill(st, s + S < len);
      advance(cost, acc, start, out);
      if (d0 < D) store_run(ap, out);
      ap += delta;
    };
    // Step 0, then whole rounds of S steps (stage j + 1 mod S for step
    // 1 + j of a round, so each stage is a constant), then the rest.
    step(0, 0, !seeded);
    int s = 1;
    for (; s + S <= len; s += S) {
#pragma unroll
      for (int j = 0; j < S; ++j) step(s + j, (j + 1) & (S - 1), false);
    }
    for (; s < len; ++s) step(s, s & (S - 1), false);
  } else {
    int cost[ND], acc[ND];
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
      int out[ND];
      advance(cost, acc, s == 0 && !seeded, out);
      TA* ap = agg + pos + d0;
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        if (d0 + k < D) ap[k] = (TA)out[k];
        cost[k] = cost_n[k];
        acc[k] = acc_n[k];
      }
      pos = pos_n;
    }
  }
  if constexpr (CHAIN) {
    if (carry_at != nullptr) {
#pragma unroll
      for (int k = 0; k < ND; ++k)
        if (d0 + k < D) carry_at[d0 + k] = prev[k];
    }
  }
}

template <typename TV, typename TA, int ND, bool CHAIN, bool ASYNC>
cudaError_t launch_kernel(const void* vol, void* agg, long long n_lines, int dir,
                          int H, int W, int D, int p1, int p2, bool reverse,
                          bool accumulate, const int* seed, int* carry,
                          cudaStream_t st) {
  const long long blocks = (n_lines + NT / 32 - 1) / (NT / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = ASYNC ? NT / 32 * S * Stage<TV, TA, ND>::BYTES : 0;
  auto kernel = directional_kernel<TV, TA, ND, CHAIN, ASYNC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, NT, smem, st>>>(
      (const TV*)vol, (TA*)agg, n_lines, dir, H, W, D, p1, p2, reverse,
      accumulate, seed, carry);
  return cudaGetLastError();
}

template <typename TV, typename TA, int ND>
cudaError_t launch_nd(const void* vol, void* agg, long long n_lines, int dir,
                      int H, int W, int D, int p1, int p2, bool reverse,
                      bool accumulate, const int* seed, int* carry,
                      cudaStream_t st) {
  // The ring takes 16-byte copies and whole lanes: a step's runs of both
  // arrays are multiples of 16 bytes, both arrays 16-byte aligned, and
  // D % ND == 0 (a lane is wholly inside D or past it, and its run of the
  // aggregate one aligned store).
  const bool async = ((uintptr_t)vol | (uintptr_t)agg | (uintptr_t)(D * sizeof(TV)) |
                      (uintptr_t)(D * sizeof(TA))) % 16 == 0 && D % ND == 0;
  const bool chain = seed != nullptr || carry != nullptr;
#define K4_LAUNCH(C, A)                                                          \
  return launch_kernel<TV, TA, ND, C, A>(vol, agg, n_lines, dir, H, W, D, p1, p2, \
                                         reverse, accumulate, seed, carry, st)
  if (chain) {
    if (async) K4_LAUNCH(true, true);
    K4_LAUNCH(true, false);
  }
  if (async) K4_LAUNCH(false, true);
  K4_LAUNCH(false, false);
#undef K4_LAUNCH
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
