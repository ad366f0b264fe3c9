// K5: the fused SGM tail over the aggregated volume, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_sgm.py:1065
// sgm_tail_pallas (body _tail_kernel, :960).  Semantics, per pixel of the
// aggregate A [B, H, W, D] (ops/sgm.py volume_argmin_subpixel,
// right_disparity_from_left_volume, second_best_outside_neighborhood;
// ops/costvolume.py argmin_subpixel_scan):
//   * disparity: the first d minimising A[y, x, d] (strict <, sentinel
//     2^30), carrying the costs at d-1 and d+1 of the running minimum;
//   * subpixel: disparity + the parabola offset (cl - cr) / (2 * denom),
//     denom = cl - 2 cm + cr, taken only where both neighbours exist and
//     denom > 0, clipped to [-0.5, 0.5];
//   * cost: A at the winner;
//   * disparity_right: the first d minimising A[y, min(x + d, W - 1), d]
//     (strict <, sentinel 2^28);
//   * optionally c2: min over d with |d - disparity| > 1 (sentinel 2^28),
//     the numerator of the uniqueness ratio.
// The float epilogue is written with __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn in ops/costvolume.py:124-133's order, so nothing is contracted
// and the divide is IEEE: the plane is bitwise equal to the JAX package's.
//
// What bounds it on the H100: device memory.  The function reads the
// aggregate once (2*D or 4*D bytes per pixel) and writes 16-20 bytes per
// pixel; its arithmetic is a few integer ops per element.
//
// Two routes, chosen by the caller before launch from (dtype, D, W) alone
// (ops/fused_sgm.py k5_route; the shared-memory figure is this file's
// sgm_tail_smem_bytes):
//
// Segments (seg_kernel), wherever a segment fits shared memory and a
// pixel's run is at most 8 words a lane.  A block of SEG_WARPS warps owns
// SEG_PX pixels of one row.  In [B, H, W, D] those pixels, plus the D - 1
// that the right view reaches (clamped at W - 1), are one contiguous run
// of bytes: the block copies it into shared memory once with 16-byte
// cp.async copies (from the 16-byte boundary below it), waits, and
// synchronises once.  Each element is read from device memory once; only
// the D - 1 pixels where neighbouring segments overlap are read twice,
// mostly from L2.  Then each warp takes 32 pixels, one at a time, with d
// across its lanes: lane l holds the words l, l + 32, ... of a pixel's
// run (d = (l + 32 j) * E + e, E elements a word), so the left view is
// whole-row reads and the right view's reads of A[x + d, d] land in bank
// l whenever a run is a multiple of 128 bytes: both conflict-free at the
// bench shape without padding.  The first minimum is a warp reduction
// (__reduce_min_sync): for int16 of the key (cost + 2^15) << 16 | d, one
// reduction that is exact; for int32 the minimum cost, then the first d
// that holds it.  With uniqueness, c2 is one more reduction over the
// same registers, masking |d - d*| <= 1: the one pass reads everything.
// Lane k keeps pixel k's results; the warp then reads the winner's two
// neighbours for its 32 pixels from the staged run, computes the float
// epilogue and stores the planes in 128-byte rows.  Many blocks per SM
// (24.5 KB each at int16, D=64) keep copies in flight while others scan.
//
// Wide (tail_kernel), for the rest (int32 at D=256, or D past 512 / 256
// at int16 / int32): one block of TX = 128 threads per 128-pixel
// segment of a row, one thread per pixel with all carries in registers,
// walking d in chunks of DC = 32 staged in padded int32 tiles (the left
// view and the right view's diagonal), restaging the left tiles for the
// uniqueness pass.  Any D: the chunking keeps shared memory at 37 KB.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int ARGBIG = 1 << 30;
constexpr int SGM_BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- segments

constexpr int SEG_WARPS = 4;
constexpr int SEG_PX = 32 * SEG_WARPS;  // pixels (and threads) of a block
constexpr int MAX_LANE_WORDS = 8;

// 32-bit words a lane holds of one pixel's run: the run's 128-byte rows,
// rounded up to a power of two.
int lane_words(int esz, int D) {
  const int rows = (D * esz + 127) / 128;
  int nj = 1;
  while (nj < rows) nj *= 2;
  return nj;
}

// Dynamic shared memory of a segment: its pixels' runs, whole 16-byte
// chunks from the boundary below the first byte.
long long seg_smem_bytes(int esz, int D, int W) {
  const long long px = SEG_PX + D - 1 < W ? SEG_PX + D - 1 : W;
  return (px * D * esz + 15) / 16 * 16 + 16;
}

// The first minimum of a warp's costs against `sentinel` (strict <): the
// value (sentinel where none is below it) and its d (0 then).  int16
// lanes pass their keys (cost + 2^15) << 16 | d, 0xffffffff past D;
// int32 lanes their costs, INT_MAX past D, and the slots' d.
template <int K>
__device__ __forceinline__ void first_min_keys(const unsigned (&key)[K], int sentinel,
                                               int& value, int& d) {
  unsigned k = key[0];
#pragma unroll
  for (int s = 1; s < K; ++s) k = min(k, key[s]);
  k = __reduce_min_sync(FULL, k);
  // int16 costs are always below either sentinel and D >= 1.
  value = (int)(k >> 16) - 32768;
  d = (int)(k & 0xffffu);
  (void)sentinel;
}

template <int K>
__device__ __forceinline__ void first_min_costs(const int (&c)[K], const int (&ds)[K],
                                                int sentinel, int& value, int& d) {
  int m = c[0];
#pragma unroll
  for (int s = 1; s < K; ++s) m = min(m, c[s]);
  m = __reduce_min_sync(FULL, m);
  if (m >= sentinel) {  // warp-uniform
    value = sentinel;
    d = 0;
    return;
  }
  int first = INT_MAX;
#pragma unroll
  for (int s = 0; s < K; ++s)
    if (c[s] == m) first = min(first, ds[s]);
  value = m;
  d = __reduce_min_sync(FULL, first);
}

// NJ words a lane; WORDS: int16 with D even and the aggregate 4-byte
// aligned, so the left view reads a lane's two costs as one word.
template <typename TA, int NJ, bool WORDS, bool UNIQ>
__global__ void __launch_bounds__(SEG_PX)
seg_kernel(const TA* __restrict__ agg, int* __restrict__ disp, float* __restrict__ sub,
           int* __restrict__ cost, int* __restrict__ dright, int* __restrict__ c2, int W,
           int D, int segs) {
  constexpr bool NARROW = sizeof(TA) == 2;
  constexpr int E = 4 / (int)sizeof(TA);  // elements a word
  constexpr int K = NJ * E;               // costs a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row = blockIdx.x / segs;  // b * H + y
  const int x0 = (int)(blockIdx.x % segs) * SEG_PX;
  const int n_px = min(SEG_PX + D - 1, W - x0);

  // Stage the segment's run: whole 16-byte chunks from the boundary below
  // its first byte (a chunk holding one byte of the tensor lies in its
  // allocation).
  const unsigned char* g0 =
      reinterpret_cast<const unsigned char*>(agg + (row * W + x0) * (long long)D);
  const unsigned char* a0 =
      reinterpret_cast<const unsigned char*>((uintptr_t)g0 & ~(uintptr_t)15);
  const int lead = (int)(g0 - a0);
  const int n_chunks = (lead + n_px * D * (int)sizeof(TA) + 15) / 16;
  for (int c = threadIdx.x; c < n_chunks; c += SEG_PX)
    __pipeline_memcpy_async(smem + 16 * c, a0 + 16 * c, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const TA* seg = reinterpret_cast<const TA*>(smem + lead);

  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * 32;  // the warp's first pixel
  const int last = W - 1 - x0;             // the row's last pixel
  int ds[K];
  bool in[K];
  unsigned kc[K];  // int16: the key's low bits, 2^31 + d
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int s = j * E + e;
      ds[s] = (lane + 32 * j) * E + e;
      in[s] = ds[s] < D;
      kc[s] = 0x80000000u + (unsigned)ds[s];
    }

  int my_d = 0, my_cost = ARGBIG, my_dr = 0, my_c2 = SGM_BIG;
  const int n_mine = min(32, W - x0 - p0);  // warp-uniform
  for (int i = 0; i < n_mine; ++i) {
    const int p = p0 + i;
    const TA* px = seg + p * D;
    int best, dstar, rbest, rd, c2v = SGM_BIG;
    if constexpr (NARROW) {
      unsigned key[K], rkey[K];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if constexpr (WORDS) {
          const unsigned w = in[2 * j]
              ? *reinterpret_cast<const unsigned*>(px + 2 * (lane + 32 * j)) : 0u;
          key[2 * j] = in[2 * j] ? (w << 16) + kc[2 * j] : FULL;
          key[2 * j + 1] = in[2 * j + 1] ? (w & 0xffff0000u) + kc[2 * j + 1] : FULL;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = 2 * j + e;
            key[s] = in[s] ? ((unsigned)(unsigned short)px[ds[s]] << 16) + kc[s] : FULL;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < K; ++s)
        rkey[s] = in[s]
            ? ((unsigned)(unsigned short)seg[min(p + ds[s], last) * D + ds[s]] << 16) + kc[s]
            : FULL;
      first_min_keys(key, ARGBIG, best, dstar);
      first_min_keys(rkey, SGM_BIG, rbest, rd);
      if constexpr (UNIQ) {
        unsigned k2 = FULL;
#pragma unroll
        for (int s = 0; s < K; ++s)
          if ((unsigned)(ds[s] - dstar + 1) > 2u) k2 = min(k2, key[s]);
        k2 = __reduce_min_sync(FULL, k2);
        if (k2 != FULL) c2v = min((int)(k2 >> 16) - 32768, SGM_BIG);
      }
    } else {
      int c[K], cr[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        c[s] = in[s] ? (int)px[ds[s]] : INT_MAX;
        cr[s] = in[s] ? (int)seg[min(p + ds[s], last) * D + ds[s]] : INT_MAX;
      }
      first_min_costs(c, ds, ARGBIG, best, dstar);
      first_min_costs(cr, ds, SGM_BIG, rbest, rd);
      if constexpr (UNIQ) {
        int m2 = INT_MAX;
#pragma unroll
        for (int s = 0; s < K; ++s)
          if ((unsigned)(ds[s] - dstar + 1) > 2u) m2 = min(m2, c[s]);
        c2v = min(__reduce_min_sync(FULL, m2), SGM_BIG);
      }
    }
    (void)rbest;
    if (lane == i) {
      my_d = dstar;
      my_cost = best;
      my_dr = rd;
      my_c2 = c2v;
    }
  }

  // Lane k's pixel: the winner's neighbours from the staged run, the
  // float epilogue, and the stores in 128-byte rows.
  const int p = p0 + lane;
  if (x0 + p >= W) return;  // after the only barrier
  int c_left = ARGBIG, c_right = ARGBIG;
  if (my_cost < ARGBIG) {
    if (my_d > 0) c_left = seg[p * D + my_d - 1];
    if (my_d < D - 1) c_right = seg[p * D + my_d + 1];
  }
  const long long o = row * W + x0 + p;
  const float cl = (float)c_left, cm = (float)my_cost, crf = (float)c_right;
  const float denom = __fadd_rn(__fsub_rn(cl, __fmul_rn(2.0f, cm)), crf);
  float off = 0.0f;
  if (c_left < ARGBIG && c_right < ARGBIG && denom > 0.0f)
    off = __fdiv_rn(__fsub_rn(cl, crf), __fmul_rn(2.0f, denom));
  off = fminf(fmaxf(off, -0.5f), 0.5f);
  disp[o] = my_d;
  sub[o] = __fadd_rn((float)my_d, off);
  cost[o] = my_cost;
  dright[o] = my_dr;
  if (UNIQ) c2[o] = my_c2;
}

template <typename TA, int NJ, bool WORDS, bool UNIQ>
cudaError_t launch_seg(const void* agg, int* disp, float* sub, int* cost, int* dright,
                       int* c2, long long rows, int W, int D, cudaStream_t st) {
  const int segs = (W + SEG_PX - 1) / SEG_PX;
  const long long blocks = rows * segs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = (int)seg_smem_bytes((int)sizeof(TA), D, W);
  auto kernel = seg_kernel<TA, NJ, WORDS, UNIQ>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, SEG_PX, smem, st>>>((const TA*)agg, disp, sub, cost, dright, c2,
                                                  W, D, segs);
  return cudaGetLastError();
}

template <typename TA, int NJ, bool WORDS>
cudaError_t launch_seg_u(const void* agg, int* disp, float* sub, int* cost, int* dright,
                         int* c2, long long rows, int W, int D, cudaStream_t st) {
  if (c2) return launch_seg<TA, NJ, WORDS, true>(agg, disp, sub, cost, dright, c2, rows, W, D, st);
  return launch_seg<TA, NJ, WORDS, false>(agg, disp, sub, cost, dright, c2, rows, W, D, st);
}

template <typename TA, bool WORDS>
cudaError_t launch_seg_nj(const void* agg, int* disp, float* sub, int* cost, int* dright,
                          int* c2, long long rows, int W, int D, cudaStream_t st) {
  switch (lane_words((int)sizeof(TA), D)) {
    case 1: return launch_seg_u<TA, 1, WORDS>(agg, disp, sub, cost, dright, c2, rows, W, D, st);
    case 2: return launch_seg_u<TA, 2, WORDS>(agg, disp, sub, cost, dright, c2, rows, W, D, st);
    case 4: return launch_seg_u<TA, 4, WORDS>(agg, disp, sub, cost, dright, c2, rows, W, D, st);
    case 8: return launch_seg_u<TA, 8, WORDS>(agg, disp, sub, cost, dright, c2, rows, W, D, st);
    default: return cudaErrorInvalidValue;  // past MAX_LANE_WORDS: the wide route's
  }
}

// -------------------------------------------------------------------- wide

constexpr int TX = 128;     // pixels (threads) per block
constexpr int DC = 32;      // disparities per staged chunk
constexpr int LD = DC + 1;  // padded tile row: odd, conflict-free walks

// Stage rows px = first + j (clamped to W - 1), j < rows, columns
// d0 .. d0 + dn - 1, into tile[j * LD + dd].
template <typename TA>
__device__ __forceinline__ void stage(int* tile, const TA* __restrict__ rowp,
                                      int first, int rows, int W, int D,
                                      int d0, int dn) {
  for (int e = threadIdx.x; e < rows * dn; e += TX) {
    const int j = e / dn;
    const int dd = e - j * dn;
    const int px = min(first + j, W - 1);
    tile[j * LD + dd] = rowp[(long long)px * D + d0 + dd];
  }
}

template <typename TA, bool UNIQ>
__global__ void __launch_bounds__(TX)
tail_kernel(const TA* __restrict__ agg, int* __restrict__ disp,
            float* __restrict__ sub, int* __restrict__ cost,
            int* __restrict__ dright, int* __restrict__ c2, int W, int D,
            int segs) {
  __shared__ int left[TX * LD];
  __shared__ int right[(TX + DC - 1) * LD];
  const long long row = blockIdx.x / segs;  // b * H + y
  const int x0 = (int)(blockIdx.x % segs) * TX;
  const int t = threadIdx.x;
  const TA* rowp = agg + row * W * D;

  int best = ARGBIG, best_d = 0, c_left = ARGBIG, c_right = ARGBIG;
  int c_prev = ARGBIG;
  bool was_new = false;
  int best_r = SGM_BIG, best_rd = 0;
  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dn = min(DC, D - d0);
    __syncthreads();  // the previous chunk's reads are done
    stage(left, rowp, x0, TX, W, D, d0, dn);
    stage(right, rowp, x0 + d0, TX + dn - 1, W, D, d0, dn);
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const int d = d0 + dd;
      const int c = left[t * LD + dd];
      if (was_new) c_right = c;  // the step after a new minimum
      const bool is_new = c < best;
      if (is_new) {
        best = c;
        best_d = d;
        c_left = c_prev;
        c_right = ARGBIG;
      }
      c_prev = c;
      was_new = is_new;
      const int cr = right[(t + dd) * LD + dd];  // A[min(x + d, W - 1), d]
      if (cr < best_r) {
        best_r = cr;
        best_rd = d;
      }
    }
  }
  int s = SGM_BIG;
  if (UNIQ) {
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dn = min(DC, D - d0);
      __syncthreads();
      stage(left, rowp, x0, TX, W, D, d0, dn);
      __syncthreads();
      for (int dd = 0; dd < dn; ++dd)
        if (abs(best_d - (d0 + dd)) > 1) s = min(s, left[t * LD + dd]);
    }
  }
  const int x = x0 + t;
  if (x >= W) return;  // after the last barrier
  const long long p = row * W + x;
  const float cl = (float)c_left, cm = (float)best, crf = (float)c_right;
  const float denom = __fadd_rn(__fsub_rn(cl, __fmul_rn(2.0f, cm)), crf);
  float off = 0.0f;
  if (c_left < ARGBIG && c_right < ARGBIG && denom > 0.0f)
    off = __fdiv_rn(__fsub_rn(cl, crf), __fmul_rn(2.0f, denom));
  off = fminf(fmaxf(off, -0.5f), 0.5f);
  disp[p] = best_d;
  sub[p] = __fadd_rn((float)best_d, off);
  cost[p] = best;
  dright[p] = best_rd;
  if (UNIQ) c2[p] = s;
}

template <typename TA>
cudaError_t launch_wide(const void* agg, int* disp, float* sub, int* cost,
                        int* dright, int* c2, long long rows, int W, int D,
                        cudaStream_t st) {
  const int segs = (W + TX - 1) / TX;
  const long long blocks = rows * segs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (c2)
    tail_kernel<TA, true><<<(unsigned)blocks, TX, 0, st>>>((const TA*)agg, disp, sub, cost, dright, c2, W, D, segs);
  else
    tail_kernel<TA, false><<<(unsigned)blocks, TX, 0, st>>>((const TA*)agg, disp, sub, cost, dright, nullptr, W, D, segs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The segment route's dynamic shared memory for an aggregate of
// `agg_bytes` (2, 4) at D disparities and W columns, in bytes; the route
// takes it up to 232448 (ops/fused_sgm.py k5_smem_bytes mirrors it).
long long sgm_tail_smem_bytes(int agg_bytes, int D, int W) {
  return seg_smem_bytes(agg_bytes, D, W);
}

// agg: [B, H, W, D] of `agg_bytes` (2, 4: int16, int32).  disp, cost,
// dright: int32 [B, H, W]; sub: float32 [B, H, W]; c2: int32 [B, H, W] or
// null (no uniqueness).  route: 1 segments, 0 wide (the caller's
// k5_route); the segment route refuses D past 8 words a lane.  Launches
// one kernel on `stream`; returns cudaGetLastError().
int sgm_tail(const void* agg, int agg_bytes, void* disp, void* sub,
             void* cost, void* dright, void* c2, int B, int H, int W, int D,
             int route, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H;
  cudaStream_t st = (cudaStream_t)stream;
  int* o[4] = {(int*)disp, (int*)cost, (int*)dright, (int*)c2};
  float* s = (float*)sub;
  if (route == 1) {
    if (lane_words(agg_bytes, D) > MAX_LANE_WORDS) return (int)cudaErrorInvalidValue;
    switch (agg_bytes) {
      case 2:
        if (D % 2 == 0 && (uintptr_t)agg % 4 == 0)
          return (int)launch_seg_nj<int16_t, true>(agg, o[0], s, o[1], o[2], o[3], rows, W, D, st);
        return (int)launch_seg_nj<int16_t, false>(agg, o[0], s, o[1], o[2], o[3], rows, W, D, st);
      case 4:
        return (int)launch_seg_nj<int32_t, false>(agg, o[0], s, o[1], o[2], o[3], rows, W, D, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (agg_bytes) {
    case 2: return (int)launch_wide<int16_t>(agg, o[0], s, o[1], o[2], o[3], rows, W, D, st);
    case 4: return (int)launch_wide<int32_t>(agg, o[0], s, o[1], o[2], o[3], rows, W, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
