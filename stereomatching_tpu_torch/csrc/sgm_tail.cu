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
//   * disparity_right: the first d minimising A[y, min(x + d, W - 1), d];
//   * optionally c2: min over d with |d - disparity| > 1 (sentinel 2^28),
//     the numerator of the uniqueness ratio.
// The float epilogue is written with __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn in ops/costvolume.py:124-133's order, so nothing is contracted
// and the divide is IEEE: the plane is bitwise equal to the JAX package's.
//
// What bounds it on the H100: device memory.  The function reads the
// aggregate once (2*D or 4*D bytes per pixel) and writes 16-20 bytes per
// pixel, against ~10 integer ops per element.
//
// Design: one block of TX = 128 threads per 128-pixel segment of a row,
// one thread per pixel with all carries in registers, walking d in chunks
// of DC = 32.  For each chunk the block stages two tiles in shared memory
// with coalesced loads: the segment's own D-runs (left view) and the
// segment shifted by the chunk's first d and DC - 1 pixels wider, clamped
// at the last column (right view: thread x reads row x + d of it at
// column d).  Rows are padded to 33 words, so both the row walk of the
// left view and the diagonal walk of the right view hit 32 different
// banks.  The uniqueness pass restages the left tiles once the winner is
// known.  Each element is read from device memory ~2.25 times in all (its
// own tile, and the right tiles that overlap it, mostly from L2), always
// in runs of D-contiguous values.  Any D: the chunking keeps shared
// memory at 37 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 128;     // pixels (threads) per block
constexpr int DC = 32;      // disparities per staged chunk
constexpr int LD = DC + 1;  // padded tile row: odd, conflict-free walks
constexpr int ARGBIG = 1 << 30;
constexpr int SGM_BIG = 1 << 28;

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
  int best_r = ARGBIG, best_rd = 0;
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
cudaError_t launch(const void* agg, int* disp, float* sub, int* cost,
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

// agg: [B, H, W, D] of `agg_bytes` (2, 4: int16, int32).  disp, cost,
// dright: int32 [B, H, W]; sub: float32 [B, H, W]; c2: int32 [B, H, W] or
// null (no uniqueness pass).  Launches on `stream`; returns
// cudaGetLastError().
int sgm_tail(const void* agg, int agg_bytes, void* disp, void* sub,
             void* cost, void* dright, void* c2, int B, int H, int W, int D,
             void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H;
  cudaStream_t st = (cudaStream_t)stream;
  switch (agg_bytes) {
    case 2: return (int)launch<int16_t>(agg, (int*)disp, (float*)sub, (int*)cost, (int*)dright, (int*)c2, rows, W, D, st);
    case 4: return (int)launch<int32_t>(agg, (int*)disp, (float*)sub, (int*)cost, (int*)dright, (int*)c2, rows, W, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
