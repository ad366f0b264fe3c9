// K7: the box route's disparity for one reference view, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_modern.py:232
// disparity_pallas (body _kernel, :53).  Semantics (models/modern.py
// _cost_fn at scales = 1, ops/costvolume.py argmin_subpixel_scan): for int32
// cost inputs ref, other [B, H, W] (pixel intensities for SAD, census codes
// for census) and each d < D,
//     pc(y, x, d) = cost(ref[y, x], other[y, xm(x, d)])      (in the frame)
//     C(y, x, d)  = sum of pc over the (2h+1)^2 window at (y, x), window
//                   pixels outside the frame adding 0,
// with cost = |a - b| or popcount(a ^ b), and the matching view clamped at
// its edge: xm = max(x - d, 0) for the left reference, min(x + d, W - 1)
// for the right one.  Out: the first d minimising C (strict <, sentinel
// 2^30) as int32, that d plus the parabola offset on (C[d-1], C[d],
// C[d+1]) as float32, and the winning cost as int32.  The carries
// (best, best_d, c_left, c_right, c_prev, was_new) are updated in the
// order of argmin_subpixel_scan: c_right takes the cost after a new
// minimum before is_new is decided.  The parabola is written with
// __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn in the JAX op order
// (denom = (cl - 2 cm) + cr; offset = (cl - cr) / (2 denom), clipped to
// +-0.5), as K5 (sgm_tail.cu) does, so the plane is bitwise equal.  The
// volume never exists.
//
// What bounds it on the H100: integer instruction throughput, not device
// memory.  Each pixel reads 8 B and writes 12 B, against ~12 integer ops
// per pixel and disparity (cost, separable box sum, argmin): at 1024x1024,
// D = 64 that is ~800 ops per byte.
//
// Design: one block of 256 threads per (image, 32x32 output tile), after
// K1 (match_score_edges.cu).  Per d the box sum is separable and
// incremental: a column pass writes running (2h+1)-row sums of pc for the
// tile's 32 + 2h columns into shared memory (tasks of `rc` rows, one
// running sum each; a column outside the frame sums to 0), then each
// thread slides a (2h+1)-wide row sum over 4 output pixels and updates
// their argmin carries, which stay in registers across all D.  Where the
// tiles fit (STAGED), the block first stages the reference tile with its
// h halo and the matching view's rows, D - 1 columns wider, in shared
// memory (rows outside the frame hold 0 in both, so they cost 0; the x
// clamp is applied while staging).  Windows whose halo would not fit
// (about 65 and up at D = 64) read both views straight from device memory
// through L1 instead, with the same arithmetic; only the column sums live
// in shared memory then.  Windows up to 255 and D up to 256, as the JAX
// kernel takes.  None of the TPU structure is carried over (no lane rolls,
// no banded matmuls, no digit splits: the sums are exact int32 adds).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;  // output rows per block
constexpr int TW = 32;  // output columns per block
constexpr int NT = 256;
constexpr int PX = 4;   // output pixels per thread (along x)
constexpr int ARGBIG = 1 << 30;
constexpr int STAGED_MAX_BYTES = 116 * 1024;  // two blocks per SM

static_assert(TH * (TW / PX) == NT, "one thread per (row, 4-pixel strip)");

struct Geometry {
  int half, k;
  int rows, wr, wo;  // halo rows, reference / matching tile widths
  int cs_stride;     // column-sum row stride (odd)
  int rc;            // rows per running column-sum task
  bool staged;
  int smem_bytes;
};

inline Geometry geometry(int half, int D) {
  Geometry g;
  g.half = half;
  g.k = 2 * half + 1;
  g.rows = TH + 2 * half;
  g.wr = TW + 2 * half;
  g.wo = g.wr + D - 1;
  g.cs_stride = g.wr | 1;
  g.rc = g.k <= 16 ? 8 : TH;
  const int cs = TH * g.cs_stride * 4;
  const int staged = (g.rows * (g.wr + g.wo)) * 4 + cs;
  g.staged = staged <= STAGED_MAX_BYTES;
  g.smem_bytes = g.staged ? staged : cs;
  return g;
}

template <bool CENSUS, bool STAGED>
__global__ void __launch_bounds__(NT)
disparity_kernel(const int* __restrict__ ref, const int* __restrict__ other,
                 int* __restrict__ disp_out, float* __restrict__ sub_out,
                 int* __restrict__ cost_out, int H, int W, int D, int half,
                 int rows, int wr, int wo, int cs_stride, int rc,
                 bool right_ref) {
  extern __shared__ __align__(16) int smem[];
  const int k = 2 * half + 1;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  ref += b * plane;
  other += b * plane;
  int* colsum = smem;
  int* sref = smem + TH * cs_stride;  // STAGED only
  int* soth = sref + rows * wr;

  if (STAGED) {
    // Halo cell (r, c) is global (y0 - h + r, x0 - h + c); matching column
    // j is global x0 - h + j, shifted left by D - 1 for the left
    // reference, clamped into the frame.
    const int shift = right_ref ? 0 : D - 1;
    for (int i = threadIdx.x; i < rows * wr; i += NT) {
      const int r = i / wr, c = i - r * wr;
      const int gy = y0 - half + r, gx = x0 - half + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      sref[i] = in ? ref[(size_t)gy * W + gx] : 0;
    }
    for (int i = threadIdx.x; i < rows * wo; i += NT) {
      const int r = i / wo, j = i - r * wo;
      const int gy = y0 - half + r;
      const int gx = min(max(x0 - half + j - shift, 0), W - 1);
      soth[i] = (gy >= 0 && gy < H) ? other[(size_t)gy * W + gx] : 0;
    }
    __syncthreads();
  }

  // This thread's pixels: row ty, columns tx0 .. tx0 + PX - 1 of the tile.
  const int ty = threadIdx.x / (TW / PX);
  const int tx0 = (threadIdx.x % (TW / PX)) * PX;
  int best[PX], best_d[PX], c_left[PX], c_right[PX], c_prev[PX];
  bool was_new[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    best[j] = c_left[j] = c_right[j] = c_prev[j] = ARGBIG;
    best_d[j] = 0;
    was_new[j] = false;
  }

  const int n_tasks = (TH / rc) * wr;
  for (int d = 0; d < D; ++d) {
    const int off = right_ref ? d : D - 1 - d;  // staged matching column - c
    // Per-pixel cost of halo cell (r, c); its column is in the frame.
    auto pc = [&](int r, int c) -> int {
      int a, o;
      if (STAGED) {
        a = sref[r * wr + c];
        o = soth[r * wo + c + off];
      } else {
        const int gy = y0 - half + r;
        if (gy < 0 || gy >= H) return 0;
        const int gx = x0 - half + c;
        const int xm = right_ref ? min(gx + d, W - 1) : max(gx - d, 0);
        a = __ldg(ref + (size_t)gy * W + gx);
        o = __ldg(other + (size_t)gy * W + xm);
      }
      return CENSUS ? __popc(a ^ o) : abs(a - o);
    };
    // Column pass: colsum[r][c] = sum_{i < k} pc(r + i, c).
    for (int t = threadIdx.x; t < n_tasks; t += NT) {
      const int c = t % wr, r0 = (t / wr) * rc;
      const int gx = x0 - half + c;
      int* out = colsum + r0 * cs_stride + c;
      if (gx < 0 || gx >= W) {
        for (int r = 0; r < rc; ++r) out[r * cs_stride] = 0;
        continue;
      }
      int sum = 0;
      for (int i = 0; i < k; ++i) sum += pc(r0 + i, c);
      out[0] = sum;
      for (int r = 1; r < rc; ++r) {
        sum += pc(r0 + r + k - 1, c) - pc(r0 + r - 1, c);
        out[r * cs_stride] = sum;
      }
    }
    __syncthreads();
    // Row pass and the argmin carries of this thread's PX pixels.
    const int* cs = colsum + ty * cs_stride + tx0;
    int sum = 0;
    for (int i = 0; i < k; ++i) sum += cs[i];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      if (j > 0) sum += cs[j + k - 1] - cs[j - 1];
      const int c = sum;
      if (was_new[j]) c_right[j] = c;  // the step after a new minimum
      const bool is_new = c < best[j];
      if (is_new) {
        best[j] = c;
        best_d[j] = d;
        c_left[j] = c_prev[j];
        c_right[j] = ARGBIG;
      }
      c_prev[j] = c;
      was_new[j] = is_new;
    }
    __syncthreads();  // colsum is rewritten for the next d
  }

  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int x = x0 + tx0 + j;
    if (x >= W) continue;
    const float cl = (float)c_left[j], cm = (float)best[j];
    const float cr = (float)c_right[j];
    const float denom = __fadd_rn(__fsub_rn(cl, __fmul_rn(2.0f, cm)), cr);
    float off = 0.0f;
    if (c_left[j] < ARGBIG && c_right[j] < ARGBIG && denom > 0.0f)
      off = __fdiv_rn(__fsub_rn(cl, cr), __fmul_rn(2.0f, denom));
    off = fminf(fmaxf(off, -0.5f), 0.5f);
    const size_t o = b * plane + (size_t)y * W + x;
    disp_out[o] = best_d[j];
    sub_out[o] = __fadd_rn((float)best_d[j], off);
    cost_out[o] = best[j];
  }
}

template <bool CENSUS, bool STAGED>
cudaError_t launch(const Geometry& g, const int* ref, const int* other,
                   int* disp, float* sub, int* cost, int B, int H, int W,
                   int D, bool right_ref, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      disparity_kernel<CENSUS, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  disparity_kernel<CENSUS, STAGED><<<grid, NT, g.smem_bytes, st>>>(
      ref, other, disp, sub, cost, H, W, D, g.half, g.rows, g.wr, g.wo,
      g.cs_stride, g.rc, right_ref);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when a launch with this half window and D stages both views in shared
// memory, 0 when it reads them from device memory.
int disparity_staged(int half, int D) { return geometry(half, D).staged; }

// ref, other: int32 [B, H, W], contiguous, on the device (intensities for
// SAD, census codes for census).  Outputs: int32 disparity, float32
// subpixel, int32 cost [B, H, W].  half = window / 2 (0..127), 1 <= D <=
// 256, B <= 65535; right_ref: 1 matches ref(x) against other(x + d).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int disparity(const void* ref, const void* other, void* disp, void* sub,
              void* cost, int B, int H, int W, int D, int half, int census,
              int right_ref, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || D > 256 || half < 0 ||
      half > 127)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(half, D);
  const int* r = (const int*)ref;
  const int* o = (const int*)other;
  int* dp = (int*)disp;
  float* sp = (float*)sub;
  int* cp = (int*)cost;
  cudaStream_t st = (cudaStream_t)stream;
  const bool rr = right_ref != 0;
  if (census)
    return (int)(g.staged ? launch<true, true>(g, r, o, dp, sp, cp, B, H, W, D, rr, st)
                          : launch<true, false>(g, r, o, dp, sp, cp, B, H, W, D, rr, st));
  return (int)(g.staged ? launch<false, true>(g, r, o, dp, sp, cp, B, H, W, D, rr, st)
                        : launch<false, false>(g, r, o, dp, sp, cp, B, H, W, D, rr, st));
}

}  // extern "C"
