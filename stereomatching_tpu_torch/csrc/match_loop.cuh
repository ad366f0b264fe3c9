// The shift loop of the classic pipeline's two matching kernels, K1
// (match_score_edges.cu: edges built from brightness) and K8
// (match_and_score.cu: edge maps given), for sm_90a.
//
// Both kernels stage two uint8 edge tiles in shared memory -- the left
// tile covers the block's 32x32 output tile and its +-half halo, the
// right one D-1 more columns for the shift reads -- and then run
// shift_loop, which for every shift s of D:
//   * matches left(x) against right(x + s) (equality, so two non-edges
//     match too);
//   * box-sums the match plane over the square window: a column pass
//     writes sw-row running sums (tasks of 8 rows, one running sum each)
//     into shared memory, then each thread slides an sw-wide row sum over
//     its 4 output pixels;
//   * keeps score = box sum where matched, else 0, and the last-wins
//     argmax (best, winner) in registers: score >= best -> winner = s + 1,
//     so ties go to the last shift and all-zero scores give winner = D.
// With SUBPIXEL it also carries each pixel's neighbour scores (s_left,
// s_right, the previous score, took-the-max flag) in the order of
// stereomatching_tpu/ops/argmax.py match_and_score_subpixel and ends with
// the maximising parabola of _parabola_refine (stereomatching_tpu/ops/
// fused.py): -1 marks a missing neighbour, the offset is taken only where
// both neighbours exist and the triple is strictly concave, clipped to
// [-0.5, 0.5].  The float ops are __f*_rn intrinsics, so nvcc contracts
// nothing into an FMA and the divide is IEEE: the same bits as the JAX
// package's XLA tier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace match_loop {

constexpr int TH = 32;  // output rows per block
constexpr int TW = 32;  // output columns per block
constexpr int NT = 256; // threads per block
constexpr int RC = 8;   // rows per running column sum task
constexpr int PX = 4;   // output pixels per thread (along x)
// Ghost mode: left cells outside the image hold 2, which never equals an
// edge value (0 or 1), so they never match (the zero-filled match halo);
// right cells outside the image hold 0, genuine matches against a left 0
// (the reference's zero edge halo, src/stereo-ghost.c:119-121).
constexpr uint8_t LEFT_SENTINEL = 2;

static_assert(TH * (TW / PX) == NT, "one thread per (row, 4-pixel strip)");
static_assert(TH % RC == 0, "column tasks tile the rows");

// Shapes of the two edge tiles and the column-sum buffer.
struct EdgeTiles {
  int half, sw;
  int rows;       // edge tile rows: TH + 2 * half
  int ew_l, ew_r; // edge tile widths: TW + 2 * half (+ D - 1 on the right)
  int cs_stride;  // column-sum row stride (odd: no bank conflicts)
  int e_bytes;    // both edge tiles
  int cs_bytes;   // the column sums
};

__host__ __device__ inline EdgeTiles edge_tiles(int half, int num_shifts) {
  EdgeTiles t;
  t.half = half;
  t.sw = 2 * half + 1;
  t.rows = TH + 2 * half;
  t.ew_l = TW + 2 * half;
  t.ew_r = t.ew_l + num_shifts - 1;
  t.cs_stride = t.ew_l | 1;
  t.e_bytes = t.rows * (t.ew_l + t.ew_r);
  t.cs_bytes = TH * t.cs_stride * 4;
  return t;
}

__device__ __forceinline__ int wrap_index(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// winner + the parabola offset through (s_left, best, s_right).
__device__ __forceinline__ float parabola_max(int best, int winner,
                                              int s_left, int s_right) {
  const float sl = (float)s_left, sm = (float)best, sr = (float)s_right;
  const float denom = __fadd_rn(__fsub_rn(sl, __fmul_rn(2.0f, sm)), sr);
  float offset = 0.0f;
  if (s_left >= 0 && s_right >= 0 && denom < 0.0f)
    offset = __fdiv_rn(__fsub_rn(sl, sr), __fmul_rn(2.0f, denom));
  offset = fminf(fmaxf(offset, -0.5f), 0.5f);
  return __fadd_rn((float)winner, offset);
}

// The shift loop of one block over its staged edge tiles e_l / e_r
// (edge cell (r, c) of both sits at image (y0 - half + r, x0 - half + c));
// `colsum` needs cs_bytes of shared memory that nothing else uses during
// the loop.  Writes best, winner (and subpixel) of the block's in-image
// pixels at offset `plane` (the image's first pixel) of the outputs.
template <bool SUBPIXEL>
__device__ void shift_loop(const uint8_t* e_l, const uint8_t* e_r,
                           int* colsum, const EdgeTiles& t, int num_shifts,
                           int H, int W, int y0, int x0, size_t plane,
                           int* __restrict__ best_out,
                           int* __restrict__ winner_out,
                           float* __restrict__ sub_out) {
  // This thread's pixels: row ty, columns tx0 .. tx0 + PX - 1 of the tile.
  const int ty = threadIdx.x / (TW / PX);
  const int tx0 = (threadIdx.x % (TW / PX)) * PX;
  int best[PX], winner[PX];
  // Sub-pixel carries (unused without SUBPIXEL; the compiler drops them).
  int s_left[PX], s_right[PX], s_prev[PX];
  bool was_new[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    best[j] = winner[j] = 0;
    s_left[j] = s_right[j] = s_prev[j] = -1;
    was_new[j] = false;
  }

  const int n_tasks = (TH / RC) * t.ew_l;
  for (int s = 0; s < num_shifts; ++s) {
    // Column pass: colsum[r][c] = sum_{i < sw} match(r + i, c).
    for (int task = threadIdx.x; task < n_tasks; task += NT) {
      int c = task % t.ew_l, r0 = (task / t.ew_l) * RC;
      const uint8_t* pl = e_l + c;
      const uint8_t* pr = e_r + c + s;
      int sum = 0;
      for (int i = 0; i < t.sw; ++i)
        sum += pl[(r0 + i) * t.ew_l] == pr[(r0 + i) * t.ew_r];
      colsum[r0 * t.cs_stride + c] = sum;
      for (int r = r0 + 1; r < r0 + RC; ++r) {
        int in = r + t.sw - 1, out = r - 1;
        sum += (pl[in * t.ew_l] == pr[in * t.ew_r]) -
               (pl[out * t.ew_l] == pr[out * t.ew_r]);
        colsum[r * t.cs_stride + c] = sum;
      }
    }
    __syncthreads();
    // Row pass + score + argmax for this thread's PX pixels.
    const int* cs = colsum + ty * t.cs_stride + tx0;
    int sum = 0;
    for (int i = 0; i < t.sw; ++i) sum += cs[i];
    const uint8_t* ml = e_l + (ty + t.half) * t.ew_l + tx0 + t.half;
    const uint8_t* mr = e_r + (ty + t.half) * t.ew_r + tx0 + t.half + s;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      if (j > 0) sum += cs[j + t.sw - 1] - cs[j - 1];
      const int score = ml[j] == mr[j] ? sum : 0;
      if constexpr (SUBPIXEL) {
        // The step after a (re-)selection supplies its right neighbour.
        if (was_new[j]) s_right[j] = score;
      }
      const bool is_new = score >= best[j];
      if (is_new) {
        best[j] = score;
        winner[j] = s + 1;
      }
      if constexpr (SUBPIXEL) {
        if (is_new) {
          s_left[j] = s_prev[j];
          s_right[j] = -1;
        }
        s_prev[j] = score;
        was_new[j] = is_new;
      }
    }
    __syncthreads();  // colsum is rewritten by the next shift
  }

  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int x = x0 + tx0 + j;
    if (x < W) {
      const size_t o = plane + (size_t)y * W + x;
      best_out[o] = best[j];
      winner_out[o] = winner[j];
      if constexpr (SUBPIXEL)
        sub_out[o] = parabola_max(best[j], winner[j], s_left[j], s_right[j]);
    }
  }
}

}  // namespace match_loop
