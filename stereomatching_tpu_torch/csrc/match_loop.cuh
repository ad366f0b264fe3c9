// The shift loop of the classic pipeline's three matching kernels, K1
// (match_score_edges.cu: edges built from brightness), K8 and K9
// (match_and_score.cu: edge maps given, whole images or row-shard halo
// blocks), for sm_90a.
//
// Each kernel stages its two edge tiles as bit rows in shared memory and
// then runs shift_loop.  One block of NT = 512 threads owns a TW = 128
// column output tile of th rows (128, or 64 with the sub-pixel carries).
// The staged rows, 1-bit cells packed along x into 32-bit words (word w
// of a row holds tile columns 32w .. 32w + 31; tile cell (r, c) is image
// (y0 - half + r, x0 - half + c)):
//   * a left bit row (the edge map) and a left validity row (0 where a
//     cell never matches: ghost mode's cells outside the image, the
//     zero-filled match halo), both TW + 2 * half columns;
//   * a right bit row D - 1 columns wider (ghost mode: cells outside the
//     image are 0 and match a left 0, the reference's zero edge halo,
//     src/stereo-ghost.c:119-121).
// For every shift s of D, shift_loop:
//   * makes the match plane 32 columns at a time: one funnel shift of two
//     right words, one XOR/NOT and one AND,
//     M = ~(L ^ funnel(R[w + s/32], R[w + s/32 + 1], s % 32)) & V
//     (equality, so two non-edges match too).  The block writes the whole
//     tile's match words for shift s into one of two buffers, then passes
//     one barrier; the next shift writes the other buffer, so one barrier
//     per shift suffices;
//   * sums a row's sw-wide window at one column as __popc of sw bits of
//     the match row (one funnel shift of two words for sw <= 31; a word
//     loop above), so no column-sum plane exists.  Each match-plane entry
//     holds a word and its right neighbour, so the two words are one
//     64-bit load; all 32 lanes of a warp own neighbouring columns and
//     read the same entry: every shared-memory load in the loop is a
//     broadcast;
//   * walks each thread's strip (one output column, R consecutive rows)
//     with a running column sum, box += rowsum(entering row) -
//     rowsum(leaving row), so the window's sw rows are summed once per
//     strip, not per pixel;
//   * keeps score = box sum where matched, else 0, and (best, winner)
//     packed in one register: best < 65536 (sw <= 255) in the high half,
//     winner = s + 1 < 65536 in the low half.  As s grows,
//     max(packed, score << 16 | s + 1) keeps the last shift among equal
//     scores, the reference's last-wins `score >= best` (all-zero scores
//     give winner = D).
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

constexpr int TW = 128;          // output columns per block
constexpr int NT = 512;          // threads per block
constexpr int GROUPS = NT / TW;  // row strips per block
constexpr int NWARPS = NT / 32;

// Output rows per thread (the strip): the sub-pixel carries take four
// more registers per pixel, so their strip is half as tall.
template <bool SUBPIXEL>
__host__ __device__ constexpr int strip_rows() { return SUBPIXEL ? 16 : 32; }

// Shapes of the bit rows in shared memory (32-bit words).
struct Layout {
  int half, sw;
  int th;    // output rows per block: GROUPS * strip
  int rows;  // tile rows: th + 2 * half
  int ew_l;  // left tile columns: TW + 2 * half
  int ew_r;  // right tile columns: ew_l + D - 1
  int lst;   // words per left and validity row, word pairs per match
             // row (one spare word)
  int rst;   // words per right row (the funnel reads one past the last)
  int words; // L, V, R and both match buffers (two words per entry)
};

__host__ __device__ inline Layout layout(int half, int num_shifts, int th) {
  Layout g;
  g.half = half;
  g.sw = 2 * half + 1;
  g.th = th;
  g.rows = th + 2 * half;
  g.ew_l = TW + 2 * half;
  g.ew_r = g.ew_l + num_shifts - 1;
  g.lst = (g.ew_l + 31) / 32 + 1;
  g.rst = g.lst + (num_shifts - 1) / 32 + 1;
  g.words = g.rows * (6 * g.lst + g.rst);
  return g;
}

// Dynamic shared memory of a block of the taller tile (without the
// sub-pixel plane; the sub-pixel variant needs less).  The callers refuse
// configurations above the sm_90 opt-in limit of 232448 bytes, square
// widths above 255 and more than 65535 shifts (the packed best / winner).
__host__ __device__ inline int smem_bytes(int half, int num_shifts) {
  return 4 * layout(half, num_shifts, GROUPS * strip_rows<false>()).words;
}

// A block's shared memory: the staged rows and the two match buffers.
struct Tiles {
  uint32_t* lbits;  // rows x lst
  uint32_t* vbits;  // rows x lst
  uint2* mbuf0;     // rows x lst entries (a word and its right neighbour)
  uint2* mbuf1;
  uint32_t* rbits;  // rows x rst
};

__device__ __forceinline__ Tiles tiles(uint32_t* smem, const Layout& g) {
  Tiles t;
  t.lbits = smem;
  t.vbits = t.lbits + g.rows * g.lst;
  t.mbuf0 = reinterpret_cast<uint2*>(t.vbits + g.rows * g.lst);
  t.mbuf1 = t.mbuf0 + g.rows * g.lst;
  t.rbits = reinterpret_cast<uint32_t*>(t.mbuf1 + g.rows * g.lst);
  return t;
}

__host__ __device__ __forceinline__ int wrap_index(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int wrap_fast(int i, int n) {
  return (i >= 0 && i < n) ? i : wrap_index(i, n);
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

// Matches in the sw-wide window of match row `m` starting at tile column
// a (columns a .. a + sw - 1).  Entry w of a match row holds words w and
// w + 1, so the two words of a narrow window are one 64-bit load.
template <bool NARROW>
__device__ __forceinline__ int window_sum(const uint2* m, int a, int sw,
                                          uint32_t mask) {
  if constexpr (NARROW) {  // sw <= 31: two words
    const uint2 p = m[a >> 5];
    return __popc(__funnelshift_r(p.x, p.y, a & 31) & mask);
  } else {
    const int b = a + sw - 1, wa = a >> 5, wb = b >> 5;
    int n = 0;
    for (int w = wa; w <= wb; ++w) {
      uint32_t v = m[w].x;
      if (w == wa) v &= ~0u << (a & 31);
      if (w == wb) v &= ~0u >> (31 - (b & 31));
      n += __popc(v);
    }
    return n;
  }
}

// The shift loop of one block over its staged rows t.lbits / t.vbits /
// t.rbits (the caller has passed a barrier after staging).  Writes best,
// winner (and subpixel) of the block's pixels inside H x W at offset
// `plane` (the image's first pixel) of the outputs, and calls
// extra(o, row, c) for each of them: o the output offset, (row, c) the
// pixel's tile cell.
template <bool SUBPIXEL, bool NARROW, class Extra>
__device__ __forceinline__ void shift_loop(const Tiles& t, const Layout& g,
                                           int num_shifts, int H, int W,
                                           int y0, int x0, size_t plane,
                                           int* __restrict__ best_out,
                                           int* __restrict__ winner_out,
                                           float* __restrict__ sub_out,
                                           Extra extra) {
  constexpr int R = strip_rows<SUBPIXEL>();
  const int half = g.half;
  const uint32_t* lbits = t.lbits;
  const uint32_t* vbits = t.vbits;
  const uint32_t* rbits = t.rbits;
  // This thread's pixels: output column xt, rows r0 .. r0 + R - 1 of the
  // tile (tile row r + half, tile column xt + half).
  const int xt = threadIdx.x % TW;
  const int r0 = (threadIdx.x / TW) * R;
  const int cw = (xt + half) >> 5, cb = (xt + half) & 31;
  const uint32_t mask = NARROW ? (1u << g.sw) - 1 : 0u;
  // The match-plane word this thread writes, and its row step.
  const int mw = threadIdx.x % g.lst, mstep = NT / g.lst;
  const int mr0 = threadIdx.x / g.lst;

  uint32_t st[R];  // best << 16 | winner
  // Sub-pixel carries (unused without SUBPIXEL; the compiler drops them).
  int s_left[R], s_right[R], s_prev[R];
  bool was_new[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    st[i] = 0;
    s_left[i] = s_right[i] = s_prev[i] = -1;
    was_new[i] = false;
  }

  for (int s = 0; s < num_shifts; ++s) {
    uint2* m = (s & 1) ? t.mbuf1 : t.mbuf0;
    if (mr0 < mstep) {
      const int sq = s >> 5, sb = s & 31;
      for (int r = mr0; r < g.rows; r += mstep) {
        const uint32_t* rr = rbits + r * g.rst + mw + sq;
        const int o = r * g.lst + mw;
        const uint32_t v = ~(lbits[o] ^ __funnelshift_r(rr[0], rr[1], sb)) & vbits[o];
        m[o].x = v;
        if (mw > 0) m[o - 1].y = v;
      }
    }
    __syncthreads();  // the other buffer is rewritten by the next shift

    const uint32_t s1 = (uint32_t)(s + 1);
    int box = 0;
    for (int r = r0; r < r0 + 2 * half; ++r)
      box += window_sum<NARROW>(m + r * g.lst, xt, g.sw, mask);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + i;
      box += window_sum<NARROW>(m + (r + 2 * half) * g.lst, xt, g.sw, mask);
      const bool hit = (m[(r + half) * g.lst + cw].x >> cb) & 1u;
      const int score = hit ? box : 0;
      const uint32_t cand = ((uint32_t)score << 16) | s1;
      if constexpr (SUBPIXEL) {
        // The step after a (re-)selection supplies its right neighbour.
        if (was_new[i]) s_right[i] = score;
        const bool is_new = cand > st[i];
        if (is_new) {
          st[i] = cand;
          s_left[i] = s_prev[i];
          s_right[i] = -1;
        }
        s_prev[i] = score;
        was_new[i] = is_new;
      } else {
        st[i] = max(st[i], cand);
      }
      if (i + 1 < R)
        box -= window_sum<NARROW>(m + r * g.lst, xt, g.sw, mask);
    }
  }

  const int x = x0 + xt;
  if (x >= W) return;
  const int c = xt + half;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int y = y0 + r0 + i;
    if (y < H) {
      const size_t o = plane + (size_t)y * W + x;
      const int best = (int)(st[i] >> 16), winner = (int)(st[i] & 0xffffu);
      best_out[o] = best;
      winner_out[o] = winner;
      if constexpr (SUBPIXEL)
        sub_out[o] = parabola_max(best, winner, s_left[i], s_right[i]);
      extra(o, r0 + i + half, c);
    }
  }
}

}  // namespace match_loop
