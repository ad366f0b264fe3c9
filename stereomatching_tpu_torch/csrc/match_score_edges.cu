// K1: exact-rule edges + per-shift match + square box score + last-wins
// argmax (+ the optional parabola sub-pixel plane), fused in one kernel,
// for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused.py
// match_score_edges_pallas (body _kernel_from_brightness, _edges_exact_tile,
// _match_loop, _parabola_refine).  Brightness in, four int32 planes out:
// best score, winning shift (1..D), and both edge maps; with the sub-pixel
// plane a fifth, float32.
//
// What bounds it on the H100: not device memory.  Each output pixel reads
// two floats and writes four ints (24 B), but does D * (match + box sum +
// argmax) work.  The kernel is bound by integer issue and shared-memory
// loads inside the shift loop, so the design spends as few of either per
// pixel and shift as it can:
//
//   * Bit rows.  One block of 512 threads per (image, 128-column output
//     tile of TH rows: 128, or 64 with the sub-pixel carries) computes both
//     exact-rule edge tiles once, straight from the brightness (k =
//     rint(b * 256), round half to even as jnp.round; ghost cells hold the
//     128.0 halo brightness, k = 32768; wrap mode indexes modulo H and W),
//     and stores them as 1-bit cells packed along x into 32-bit words
//     (__ballot_sync of 32 neighbouring cells): a left bit row, a left
//     validity row (ghost mode: cells outside the image never match, the
//     zero-filled match halo), and a right bit row D - 1 columns wider
//     (cells outside the image are 0 and match a left 0, the reference's
//     zero edge halo, src/stereo-ghost.c:119-121).  The tiles cover the
//     output tile and its +-half halo.
//   * The match plane.  For shift s the match of 32 columns is one funnel
//     shift of two right words, one XOR/NOT and one AND:
//     M = ~(L ^ funnel(R[w + s/32], R[w + s/32 + 1], s % 32)) & V.  The
//     block writes the whole tile's match words for shift s into one of
//     two buffers, then passes one barrier; the next shift writes the
//     other buffer, so one barrier per shift suffices.
//   * Row sums by popcount.  A row's sw-wide window sum at one column is
//     __popc of sw bits of the match row (one funnel shift of two words
//     for sw <= 31; a word loop above), so no column-sum plane exists.
//     Each match-plane entry holds a word and its right neighbour, so the
//     two words are one 64-bit load; all 32 lanes of a warp own
//     neighbouring columns and read the same entry: every shared-memory
//     load in the loop is a broadcast.
//   * Column running sums over the thread's whole strip.  A thread owns
//     one output column and R consecutive output rows and walks down
//     them: box += rowsum(entering row) - rowsum(leaving row), so the
//     window's sw rows are summed once per strip, not per pixel.
//   * (best, winner) packed in one register: best < 65536 (sw <= 255) in
//     the high half, winner = s + 1 < 65536 in the low half.  As s grows,
//     max(packed, score << 16 | s + 1) keeps the last shift among equal
//     scores, the reference's last-wins `score >= best` (all-zero scores
//     give winner = D).
//   * With SUBPIXEL each pixel also carries its neighbour scores (s_left,
//     s_right, the previous score, took-the-max flag) in the order of
//     stereomatching_tpu/ops/argmax.py match_and_score_subpixel, and ends
//     with the maximising parabola of _parabola_refine
//     (match_loop::parabola_max; __f*_rn ops, IEEE divide).
//   * The edge predicate 2|ka-kb| > min(f32(t) * (ka+kb), 1536) multiplies
//     with __fmul_rn so it is one IEEE product, never contracted.
// None of the TPU structure is carried over (no lane rolls, no (8,128)
// padding, no int16 storage, no banded matmuls).

#include "match_loop.cuh"  // wrap_index, parabola_max (K8's loop is not used)

namespace {

constexpr int TW = 128;          // output columns per block
constexpr int NT = 512;          // threads per block
constexpr int GROUPS = NT / TW;  // row strips per block
constexpr int NWARPS = NT / 32;
constexpr int GHOST_K = 32768;   // round(128.0 * 256)

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

__device__ __forceinline__ bool decide(int ka, int kb, float thr) {
  float lhs = (float)(2 * abs(ka - kb));
  float rhs = fminf(__fmul_rn(thr, (float)(ka + kb)), 1536.0f);
  return lhs > rhs;
}

__device__ __forceinline__ int wrap_fast(int i, int n) {
  return (i >= 0 && i < n) ? i : match_loop::wrap_index(i, n);
}

// k = rint(b * 256) at image (gy, gx); GHOST_K outside the image in ghost
// mode, modulo H and W in wrap mode.
__device__ __forceinline__ int load_k(const float* __restrict__ img, int gy,
                                      int gx, int H, int W, bool ghost) {
  if (ghost) {
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) return GHOST_K;
  } else {
    gy = wrap_fast(gy, H);
    gx = wrap_fast(gx, W);
  }
  return __float2int_rn(__ldg(img + (size_t)gy * W + gx) * 256.0f);
}

// Exact-rule edge at image (gy, gx) (in the image, or wrapped).
__device__ bool edge_at(const float* __restrict__ img, int gy, int gx, int H,
                        int W, bool ghost, float thr) {
  int k[3][3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      k[dy][dx] = load_k(img, gy + dy - 1, gx + dx - 1, H, W, ghost);
  // The four operators of EDGE_OPERATORS (src/stereo.c:16-70), taps as
  // (dx, dy); integer sums, so the tap order does not matter.
#define K(dx, dy) k[(dy) + 1][(dx) + 1]
  return decide(K(-1, -1) + K(-1, 0) + K(-1, 1),
                K(1, -1) + K(1, 0) + K(1, 1), thr) ||  // left_right
         decide(K(-1, -1) + K(0, -1) + K(1, -1),
                K(-1, 1) + K(0, 1) + K(1, 1), thr) ||  // top_bottom
         decide(K(-1, -1) + K(0, -1) + K(-1, 0),
                K(1, 0) + K(0, 1) + K(1, 1), thr) ||  // upleft_downright
         decide(K(-1, 1) + K(0, 1) + K(-1, 0),
                K(0, -1) + K(1, -1) + K(1, 0), thr);  // downleft_upright
#undef K
}

// One image's edge tile as bit rows: word w of row r holds tile columns
// 32w .. 32w + 31 (image (y0 - half + r, x0 - half + c)); columns at or
// past `cols` are 0.  With `valid`, also the validity rows (1 where the
// cell is inside the image or wraps into it).
__device__ void stage_bits(uint32_t* bits, uint32_t* valid, int stride,
                           int cols, const Layout& g,
                           const float* __restrict__ img, int H, int W,
                           int y0, int x0, bool ghost, float thr) {
  const int lane = threadIdx.x & 31;
  for (int item = threadIdx.x >> 5; item < g.rows * stride; item += NWARPS) {
    const int r = item / stride, w = item - r * stride;
    const int c = 32 * w + lane;
    const int gy = y0 - g.half + r, gx = x0 - g.half + c;
    const bool in = c < cols && (!ghost || (gy >= 0 && gy < H && gx >= 0 && gx < W));
    const bool e = in && edge_at(img, gy, gx, H, W, ghost, thr);
    const uint32_t eb = __ballot_sync(0xffffffffu, e);
    const uint32_t vb = __ballot_sync(0xffffffffu, in);
    if (lane == 0) {
      bits[item] = eb;
      if (valid != nullptr) valid[item] = vb;
    }
  }
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

template <bool SUBPIXEL, bool NARROW>
__global__ void __launch_bounds__(NT)
match_score_edges_kernel(const float* __restrict__ left,
                         const float* __restrict__ right,
                         int* __restrict__ best_out,
                         int* __restrict__ winner_out,
                         int* __restrict__ edges_l_out,
                         int* __restrict__ edges_r_out,
                         float* __restrict__ sub_out, int H, int W, int half,
                         int num_shifts, int ghost_mode, float thr) {
  constexpr int R = strip_rows<SUBPIXEL>();
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout g = layout(half, num_shifts, GROUPS * R);
  const bool ghost = ghost_mode != 0;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * g.th, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)b * H * W;
  left += plane;
  right += plane;

  uint32_t* lbits = smem;
  uint32_t* vbits = lbits + g.rows * g.lst;
  uint2* mbuf0 = reinterpret_cast<uint2*>(vbits + g.rows * g.lst);
  uint2* mbuf1 = mbuf0 + g.rows * g.lst;
  uint32_t* rbits = reinterpret_cast<uint32_t*>(mbuf1 + g.rows * g.lst);

  stage_bits(lbits, vbits, g.lst, g.ew_l, g, left, H, W, y0, x0, ghost, thr);
  stage_bits(rbits, nullptr, g.rst, g.ew_r, g, right, H, W, y0, x0, ghost, thr);
  __syncthreads();

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
    uint2* m = (s & 1) ? mbuf1 : mbuf0;
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
    for (int t = r0; t < r0 + 2 * half; ++t)
      box += window_sum<NARROW>(m + t * g.lst, xt, g.sw, mask);
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
        sub_out[o] = match_loop::parabola_max(best, winner, s_left[i], s_right[i]);
      const int row = r0 + i + half;
      edges_l_out[o] = (lbits[row * g.lst + (c >> 5)] >> (c & 31)) & 1u;
      edges_r_out[o] = (rbits[row * g.rst + (c >> 5)] >> (c & 31)) & 1u;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (the taller tile, without the
// sub-pixel plane; the sub-pixel variant needs less).  The caller refuses
// configurations above the sm_90 opt-in limit of 232448 bytes, square
// widths above 255 and more than 65535 shifts (the packed best / winner).
int match_score_edges_smem_bytes(int half, int num_shifts) {
  return 4 * layout(half, num_shifts, GROUPS * strip_rows<false>()).words;
}

// left/right: float32 [B, H, W] brightness, contiguous, on the device.
// Outputs: int32 [B, H, W] best, winner, edges_l, edges_r, and float32
// [B, H, W] subpixel unless `subpixel` is NULL.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int match_score_edges(const void* left, const void* right, void* best,
                      void* winner, void* edges_l, void* edges_r,
                      void* subpixel, int B, int H, int W, int half,
                      int num_shifts, int ghost, float threshold,
                      void* stream) {
  if (B < 1 || H < 1 || W < 1 || num_shifts < 1 || num_shifts > 65535 ||
      half < 0 || half > 127)
    return (int)cudaErrorInvalidValue;
  const bool sub = subpixel != nullptr, narrow = half <= 15;
  auto kernel = sub ? (narrow ? match_score_edges_kernel<true, true>
                              : match_score_edges_kernel<true, false>)
                    : (narrow ? match_score_edges_kernel<false, true>
                              : match_score_edges_kernel<false, false>);
  const int th = GROUPS * (sub ? strip_rows<true>() : strip_rows<false>());
  const int smem = 4 * layout(half, num_shifts, th).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + th - 1) / th, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)right, (int*)best, (int*)winner,
      (int*)edges_l, (int*)edges_r, (float*)subpixel, H, W, half, num_shifts,
      ghost, threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
