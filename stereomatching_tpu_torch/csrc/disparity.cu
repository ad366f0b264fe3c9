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
// C[d+1]) as float32, and the winning cost as int32.  The parabola is
// written with __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn in the JAX op
// order (denom = (cl - 2 cm) + cr; offset = (cl - cr) / (2 denom), clipped
// to +-0.5), as K5 (sgm_tail.cu) does, so the plane is bitwise equal.  The
// volume never exists.
//
// What bounds it on the H100: integer instructions and shared-memory
// accesses, not device memory.  Each pixel reads 8 B and writes 12 B,
// against at least 5 integer ops per pixel and disparity (the cost, the
// column and row sums' updates, the key and the minimum): at D = 64, 320
// ops per pixel, 16 per byte, above the card's ~5 ops per byte of HBM.
// So the loop must not wait: the tile kernel below (d outermost,
// for what the strips do not take) waits at two block barriers per d, with
// a third of its warps idle in the column pass and each cost evaluated 3.6
// times in serial chains.
//
// The warp strips.  Disparities run across the lanes of a warp: lane l
// owns d = l + 32 j (j < ND = ceil(D / 32)), so the lanes' reads of the
// matching view are consecutive addresses.  A block of NW warps stages its
// reference tile (th rows plus the h halo, 32 NW + 2h columns) and the
// matching view D - 1 columns wider in shared memory once (bytes for SAD,
// 32-bit codes for census; a zero row on top, the x clamp applied while
// staging), then synchronises; after that each warp works alone, on
// shared memory it owns, with no block barrier.  Warp w owns 32 output
// columns and walks down the tile two rows per step.  For each of its
// 32 + 2h columns and each d it keeps the running column sum in its own
// slice of shared memory (one word per column and d, lanes on consecutive
// d, the sums of both rows of the step as 16-bit halves):
// V(t) = V(t - 1) + pc(t + 2h) - pc(t - 1), so each cost is evaluated
// twice (entering and leaving the window), plus the 2h warm-up rows of a
// tile.  The row sum S slides along x in registers:
// S += V(c) - V(c - 2h - 1).  Columns go in groups of 8, each column's
// loads issued one column ahead; for SAD a group takes its 8 reference
// bytes of a row in one broadcast load and the lane's 8 matching bytes
// from 3 aligned words, and makes 4 absolute differences per
// __vabsdiffu4.  Columns outside the frame keep V = 0 (a group is tested
// at once; columns before the strip count as outside).
//
// The argmin.  Lane l writes key = S << 8 | d for each of its d into a
// per-warp row of keys, 8 output columns at a time; then 4 lanes per
// column scan the keys (d = q, q + 4, ...), take the minimum and combine
// it with two butterfly shuffles.  The least key is the least cost and,
// among equal costs, the least d: the first minimum, which is the best_d
// that argmin_subpixel_scan's strict-< scan ends with.  The scan's other
// carries end as c_left = C[d* - 1] (c_prev is taken when the minimum is
// set; it is the sentinel 2^30 at d* = 0) and c_right = C[d* + 1] (reset
// to the sentinel when the minimum is set and taken one step later, so
// the sentinel at d* = D - 1), so reading the keys at d* - 1 and d* + 1
// gives the same three values.  tests/test_torch_box.py pins this reading
// against argmin_subpixel_scan.
//
// Domain: SAD intensities 0..255 and census codes of at most 24 set bits
// (census_window <= 5), as the pipeline feeds and disparity_pallas
// documents; the pipelines refuse SAD planes outside 0..255
// (models/modern.py check_sad_pixels).  Then V <= 255 * 255 fits 16 bits,
// and C <= 255 * 255^2 < 2^24 leaves 8 bits for d in the key.
//
// Where the strips do not fit in shared memory (SAD windows from 241 at
// D = 64, 111 at D = 256), or leave census fewer than 4 warps per SM (its
// strips stage 32-bit codes and then lose to the staged tiles), the tile
// kernel runs instead: both views staged in shared memory when they fit
// in 116 KB, else read through L1.  Windows up
// to 255 and D up to 256, as the JAX kernel takes.  None of the TPU
// structure is carried over (no lane rolls, no banded matmuls, no digit
// splits: the sums are exact integer adds).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ARGBIG = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------
// The warp-strip kernel.

constexpr int SW = 32;       // output columns per warp, one per lane
constexpr int GROUP = 8;     // output columns per argmin scan, 4 lanes each
constexpr int MAX_NW = 4;    // warps per block
constexpr int SMEM_PER_SM = 233472;  // 228 KB, 1 KB of it reserved per block
// Census strips with fewer warps per SM than this lose to the staged tiles
// (32-bit staging): 4 or more won at all 6 census instances timed, 1-2
// lost or tied at all 6 where the tiles were staged; where the tiles read
// through L1 one of two readings favoured the strips (window 51, D = 256).
// SAD strips beat the tiles whenever they fit.
constexpr int MIN_CENSUS_STRIP_WARPS = 4;

struct Strips {
  int nw, th;       // warps per block, output rows per block (even)
  int pad;          // columns before the staged tile (groups start 8-aligned)
  int wr, wo;       // staged reference / matching row strides (multiples of 8)
  int rows;         // staged rows: a zero row, then th + 2h
  int warp_bytes;   // one warp's keys and column sums
  int smem_bytes;
  int warps_per_sm;
};

inline Strips strips_geometry(int half, int D, bool census) {
  Strips best{};
  int best_score = -1;
  const int nd = (D + 31) / 32;
  const int esz = census ? 4 : 1;
  for (int nw = MAX_NW; nw >= 1; nw /= 2) {
    for (int th = 128; th >= 16; th /= 2) {
      Strips g;
      g.nw = nw;
      g.th = th;
      // SAD reads each group's 8 bytes of a row at once: 8-aligned rows
      // and group starts, 8 spare bytes after the matching view.
      g.pad = census ? 0 : (8 - 2 * half % 8) % 8;
      g.wr = SW * nw + 2 * half;
      g.wo = g.wr + D - 1;
      if (!census) {
        g.wr = (g.pad + g.wr + 7) / 8 * 8;
        g.wo = (g.pad + g.wo + 8 + 7) / 8 * 8;
      }
      g.rows = th + 2 * half + 1;
      const int dv = 32 * nd, dp = dv + 4;  // the kernel's DV, DP
      g.warp_bytes = (2 * GROUP * dp + (SW + 2 * half + 1) * dv) * 4;
      const int staged = (g.rows * (g.wr + g.wo) * esz + 15) / 16 * 16;
      g.smem_bytes = nw * g.warp_bytes + staged;
      const int blocks = SMEM_PER_SM / (g.smem_bytes + 1024);
      g.warps_per_sm = blocks * nw;
      if (g.smem_bytes > 232448) continue;
      // Resident warps (up to 16) times the share of rows that produce
      // output (the rest warm the column sums up).
      const int w = g.warps_per_sm < 16 ? g.warps_per_sm : 16;
      const int score = w * 1024 * th / (th + 2 * half);
      if (score > best_score) {
        best_score = score;
        best = g;
      }
    }
  }
  return best;
}

inline bool strips_fit(const Strips& g, bool census) {
  return g.warps_per_sm >= (census ? MIN_CENSUS_STRIP_WARPS : 1);
}

// One output pixel: the winner d, d plus the parabola offset, the cost.
__device__ __forceinline__ void write_pixel(int* disp_out, float* sub_out, int* cost_out,
                                            size_t o, int best_d, int best, int c_left,
                                            int c_right) {
  const float cl = (float)c_left, cm = (float)best, cr = (float)c_right;
  const float denom = __fadd_rn(__fsub_rn(cl, __fmul_rn(2.0f, cm)), cr);
  float off = 0.0f;
  if (c_left < ARGBIG && c_right < ARGBIG && denom > 0.0f)
    off = __fdiv_rn(__fsub_rn(cl, cr), __fmul_rn(2.0f, denom));
  off = fminf(fmaxf(off, -0.5f), 0.5f);
  disp_out[o] = best_d;
  sub_out[o] = __fadd_rn((float)best_d, off);
  cost_out[o] = best;
}

template <bool CENSUS, int ND>
__global__ void __launch_bounds__(SW * MAX_NW)
strips_kernel(const int* __restrict__ ref, const int* __restrict__ other,
              int* __restrict__ disp_out, float* __restrict__ sub_out,
              int* __restrict__ cost_out, int H, int W, int D, int half,
              bool right_ref, Strips g) {
  using T = typename std::conditional<CENSUS, uint32_t, uint8_t>::type;
  constexpr int DV = 32 * ND, DP = DV + 4;  // d slots per column, key row stride
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x / 32;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * SW * nw, y0 = blockIdx.y * g.th;
  const size_t plane = (size_t)H * W;
  ref += b * plane;
  other += b * plane;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = 2 * half + 1, ncols = SW + 2 * half;
  unsigned* __restrict__ keys = (unsigned*)(smem + warp * g.warp_bytes);  // [2][GROUP][DP]
  unsigned* __restrict__ vcol = keys + 2 * GROUP * DP;  // [ncols + 1][DV], slot 0 all 0
  T* sref = (T*)(smem + nw * g.warp_bytes);  // [rows][wr]
  T* soth = sref + g.rows * g.wr;            // [rows][wo]

  // Staging: staged row s >= 1 is global row y0 - h + s - 1 (0 outside the
  // frame), row 0 is all 0.  Reference column pad + c is global x0 - h + c
  // (0 outside the frame; such columns are never used); matching column
  // pad + j is global x0 - h + j, shifted left by D - 1 for the left
  // reference, clamped into the frame.
  const int shift = right_ref ? 0 : D - 1;
  for (int s = warp; s < g.rows; s += nw) {
    const int gy = y0 - half + s - 1;
    const bool row_in = s > 0 && gy >= 0 && gy < H;
    const int* rr = ref + (size_t)(row_in ? gy : 0) * W;
    const int* ro = other + (size_t)(row_in ? gy : 0) * W;
    for (int c = lane; c < g.wr; c += 32) {
      const int gx = x0 - half + c - g.pad;
      sref[s * g.wr + c] = (row_in && gx >= 0 && gx < W) ? (T)rr[gx] : (T)0;
    }
    for (int j = lane; j < g.wo; j += 32) {
      const int gx = min(max(x0 - half + j - g.pad - shift, 0), W - 1);
      soth[s * g.wo + j] = row_in ? (T)ro[gx] : (T)0;
    }
  }
  for (int i = lane; i < 2 * GROUP * DP; i += 32) keys[i] = 0xffffffffu;
  for (int i = lane; i < (ncols + 1) * DV; i += 32) vcol[i] = 0;
  __syncthreads();  // the only block barrier

  const int xw = x0 + SW * warp;  // this warp's first output column
  if (xw >= W) return;
  const int n_out = min(g.th, H - y0);
  // The warp's column cc (0 .. ncols - 1) is global xw - h + cc, staged
  // column pad + SW * warp + cc; columns cc_lo .. cc_hi - 1 are in the
  // frame.  Groups of 8 columns start at staged columns that are multiples
  // of 8.
  const int cc_lo = max(0, half - xw), cc_hi = min(ncols, W - xw + half);
  const T* __restrict__ ref_w = sref + g.pad + SW * warp;
  const T* __restrict__ oth_w = soth + g.pad + SW * warp;
  int off[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = lane + 32 * j;
    off[j] = d < D ? (right_ref ? d : D - 1 - d) : 0;
  }
  const bool last_valid = lane + 32 * (ND - 1) < D;  // the other slots all are
  unsigned* __restrict__ keys_l = keys + lane;

  // One column's inputs in the two entering (0, 1) and two leaving (2, 3)
  // rows at each of the lane's d: for SAD the costs, for census the codes
  // (reference in a, matching in pc); and the column sum of the previous
  // row.
  struct Inputs {
    int a[4];
    int pc[4][ND];
    int prev[ND];
  };

  // One step: rows s_in0, s_in0 + 1 enter the column sums, s_out0,
  // s_out0 + 1 leave them (SUB); with OUT the two output rows t, t + 1 are
  // produced.
  auto step = [&](auto out_tag, auto sub_tag, int s_in0, int s_out0, int t) {
    constexpr bool OUT = decltype(out_tag)::value, SUB = decltype(sub_tag)::value;
    constexpr int NR = SUB ? 4 : 2;  // rows whose costs are read
    const T* rrow[4] = {ref_w + s_in0 * g.wr, ref_w + (s_in0 + 1) * g.wr,
                        ref_w + s_out0 * g.wr, ref_w + (s_out0 + 1) * g.wr};
    const T* orow[4] = {oth_w + s_in0 * g.wo, oth_w + (s_in0 + 1) * g.wo,
                        oth_w + s_out0 * g.wo, oth_w + (s_out0 + 1) * g.wo};
    int s0[ND], s1[ND];  // row sums of output rows t and t + 1
#pragma unroll
    for (int j = 0; j < ND; ++j) s0[j] = s1[j] = 0;
    unsigned best[2] = {0, 0};
    int c_left[2] = {0, 0}, c_right[2] = {0, 0};

    // SAD: a group's absolute differences, 4 columns per word: byte p & 3
    // of dif[r][j][p >> 2] is row r's cost at column cc0 + p and the lane's
    // j-th d.  The reference row's 8 bytes are one broadcast load; the
    // lane's 8 matching bytes come from 3 aligned words, funnel-shifted.
    unsigned dif[4][ND][2];
    auto load_group = [&](int cc0) {
      if (CENSUS) return;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const uint2 a = *(const uint2*)(rrow[r] + cc0);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const unsigned* w = (const unsigned*)(orow[r] + cc0 + (off[j] & ~3));
          const unsigned w0 = w[0], w1 = w[1], w2 = w[2];
          const unsigned sh = 8 * (off[j] & 3);
          dif[r][j][0] = __vabsdiffu4(a.x, __funnelshift_r(w0, w1, sh));
          dif[r][j][1] = __vabsdiffu4(a.y, __funnelshift_r(w1, w2, sh));
        }
      }
    };
    // Column cc (output column p of its group): its costs and previous sums.
    auto load = [&](int cc, int p, bool in_frame) {
      Inputs in;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        in.prev[j] = in_frame ? (int)(vcol[(cc + 1) * DV + 32 * j + lane] >> 16) : 0;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if (CENSUS) {
            in.a[r] = in_frame ? (int)rrow[r][cc] : 0;
            in.pc[r][j] = in_frame ? (int)orow[r][cc + off[j]] : 0;
          } else {
            in.pc[r][j] = (int)__byte_perm(dif[r][j][p >> 2], 0, 0x4440 + (p & 3));
          }
        }
      }
      return in;
    };
    // The column sums of column cc - k (the one leaving the row window of
    // output column cc), this row's: stored before they are read.
    auto load_old = [&](int cc, unsigned* old) {
#pragma unroll
      for (int j = 0; j < ND; ++j) old[j] = vcol[(cc + 1 - k) * DV + 32 * j + lane];
    };
    // Column cc from its inputs: its column sums of rows t, t + 1 (stored),
    // then with OUT the row sums, and with KEY (old holds column cc - k's
    // sums) the keys of output column p of the group.
    auto column = [&](auto key_tag, const Inputs& in, int cc, int p, bool in_frame,
                      const unsigned* old) {
      constexpr bool KEY = decltype(key_tag)::value;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        auto cost = [&](int r) { return CENSUS ? __popc(in.a[r] ^ in.pc[r][j]) : in.pc[r][j]; };
        int v0 = 0, v1 = 0;
        if (in_frame) {
          v0 = in.prev[j] + cost(0) - (SUB ? cost(2) : 0);
          v1 = v0 + cost(1) - (SUB ? cost(3) : 0);
          vcol[(cc + 1) * DV + 32 * j + lane] = (unsigned)v0 + ((unsigned)v1 << 16);
        }
        if (OUT) {
          if (KEY) {
            s0[j] += v0 - (int)(old[j] & 0xffff);
            s1[j] += v1 - (int)(old[j] >> 16);
            if (j < ND - 1 || last_valid) {
              const unsigned d = lane + 32 * j;
              keys_l[p * DP + 32 * j] = ((unsigned)s0[j] << 8) + d;
              keys_l[(GROUP + p) * DP + 32 * j] = ((unsigned)s1[j] << 8) + d;
            }
          } else {
            s0[j] += v0;
            s1[j] += v1;
          }
        }
      }
    };

    // Group g0's scan of row r: lanes 4p .. 4p + 3 take output column p's
    // first minimum and its neighbours' costs, which then move to lane
    // 8 g0 + p.
    auto scan = [&](int g0, int r) {
      const int p = lane >> 2, q = lane & 3;
      const unsigned* kr = keys + (r * GROUP + p) * DP;
      unsigned m = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < 8 * ND; ++i) m = min(m, kr[q + 4 * i]);
      m = min(m, __shfl_xor_sync(FULL, m, 1));
      m = min(m, __shfl_xor_sync(FULL, m, 2));
      const int ds = m & 255;
      int cl = (int)(kr[ds > 0 ? ds - 1 : 0] >> 8);
      int cr = (int)(kr[ds + 1 < D ? ds + 1 : 0] >> 8);
      if (ds == 0) cl = ARGBIG;
      if (ds + 1 >= D) cr = ARGBIG;
      const int src = (lane & 7) << 2;
      m = __shfl_sync(FULL, m, src);
      cl = __shfl_sync(FULL, cl, src);
      cr = __shfl_sync(FULL, cr, src);
      if ((lane >> 3) == g0) {
        best[r] = m;
        c_left[r] = cl;
        c_right[r] = cr;
      }
    };

    // Columns cc0 .. cc0 + 7; KEY for output columns.  CHECK tests each
    // column against the frame (columns before 0 count as outside it).
    // Each column's loads are issued one column ahead.
    auto group = [&](auto key_tag, auto check_tag, int cc0) {
      constexpr bool KEY = OUT && decltype(key_tag)::value;
      constexpr bool CHECK = decltype(check_tag)::value;
      auto in_frame = [&](int cc) { return !CHECK || (cc >= cc_lo && cc < cc_hi); };
      load_group(cc0);
      Inputs cur = load(cc0, 0, in_frame(cc0));
      unsigned old[ND];
      if (KEY) load_old(cc0, old);
#pragma unroll
      for (int p = 0; p < GROUP; ++p) {
        const int cc = cc0 + p;
        Inputs nxt;
        if (p + 1 < GROUP) nxt = load(cc + 1, p + 1, in_frame(cc + 1));
        column(std::integral_constant<bool, KEY>{}, cur, cc, p, in_frame(cc), old);
        if (KEY && p + 1 < GROUP) load_old(cc + 1, old);
        if (p + 1 < GROUP) cur = nxt;
      }
    };
    auto run_group = [&](auto key_tag, int cc0) {
      if (cc0 >= cc_lo && cc0 + GROUP <= cc_hi)
        group(key_tag, std::false_type{}, cc0);
      else
        group(key_tag, std::true_type{}, cc0);
    };
    // The left 2h columns, summed without output, in groups of 8 ending at
    // column 2h.
#pragma unroll 1
    for (int cc0 = 2 * half - GROUP; cc0 > -GROUP; cc0 -= GROUP) run_group(std::false_type{}, cc0);
    // The 32 output columns, 8 at a time.
#pragma unroll 1
    for (int g0 = 0; g0 < SW / GROUP; ++g0) {
      run_group(std::true_type{}, 2 * half + GROUP * g0);
      if (OUT) {
        __syncwarp();
        scan(g0, 0);
        scan(g0, 1);
        __syncwarp();  // the keys are rewritten by the next group
      }
    }
    if (OUT) {
      const int x = xw + lane;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (x < W && t + r < n_out)
          write_pixel(disp_out, sub_out, cost_out, b * plane + (size_t)(y0 + t + r) * W + x,
                      best[r] & 255, best[r] >> 8, c_left[r], c_right[r]);
      }
    }
  };

  // Warm-up: staged rows 1 .. 2h (global y0 - h .. y0 + h - 1) enter.
  for (int s = 1; s < 2 * half + 1; s += 2) step(std::false_type{}, std::false_type{}, s, 0, 0);
  // Output rows t, t + 1: rows t + 2h + 1, t + 2h + 2 enter, t, t + 1 leave
  // (row 0 is the zero row).
  for (int t = 0; t < n_out; t += 2)
    step(std::true_type{}, std::true_type{}, t + 2 * half + 1, t, t);
}

template <bool CENSUS, int ND>
cudaError_t launch_strips(const Strips& g, const int* ref, const int* other, int* disp,
                          float* sub, int* cost, int B, int H, int W, int D, int half,
                          bool right_ref, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      strips_kernel<CENSUS, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + SW * g.nw - 1) / (SW * g.nw), (H + g.th - 1) / g.th, B);
  strips_kernel<CENSUS, ND><<<grid, SW * g.nw, g.smem_bytes, st>>>(
      ref, other, disp, sub, cost, H, W, D, half, right_ref, g);
  return cudaGetLastError();
}

template <bool CENSUS>
cudaError_t run_strips(const Strips& g, const int* ref, const int* other, int* disp,
                       float* sub, int* cost, int B, int H, int W, int D, int half,
                       bool right_ref, cudaStream_t st) {
  switch ((D + 31) / 32) {
#define K7_ND(n) \
  case n:        \
    return launch_strips<CENSUS, n>(g, ref, other, disp, sub, cost, B, H, W, D, half, right_ref, st);
    K7_ND(1) K7_ND(2) K7_ND(3) K7_ND(4) K7_ND(5) K7_ND(6) K7_ND(7) K7_ND(8)
#undef K7_ND
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// The tile kernel, for windows and D whose strips do not fit: one block
// of 256 threads per (image, 32x32 output tile).  Per d the box sum is
// separable and incremental: a column pass writes running (2h+1)-row sums
// of pc for the tile's 32 + 2h columns into shared memory (tasks of `rc`
// rows, one running sum each; a column outside the frame sums to 0), then
// each thread slides a (2h+1)-wide row sum over 4 output pixels and
// updates their argmin carries (in the order of argmin_subpixel_scan),
// which stay in registers across all D.  Where the tiles fit (STAGED), the
// block first stages the reference tile with its h halo and the matching
// view's rows, D - 1 columns wider, in shared memory; otherwise both views
// are read from device memory through L1.

constexpr int TH = 32;  // output rows per block
constexpr int TW = 32;  // output columns per block
constexpr int NT = 256;
constexpr int PX = 4;   // output pixels per thread (along x)
constexpr int STAGED_MAX_BYTES = 116 * 1024;  // two blocks per SM

static_assert(TH * (TW / PX) == NT, "one thread per (row, 4-pixel strip)");

template <bool CENSUS>
__device__ __forceinline__ int pixel_cost(int a, int o) {
  return CENSUS ? __popc(a ^ o) : (int)__usad((unsigned)a, (unsigned)o, 0u);
}

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
  extern __shared__ __align__(16) int tsmem[];
  const int k = 2 * half + 1;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  ref += b * plane;
  other += b * plane;
  int* colsum = tsmem;
  int* sref = tsmem + TH * cs_stride;  // STAGED only
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
      return pixel_cost<CENSUS>(a, o);
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
    if (x < W)
      write_pixel(disp_out, sub_out, cost_out, b * plane + (size_t)y * W + x, best_d[j],
                  best[j], c_left[j], c_right[j]);
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

// 0: warp strips; 1: tiles, both views staged; 2: tiles, through L1.
int route(int half, int D, bool census) {
  if (strips_fit(strips_geometry(half, D, census), census)) return 0;
  return geometry(half, D).staged ? 1 : 2;
}

}  // namespace

extern "C" {

// Which kernel a launch with this half window, D and cost takes: 0 the
// warp strips, 1 the tiles with both views staged in shared memory, 2 the
// tiles reading both views through L1.
int disparity_route(int half, int D, int census) { return route(half, D, census != 0); }

// ref, other: int32 [B, H, W], contiguous, on the device: intensities
// 0..255 for SAD, census codes of at most 24 set bits for census (the
// strips keep 16-bit column sums and 24-bit costs).  Outputs: int32
// disparity, float32 subpixel, int32 cost [B, H, W].  half = window / 2
// (0..127), 1 <= D <= 256, B <= 65535; right_ref: 1 matches ref(x) against
// other(x + d).  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
int disparity(const void* ref, const void* other, void* disp, void* sub,
              void* cost, int B, int H, int W, int D, int half, int census,
              int right_ref, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || D > 256 || half < 0 ||
      half > 127)
    return (int)cudaErrorInvalidValue;
  const int* r = (const int*)ref;
  const int* o = (const int*)other;
  int* dp = (int*)disp;
  float* sp = (float*)sub;
  int* cp = (int*)cost;
  cudaStream_t st = (cudaStream_t)stream;
  const bool rr = right_ref != 0;
  const Strips s = strips_geometry(half, D, census != 0);
  if (strips_fit(s, census != 0))
    return (int)(census ? run_strips<true>(s, r, o, dp, sp, cp, B, H, W, D, half, rr, st)
                        : run_strips<false>(s, r, o, dp, sp, cp, B, H, W, D, half, rr, st));
  const Geometry g = geometry(half, D);
  if (census)
    return (int)(g.staged ? launch<true, true>(g, r, o, dp, sp, cp, B, H, W, D, rr, st)
                          : launch<true, false>(g, r, o, dp, sp, cp, B, H, W, D, rr, st));
  return (int)(g.staged ? launch<false, true>(g, r, o, dp, sp, cp, B, H, W, D, rr, st)
                        : launch<false, false>(g, r, o, dp, sp, cp, B, H, W, D, rr, st));
}

}  // extern "C"
