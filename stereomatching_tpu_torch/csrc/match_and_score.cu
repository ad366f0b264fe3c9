// K8: per-shift match + square box score + last-wins argmax (+ the optional
// parabola sub-pixel plane) from two given edge maps, for sm_90a; and K9,
// the same on row shards whose halo rows were already exchanged.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused.py
// match_and_score_pallas (bodies _kernel, _invoke_kernel, _match_loop,
// _parabola_refine), the route of the "reference" edge rule, whose float
// edges are computed outside the kernel.  Two int32 edge maps [B, H, W]
// in; int32 best score and winning shift (1..D) out, and with the
// sub-pixel plane a float32 third.  Semantics of _prepare (fused.py:
// 166-216): in ghost mode left cells outside the image never match and
// right cells outside it are 0 (they match a left 0); wrap mode indexes
// rows and columns modulo H and W, for any D, also D > W.
//
// What bounds it on the H100: integer issue and shared-memory loads in the
// shift loop, as for K1 (16 B of device memory per pixel against
// ~10 * D integer operations).
//
// Design: K1's kernel with the edge maps staged instead of computed.  One
// block of 512 threads per (image, 128-column output tile of 128 rows, or
// 64 with the sub-pixel carries) stages both maps' tiles with their halos
// as bit rows in K1's layout -- one warp per 32 cells of a tile row reads
// 128 coalesced bytes, and __ballot_sync of value != 0 makes the word (a
// cell is an edge where its int32 value is non-zero, as the wrapper's
// plain route reads it): a left bit row, a left validity row (0 where a
// cell never matches) and a right bit row D - 1 columns wider.  A warp
// issues the loads of STAGE_BATCH words before their ballots, so that
// several loads are in flight.  Then it runs match_loop::shift_loop
// (match_loop.cuh), the loop K1 runs: match words by funnel shift / XOR /
// AND, row sums by popcount, column running sums down each thread's
// strip, (best, winner) packed in one register, the sub-pixel carries.
//
// K9 (match_and_score_prehalo) replaces the Pallas entry
// stereomatching_tpu/ops/fused.py:757 match_and_score_pallas_prehalo, the
// per-shard kernel of the sharded classic tier (stereomatching_tpu/
// parallel/pipeline.py:152-165).  Its inputs are halo blocks: the left
// edge map [B, hs + 2*halo, W] and the right one [B, hs + 2*halo, WR]
// (WR >= W + D: the right map's x extension), their `halo` >= half rows
// on each side exchanged from the neighbouring shards.  Only the staging
// differs from K8's: rows are the block's own (no y wrap, no y fill; a
// tile row past the block is never read by a kept output, and is staged
// as 0); columns wrap modulo W for both maps in wrap mode (the JAX entry
// ignores the right map's extension there, fused.py:810-816), else a left
// column outside [0, W) never matches and a right one outside [0, WR) is
// 0 (fused.py:817-824).  In ghost mode a left cell outside the GLOBAL
// image never matches either: each image carries its block's global first
// row and column (row0, col0), and the global H and W are given, so the
// mask is the validity row.  Output rows are the shard's hs; rows of the
// last tile past hs are computed and not stored.

#include "match_loop.cuh"

namespace {

using namespace match_loop;

constexpr int STAGE_BATCH = 4;  // words a warp stages per round

// Where a tile cell reads its edge value: `p` (nullptr: the cell is 0)
// and whether it can match (`valid`; read for the left map only).
struct Cell {
  const int* p;
  bool valid;
};

// Stage one map as bit rows of `stride` words: word w of row r holds tile
// columns 32w .. 32w + 31; cell(r, c) says where cell (r, c) reads;
// columns at or past `cols` are 0.  With `valid`, also the validity rows.
template <class CellAt>
__device__ void stage(uint32_t* bits, uint32_t* valid, int stride, int cols,
                      int rows, CellAt cell) {
  const int lane = threadIdx.x & 31;
  const int n = rows * stride;
  for (int base = threadIdx.x >> 5; base < n; base += STAGE_BATCH * NWARPS) {
    int v[STAGE_BATCH];
    bool in[STAGE_BATCH];
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; ++k) {
      const int item = base + k * NWARPS;
      const int r = item / stride, c = 32 * (item - r * stride) + lane;
      Cell x = {nullptr, false};
      if (item < n && c < cols) x = cell(r, c);
      in[k] = x.valid;
      v[k] = x.p != nullptr ? __ldg(x.p) : 0;
    }
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; ++k) {
      const int item = base + k * NWARPS;  // the same for the whole warp
      if (item < n) {
        const uint32_t eb = __ballot_sync(0xffffffffu, v[k] != 0);
        const uint32_t vb = __ballot_sync(0xffffffffu, in[k]);
        if (lane == 0) {
          bits[item] = eb;
          if (valid != nullptr) valid[item] = vb;
        }
      }
    }
  }
}

// K8 and K9 store nothing beside best / winner (/ subpixel).
struct NoExtra {
  __device__ void operator()(size_t, int, int) const {}
};

template <bool SUBPIXEL, bool NARROW>
__global__ void __launch_bounds__(NT)
match_and_score_kernel(const int* __restrict__ edges_l,
                       const int* __restrict__ edges_r,
                       int* __restrict__ best_out,
                       int* __restrict__ winner_out,
                       float* __restrict__ sub_out, int H, int W, int half,
                       int num_shifts, int ghost_mode) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout g = layout(half, num_shifts, GROUPS * strip_rows<SUBPIXEL>());
  const Tiles t = tiles(smem, g);
  const bool ghost = ghost_mode != 0;
  const int y0 = blockIdx.y * g.th, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)blockIdx.z * H * W;

  // Ghost mode: cells outside the image are 0, and left ones never match;
  // wrap mode: rows and columns modulo H and W.
  auto map_cell = [=](const int* m) {
    return [=](int r, int c) -> Cell {
      int gy = y0 - half + r, gx = x0 - half + c;
      if (ghost) {
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) return {nullptr, false};
      } else {
        gy = wrap_fast(gy, H);
        gx = wrap_fast(gx, W);
      }
      return {m + plane + (size_t)gy * W + gx, true};
    };
  };
  stage(t.lbits, t.vbits, g.lst, g.ew_l, g.rows, map_cell(edges_l));
  stage(t.rbits, nullptr, g.rst, g.ew_r, g.rows, map_cell(edges_r));
  __syncthreads();
  shift_loop<SUBPIXEL, NARROW>(t, g, num_shifts, H, W, y0, x0, plane,
                               best_out, winner_out, sub_out, NoExtra());
}

template <bool NARROW>
__global__ void __launch_bounds__(NT)
match_and_score_prehalo_kernel(const int* __restrict__ l_blk,
                               const int* __restrict__ r_blk,
                               int* __restrict__ best_out,
                               int* __restrict__ winner_out, int rows_in,
                               int W, int WR, int halo, int half, int num_shifts,
                               int wrap, int ghost, const int* __restrict__ row0,
                               int Hg, const int* __restrict__ col0, int Wg) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout g = layout(half, num_shifts, GROUPS * strip_rows<false>());
  const Tiles t = tiles(smem, g);
  const int hs = rows_in - 2 * halo;
  const int y0 = blockIdx.y * g.th, x0 = blockIdx.x * TW;
  const int b = blockIdx.z;
  const int gy0 = row0[b], gx0 = col0[b];

  // Tile cell (r, c) is block row y0 - half + r + halo, column
  // x0 - half + c.  Rows past the block are 0 (they reach only dropped
  // outputs).  Wrap mode: columns modulo W; else columns outside [0, mw)
  // are 0 and never match.  `mask` (the left map in ghost mode): cells
  // outside the global Hg x Wg image never match.
  auto block_cell = [=](const int* m, int mw, bool mask) {
    return [=](int r, int c) -> Cell {
      const int by = y0 - half + r + halo, bx = x0 - half + c;
      if (by >= rows_in) return {nullptr, false};
      if (mask) {
        const int gy = gy0 + by, gx = gx0 + bx;
        if (gy < 0 || gy >= Hg || gx < 0 || gx >= Wg) return {nullptr, false};
      }
      int x = bx;
      if (wrap) {
        x = wrap_fast(bx, W);
      } else if (bx < 0 || bx >= mw) {
        return {nullptr, false};
      }
      return {m + ((size_t)b * rows_in + by) * mw + x, true};
    };
  };
  stage(t.lbits, t.vbits, g.lst, g.ew_l, g.rows, block_cell(l_blk, W, ghost != 0));
  stage(t.rbits, nullptr, g.rst, g.ew_r, g.rows, block_cell(r_blk, WR, false));
  __syncthreads();
  shift_loop<false, NARROW>(t, g, num_shifts, hs, W, y0, x0, (size_t)b * hs * W,
                            best_out, winner_out, nullptr, NoExtra());
}

bool valid_shape(int half, int num_shifts) {
  return num_shifts >= 1 && num_shifts <= 65535 && half >= 0 && half <= 127;
}

}  // namespace

extern "C" {

// edges_l/edges_r: int32 [B, H, W] edge maps (non-zero = edge),
// contiguous, on the device.  Outputs: int32 [B, H, W] best and winner, and float32
// [B, H, W] subpixel unless `subpixel` is NULL.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int match_and_score(const void* edges_l, const void* edges_r, void* best,
                    void* winner, void* subpixel, int B, int H, int W,
                    int half, int num_shifts, int ghost, void* stream) {
  if (B < 1 || H < 1 || W < 1 || !valid_shape(half, num_shifts))
    return (int)cudaErrorInvalidValue;
  const bool sub = subpixel != nullptr, narrow = half <= 15;
  auto kernel = sub ? (narrow ? match_and_score_kernel<true, true>
                              : match_and_score_kernel<true, false>)
                    : (narrow ? match_and_score_kernel<false, true>
                              : match_and_score_kernel<false, false>);
  const int th = GROUPS * (sub ? strip_rows<true>() : strip_rows<false>());
  const int smem = 4 * layout(half, num_shifts, th).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + th - 1) / th, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const int*)edges_l, (const int*)edges_r, (int*)best, (int*)winner,
      (float*)subpixel, H, W, half, num_shifts, ghost);
  return (int)cudaGetLastError();
}

// K9.  l_blk: int32 [B, hs + 2*halo, W], r_blk: int32 [B, hs + 2*halo,
// WR] halo blocks (non-zero = edge), contiguous, on the device; halo >=
// half.  wrap: columns modulo W; else ghost-style columns.  ghost: mask
// left cells outside the global H x W image, block row 0 / column 0 of
// image b being global row row0[b] / column col0[b] (int32 [B] on the
// device).  Outputs: int32 [B, hs, W] best and winner.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int match_and_score_prehalo(const void* l_blk, const void* r_blk, void* best,
                            void* winner, int B, int rows_in, int W, int WR,
                            int halo, int half, int num_shifts, int wrap,
                            int ghost, const void* row0, int Hg,
                            const void* col0, int Wg, void* stream) {
  const int hs = rows_in - 2 * halo;
  if (B < 1 || hs < 1 || W < 1 || !valid_shape(half, num_shifts) || halo < half ||
      WR < W)
    return (int)cudaErrorInvalidValue;
  auto kernel = half <= 15 ? match_and_score_prehalo_kernel<true>
                           : match_and_score_prehalo_kernel<false>;
  const int smem = smem_bytes(half, num_shifts);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int th = GROUPS * strip_rows<false>();
  dim3 grid((W + TW - 1) / TW, (hs + th - 1) / th, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const int*)l_blk, (const int*)r_blk, (int*)best, (int*)winner, rows_in,
      W, WR, halo, half, num_shifts, wrap, ghost, (const int*)row0, Hg,
      (const int*)col0, Wg);
  return (int)cudaGetLastError();
}

}  // extern "C"
