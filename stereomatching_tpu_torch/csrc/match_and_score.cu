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
// 166-216): ghost mode marks left cells outside the image with the
// sentinel 2 (never matches) and right cells past the image with 0
// (matches a left 0); wrap mode indexes rows and columns modulo H and W,
// for any D, also D > W.
//
// What bounds it on the H100: integer issue and shared-memory loads in the
// shift loop, as for K1 (16 B of device memory per pixel against
// ~10 * D integer operations).
//
// Design: K1's kernel without the brightness and edge stages.  One block
// of 256 threads per (image, 32x32 output tile) stages both edge maps'
// tiles with their halos as uint8 in shared memory -- a cell is an edge
// (1) where its int32 value is non-zero, as the wrapper's plain route
// reads it -- and runs match_loop::shift_loop
// (match_loop.cuh), the loop K1 runs: running column sums of 8-row tasks,
// a sliding row sum over 4 pixels per thread, (best, winner) and the
// sub-pixel carries in registers.  The column sums take their own shared
// memory here (no k tiles to reuse).
//
// K9 (match_and_score_prehalo) replaces the Pallas entry
// stereomatching_tpu/ops/fused.py:757 match_and_score_pallas_prehalo, the
// per-shard kernel of the sharded classic tier (stereomatching_tpu/
// parallel/pipeline.py:152-165).  Its inputs are halo blocks: the left
// edge map [B, hs + 2*halo, W] and the right one [B, hs + 2*halo, WR]
// (WR >= W + D: the right map's x extension), their `halo` >= half rows
// on each side exchanged from the neighbouring shards.  Only the staging
// differs from K8's: rows are the block's own (no y wrap, no y fill; a
// tile row past the block is never read by a kept output); columns wrap
// modulo W for both maps in wrap mode (the JAX entry ignores the right
// map's extension there, fused.py:810-816), else a left column outside
// [0, W) is the sentinel and a right one outside [0, WR) is 0
// (fused.py:817-824).  In ghost mode a left cell outside the GLOBAL image
// is the sentinel too: each image carries its block's global first row
// and column (row0, col0), and the global H and W are given, so the mask
// is staged here rather than written into the map by the caller (K8's
// staging maps every non-zero value to an edge).

#include "match_loop.cuh"

namespace {

using namespace match_loop;

// Stage edge map `edges` (one image) as the uint8 tile e (rows x ew):
// cell (r, c) is image (y0 - half + r, x0 - half + c), 1 where the edge
// map is non-zero, else 0; `outside` where ghost mode leaves the image.
__device__ void stage_edges(uint8_t* e, int ew, int rows,
                            const int* __restrict__ edges, int H, int W,
                            int y0, int x0, int half, bool ghost,
                            uint8_t outside) {
  for (int i = threadIdx.x; i < rows * ew; i += NT) {
    int r = i / ew, c = i - r * ew;
    int gy = y0 - half + r, gx = x0 - half + c;
    uint8_t v;
    if (ghost) {
      bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      v = in ? (uint8_t)(edges[(size_t)gy * W + gx] != 0) : outside;
    } else {
      v = (uint8_t)(edges[(size_t)wrap_index(gy, H) * W + wrap_index(gx, W)] != 0);
    }
    e[i] = v;
  }
}

// K9's staging of one halo block `m` ([rows_in, mw]) as the uint8 tile e
// (rows x ew): cell (r, c) is block row y0 - half + r + halo and column
// x0 - half + c.  `outside` where a column leaves [0, mw) (not wrapping),
// and with `mask`, where the cell leaves the global image.
__device__ void stage_block(uint8_t* e, int ew, int rows, const int* __restrict__ m,
                            int rows_in, int mw, int W, int y0, int x0, int half,
                            int halo, bool wrap, bool mask, int row0, int Hg,
                            int col0, int Wg, uint8_t outside) {
  for (int i = threadIdx.x; i < rows * ew; i += NT) {
    int r = i / ew, c = i - r * ew;
    int by = y0 - half + r + halo, bx = x0 - half + c;
    uint8_t v = 0;  // rows past the block only reach dropped outputs
    if (by < rows_in) {
      if (wrap) {
        v = (uint8_t)(m[(size_t)by * mw + wrap_index(bx, W)] != 0);
      } else if (bx < 0 || bx >= mw) {
        v = outside;
      } else {
        v = (uint8_t)(m[(size_t)by * mw + bx] != 0);
      }
      if (mask) {
        int gy = row0 + by, gx = col0 + bx;
        if (gy < 0 || gy >= Hg || gx < 0 || gx >= Wg) v = LEFT_SENTINEL;
      }
    }
    e[i] = v;
  }
}

__global__ void __launch_bounds__(NT)
match_and_score_prehalo_kernel(const int* __restrict__ l_blk,
                               const int* __restrict__ r_blk,
                               int* __restrict__ best_out,
                               int* __restrict__ winner_out, int rows_in,
                               int W, int WR, int halo, int half, int num_shifts,
                               int wrap, int ghost, const int* __restrict__ row0,
                               int Hg, const int* __restrict__ col0, int Wg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const EdgeTiles t = edge_tiles(half, num_shifts);
  const int hs = rows_in - 2 * halo;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int b = blockIdx.z;

  int* colsum = reinterpret_cast<int*>(smem);
  uint8_t* e_l = smem + t.cs_bytes;
  uint8_t* e_r = e_l + t.rows * t.ew_l;
  stage_block(e_l, t.ew_l, t.rows, l_blk + (size_t)b * rows_in * W, rows_in, W,
              W, y0, x0, half, halo, wrap != 0, ghost != 0, row0[b], Hg,
              col0[b], Wg, LEFT_SENTINEL);
  stage_block(e_r, t.ew_r, t.rows, r_blk + (size_t)b * rows_in * WR, rows_in,
              WR, W, y0, x0, half, halo, wrap != 0, false, 0, 0, 0, 0, 0);
  __syncthreads();
  shift_loop<false>(e_l, e_r, colsum, t, num_shifts, hs, W, y0, x0,
                    (size_t)b * hs * W, best_out, winner_out, nullptr);
}

template <bool SUBPIXEL>
__global__ void __launch_bounds__(NT)
match_and_score_kernel(const int* __restrict__ edges_l,
                       const int* __restrict__ edges_r,
                       int* __restrict__ best_out,
                       int* __restrict__ winner_out,
                       float* __restrict__ sub_out, int H, int W, int half,
                       int num_shifts, int ghost_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const EdgeTiles t = edge_tiles(half, num_shifts);
  const bool ghost = ghost_mode != 0;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)blockIdx.z * H * W;

  int* colsum = reinterpret_cast<int*>(smem);
  uint8_t* e_l = smem + t.cs_bytes;
  uint8_t* e_r = e_l + t.rows * t.ew_l;
  stage_edges(e_l, t.ew_l, t.rows, edges_l + plane, H, W, y0, x0, half,
              ghost, LEFT_SENTINEL);
  stage_edges(e_r, t.ew_r, t.rows, edges_r + plane, H, W, y0, x0, half,
              ghost, 0);
  __syncthreads();
  shift_loop<SUBPIXEL>(e_l, e_r, colsum, t, num_shifts, H, W, y0, x0, plane,
                       best_out, winner_out, sub_out);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the caller refuses configurations
// above the sm_90 opt-in limit of 232448 bytes.
int match_and_score_smem_bytes(int half, int num_shifts) {
  EdgeTiles t = edge_tiles(half, num_shifts);
  return t.cs_bytes + t.e_bytes;
}

// edges_l/edges_r: int32 [B, H, W] edge maps (non-zero = edge),
// contiguous, on the device.  Outputs: int32 [B, H, W] best and winner, and float32
// [B, H, W] subpixel unless `subpixel` is NULL.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int match_and_score(const void* edges_l, const void* edges_r, void* best,
                    void* winner, void* subpixel, int B, int H, int W,
                    int half, int num_shifts, int ghost, void* stream) {
  int smem = match_and_score_smem_bytes(half, num_shifts);
  if (B < 1 || H < 1 || W < 1 || num_shifts < 1 || half < 0)
    return (int)cudaErrorInvalidValue;
  const bool sub = subpixel != nullptr;
  auto kernel = sub ? match_and_score_kernel<true>
                    : match_and_score_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
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
  int smem = match_and_score_smem_bytes(half, num_shifts);
  const int hs = rows_in - 2 * halo;
  if (B < 1 || hs < 1 || W < 1 || num_shifts < 1 || half < 0 || halo < half ||
      WR < W)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      match_and_score_prehalo_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (hs + TH - 1) / TH, B);
  match_and_score_prehalo_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const int*)l_blk, (const int*)r_blk, (int*)best, (int*)winner, rows_in,
      W, WR, halo, half, num_shifts, wrap, ghost, (const int*)row0, Hg,
      (const int*)col0, Wg);
  return (int)cudaGetLastError();
}

}  // extern "C"
