// K1: exact-rule edges + per-shift match + square box score + last-wins
// argmax, fused in one kernel, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused.py
// match_score_edges_pallas (body _kernel_from_brightness, _edges_exact_tile,
// _match_loop).  Brightness in, four int32 planes out: best score, winning
// shift (1..D), and both edge maps.
//
// What bounds it on the H100: not device memory.  Each output pixel reads
// two floats and writes four ints (24 B), but does D * (match + box sum +
// argmax) work: at 1024x1024, D = 64, sw = 21 the box sums alone are
// ~2 * sw * D adds per pixel when done naively.  The kernel is bound by
// shared-memory loads and integer issue inside the shift loop.
//
// Design:
//   * One block of 256 threads per (image, 32x32 output tile).  The block
//     stages k = rint(b * 256) (round half to even, as jnp.round) for the
//     tile and its halo in shared memory: rows +-(half+1), columns
//     -(half+1) .. +(half+1), and for the right image D-1 more columns for
//     the shift reads.  Ghost cells hold the 128.0 halo brightness
//     (k = 32768); wrap mode indexes modulo H and W.
//   * Both exact-rule edge tiles are computed once into shared memory
//     (uint8).  Ghost mode marks left cells outside the image with the
//     sentinel 2, which never equals an edge value, so they never match
//     (the zero-filled match halo); right cells outside the image are 0,
//     genuine matches against a left 0 (src/stereo-ghost.c:119-121).
//   * The shift loop keeps the box sum separable and incremental: a
//     column pass writes 21-row running sums of the match plane for the
//     (32 + 2*half)-wide window into shared memory (tasks of 8 rows, one
//     running sum each), then each thread slides a 21-wide row sum over
//     4 output pixels.  At sw = 21 that is ~23 shared-memory loads per
//     pixel and shift instead of sw^2 = 441 global reads (the reference
//     CUDA, src/stereo.cu:146).
//   * (best, winner) live in registers across all D shifts; the update is
//     score >= best -> winner = s + 1, so ties go to the last shift and
//     all-zero scores give winner = D.
//   * The edge predicate 2|ka-kb| > min(f32(t) * (ka+kb), 1536) multiplies
//     with __fmul_rn so it is one IEEE product, never contracted.
// None of the TPU structure is carried over (no lane rolls, no (8,128)
// padding, no int16 storage, no banded matmuls).
// Not ported yet: the optional parabola sub-pixel plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;        // output rows per block
constexpr int TW = 32;        // output columns per block
constexpr int NT = 256;       // threads per block
constexpr int RC = 8;         // rows per running column sum task
constexpr int PX = 4;         // output pixels per thread (along x)
constexpr int GHOST_K = 32768;  // round(128.0 * 256)
constexpr uint8_t LEFT_SENTINEL = 2;

static_assert(TH * (TW / PX) == NT, "one thread per (row, 4-pixel strip)");
static_assert(TH % RC == 0, "column tasks tile the rows");

struct Geometry {
  int half, sw;
  int rows_k, kw_l, kw_r;  // staged k tiles
  int rows_e, ew_l, ew_r;  // edge tiles
  int cs_stride;           // column-sum row stride (odd: no bank conflicts)
  int k_bytes, e_bytes;
};

__host__ __device__ inline Geometry geometry(int half, int num_shifts) {
  Geometry g;
  g.half = half;
  g.sw = 2 * half + 1;
  g.rows_e = TH + 2 * half;
  g.ew_l = TW + 2 * half;
  g.ew_r = g.ew_l + num_shifts - 1;
  g.rows_k = g.rows_e + 2;
  g.kw_l = g.ew_l + 2;
  g.kw_r = g.ew_r + 2;
  g.cs_stride = g.ew_l | 1;
  int k_bytes = g.rows_k * (g.kw_l + g.kw_r) * 4;
  int cs_bytes = TH * g.cs_stride * 4;  // aliases the k tiles once edges exist
  g.k_bytes = k_bytes > cs_bytes ? k_bytes : cs_bytes;
  g.e_bytes = g.rows_e * (g.ew_l + g.ew_r);
  return g;
}

__device__ __forceinline__ int wrap_index(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ bool decide(int ka, int kb, float thr) {
  float lhs = (float)(2 * abs(ka - kb));
  float rhs = fminf(__fmul_rn(thr, (float)(ka + kb)), 1536.0f);
  return lhs > rhs;
}

// Stage k = rint(b * 256) for rows [y0-half-1, ..) and columns
// [x0-half-1, .. + kw) of one image.
__device__ void stage_k(int* k, int kw, int rows, const float* img, int H,
                        int W, int y0, int x0, int half, bool ghost) {
  for (int i = threadIdx.x; i < rows * kw; i += NT) {
    int r = i / kw, c = i - r * kw;
    int gy = y0 - half - 1 + r, gx = x0 - half - 1 + c;
    int v;
    if (ghost) {
      bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      v = in ? __float2int_rn(img[(size_t)gy * W + gx] * 256.0f) : GHOST_K;
    } else {
      v = __float2int_rn(
          img[(size_t)wrap_index(gy, H) * W + wrap_index(gx, W)] * 256.0f);
    }
    k[i] = v;
  }
}

// Exact-rule edges of the staged k tile; edge cell (r, c) sits at global
// (y0 - half + r, x0 - half + c) and reads k cells (r..r+2, c..c+2).
__device__ void edge_tile(uint8_t* e, int ew, int rows, const int* k, int kw,
                          int H, int W, int y0, int x0, int half, bool ghost,
                          uint8_t outside, float thr) {
  for (int i = threadIdx.x; i < rows * ew; i += NT) {
    int r = i / ew, c = i - r * ew;
    int gy = y0 - half + r, gx = x0 - half + c;
    uint8_t v;
    if (ghost && (gy < 0 || gy >= H || gx < 0 || gx >= W)) {
      v = outside;
    } else {
      const int* p = k + (r + 1) * kw + (c + 1);  // center tap
      // The four operators of EDGE_OPERATORS (src/stereo.c:16-70), taps
      // as (dx, dy); integer sums, so the tap order does not matter.
#define K(dx, dy) p[(dy) * kw + (dx)]
      bool edge =
          decide(K(-1, -1) + K(-1, 0) + K(-1, 1),
                 K(1, -1) + K(1, 0) + K(1, 1), thr) ||  // left_right
          decide(K(-1, -1) + K(0, -1) + K(1, -1),
                 K(-1, 1) + K(0, 1) + K(1, 1), thr) ||  // top_bottom
          decide(K(-1, -1) + K(0, -1) + K(-1, 0),
                 K(1, 0) + K(0, 1) + K(1, 1), thr) ||  // upleft_downright
          decide(K(-1, 1) + K(0, 1) + K(-1, 0),
                 K(0, -1) + K(1, -1) + K(1, 0), thr);  // downleft_upright
#undef K
      v = edge ? 1 : 0;
    }
    e[i] = v;
  }
}

__global__ void __launch_bounds__(NT)
match_score_edges_kernel(const float* __restrict__ left,
                         const float* __restrict__ right,
                         int* __restrict__ best_out,
                         int* __restrict__ winner_out,
                         int* __restrict__ edges_l_out,
                         int* __restrict__ edges_r_out, int H, int W,
                         int half, int num_shifts, int ghost_mode, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g = geometry(half, num_shifts);
  const bool ghost = ghost_mode != 0;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  left += b * plane;
  right += b * plane;

  int* k_l = reinterpret_cast<int*>(smem);
  int* k_r = k_l + g.rows_k * g.kw_l;
  int* colsum = reinterpret_cast<int*>(smem);  // reuses the k tiles
  uint8_t* e_l = smem + g.k_bytes;
  uint8_t* e_r = e_l + g.rows_e * g.ew_l;

  stage_k(k_l, g.kw_l, g.rows_k, left, H, W, y0, x0, half, ghost);
  stage_k(k_r, g.kw_r, g.rows_k, right, H, W, y0, x0, half, ghost);
  __syncthreads();
  edge_tile(e_l, g.ew_l, g.rows_e, k_l, g.kw_l, H, W, y0, x0, half, ghost,
            LEFT_SENTINEL, thr);
  edge_tile(e_r, g.ew_r, g.rows_e, k_r, g.kw_r, H, W, y0, x0, half, ghost, 0,
            thr);
  __syncthreads();

  // This thread's pixels: row ty, columns tx0 .. tx0 + PX - 1 of the tile.
  const int ty = threadIdx.x / (TW / PX);
  const int tx0 = (threadIdx.x % (TW / PX)) * PX;
  int best[PX], winner[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) best[j] = winner[j] = 0;

  const int n_tasks = (TH / RC) * g.ew_l;
  for (int s = 0; s < num_shifts; ++s) {
    // Column pass: colsum[r][c] = sum_{i < sw} match(r + i, c).
    for (int t = threadIdx.x; t < n_tasks; t += NT) {
      int c = t % g.ew_l, r0 = (t / g.ew_l) * RC;
      const uint8_t* pl = e_l + c;
      const uint8_t* pr = e_r + c + s;
      int sum = 0;
      for (int i = 0; i < g.sw; ++i)
        sum += pl[(r0 + i) * g.ew_l] == pr[(r0 + i) * g.ew_r];
      colsum[r0 * g.cs_stride + c] = sum;
      for (int r = r0 + 1; r < r0 + RC; ++r) {
        int in = r + g.sw - 1, out = r - 1;
        sum += (pl[in * g.ew_l] == pr[in * g.ew_r]) -
               (pl[out * g.ew_l] == pr[out * g.ew_r]);
        colsum[r * g.cs_stride + c] = sum;
      }
    }
    __syncthreads();
    // Row pass + score + argmax for this thread's PX pixels.
    const int* cs = colsum + ty * g.cs_stride + tx0;
    int sum = 0;
    for (int i = 0; i < g.sw; ++i) sum += cs[i];
    const uint8_t* ml = e_l + (ty + half) * g.ew_l + tx0 + half;
    const uint8_t* mr = e_r + (ty + half) * g.ew_r + tx0 + half + s;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      if (j > 0) sum += cs[j + g.sw - 1] - cs[j - 1];
      int score = ml[j] == mr[j] ? sum : 0;
      if (score >= best[j]) {
        best[j] = score;
        winner[j] = s + 1;
      }
    }
    __syncthreads();  // colsum is rewritten by the next shift
  }

  const int y = y0 + ty;
  if (y < H) {
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      int x = x0 + tx0 + j;
      if (x < W) {
        size_t o = b * plane + (size_t)y * W + x;
        best_out[o] = best[j];
        winner_out[o] = winner[j];
        edges_l_out[o] = e_l[(ty + half) * g.ew_l + tx0 + j + half];
        edges_r_out[o] = e_r[(ty + half) * g.ew_r + tx0 + j + half];
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the caller refuses configurations
// above the sm_90 opt-in limit of 232448 bytes (cudaFuncSetAttribute below
// would refuse them too).
int match_score_edges_smem_bytes(int half, int num_shifts) {
  Geometry g = geometry(half, num_shifts);
  return g.k_bytes + g.e_bytes;
}

// left/right: float32 [B, H, W] brightness, contiguous, on the device.
// Outputs: int32 [B, H, W] best, winner, edges_l, edges_r.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int match_score_edges(const void* left, const void* right, void* best,
                      void* winner, void* edges_l, void* edges_r, int B,
                      int H, int W, int half, int num_shifts, int ghost,
                      float threshold, void* stream) {
  int smem = match_score_edges_smem_bytes(half, num_shifts);
  if (B < 1 || H < 1 || W < 1 || num_shifts < 1 || half < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      match_score_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  match_score_edges_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)right, (int*)best, (int*)winner,
      (int*)edges_l, (int*)edges_r, H, W, half, num_shifts, ghost, threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
