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
//     (uint8), ghost cells outside the image as match_loop.cuh sets out.
//   * The shift loop, shared with K8 (match_and_score.cu), is
//     match_loop::shift_loop: separable running box sums in shared memory
//     (~23 shared-memory loads per pixel and shift at sw = 21 instead of
//     sw^2 = 441 global reads, the reference CUDA's src/stereo.cu:146),
//     (best, winner) and the sub-pixel carries in registers.  The column
//     sums reuse the k tiles' shared memory once the edges exist.
//   * The edge predicate 2|ka-kb| > min(f32(t) * (ka+kb), 1536) multiplies
//     with __fmul_rn so it is one IEEE product, never contracted.
// None of the TPU structure is carried over (no lane rolls, no (8,128)
// padding, no int16 storage, no banded matmuls).

#include "match_loop.cuh"

namespace {

using namespace match_loop;

constexpr int GHOST_K = 32768;  // round(128.0 * 256)

struct Geometry {
  EdgeTiles t;
  int rows_k, kw_l, kw_r;  // staged k tiles
  int k_bytes;             // the k tiles, or the column sums if larger
};

__host__ __device__ inline Geometry geometry(int half, int num_shifts) {
  Geometry g;
  g.t = edge_tiles(half, num_shifts);
  g.rows_k = g.t.rows + 2;
  g.kw_l = g.t.ew_l + 2;
  g.kw_r = g.t.ew_r + 2;
  int k_bytes = g.rows_k * (g.kw_l + g.kw_r) * 4;
  g.k_bytes = k_bytes > g.t.cs_bytes ? k_bytes : g.t.cs_bytes;
  return g;
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

template <bool SUBPIXEL>
__global__ void __launch_bounds__(NT)
match_score_edges_kernel(const float* __restrict__ left,
                         const float* __restrict__ right,
                         int* __restrict__ best_out,
                         int* __restrict__ winner_out,
                         int* __restrict__ edges_l_out,
                         int* __restrict__ edges_r_out,
                         float* __restrict__ sub_out, int H, int W, int half,
                         int num_shifts, int ghost_mode, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g = geometry(half, num_shifts);
  const EdgeTiles& t = g.t;
  const bool ghost = ghost_mode != 0;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)b * H * W;
  left += plane;
  right += plane;

  int* k_l = reinterpret_cast<int*>(smem);
  int* k_r = k_l + g.rows_k * g.kw_l;
  int* colsum = reinterpret_cast<int*>(smem);  // reuses the k tiles
  uint8_t* e_l = smem + g.k_bytes;
  uint8_t* e_r = e_l + t.rows * t.ew_l;

  stage_k(k_l, g.kw_l, g.rows_k, left, H, W, y0, x0, half, ghost);
  stage_k(k_r, g.kw_r, g.rows_k, right, H, W, y0, x0, half, ghost);
  __syncthreads();
  edge_tile(e_l, t.ew_l, t.rows, k_l, g.kw_l, H, W, y0, x0, half, ghost,
            LEFT_SENTINEL, thr);
  edge_tile(e_r, t.ew_r, t.rows, k_r, g.kw_r, H, W, y0, x0, half, ghost, 0,
            thr);
  __syncthreads();

  shift_loop<SUBPIXEL>(e_l, e_r, colsum, t, num_shifts, H, W, y0, x0, plane,
                       best_out, winner_out, sub_out);

  // The edge tiles are untouched by the loop: write this thread's edges.
  const int ty = threadIdx.x / (TW / PX);
  const int tx0 = (threadIdx.x % (TW / PX)) * PX;
  const int y = y0 + ty;
  if (y < H) {
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      int x = x0 + tx0 + j;
      if (x < W) {
        size_t o = plane + (size_t)y * W + x;
        edges_l_out[o] = e_l[(ty + half) * t.ew_l + tx0 + j + half];
        edges_r_out[o] = e_r[(ty + half) * t.ew_r + tx0 + j + half];
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
  return g.k_bytes + g.t.e_bytes;
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
  int smem = match_score_edges_smem_bytes(half, num_shifts);
  if (B < 1 || H < 1 || W < 1 || num_shifts < 1 || half < 0)
    return (int)cudaErrorInvalidValue;
  const bool sub = subpixel != nullptr;
  auto kernel = sub ? match_score_edges_kernel<true>
                    : match_score_edges_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)right, (int*)best, (int*)winner,
      (int*)edges_l, (int*)edges_r, (float*)subpixel, H, W, half, num_shifts,
      ghost, threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
