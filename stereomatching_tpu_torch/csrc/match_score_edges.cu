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
// pixel and shift as it can: the bit-row shift loop of match_loop.cuh,
// which K8 and K9 run too (bit rows, match words by funnel shift / XOR /
// AND, row sums by popcount, column running sums down each thread's
// strip, (best, winner) packed in one register, the sub-pixel carries).
//
// This file adds K1's own staging: one block of 512 threads per (image,
// 128-column output tile of 128 rows, or 64 with the sub-pixel carries)
// computes both exact-rule edge tiles once, straight from the brightness
// (k = rint(b * 256), round half to even as jnp.round; ghost cells hold
// the 128.0 halo brightness, k = 32768; wrap mode indexes modulo H and
// W), and stores them as bit rows (__ballot_sync of 32 neighbouring
// cells): a left bit row, a left validity row (ghost mode: cells outside
// the image never match) and a right bit row D - 1 columns wider; then,
// after the loop, both edge planes of its pixels.
//   * The edge predicate 2|ka-kb| > min(f32(t) * (ka+kb), 1536) multiplies
//     with __fmul_rn so it is one IEEE product, never contracted.
// None of the TPU structure is carried over (no lane rolls, no (8,128)
// padding, no int16 storage, no banded matmuls).

#include "match_loop.cuh"

namespace {

using namespace match_loop;

constexpr int GHOST_K = 32768;   // round(128.0 * 256)

__device__ __forceinline__ bool decide(int ka, int kb, float thr) {
  float lhs = (float)(2 * abs(ka - kb));
  float rhs = fminf(__fmul_rn(thr, (float)(ka + kb)), 1536.0f);
  return lhs > rhs;
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
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout g = layout(half, num_shifts, GROUPS * strip_rows<SUBPIXEL>());
  const Tiles t = tiles(smem, g);
  const bool ghost = ghost_mode != 0;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * g.th, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)b * H * W;
  left += plane;
  right += plane;

  stage_bits(t.lbits, t.vbits, g.lst, g.ew_l, g, left, H, W, y0, x0, ghost, thr);
  stage_bits(t.rbits, nullptr, g.rst, g.ew_r, g, right, H, W, y0, x0, ghost, thr);
  __syncthreads();

  // Beside best / winner (/ subpixel): both edge planes of each pixel.
  shift_loop<SUBPIXEL, NARROW>(
      t, g, num_shifts, H, W, y0, x0, plane, best_out, winner_out, sub_out,
      [&](size_t o, int row, int c) {
        edges_l_out[o] = (t.lbits[row * g.lst + (c >> 5)] >> (c & 31)) & 1u;
        edges_r_out[o] = (t.rbits[row * g.rst + (c >> 5)] >> (c & 31)) & 1u;
      });
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (the taller tile, without the
// sub-pixel plane; the sub-pixel variant needs less).  The caller refuses
// configurations above the sm_90 opt-in limit of 232448 bytes, square
// widths above 255 and more than 65535 shifts (the packed best / winner).
int match_score_edges_smem_bytes(int half, int num_shifts) {
  return smem_bytes(half, num_shifts);
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
