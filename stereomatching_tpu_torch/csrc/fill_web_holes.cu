// K2: the web hole-filling diffusion + per-image min/max, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_diffusion.py
// fill_web_holes_pallas(with_range=True) (bodies _kernel_range, _kernel).
// Semantics (ops/diffusion.py, reference src/stereo.c:230-251): with
// X[-1] = X[0] = web,
//     X[t+1][p] = X[t][p] == 0 ? floor((X[p+1] + X[p+W] + X[p-1] + X[p-W]) / 4)
//                              : X[t-1][p]
// for times-1 steps, p a flat index of its own image (x neighbours cross
// rows), reads outside [0, H*W) of the image are 0; then each image's min
// and max of X[times-1].
//
// What bounds it on the H100: device memory.  Each step is one elementwise
// pass that reads X[t] (neighbours mostly from L1/L2), reads X[t-1] and
// writes X[t+1]: ~12 B per pixel per step, against 1 integer add chain.
//
// Design (simple and right first): one launch per Jacobi step over the
// whole batch, on three rotating int32 buffers in device memory; the
// rotation is chosen so the last step lands in the output buffer and the
// input is never written.  Then one reduction launch: a block reduce per
// image chunk with warp shuffles, then atomicMin / atomicMax into per-image
// slots that the caller filled with INT_MAX / INT_MIN; integer atomics are
// order-independent, so the result is deterministic.  For times <= 1 the
// input is copied and reduced.
//
// The sharded tier (stereomatching_tpu/parallel/pipeline.py:204-259) runs
// one step per halo exchange: fill_web_holes_step is diffuse_step on a
// block whose 1-row (and, 2-D, 1-column) halo was exchanged, writing only
// the interior.  With a row stride of the block's width, the flat p +- 1
// and p +- stride of an interior cell are its four neighbours as the
// reference reads them: on a rows-only block, (y, 0)'s p - 1 is
// (y - 1, W - 1), inside the block; on a 2-D block the halo columns
// arrive row-shifted at the global x edge (the flat wrap), so they are
// exactly the cells the flat index reads.
//
// The TPU kernel fuses all steps in one VMEM tile with a `steps`-row halo.
// A full-width 1024-column tile with a 31-row halo does not fit in 227 KB
// of shared memory (2 buffers x 62 rows x 4 KB is ~500 KB), so fusing the
// steps on Hopper needs narrower tiles with a column halo too, or thread
// block clusters: later work.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

// One cell's step: X[t] of an image whose rows are `stride` apart, the
// cell at p, in[k] whether neighbour k (p + 1, p + stride, p - 1,
// p - stride) is read (one that is not adds 0), *prev its X[t-1].
__device__ __forceinline__ int diffuse_cell(const int* __restrict__ cur, int p,
                                            int stride, const bool in[4],
                                            const int* prev) {
  if (cur[p] != 0) return *prev;
  const int sum = (in[0] ? cur[p + 1] : 0) + (in[1] ? cur[p + stride] : 0) +
                  (in[2] ? cur[p - 1] : 0) + (in[3] ? cur[p - stride] : 0);
  return sum >> 2;  // arithmetic shift: floor division by 4
}

__global__ void __launch_bounds__(NT)
diffuse_step(const int* __restrict__ prev, const int* __restrict__ cur,
             int* __restrict__ next, long long total, int hw, int w) {
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const int p = (int)(i % hw);
    // Flat neighbours of the cell's own image.
    const bool in[4] = {p + 1 < hw, p + w < hw, p >= 1, p >= w};
    next[i] = diffuse_cell(cur + (i - p), p, w, in, prev + i);
  }
}

// One step on halo blocks: cur_ext [B, hs + 2, we] (interior columns
// x_off .. x_off + ws - 1), prev and next [B, hs, ws].  Every flat
// neighbour of an interior cell lies inside its block.
__global__ void __launch_bounds__(NT)
diffuse_step_block(const int* __restrict__ prev, const int* __restrict__ cur_ext,
                   int* __restrict__ next, long long total, int hs, int ws,
                   int we, int x_off) {
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const int x = (int)(i % ws);
    const long long r = i / ws;  // image * hs + y
    const int y = (int)(r % hs);
    const bool in[4] = {true, true, true, true};
    next[i] = diffuse_cell(cur_ext + (r / hs) * (long long)(hs + 2) * we,
                           (y + 1) * we + x + x_off, we, in, prev + i);
  }
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid = (chunks, B): block (c, b) reduces a strided share of image b.
__global__ void __launch_bounds__(NT)
image_range(const int* __restrict__ x, int hw, int* __restrict__ mn,
            int* __restrict__ mx) {
  const int* img = x + (size_t)blockIdx.y * hw;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = blockIdx.x * NT + threadIdx.x; i < hw; i += gridDim.x * NT) {
    int v = img[i];
    lo = min(lo, v);
    hi = max(hi, v);
  }
  __shared__ int s_lo[NT / 32], s_hi[NT / 32];
  lo = warp_min(lo);
  hi = warp_max(hi);
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < NT / 32 ? s_lo[lane] : INT_MAX;
    hi = lane < NT / 32 ? s_hi[lane] : INT_MIN;
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      atomicMin(mn + blockIdx.y, lo);
      atomicMax(mx + blockIdx.y, hi);
    }
  }
}

int blocks_for(long long n, int cap) {
  long long b = (n + NT - 1) / NT;
  return (int)(b < cap ? (b < 1 ? 1 : b) : cap);
}

}  // namespace

extern "C" {

// web: int32 [B, H, W] (read only).  out: int32 [B, H, W] receives
// X[times-1]; scratch0/scratch1: int32 [B, H, W] each, used when
// times >= 3.  mn/mx: int32 [B], filled
// by the caller with INT_MAX / INT_MIN.  Returns cudaGetLastError().
int fill_web_holes_range(const void* web, void* out, void* scratch0,
                         void* scratch1, void* mn, void* mx, int B, int H,
                         int W, int times, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hw = H * W;
  const long long total = (long long)B * hw;
  const int steps = times > 1 ? times - 1 : 0;
  int* bufs[3] = {(int*)out, (int*)scratch0, (int*)scratch1};
  if (steps == 0) {
    cudaError_t err = cudaMemcpyAsync(out, web, total * sizeof(int),
                                      cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  // X[t] goes to bufs[(t - steps) mod 3]: X[steps] lands in `out`, and the
  // buffer written at step t never holds X[t-1] or X[t-2].
  const int* prev = (const int*)web;
  const int* cur = (const int*)web;
  const int grid = blocks_for(total, 132 * 16);
  for (int t = 1; t <= steps; ++t) {
    int* next = bufs[((t - steps) % 3 + 3) % 3];
    diffuse_step<<<grid, NT, 0, st>>>(prev, cur, next, total, hw, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    prev = cur;
    cur = next;
  }
  dim3 rgrid(blocks_for(hw, 64), B);
  image_range<<<rgrid, NT, 0, st>>>((const int*)out, hw, (int*)mn, (int*)mx);
  return (int)cudaGetLastError();
}

// One Jacobi step of the sharded tier.  prev: int32 [B, hs, ws];
// cur_ext: int32 [B, hs + 2, we] with the interior at columns x_off ..
// x_off + ws - 1 (we = ws, x_off = 0 on a rows-only block; we = ws + 2,
// x_off = 1 on a 2-D one); next: int32 [B, hs, ws].  Returns
// cudaGetLastError().
int fill_web_holes_step(const void* prev, const void* cur_ext, void* next,
                        int B, int hs, int ws, int we, int x_off, void* stream) {
  if (B < 1 || hs < 1 || ws < 1 || we < ws + 2 * x_off)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * hs * ws;
  diffuse_step_block<<<blocks_for(total, 132 * 16), NT, 0, (cudaStream_t)stream>>>(
      (const int*)prev, (const int*)cur_ext, (int*)next, total, hs, ws, we, x_off);
  return (int)cudaGetLastError();
}

}  // extern "C"
