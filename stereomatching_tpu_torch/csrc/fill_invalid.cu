// K6: the validity-aware hole fill of the modern pipeline, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_diffusion.py:286
// fill_invalid_pallas (body _fill_invalid_kernel, :208).  Semantics
// (ops/costvolume.py fill_invalid): `iterations` Jacobi sweeps over the
// float32 disparity d and validity v of each [H, W] image,
//     num = ((dv[x+1] + dv[x-1]) + dv[y+1]) + dv[y-1],   dv = d * v
//     den = ((v[x+1] + v[x-1]) + v[y+1]) + v[y-1]
//     if v == 0 and den > 0:  d = num / max(den, 1),  v = 1
// with every neighbour outside the image 0 (zero padding).  The adds, the
// multiply and the divide are __fadd_rn / __fmul_rn / __fdiv_rn in that
// order, so the result is bitwise equal to the JAX package's.
//
// What bounds it on the H100: device memory.  A sweep reads d (4 B) and
// v (1 B) of each pixel (neighbours from L1/L2) and writes both, ~10 B
// per pixel against ~12 float ops.
//
// The sharded tier (stereomatching_tpu/parallel/modern.py:340-395) runs
// one sweep per halo exchange: fill_invalid_step sweeps a block whose
// 1-row (and, 2-D, 1-column) halo of d and v was exchanged (zeros past
// the global edge), writing only the interior.  A rows-only block's x
// neighbours stop at its columns (zero padding); a 2-D block's come from
// its halo columns.  The sum order is the same.
//
// Design (simple and right first): one elementwise launch per sweep over
// ping-pong buffers, d in float32 and v as bytes (the caller's bool
// plane, never written); the d rotation is chosen so that the last sweep
// lands in the output.  The TPU kernel keeps all sweeps in one VMEM tile
// with an `iterations`-row halo; a fused version here (a 32x32 tile with
// 16-pixel halos in shared memory) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

// One sweep.  BLOCK false: whole [B, h, w] images, cell i at p = i, a
// neighbour outside the image not read (we = w, x_off unused).  BLOCK
// true: the interior [B, h, w] of halo blocks [B, h + 2, we] whose
// interior columns are x_off .. x_off + w - 1; the y neighbours are halo
// rows, and on a rows-only block (x_off 0) an x neighbour past the
// block's columns is not read.  Both share the per-cell rule below.
template <bool BLOCK>
__global__ void __launch_bounds__(NT)
fill_step(const float* __restrict__ d_in, const uint8_t* __restrict__ v_in,
          float* __restrict__ d_out, uint8_t* __restrict__ v_out,
          long long total, int h, int w, int we, int x_off) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    long long p = i;
    int x = 0, y = 0;
    if constexpr (BLOCK) {
      x = (int)(i % w);
      const long long r = i / w;
      y = (int)(r % h);
      p = (r / h) * (long long)(h + 2) * we + (long long)(y + 1) * we + x + x_off;
    }
    const uint8_t v = v_in[p];
    const float d = d_in[p];
    if (v != 0) {
      d_out[i] = d;
      v_out[i] = v;
      continue;
    }
    if constexpr (!BLOCK) {
      x = (int)(i % w);
      y = (int)((i / w) % h);
    }
    // right, left, down, up; a neighbour not read adds +0.0.
    const int stride = BLOCK ? we : w;
    const long long nb[4] = {p + 1, p - 1, p + stride, p - stride};
    const bool open_x = BLOCK && x_off > 0;
    const bool in[4] = {open_x || x + 1 < w, open_x || x > 0, BLOCK || y + 1 < h,
                        BLOCK || y > 0};
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float dv = 0.0f, vf = 0.0f;
      if (in[k]) {
        vf = (float)v_in[nb[k]];
        dv = __fmul_rn(d_in[nb[k]], vf);
      }
      // k == 0 starts the sum: right + left, then + down, then + up.
      num = k == 0 ? dv : __fadd_rn(num, dv);
      den = k == 0 ? vf : __fadd_rn(den, vf);
    }
    if (den > 0.0f) {
      d_out[i] = __fdiv_rn(num, fmaxf(den, 1.0f));
      v_out[i] = 1;
    } else {
      d_out[i] = d;
      v_out[i] = 0;
    }
  }
}

}  // namespace

extern "C" {

// One sweep of the sharded tier.  d_ext: float32 and v_ext: uint8 (0 / 1)
// [B, hs + 2, we] halo blocks with the interior at columns x_off .. x_off +
// ws - 1 (rows-only: we = ws, x_off = 0; 2-D: we = ws + 2, x_off = 1);
// d_out / v_out: [B, hs, ws].  Returns cudaGetLastError().
int fill_invalid_step(const void* d_ext, const void* v_ext, void* d_out,
                      void* v_out, int B, int hs, int ws, int we, int x_off,
                      void* stream) {
  if (B < 1 || hs < 1 || ws < 1 || we < ws + 2 * x_off)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * hs * ws;
  long long blocks = (total + NT - 1) / NT;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  fill_step<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)d_ext, (const uint8_t*)v_ext, (float*)d_out,
      (uint8_t*)v_out, total, hs, ws, we, x_off);
  return (int)cudaGetLastError();
}

// disp: float32 [B, H, W], valid: uint8 [B, H, W] (0 / 1), both read only.
// out: float32 [B, H, W] receives d after `iterations` >= 1 sweeps.
// d_tmp: float32 [B, H, W], v_tmp1: uint8 [B, H, W], used when
// iterations >= 2; v_tmp0: uint8 [B, H, W].  One launch per sweep on
// `stream`; returns cudaGetLastError().
int fill_invalid(const void* disp, const void* valid, void* out, void* d_tmp,
                 void* v_tmp0, void* v_tmp1, int B, int H, int W,
                 int iterations, void* stream) {
  if (B < 1 || H < 1 || W < 1 || iterations < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)B * H * W;
  long long blocks = (total + NT - 1) / NT;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  float* dbuf[2] = {(float*)out, (float*)d_tmp};
  uint8_t* vbuf[2] = {(uint8_t*)v_tmp0, (uint8_t*)v_tmp1};
  const float* d_prev = (const float*)disp;
  const uint8_t* v_prev = (const uint8_t*)valid;
  for (int t = 1; t <= iterations; ++t) {
    // Sweep t writes dbuf[(iterations - t) % 2]: the last one `out`.
    float* d_next = dbuf[(iterations - t) & 1];
    uint8_t* v_next = vbuf[(t - 1) & 1];
    fill_step<false><<<grid, NT, 0, st>>>(d_prev, v_prev, d_next, v_next, total, H, W, W, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    d_prev = d_next;
    v_prev = v_next;
  }
  return 0;
}

}  // extern "C"
