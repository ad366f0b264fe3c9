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

__global__ void __launch_bounds__(NT)
fill_step(const float* __restrict__ d_in, const uint8_t* __restrict__ v_in,
          float* __restrict__ d_out, uint8_t* __restrict__ v_out,
          long long total, int H, int W) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const int x = (int)(i % W);
    const int y = (int)((i / W) % H);
    const uint8_t v = v_in[i];
    const float d = d_in[i];
    if (v != 0) {
      d_out[i] = d;
      v_out[i] = v;
      continue;
    }
    // right, left, down, up; a neighbour outside the image adds +0.0.
    const long long nb[4] = {i + 1, i - 1, i + W, i - W};
    const bool in[4] = {x + 1 < W, x > 0, y + 1 < H, y > 0};
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
    fill_step<<<grid, NT, 0, st>>>(d_prev, v_prev, d_next, v_next, total, H, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    d_prev = d_next;
    v_prev = v_next;
  }
  return 0;
}

}  // extern "C"
