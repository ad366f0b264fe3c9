// K6: the validity-aware hole fill of the modern pipeline, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_diffusion.py:286
// fill_invalid_pallas (body _fill_invalid_kernel, :208).  Semantics
// (ops/costvolume.py fill_invalid): `iterations` Jacobi sweeps over the
// float32 disparity d and validity v of each [H, W] image,
//     num = ((dv[x+1] + dv[x-1]) + dv[y+1]) + dv[y-1],   dv = d * v
//     den = ((v[x+1] + v[x-1]) + v[y+1]) + v[y-1]
//     if v == 0 and den > 0:  d = num / max(den, 1),  v = 1
// with every neighbour outside the image 0 (zero padding).
//
// What bounds it on the H100: about 12 float ops per pixel and sweep
// (utils/bench.py k6_bound_ms), issued one per lane and clock since none
// may be contracted, once the sweeps stay in shared memory (in device
// memory a sweep moves ~10 B per pixel).  Measured, the staging, the
// write-back and the latency of each sweep's walk (one barrier a sweep)
// hold it, not the arithmetic (PERF.md).
//
// Design: all sweeps in one launch, on tiles in shared memory, as the TPU
// kernel runs them in one VMEM tile (as K2, csrc/fill_web_holes.cu, does
// for the web diffusion).  A block owns TH x TW pixels of one image and
// stages them with a halo of h rows and hc = h + 3 columns rounded to
// whole words (h: the sweeps the launch runs): a float d plane and a
// state byte a cell.  After sweep t only the cells t inside the staged
// edge are right, so each sweep updates only the region the owned cells
// still need, shrinking by a row and a column on every side; the edge
// rows and words are never updated.  The x neighbours stay within the
// row, so tiles are 2-D rectangles.  Cells outside the image are staged
// as d = +0.0 and invalid and are never updated: the plain version's zero
// pad, the TPU kernel's in_img pin.  A sweep that turns no cell of the
// tile valid leaves the state as it was, and so would every later one,
// so the block stops there (the barrier that ends a sweep is
// __syncthreads_or of "a cell turned valid").  The block writes its owned
// cells once at the end.  Where the sweeps exceed one launch's HMAX,
// launches chain, each handing the next d and v in device memory (the
// same planes as the input): ceil(sweeps / HMAX) launches, the sweeps
// split evenly.  Measured (PERF.md): HMAX 16 with 64 x 64 tiles (50 KB,
// 4 blocks an SM) against HMAX 8 and 12, 32 x 64 and 64 x 128 tiles, 128
// and 512 threads, and staging by cp.async.
//
// One d plane, not two: a cell's d changes at most once, at the sweep
// where it turns valid, and before that it is the input's.  Its state
// byte holds s, the sweep since which it is valid (0: valid at the
// launch's start; 63: not yet), so a reader at sweep t takes v = (s < t)
// and uses d from the plane only then: that write came before the last
// barrier.  A thread owns a word column (four cells) and walks down its
// band of the sweep's rows carrying the state words above, at and below
// its row (the next one loaded ahead): a word whose cells are all valid
// costs one shared load and a SIMD compare; a word with an invalid cell
// loads its left and right state words, counts each cell's valid
// neighbours by SIMD compares, and only if one can turn valid reads the
// d of its row and the rows above and below as three 16-byte vectors
// (two more cells beside them) and writes its four d back as one.
//
// Bitwise hazards:
//   * The adds, the products and the divide are __fadd_rn / __fmul_rn /
//     __fdiv_rn in the plain version's order ((right + left) + down) +
//     up: nvcc would contract d * v + sum into an FMA.
//   * An invalid in-image neighbour still adds d * 0: -0.0 for a negative
//     or -0.0 d, NaN for an infinite or NaN d, and either can reach the
//     result (-0.0 where the only valid neighbour is -0.0; NaN always).
//     Its d may be overwritten in the same sweep, so the state byte keeps
//     the class of the input d beside s, also once the cell turns valid:
//     NEG (d * 0 is -0.0) or NANC (d is infinite or NaN, then read from
//     the launch's input, which holds it until the cell turns valid); the
//     term is __fmul_rn(+-1 or d, 0), bit for bit the plain version's
//     product.
//   * den is a sum of 0/1 floats, so the count of valid neighbours made
//     float is the same bits; den > 0 makes max(den, 1) = den.
//
// The sharded tier (stereomatching_tpu/parallel/modern.py:340-395) runs
// one sweep per halo exchange: fill_invalid_step sweeps a block whose
// 1-row (and, 2-D, 1-column) halo of d and v was exchanged (zeros past
// the global edge), writing only the interior.  A rows-only block's x
// neighbours stop at its columns (zero padding); a 2-D block's come from
// its halo columns.  The sum order is the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads of the step kernel

// ------------------------------------------------------------ one sweep

// One sweep on halo blocks: the interior [B, h, w] of blocks [B, h + 2,
// we] whose interior columns are x_off .. x_off + w - 1; the y
// neighbours are halo rows, and on a rows-only block (x_off 0) an x
// neighbour past the block's columns is not read.
__global__ void __launch_bounds__(NT)
fill_step(const float* __restrict__ d_in, const uint8_t* __restrict__ v_in,
          float* __restrict__ d_out, uint8_t* __restrict__ v_out,
          long long total, int h, int w, int we, int x_off) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const int x = (int)(i % w);
    const long long r = i / w;
    const int y = (int)(r % h);
    const long long p = (r / h) * (long long)(h + 2) * we + (long long)(y + 1) * we + x + x_off;
    const uint8_t v = v_in[p];
    const float d = d_in[p];
    if (v != 0) {
      d_out[i] = d;
      v_out[i] = v;
      continue;
    }
    // right, left, down, up; a neighbour not read adds +0.0.
    const long long nb[4] = {p + 1, p - 1, p + we, p - we};
    const bool open_x = x_off > 0;
    const bool in[4] = {open_x || x + 1 < w, open_x || x > 0, true, true};
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

// ---------------------------------------------------------- fused sweeps

constexpr int FNT = 256;         // threads of the fused kernel
constexpr int TH = 64, TW = 64;  // owned pixels of a block
constexpr int HMAX = 16;         // most sweeps a launch

// The state byte: s in the low 6 bits, the input d's class above.
constexpr uint32_t NEVER = 63u;   // s of a cell not (yet) valid
constexpr uint32_t NEG = 0x40u;   // d * 0 is -0.0
constexpr uint32_t NANC = 0x80u;  // d is infinite or NaN
constexpr uint32_t S4 = 0x3f3f3f3fu, ONES = 0x01010101u;

// The column halo of h sweeps in cells: h + 3 (the edge words are never
// updated), rounded to whole words.
__host__ __device__ int col_halo(int h) { return (h + 3 + 3) / 4 * 4; }

// Dynamic shared memory of one block running h sweeps: a float and a
// state byte for each of (TH + 2h) rows x (TW + 2 col_halo(h)) cells.
long long fused_smem_bytes(int h) {
  return 5LL * (TH + 2 * h) * (TW + 2 * col_halo(h));
}

// The state byte of a staged cell: valid, or not yet with its d's class.
__device__ __forceinline__ uint32_t state_of(float d, uint8_t v) {
  if (v != 0) return 0u;
  if (!isfinite(d)) return NEVER | NANC;
  return signbit(d) ? (NEVER | NEG) : NEVER;
}

// A neighbour's factor in d * v: its staged d where valid; where not, a
// value whose product with 0 has its input d's bits when that d is
// finite (+-1 by the class; an infinite or NaN d is read by the caller).
__device__ __forceinline__ float factor(uint32_t valid, uint32_t st, float d) {
  return valid ? d : ((st & NEG) ? -1.0f : 1.0f);
}

// d_in, v_in: float32 and bytes (0 / 1) [B, H, W], this launch's input;
// d_out: its d after h sweeps; v_out: its validity, or null on the last
// launch.  vec: W % 4 == 0 and every plane's base 16-byte (v: 4-byte)
// aligned, so a word of four cells moves as one vector.
__global__ void __launch_bounds__(FNT)
fused_kernel(const float* __restrict__ d_in, const uint8_t* __restrict__ v_in,
             float* __restrict__ d_out, uint8_t* __restrict__ v_out, int H, int W, int h,
             int tiles_x, int tiles_y, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hc = col_halo(h);
  const int R = TH + 2 * h;   // staged rows
  const int WC = TW + 2 * hc;  // staged cells a row
  const int WS = WC / 4;       // state words a row
  float* const dpl = reinterpret_cast<float*>(smem);
  uint32_t* const spl = reinterpret_cast<uint32_t*>(smem + 4 * R * WC);
  const int tile = blockIdx.x % (tiles_x * tiles_y);
  const long long img = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = tile / tiles_x * TH, x0 = tile % tiles_x * TW;
  const int gy0 = y0 - h, gx0 = x0 - hc;  // image coordinates of staged cell (0, 0)
  const long long ibase = img * H * (long long)W;
  const float* const dimg = d_in + ibase;
  const uint8_t* const vimg = v_in + ibase;

  // Stage: word (row, wc) holds cells gx0 + 4 wc .. + 3 of image row gy0 + row.
#pragma unroll 4
  for (int i = threadIdx.x; i < R * WS; i += FNT) {
    const int row = i / WS, wc = i - row * WS;
    const int gy = gy0 + row, gx = gx0 + 4 * wc;
    float4 d4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint32_t st = NEVER * ONES;
    if (gy >= 0 && gy < H) {
      const long long g = (long long)gy * W + gx;
      if (vec && gx >= 0 && gx + 4 <= W) {
        d4 = *reinterpret_cast<const float4*>(dimg + g);
        const uint32_t v4 = *reinterpret_cast<const uint32_t*>(vimg + g);
        st = state_of(d4.x, v4 & 0xff) | state_of(d4.y, (v4 >> 8) & 0xff) << 8 |
             state_of(d4.z, (v4 >> 16) & 0xff) << 16 | state_of(d4.w, v4 >> 24) << 24;
      } else {
        float dk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (gx + k < 0 || gx + k >= W) continue;
          dk[k] = dimg[g + k];
          st = (st & ~(0xffu << 8 * k)) | state_of(dk[k], vimg[g + k]) << 8 * k;
        }
        d4 = make_float4(dk[0], dk[1], dk[2], dk[3]);
      }
    }
    *reinterpret_cast<float4*>(dpl + row * WC + 4 * wc) = d4;
    spl[i] = st;
  }
  __syncthreads();

  // Thread (band, word column 1 + tid % (WS - 2)) walks down its band of
  // each sweep's rows.  Sweep t updates rows t .. R - t - 1 and the words
  // holding cells hc - h + t .. hc + TW + h - t - 1 (within words 1 ..
  // WS - 2).
  const int nwc = WS - 2, bands = FNT / nwc;
  const int band = threadIdx.x / nwc, wc = 1 + threadIdx.x % nwc;
  const int gx = gx0 + 4 * wc;
  uint32_t colmask = 0;  // the word's cells inside the image
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (gx + k >= 0 && gx + k < W) colmask |= 0xffu << 8 * k;
  for (int t = 1; t <= h; ++t) {
    bool changed = false;  // a cell of this thread turned valid
    const int lo = t, hi = R - t;
    const int per_band = (hi - lo + bands - 1) / bands;
    const int row0 = lo + band * per_band, row1 = min(row0 + per_band, hi);
    const bool col = wc >= (hc - h + t) / 4 && wc < (hc + TW + h - t + 3) / 4;
    if (band < bands && col && colmask != 0 && row0 < row1) {
      const uint32_t tt = (uint32_t)t * ONES;
      int o = row0 * WS + wc;
      uint32_t up = spl[o - WS], mid = spl[o], down = spl[o + WS];
      for (int row = row0; row < row1; ++row, o += WS) {
        // The next row's word below, loaded before this row's work.
        const uint32_t below = row + 1 < row1 ? spl[o + 2 * WS] : 0u;
        const int gy = gy0 + row;
        // Cells not valid after sweep t - 1, inside the image.
        uint32_t todo = ~__vcmpltu4(mid & S4, tt) & colmask;
        if (gy < 0 || gy >= H) todo = 0;
        if (todo != 0) {
          const uint32_t rs = __funnelshift_r(mid, spl[o + 1], 8);  // each cell's x + 1
          const uint32_t ls = __funnelshift_l(spl[o - 1], mid, 8);  // each cell's x - 1
          const uint32_t vr = __vcmpltu4(rs & S4, tt), vl = __vcmpltu4(ls & S4, tt);
          const uint32_t vd = __vcmpltu4(down & S4, tt), vu = __vcmpltu4(up & S4, tt);
          const uint32_t n = (vr & ONES) + (vl & ONES) + (vd & ONES) + (vu & ONES);
          todo &= __vcmpne4(n, 0u);
          if (todo != 0) {
            // The word's cells and their four neighbours' d: the words at,
            // above and below it as vectors, the cells left and right of it.
            const int c0 = row * WC + 4 * wc;
            const float4 m4 = *reinterpret_cast<const float4*>(dpl + c0);
            const float4 u4 = *reinterpret_cast<const float4*>(dpl + c0 - WC);
            const float4 d4 = *reinterpret_cast<const float4*>(dpl + c0 + WC);
            const float m[6] = {dpl[c0 - 1], m4.x, m4.y, m4.z, m4.w, dpl[c0 + 4]};
            const float u[4] = {u4.x, u4.y, u4.z, u4.w}, dn[4] = {d4.x, d4.y, d4.z, d4.w};
            float xr[4], xl[4], xd[4], xu[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int sh = 8 * k;
              xr[k] = factor((vr >> sh) & 1u, rs >> sh, m[k + 2]);
              xl[k] = factor((vl >> sh) & 1u, ls >> sh, m[k]);
              xd[k] = factor((vd >> sh) & 1u, down >> sh, dn[k]);
              xu[k] = factor((vu >> sh) & 1u, up >> sh, u[k]);
            }
            // An invalid neighbour with an infinite or NaN d (rare): its d
            // from the launch's input, which holds it until it turns valid.
            const uint32_t nr = rs & ~vr, nl = ls & ~vl, nd = down & ~vd, nu = up & ~vu;
            if (((nr | nl | nd | nu) & (NANC * ONES)) != 0) {
              const long long g = (long long)gy * W + gx;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int sh = 8 * k;
                if ((nr >> sh) & NANC) xr[k] = dimg[g + k + 1];
                if ((nl >> sh) & NANC) xl[k] = dimg[g + k - 1];
                if ((nd >> sh) & NANC) xd[k] = dimg[g + k + W];
                if ((nu >> sh) & NANC) xu[k] = dimg[g + k - W];
              }
            }
            float r[4] = {m4.x, m4.y, m4.z, m4.w};
            uint32_t next = mid;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int sh = 8 * k;
              if (((todo >> sh) & 1u) == 0) continue;
              const float tr = __fmul_rn(xr[k], (vr >> sh) & 1u ? 1.0f : 0.0f);
              const float tl = __fmul_rn(xl[k], (vl >> sh) & 1u ? 1.0f : 0.0f);
              const float td = __fmul_rn(xd[k], (vd >> sh) & 1u ? 1.0f : 0.0f);
              const float tu = __fmul_rn(xu[k], (vu >> sh) & 1u ? 1.0f : 0.0f);
              const float num = __fadd_rn(__fadd_rn(__fadd_rn(tr, tl), td), tu);
              r[k] = __fdiv_rn(num, (float)((n >> sh) & 0xffu));
              // Valid since t; the class stays for readers in this sweep.
              next = (next & ~(NEVER << sh)) | (uint32_t)t << sh;
            }
            *reinterpret_cast<float4*>(dpl + c0) = make_float4(r[0], r[1], r[2], r[3]);
            spl[o] = next;
            changed = true;
          }
        }
        up = mid;
        mid = down;
        down = below;
      }
    }
    // A sweep that turns no cell valid leaves the state as it found it,
    // and so would every later one: the tile is done.
    if (!__syncthreads_or(changed)) break;
  }

  // The owned cells: rows y0 .. y0 + TH - 1, columns x0 .. x0 + TW - 1
  // of the image, staged at row h + dy, cell hc + dx; a word at a time.
  float* const dout = d_out + ibase;
  uint8_t* const vout = v_out == nullptr ? nullptr : v_out + ibase;
  for (int i = threadIdx.x; i < TH * (TW / 4); i += FNT) {
    const int dy = i / (TW / 4), dx = 4 * (i - dy * (TW / 4));
    const int gy = y0 + dy, gxo = x0 + dx;
    if (gy >= H || gxo >= W) continue;
    const int c = (h + dy) * WC + hc + dx;
    const long long g = (long long)gy * W + gxo;
    const float4 d4 = *reinterpret_cast<const float4*>(dpl + c);
    const uint32_t v4 = __vcmpne4(spl[c / 4] & S4, NEVER * ONES) & ONES;
    if (vec && gxo + 4 <= W) {
      *reinterpret_cast<float4*>(dout + g) = d4;
      if (vout != nullptr) *reinterpret_cast<uint32_t*>(vout + g) = v4;
    } else {
      const float dk[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (gxo + k >= W) break;
        dout[g + k] = dk[k];
        if (vout != nullptr) vout[g + k] = (uint8_t)(v4 >> 8 * k);
      }
    }
  }
}

cudaError_t launch_fused(const float* d_in, const uint8_t* v_in, float* d_out, uint8_t* v_out,
                         int B, int H, int W, int h, cudaStream_t st) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long blocks = (long long)tiles_x * tiles_y * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = (int)fused_smem_bytes(h);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const bool vec = W % 4 == 0 && (uintptr_t)d_in % 16 == 0 && (uintptr_t)v_in % 4 == 0 &&
                   (uintptr_t)d_out % 16 == 0 && (v_out == nullptr || (uintptr_t)v_out % 4 == 0);
  fused_kernel<<<(unsigned)blocks, FNT, smem, st>>>(d_in, v_in, d_out, v_out, H, W, h, tiles_x,
                                                    tiles_y, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Most sweeps one fused launch runs (ops/fused_diffusion.py K6_MAX_SWEEPS
// mirrors it).
int fill_invalid_max_sweeps() { return HMAX; }

// Dynamic shared memory of a fused launch running `sweeps` sweeps
// (ops/fused_diffusion.py k6_smem_bytes mirrors it).
long long fill_invalid_smem_bytes(int sweeps) { return fused_smem_bytes(sweeps); }

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
  fill_step<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)d_ext, (const uint8_t*)v_ext, (float*)d_out,
      (uint8_t*)v_out, total, hs, ws, we, x_off);
  return (int)cudaGetLastError();
}

// disp: float32 [B, H, W], valid: uint8 [B, H, W] (0 / 1), both read only.
// out: float32 [B, H, W] receives d after `iterations` >= 1 sweeps, in
// ceil(iterations / HMAX) launches.  Between launches d and v go through
// d_tmp (float32 [B, H, W]; with `out`, d's planes alternate so that the
// last launch writes `out`) and v_tmp0, v_tmp1 (uint8 [B, H, W]): d_tmp
// and v_tmp0 are read from two launches, v_tmp1 from three (null when
// not read).  Launches on `stream`; returns the first error.
int fill_invalid(const void* disp, const void* valid, void* out, void* d_tmp,
                 void* v_tmp0, void* v_tmp1, int B, int H, int W,
                 int iterations, void* stream) {
  if (B < 1 || H < 1 || W < 1 || iterations < 1)
    return (int)cudaErrorInvalidValue;
  const int n = (iterations + HMAX - 1) / HMAX;
  if ((n > 1 && (d_tmp == nullptr || v_tmp0 == nullptr)) || (n > 2 && v_tmp1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* dbuf[2] = {(float*)out, (float*)d_tmp};
  uint8_t* vbuf[2] = {(uint8_t*)v_tmp0, (uint8_t*)v_tmp1};
  const float* d_prev = (const float*)disp;
  const uint8_t* v_prev = (const uint8_t*)valid;
  for (int k = 0; k < n; ++k) {
    const int h = iterations / n + (k < iterations % n ? 1 : 0);
    // Launch k writes dbuf[(n - 1 - k) % 2]: the last one `out`.
    float* d_next = dbuf[(n - 1 - k) & 1];
    uint8_t* v_next = k == n - 1 ? nullptr : vbuf[k & 1];
    const cudaError_t e = launch_fused(d_prev, v_prev, d_next, v_next, B, H, W, h, st);
    if (e != cudaSuccess) return (int)e;
    d_prev = d_next;
    v_prev = v_next;
  }
  return 0;
}

}  // extern "C"
