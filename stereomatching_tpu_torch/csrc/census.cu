// K10: the census transform of both views of a batch, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves the census to XLA
// (stereomatching_tpu/ops/costvolume.py census_transform, one fused
// phase), and the port ran it as torch ops (ops/costvolume.py
// census_transform, now the plain version): two int32 passes for each
// neighbour, about 55 launches an image.  Semantics: for each pixel of an
// integer plane [H, W], one bit per neighbour of the window x window
// square (window 3 or 5), centre skipped, row-major from the top-left,
// bit 0 first; a bit is set iff the neighbour is strictly below the
// centre; borders replicate (the neighbour's row and column are clamped
// into the image).  -> int32 codes [H, W] (8 or 24 bits).
//
// What bounds it on the H100: the arithmetic, about 3 int32 ops a
// neighbour (compare, select, or), 72 a pixel at window 5, against 8 B a
// pixel of device memory (stereobench/workmodel.py charges 16 B and
// 2 x 72 ops a pair's pixel, both views).
//
// Design: one launch covers the batch and both views, a block per tile
// of TH x TW pixels of one image (the blocks of the left views first,
// then the right ones').  A block stages its tile and a halo of `half`
// rows and columns in shared memory as int32 words (the input is int32:
// the coarse level's summed intensities and any integer plane pass
// unnarrowed), with the clamp in the staging's indices, once.  Each
// thread then makes the codes of 4 neighbouring pixels in each of RPT
// consecutive rows: it reads the 4 + 2 * half staged values of a row it
// needs with two 16-byte shared loads, keeps a window of
// 2 * half + 1 such rows in registers as it walks down, and writes each
// row's 4 codes as one 16-byte store where the row is whole and aligned
// (W % 4 == 0), else element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads of a block: 32 columns of threads x 8 rows
constexpr int PX = 4;     // pixels of a row a thread codes
constexpr int RPT = 4;    // rows a thread codes
constexpr int TW = 32 * PX;        // 128 pixels a tile row
constexpr int TH = (NT / 32) * RPT;  // 32 rows a tile
constexpr int SW = TW + 4;  // staged columns: the tile, a halo of 2 each side

// The 8 staged values from column c of a staged row (c % 4 == 0).
__device__ __forceinline__ void load8(const int* row, int c, int v[8]) {
  const int4 a = *reinterpret_cast<const int4*>(row + c);
  const int4 b = *reinterpret_cast<const int4*>(row + c + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int HALF>
__global__ void __launch_bounds__(NT)
census_kernel(const int* __restrict__ left, const int* __restrict__ right,
              int* __restrict__ out_left, int* __restrict__ out_right,
              int B, int H, int W, int tiles_x, int tiles_y) {
  constexpr int K = 2 * HALF + 1;   // rows (and columns) of the window
  constexpr int SH = TH + 2 * HALF;  // staged rows
  __shared__ __align__(16) int s[SH][SW];

  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int view = t / tiles_y;
  const long long plane = (long long)H * W;
  const int* in = view < B ? left + view * plane : right + (view - B) * plane;
  int* out = view < B ? out_left + view * plane : out_right + (view - B) * plane;
  const int x0 = tx * TW, y0 = ty * TH;

  // Stage rows y0 - HALF .. and columns x0 - 2 .. (SW of them; the two
  // extra at window 3 are staged too and never compared), clamped into
  // the image.  A warp stages a row, a lane the same columns in each.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int gx[(SW + 31) / 32];
#pragma unroll
  for (int k = 0; k < (SW + 31) / 32; ++k)
    gx[k] = min(max(x0 - 2 + lane + 32 * k, 0), W - 1);
  for (int r = warp; r < SH; r += NT / 32) {
    const int* src = in + (long long)min(max(y0 - HALF + r, 0), H - 1) * W;
#pragma unroll
    for (int k = 0; k < (SW + 31) / 32; ++k)
      if (lane + 32 * k < SW) s[r][lane + 32 * k] = src[gx[k]];
  }
  __syncthreads();

  // Pixel x0 + c + j (j < PX) sits at staged column c + j + 2; its window
  // spans staged columns c + j + 2 - HALF .. c + j + 2 + HALF, within the
  // 8 that load8 reads from c.
  const int c = PX * lane;
  const int r0 = RPT * warp;  // first of the thread's rows in the tile
  int win[K][8];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) load8(&s[r0 + i][0], c, win[i + 1]);
  const int x = x0 + c;
  const bool vec = (W % 4 == 0) && (x + PX <= W);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int k = 0; k < K - 1; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) win[k][e] = win[k + 1][e];
    load8(&s[r0 + i + K - 1][0], c, win[K - 1]);
    int code[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int centre = win[HALF][j + 2];
      unsigned bits = 0;
      int bit = 0;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          if (dy == HALF && dx == HALF) continue;
          bits |= (unsigned)(win[dy][j + 2 - HALF + dx] < centre) << bit;
          ++bit;
        }
      code[j] = (int)bits;
    }
    const int y = y0 + r0 + i;
    if (y >= H) break;
    int* dst = out + (long long)y * W + x;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = make_int4(code[0], code[1], code[2], code[3]);
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (x + j < W) dst[j] = code[j];
    }
  }
}

cudaError_t launch(const int* l, const int* r, int* out_left, int* out_right, int B,
                   int H, int W, int window, cudaStream_t st) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long blocks = 2LL * B * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (window == 3)
    census_kernel<1><<<(unsigned)blocks, NT, 0, st>>>(l, r, out_left, out_right, B, H, W,
                                                      tiles_x, tiles_y);
  else
    census_kernel<2><<<(unsigned)blocks, NT, 0, st>>>(l, r, out_left, out_right, B, H, W,
                                                      tiles_x, tiles_y);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// left, right: int32 [B, H, W], contiguous.  out_left, out_right: int32
// [B, H, W], contiguous and 16-byte aligned.  window: 3 or 5.  Empty
// planes launch nothing.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int census(const void* left, const void* right, void* out_left, void* out_right, int B,
           int H, int W, int window, void* stream) {
  if (B < 0 || H < 0 || W < 0 || (window != 3 && window != 5)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out_left % 16 != 0 || (uintptr_t)out_right % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  return (int)launch((const int*)left, (const int*)right, (int*)out_left, (int*)out_right, B,
                     H, W, window, (cudaStream_t)stream);
}

}  // extern "C"
