// K11: the reference rule's edge maps of both views of a batch, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package computes these edges as XLA
// ops (stereomatching_tpu/ops/edges.py), and the port ran them as torch
// ops (ops/edges.py find_edges_padded with rule "reference", now the
// plain version): a pad and about 60 elementwise ops an image, each
// reading and writing a whole plane.  Semantics (the C predicate,
// src/stereo.c:16-84): for each pixel of a float plane [H, W] and each of
// the four operators of EDGE_OPERATORS, the mean of each 3-pixel side,
// ((t0 + t1) + t2) / 3 in the input's dtype, their mean
// overall = (avg_a + avg_b) / 2, bound = clamp(thr * overall, 0, 1), and
// an edge where |avg_a - avg_b| > bound for any operator.  Outside the
// image the neighbours wrap modulo the size (src/util.h:42-47) or read
// the ghost programs' 128.0 (src/stereo-ghost.c:384-385).  -> int32
// {0, 1} maps [H, W].
//
// Every float op rounds as the plain version's does: adds, subtracts,
// products and the divides by 3 are IEEE round-to-nearest intrinsics
// (__fadd_rn, __fdiv_rn, ...), so nvcc contracts nothing into an FMA and
// never turns a divide into a product by 1/3.  The mean's divide by 2 is
// a product by 0.5: halving is exact, so both round the same real
// number.  The clamp keeps a NaN, as torch.clamp does (and a NaN bound
// sets no edge).
//
// What bounds it on the H100: the bytes, 4 B in and 4 B out a pixel and
// view in float32 (stereobench/routes/classic_ref.py charges 16 B and
// 61 float32 ops a pair's pixel, 0.00501 ms a pair at 1024^2), with the
// instructions close behind: about 7 IEEE divides a pixel and view, each
// a few FMAs, a range check and a branch, and some 100 instructions in
// all.  At 1024^2 x 32 in float32 an H100 SXM takes about 0.011 ms a
// pair, 45% of the bytes' bound.
//
// Design: one launch covers the batch and both views, a block per tile
// of TH x TW pixels of one image (the blocks of the left views first,
// then the right ones').  A block stages its tile and a 1-pixel halo in
// shared memory, with the boundary (modulo index or the ghost fill) in
// the staging's indices, once, so the compute reads no index twice and
// no padded copy is made.  Each thread then makes the edges of 4
// neighbouring pixels in each of RPT consecutive rows from a window of 3
// staged rows in registers, read with 16-byte shared loads.  Means that
// neighbouring pixels share are divided once: a column's vertical mean
// serves the left-right operator of the pixels on either side of it, and
// a row's horizontal mean the top-bottom operator of the rows above and
// below it (the same adds in the same order).  Each row's 4 flags go out
// as one 16-byte int32 store where the row is whole and aligned
// (W % 4 == 0), else element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads of a block: 32 columns of threads x 8 rows
constexpr int PX = 4;     // pixels of a row a thread makes
constexpr int RPT = 4;    // rows a thread makes
constexpr int TW = 32 * PX;          // 128 pixels a tile row
constexpr int TH = (NT / 32) * RPT;  // 32 rows a tile
constexpr int SW = TW + 4;  // staged columns x0 - 2 .. x0 + TW + 1 (16-byte aligned rows)
constexpr int SH = TH + 2;  // staged rows y0 - 1 .. y0 + TH
constexpr int GX = (SW + 31) / 32;  // staged columns a lane stages in each row
constexpr int SR = (SH + NT / 32 - 1) / (NT / 32);  // staged rows a warp stages

// Round-to-nearest arithmetic in T, as intrinsics nvcc cannot contract.
template <typename T> struct Ieee;
template <> struct Ieee<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};
template <> struct Ieee<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

// The mean of one side: ((t0 + t1) + t2) / 3.
template <typename T>
__device__ __forceinline__ T mean3(T t0, T t1, T t2) {
  using F = Ieee<T>;
  return F::div(F::add(F::add(t0, t1), t2), T(3));
}

// One operator's decision from its two side means.
template <typename T>
__device__ __forceinline__ bool differs(T a, T b, T thr) {
  using F = Ieee<T>;
  T bound = F::mul(thr, F::mul(F::add(a, b), T(0.5)));
  bound = bound < T(0) ? T(0) : (bound > T(1) ? T(1) : bound);
  return fabs(F::sub(a, b)) > bound;
}

// The 8 staged values from column c of a staged row (c % 4 == 0).
__device__ __forceinline__ void load8(const float* row, int c, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + c);
  const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const double* row, int c, double v[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = *reinterpret_cast<const double2*>(row + c + 2 * k);
    v[2 * k] = a.x; v[2 * k + 1] = a.y;
  }
}

// The index of image coordinate g on an axis of n, or -1 for the ghost
// fill.  Outputs read wrapped coordinates in [-1, n] alone, which one
// add or subtract of n maps (src/util.h:42-47's modulo there); the
// staged coordinates beyond them (the tile's outer columns, rows and
// columns past the image) are clamped to some pixel and never read.
__device__ __forceinline__ int source(int g, int n, bool wrap) {
  if (wrap) return min(max(g < 0 ? g + n : (g >= n ? g - n : g), 0), n - 1);
  return g >= 0 && g < n ? g : -1;
}

template <typename T>
__global__ void __launch_bounds__(NT)
reference_edges_kernel(const T* __restrict__ left, const T* __restrict__ right,
                       int* __restrict__ out_left, int* __restrict__ out_right, int B, int H,
                       int W, int tiles_x, int tiles_y, bool wrap, T thr) {
  __shared__ __align__(16) T s[SH][SW];

  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int view = t / tiles_y;
  const long long plane = (long long)H * W;
  const T* in = view < B ? left + view * plane : right + (view - B) * plane;
  int* out = view < B ? out_left + view * plane : out_right + (view - B) * plane;
  const int x0 = tx * TW, y0 = ty * TH;

  // Stage rows y0 - 1 .. and columns x0 - 2 .. (SW of them; the first
  // and the last are staged too and never read).  A warp stages every
  // (NT / 32)-th row, a lane the same columns in each; all of a thread's
  // loads are issued before its first store, so their latencies overlap
  // (a loop that stored each row before loading the next took 5-15% more
  // time).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int gx[GX];
#pragma unroll
  for (int k = 0; k < GX; ++k) gx[k] = source(x0 - 2 + lane + 32 * k, W, wrap);
  T staged[SR][GX];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = warp + (NT / 32) * i;
    const int gy = r < SH ? source(y0 - 1 + r, H, wrap) : -1;
    const T* src = in + (long long)max(gy, 0) * W;
#pragma unroll
    for (int k = 0; k < GX; ++k) staged[i][k] = gy < 0 || gx[k] < 0 ? T(128) : src[gx[k]];
  }
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = warp + (NT / 32) * i;
#pragma unroll
    for (int k = 0; k < GX; ++k)
      if (r < SH && lane + 32 * k < SW) s[r][lane + 32 * k] = staged[i][k];
  }
  __syncthreads();

  // Pixel x0 + c + j (j < PX) sits at staged column c + j + 2; its
  // neighbours at columns c + j + 1 .. c + j + 3, within the 8 that load8
  // reads from c.  w[0], w[1], w[2]: the rows above, at and below the
  // pixel; h[k][j]: the horizontal mean of w[k] around pixel j.
  const int c = PX * lane;
  const int r0 = RPT * warp;  // the staged row above the thread's first row
  T w[3][8], h[3][PX];
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    load8(&s[r0 + k - 1][0], c, w[k]);
#pragma unroll
    for (int j = 0; j < PX; ++j) h[k][j] = mean3(w[k][j + 1], w[k][j + 2], w[k][j + 3]);
  }
  const int x = x0 + c;
  const bool vec = (W % 4 == 0) && (x + PX <= W);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[0][e] = w[1][e];
      w[1][e] = w[2][e];
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      h[0][j] = h[1][j];
      h[1][j] = h[2][j];
    }
    load8(&s[r0 + i + 2][0], c, w[2]);
#pragma unroll
    for (int j = 0; j < PX; ++j) h[2][j] = mean3(w[2][j + 1], w[2][j + 2], w[2][j + 3]);
    T v[PX + 2];  // vertical means of staged columns c + 1 .. c + PX + 2
#pragma unroll
    for (int m = 0; m < PX + 2; ++m) v[m] = mean3(w[0][m + 1], w[1][m + 1], w[2][m + 1]);
    int edge[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int a = j + 1, m = j + 2, b = j + 3;  // columns left of, at, right of the pixel
      bool e = differs(v[j], v[j + 2], thr);                        // left_right
      e |= differs(h[0][j], h[2][j], thr);                           // top_bottom
      e |= differs(mean3(w[0][a], w[0][m], w[1][a]),                 // upleft_downright
                   mean3(w[1][b], w[2][m], w[2][b]), thr);
      e |= differs(mean3(w[2][a], w[2][m], w[1][a]),                 // downleft_upright
                   mean3(w[0][m], w[0][b], w[1][b]), thr);
      edge[j] = e;
    }
    const int y = y0 + r0 + i;
    if (y >= H) break;
    int* dst = out + (long long)y * W + x;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = make_int4(edge[0], edge[1], edge[2], edge[3]);
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (x + j < W) dst[j] = edge[j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* l, const void* r, int* out_left, int* out_right, int B, int H,
                   int W, bool wrap, double threshold, cudaStream_t st) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long blocks = 2LL * B * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  reference_edges_kernel<T><<<(unsigned)blocks, NT, 0, st>>>(
      (const T*)l, (const T*)r, out_left, out_right, B, H, W, tiles_x, tiles_y, wrap,
      (T)threshold);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// left, right: float32 (elem_bytes 4) or float64 (8) [B, H, W],
// contiguous.  out_left, out_right: int32 [B, H, W], contiguous and
// 16-byte aligned.  wrap: 1 for modulo wrap-around, 0 for the ghost
// fill.  threshold is rounded to the planes' dtype.  Empty planes launch
// nothing.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
int reference_edges(const void* left, const void* right, void* out_left, void* out_right,
                    int B, int H, int W, int elem_bytes, int wrap, double threshold,
                    void* stream) {
  if (B < 0 || H < 0 || W < 0 || (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out_left % 16 != 0 || (uintptr_t)out_right % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return (int)launch<float>(left, right, (int*)out_left, (int*)out_right, B, H, W, wrap != 0,
                              threshold, st);
  return (int)launch<double>(left, right, (int*)out_left, (int*)out_right, B, H, W, wrap != 0,
                             threshold, st);
}

}  // extern "C"
