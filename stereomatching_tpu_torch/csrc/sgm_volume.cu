// K3: the per-pixel SGM cost volume, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_sgm.py:784
// sgm_volume_pallas (body _volume_kernel, :749), and counterpart of the
// scan-major sgm_volume_vmajor_pallas (:884).  Semantics
// (models/modern.py _sgm_volume, scales = 1): for int32 cost inputs L, R
// [B, H, W] (census codes for census, pixel intensities for SAD)
//     vol[b, y, x, d] = census ? popcount(L[y, x] ^ R[y, max(x - d, 0)])
//                              : |L[y, x] - R[y, max(x - d, 0)]|
// stored as int8, int16 or int32 by the narrowing cast (T)c, the plain
// version's assignment into a narrower tensor (the caller picks a type
// that holds every cost).  The layout is [B, H, W, D], d innermost, which
// every SGM path and the tail read D-contiguous.
//
// What bounds it on the H100: device memory, 8 B in per pixel against D
// elements out (64 B at int8, D=64); census also pays one population
// count per element on its own unit, 16 per SM and clock (0.128 ms per
// batch of 8 at D=64, 71% of the byte floor), so the counts and the
// stores must overlap (utils/bench.py k3_bound_ms).
//
// Design: a block per row segment of SEG pixels stages the segment's L
// codes and R from D - 1 columns to its left (clamped at column 0, as
// max(x - d, 0) is) in shared memory, once; then every element is one
// shared load and the cost, and every store a whole 16-byte vector (16
// costs at int8, 8 at int16, 4 at int32), packed by byte permutes.
// Three routes, chosen before launch from (W, D, dtype) alone
// (ops/fused_sgm.py k3_route; this file's sgm_volume_route):
//   * pixels, where D is a multiple of 32: no vector spans two pixels, and
//     a warp's store takes 32 / V lanes of each of V pixels, so the lanes'
//     shared loads of R fall in 32 distinct banks and each pixel's part
//     of the store is whole 32-byte sectors; no division in the loop (a
//     thread's first pixel and vector group come from one division, then
//     step).  Lanes on 32 consecutive vectors meet banks 2-way at D=64
//     and 8-way at D=256; a lane per pixel stores D bytes apart (PERF.md);
//   * vectors, where a row's W * D costs fill whole vectors: thread t
//     takes vectors t, t + SEG, ... (a warp 512 contiguous bytes), its
//     (x, d) from the vector's index by one division, then d stepped and
//     x when d reaches D (a vector may span pixels, or many at small D);
//   * elements, for rows of W * D costs that are not whole vectors, or a
//     segment whose staging passes 48 KB: volume_kernel, one element a
//     thread, its x = e / D by a division per element.
// The narrowing cast (T)c keeps c's low bytes, which is what the packing
// stores; the clamp at column 0 is in the staging, not in the loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads of the element kernel
constexpr int SEG = 256;  // pixels (and threads) of a staged block

// ------------------------------------------------------------ elements

template <typename T, bool CENSUS>
__global__ void __launch_bounds__(NT)
volume_kernel(const int* __restrict__ ref, const int* __restrict__ other,
              T* __restrict__ vol, long long rows, int W, int D) {
  const int per_row = W * D;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int* l = ref + row * W;
    const int* r = other + row * W;
    T* out = vol + row * per_row;
    for (int e = threadIdx.x; e < per_row; e += NT) {
      const int x = e / D;
      const int d = e - x * D;
      const int a = l[x];
      const int b = r[max(x - d, 0)];
      const int c = CENSUS ? __popc(a ^ b) : abs(a - b);
      out[e] = (T)c;
    }
  }
}

// -------------------------------------------------------------- staged

// Shared memory of a staged block: L of SEG pixels, R of SEG + D - 1.
long long staged_smem_bytes(int D) { return 4LL * (2 * SEG + D - 1); }

constexpr long long STAGED_SMEM_LIMIT = 48 * 1024;

template <bool CENSUS>
__device__ __forceinline__ int cost(int a, int b) {
  return CENSUS ? __popc(a ^ b) : abs(a - b);
}

// V costs as one 16-byte vector, each narrowed to T: its low bytes.
template <typename T> __device__ __forceinline__ uint4 pack(const int* c);
template <> __device__ __forceinline__ uint4 pack<int8_t>(const int* c) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = __byte_perm(__byte_perm(c[4 * i], c[4 * i + 1], 0x0040),
                       __byte_perm(c[4 * i + 2], c[4 * i + 3], 0x0040), 0x5410);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <> __device__ __forceinline__ uint4 pack<int16_t>(const int* c) {
  return make_uint4(__byte_perm(c[0], c[1], 0x5410), __byte_perm(c[2], c[3], 0x5410),
                    __byte_perm(c[4], c[5], 0x5410), __byte_perm(c[6], c[7], 0x5410));
}
template <> __device__ __forceinline__ uint4 pack<int32_t>(const int* c) {
  return make_uint4(c[0], c[1], c[2], c[3]);
}

// Stage the segment's L[x0 .. x0 + n_px) into ls and R[max(x0 - (D - 1)
// + j, 0)], j < n_px + D - 1, into rs: rs[x - d + D - 1] is then
// R[max(x0 + x - d, 0)] for the segment's pixel x.
__device__ __forceinline__ void stage(int* ls, int* rs, const int* __restrict__ l,
                                      const int* __restrict__ r, int x0, int n_px, int D) {
  for (int i = threadIdx.x; i < n_px; i += SEG) ls[i] = l[x0 + i];
  for (int i = threadIdx.x; i < n_px + D - 1; i += SEG) rs[i] = r[max(x0 - (D - 1) + i, 0)];
  __syncthreads();
}

// Pixels: D a multiple of 32, so no vector spans two pixels.  A warp's
// store takes P = 32 / V lanes of each of V pixels, P consecutive vectors
// of each pixel's run (32 B at int8, 64 B at int16, 128 B at int32): the
// lanes' shared loads rs[x - cV - i] then fall in 32 distinct banks.
// Warp-instruction q of the segment takes pixel group q / (D / 32) and
// vector group q % (D / 32), divided once per thread and then stepped by
// the block's warps.
template <typename T, bool CENSUS>
__global__ void __launch_bounds__(SEG)
pixel_kernel(const int* __restrict__ ref, const int* __restrict__ other, T* __restrict__ vol,
             int W, int D, int segs) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int P = 32 / V;  // lanes a pixel
  extern __shared__ int smem[];
  int* const ls = smem;
  int* const rs = smem + SEG;
  const long long row = blockIdx.x / segs;  // b * H + y
  const int x0 = (int)(blockIdx.x % segs) * SEG;
  const int n_px = min(SEG, W - x0);
  stage(ls, rs, ref + row * W, other + row * W, x0, n_px, D);
  const int vp = D / V, groups = D / 32;  // vectors, and groups of P, a pixel
  const int lane = threadIdx.x & 31, lx = lane / P, lc = lane % P;
  constexpr int WARPS = SEG / 32;
  int pg = (threadIdx.x >> 5) / groups, cg = (threadIdx.x >> 5) - pg * groups;
  const int step_pg = WARPS / groups, step_cg = WARPS - step_pg * groups;
  uint4* const out = reinterpret_cast<uint4*>(vol + (row * W + x0) * (long long)D);
  for (; pg * V < n_px; pg += step_pg) {
    const int x = pg * V + lx, c = cg * P + lc;
    if (x < n_px) {
      const int a = ls[x];
      const int* const rp = rs + x - c * V + D - 1;  // rp[-i] = R[max(x0 + x - cV - i, 0)]
      int cs[V];
#pragma unroll
      for (int i = 0; i < V; ++i) cs[i] = cost<CENSUS>(a, rp[-i]);
      out[x * vp + c] = pack<T>(cs);
    }
    cg += step_cg;
    if (cg >= groups) {
      cg -= groups;
      ++pg;
    }
  }
}

// Vectors: a row's W * D costs fill whole vectors (D not a multiple of
// 32).  Thread t writes vectors t, t + SEG, ... of the segment's run.
template <typename T, bool CENSUS>
__global__ void __launch_bounds__(SEG)
vector_kernel(const int* __restrict__ ref, const int* __restrict__ other, T* __restrict__ vol,
              int W, int D, int segs) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ int smem[];
  int* const ls = smem;
  int* const rs = smem + SEG;
  const long long row = blockIdx.x / segs;
  const int x0 = (int)(blockIdx.x % segs) * SEG;
  const int n_px = min(SEG, W - x0);
  stage(ls, rs, ref + row * W, other + row * W, x0, n_px, D);
  const int n_vec = n_px * D / V;  // whole: (W - x0) * D and SEG * D costs fill vectors
  uint4* const out = reinterpret_cast<uint4*>(vol + (row * W + x0) * (long long)D);
  for (int v = threadIdx.x; v < n_vec; v += SEG) {
    const int e0 = v * V;
    int x = e0 / D, d = e0 - x * D;
    int a = ls[x], j = x - d + D - 1;  // rs[j] = R[max(x0 + x - d, 0)]
    int c[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      c[i] = cost<CENSUS>(a, rs[j]);
      if (i == V - 1) break;
      if (++d == D) {  // the next pixel
        d = 0;
        ++x;
        a = ls[x];
        j = x + D - 1;
      } else {
        --j;
      }
    }
    out[v] = pack<T>(c);
  }
}

// Routes (ops/fused_sgm.py k3_route mirrors them).
enum Route { ELEMENTS = 0, VECTORS = 1, PIXELS = 2 };

int route_of(int W, int D, int esz) {
  if (staged_smem_bytes(D) > STAGED_SMEM_LIMIT) return ELEMENTS;
  if (D % 32 == 0) return PIXELS;
  if ((long long)W * D * esz % 16 == 0) return VECTORS;
  return ELEMENTS;
}

template <typename T>
cudaError_t launch(const int* ref, const int* other, void* vol, long long rows, int W, int D,
                   bool census, int route, cudaStream_t st) {
  if (route == ELEMENTS) {
    const int grid = (int)(rows < (1LL << 30) ? rows : (1LL << 30));
    if (census)
      volume_kernel<T, true><<<grid, NT, 0, st>>>(ref, other, (T*)vol, rows, W, D);
    else
      volume_kernel<T, false><<<grid, NT, 0, st>>>(ref, other, (T*)vol, rows, W, D);
    return cudaGetLastError();
  }
  const int segs = (W + SEG - 1) / SEG;
  const long long blocks = rows * segs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = (int)staged_smem_bytes(D);
  auto kernel = route == PIXELS ? (census ? pixel_kernel<T, true> : pixel_kernel<T, false>)
                                : (census ? vector_kernel<T, true> : vector_kernel<T, false>);
  kernel<<<(unsigned)blocks, SEG, smem, st>>>(ref, other, (T*)vol, W, D, segs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The route of a volume of W columns, D disparities and `elem_bytes` (1,
// 2, 4) per element: 0 elements, 1 vectors, 2 pixels (ops/fused_sgm.py
// k3_route mirrors it); -1 for another width.
int sgm_volume_route(int W, int D, int elem_bytes) {
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4) return -1;
  return route_of(W, D, elem_bytes);
}

// ref, other: int32 [B, H, W].  vol: [B, H, W, D] of `elem_bytes` (1, 2 or
// 4: int8, int16, int32).  census: 1 for popcount(xor), 0 for |a - b|.
// route: the caller's k3_route (0 elements, 1 vectors, 2 pixels); the
// vector routes refuse a shape of another route and a volume whose base
// is not 16-byte aligned.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int sgm_volume(const void* ref, const void* other, void* vol, int B, int H,
               int W, int D, int census, int elem_bytes, int route, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if ((long long)W * D > (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (route != ELEMENTS &&
      (sgm_volume_route(W, D, elem_bytes) != route || (uintptr_t)vol % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H;
  cudaStream_t st = (cudaStream_t)stream;
  const int* l = (const int*)ref;
  const int* r = (const int*)other;
  switch (elem_bytes) {
    case 1: return (int)launch<int8_t>(l, r, vol, rows, W, D, census, route, st);
    case 2: return (int)launch<int16_t>(l, r, vol, rows, W, D, census, route, st);
    case 4: return (int)launch<int32_t>(l, r, vol, rows, W, D, census, route, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
