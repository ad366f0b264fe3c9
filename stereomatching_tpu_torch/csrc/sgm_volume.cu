// K3: the per-pixel SGM cost volume, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_sgm.py:784
// sgm_volume_pallas (body _volume_kernel, :749).  Semantics
// (models/modern.py _sgm_volume, scales = 1): for int32 cost inputs L, R
// [B, H, W] (census codes for census, pixel intensities for SAD)
//     vol[b, y, x, d] = census ? popcount(L[y, x] ^ R[y, max(x - d, 0)])
//                              : |L[y, x] - R[y, max(x - d, 0)]|
// stored as int8, int16 or int32 (the caller picks the narrowest type the
// cost bound allows; values never wrap).  The layout is [B, H, W, D], d
// innermost, which every SGM path and the tail read D-contiguous.
//
// What bounds it on the H100: device memory.  Each output element is one
// store (1-4 B) against two 4-byte input reads that are shared by the D
// elements of a pixel (they come from L1), and ~5 integer ops.  At
// 32 x 1 MP x D=64 in int8 the volume is 2 GiB of writes.
//
// Design (simple and right first): one block per image row, its threads
// walking the row's W*D outputs in order (x = e / D, d = e % D), so a warp
// stores 32 consecutive elements: full sectors for every storage type.
// Any width and any D; no (8, 128) tiling, no lane rolls, no left-extended
// copy of R (the clamp is an index).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

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

template <typename T>
cudaError_t launch(const int* ref, const int* other, void* vol, long long rows,
                   int W, int D, bool census, cudaStream_t st) {
  const int grid = (int)(rows < (1LL << 30) ? rows : (1LL << 30));
  if (census)
    volume_kernel<T, true><<<grid, NT, 0, st>>>(ref, other, (T*)vol, rows, W, D);
  else
    volume_kernel<T, false><<<grid, NT, 0, st>>>(ref, other, (T*)vol, rows, W, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ref, other: int32 [B, H, W].  vol: [B, H, W, D] of `elem_bytes` (1, 2 or
// 4: int8, int16, int32).  census: 1 for popcount(xor), 0 for |a - b|.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int sgm_volume(const void* ref, const void* other, void* vol, int B, int H,
               int W, int D, int census, int elem_bytes, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if ((long long)W * D > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H;
  cudaStream_t st = (cudaStream_t)stream;
  const int* l = (const int*)ref;
  const int* r = (const int*)other;
  switch (elem_bytes) {
    case 1: return (int)launch<int8_t>(l, r, vol, rows, W, D, census, st);
    case 2: return (int)launch<int16_t>(l, r, vol, rows, W, D, census, st);
    case 4: return (int)launch<int32_t>(l, r, vol, rows, W, D, census, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
