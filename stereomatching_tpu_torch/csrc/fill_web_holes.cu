// K2: the web hole-filling diffusion + per-image min/max, for sm_90a.
//
// Replaces the Pallas kernel stereomatching_tpu/ops/fused_diffusion.py:344
// fill_web_holes_pallas(with_range=True) (bodies _kernel_range, _kernel).
// Semantics (ops/diffusion.py, reference src/stereo.c:230-251): with
// X[-1] = X[0] = web,
//     X[t+1][p] = X[t][p] == 0 ? floor((X[p+1] + X[p+W] + X[p-1] + X[p-W]) / 4)
//                              : X[t-1][p]
// for times-1 steps, p a flat index of its own image (x neighbours cross
// rows), reads outside [0, H*W) of the image are 0; then each image's min
// and max of X[times-1].
//
// What bounds it on the H100: a few integer ops per cell and step
// (utils/bench.py k2_bound_ms), once the steps stop going through device
// memory: one launch per step moved ~12 B per cell and step.
//
// Design: all steps in one launch, on tiles in shared memory, as the TPU
// kernel runs them in one VMEM tile.  A block owns TH rows x TW columns of
// one image and stages, for each of its rows and h rows above and below,
// the flat range [r*W + x0 - hc, r*W + x0 + TW + hc): in that view p +- 1
// (crossing rows) and p +- W are plain neighbours inside the tile, with no
// case at the image's x edges, as the sharded step kernel relies on the
// flat wrap.  Cells whose flat index lies outside the image are staged as
// 0 and held at 0.  The halo h is the steps the launch runs (hc, its
// column form, rounded to whole words): the tile's edge rows and words
// are never updated, and after step t only the cells t inside them are
// right, so after h steps the owned cells are.  A cell reads its own
// X[t-1] and only its neighbours' X[t], so X[t+1] overwrites X[t-1] in
// place: two planes in shared memory and one barrier per step.  The
// epilogue writes the owned cells and folds each image's min and max in
// (a block reduction, then atomicMin / atomicMax, which are
// order-independent): no range launch.
//
// Storage from a bound, as the JAX package packs by its value_bound: the
// caller proves the web's values lie in [0, value_bound) (the classic
// pipeline's winner plane, [0, num_shifts], ops/argmax.py), and the
// planes are bytes below 256, 16-bit below 65536, int32 otherwise (a
// resumed web, any values).  Byte cells go four to a word: the four
// neighbour sums as two 16-bit lanes of even and odd bytes, __vcmpeq4 for
// the zero test.  Tiles: bytes 128 x 128 with h <= 16 (54 KB, 3 blocks an
// SM), 16-bit 128 x 64 with h <= 31, int32 64 x 64 with h <= 16.  Where
// times - 1 exceeds a launch's h, launches chain, each handing the next
// both planes (X[t-1], X[t]) in device memory at the storage's width:
// ceil(steps / h_max) launches, the steps split evenly.  Each step
// updates only what the owned cells still need, a region shrinking by a
// row and a cell on every side.  Measured (PERF.md, PR 11): at the
// classic pipeline's 31 steps two launches of h 16 and 15 beat one of 31
// (less halo work), and 3 blocks an SM by registers match 2 and 4.
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

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads of the step kernel
constexpr int FNT = 512;  // threads of the fused kernel
constexpr int FMIN = 3;   // its blocks an SM holds by registers (<= 42 a thread)

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

int blocks_for(long long n, int cap) {
  long long b = (n + NT - 1) / NT;
  return (int)(b < cap ? (b < 1 ? 1 : b) : cap);
}

// ------------------------------------------------------------ fused steps

// Tile shape and most steps a launch of each storage type (bytes, 16-bit,
// int32 cells).
template <typename T> struct Tile;
template <> struct Tile<uint8_t> { static constexpr int TW = 128, TH = 128, HMAX = 16; };
template <> struct Tile<uint16_t> { static constexpr int TW = 128, TH = 64, HMAX = 31; };
template <> struct Tile<int32_t> { static constexpr int TW = 64, TH = 64, HMAX = 16; };

template <typename T>
__host__ __device__ constexpr int cells_per_word() { return 4 / (int)sizeof(T); }

// A cell's bits in its word.
template <typename T>
__host__ __device__ constexpr uint32_t cell_mask() {
  return (uint32_t)((1ull << (32 / cells_per_word<T>())) - 1);
}

// The column halo of h steps in cells: the tile's edge words are never
// updated, so h + (cells a word - 1) cells, rounded to whole words.
template <typename T>
__host__ __device__ int col_halo(int h) {
  constexpr int C = cells_per_word<T>();
  return (h + C - 1 + C - 1) / C * C;
}

// Dynamic shared memory of one block running h steps: two planes of
// (TH + 2h) rows x (TW + 2 col_halo(h)) cells.
template <typename T>
long long fused_smem_bytes(int h) {
  return 2LL * (Tile<T>::TH + 2 * h) * (Tile<T>::TW + 2 * col_halo<T>(h)) * (long long)sizeof(T);
}

// One word of cells after a step: its X[t] `c`, the words left and right
// of it `l`, `r` and above and below it `u`, `d` (X[t]), its X[t-1] `p`.
__device__ __forceinline__ uint32_t step_word(uint8_t, uint32_t c, uint32_t l, uint32_t r,
                                              uint32_t u, uint32_t d, uint32_t p) {
  const uint32_t lw = __funnelshift_l(l, c, 8);  // each cell's p - 1: (c << 8) | (l >> 24)
  const uint32_t rw = __funnelshift_r(c, r, 8);  // each cell's p + 1: (c >> 8) | (r << 24)
  // The four neighbours' sums as 16-bit lanes: even bytes, odd bytes.
  constexpr uint32_t M = 0x00ff00ffu;
  const uint32_t se = (lw & M) + (rw & M) + (u & M) + (d & M);
  const uint32_t so = __byte_perm(lw, 0, 0x4341) + __byte_perm(rw, 0, 0x4341) +
                      __byte_perm(u, 0, 0x4341) + __byte_perm(d, 0, 0x4341);
  const uint32_t avg = ((se >> 2) & M) | ((so << 6) & ~M);
  // 0xff in each byte of c that is not 0: its high bit from the low seven
  // bits' carry or its own.
  const uint32_t nz = ((((c & 0x7f7f7f7fu) + 0x7f7f7f7fu) | c) & 0x80808080u) >> 7;
  const uint32_t keep = nz * 0xffu;
  return (p & keep) | (avg & ~keep);
}

__device__ __forceinline__ uint32_t step_word(uint16_t, uint32_t c, uint32_t l, uint32_t r,
                                              uint32_t u, uint32_t d, uint32_t p) {
  const uint32_t lw = __funnelshift_l(l, c, 16);
  const uint32_t rw = __funnelshift_r(c, r, 16);
  const uint32_t s0 = (lw & 0xffffu) + (rw & 0xffffu) + (u & 0xffffu) + (d & 0xffffu);
  const uint32_t s1 = (lw >> 16) + (rw >> 16) + (u >> 16) + (d >> 16);
  const uint32_t avg = (s0 >> 2) | ((s1 >> 2) << 16);
  const uint32_t nz = ((((c & 0x7fff7fffu) + 0x7fff7fffu) | c) & 0x80008000u) >> 15;
  const uint32_t keep = nz * 0xffffu;
  return (p & keep) | (avg & ~keep);
}

__device__ __forceinline__ uint32_t step_word(int32_t, uint32_t c, uint32_t l, uint32_t r,
                                              uint32_t u, uint32_t d, uint32_t p) {
  // Wrapping int32 sum, floor division by an arithmetic shift.
  return c == 0 ? (uint32_t)((int)(l + r + u + d) >> 2) : p;
}

// The cells of a word whose flat indices f0 .. f0 + C - 1 lie in
// [0, hw): all-ones cells in the mask, the others 0.
template <typename T>
__device__ __forceinline__ uint32_t inside_mask(long long f0, int hw) {
  constexpr int C = cells_per_word<T>();
  if (f0 >= 0 && f0 + C <= hw) return 0xffffffffu;
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (f0 + k >= 0 && f0 + k < hw) m |= cell_mask<T>() << (k * 32 / C);
  return m;
}

// The h steps on the two staged planes of R rows x WS words: step t
// reads X[t0 + t] from plane (t + 1) % 2 and writes X[t0 + t + 1] over
// X[t0 + t - 1] in plane t % 2.  Step s = t + 1 updates only what the
// owned cells (rows h .. R - h - 1, cells hc .. hc + TW - 1) still need
// after it: rows s .. R - s - 1 and the words holding cells hc - h + s ..
// hc + TW + h - s - 1, within rows 1 .. R - 2 and words 1 .. WS - 2 (the
// edge words and rows are never updated).  Thread (band, word column 1 +
// tid % (WS - 2)) walks down its band of that step's rows, carrying the
// words above and at its row, so each word costs four shared loads and
// one store.  MASKED holds cells whose flat index (f00 + row * W + word *
// C + k) is outside [0, hw) at 0.
template <typename T, bool MASKED>
__device__ __forceinline__ void steps(uint32_t* planes, int R, int WS, int h, int hc,
                                      long long f00, int W, int hw) {
  constexpr int C = cells_per_word<T>();
  const int nwc = WS - 2, bands = FNT / nwc;
  const int band = threadIdx.x / nwc, wc = 1 + threadIdx.x % nwc;
  for (int t = 0; t < h; ++t) {
    const uint32_t* cur = planes + ((t + 1) & 1) * R * WS;
    uint32_t* nxt = planes + (t & 1) * R * WS;
    const int s = t + 1, lo = s, hi = R - s;  // rows [lo, hi)
    const int per_band = (hi - lo + bands - 1) / bands;
    const int row0 = lo + band * per_band, row1 = min(row0 + per_band, hi);
    const bool col = wc >= (hc - h + s) / C && wc < (hc + Tile<T>::TW + h - s + C - 1) / C;
    if (band < bands && col && row0 < row1) {
      int o = row0 * WS + wc;
      uint32_t up = cur[o - WS], mid = cur[o];
      for (int row = row0; row < row1; ++row, o += WS) {
        const uint32_t down = cur[o + WS];
        uint32_t v = step_word(T(), mid, cur[o - 1], cur[o + 1], up, down, nxt[o]);
        if (MASKED) v &= inside_mask<T>(f00 + (long long)row * W + wc * C, hw);
        nxt[o] = v;
        up = mid;
        mid = down;
      }
    }
    __syncthreads();
  }
}

// FIRST: stage both planes from the int32 web (X[-1] = X[0]); else from
// the previous launch's planes prev_in, cur_in (storage T).  LAST: write
// X[t0 + steps] as int32 `out` and fold each image's min / max into mn /
// mx; else write both planes to prev_out, cur_out.
template <typename T, bool FIRST, bool LAST>
__global__ void __launch_bounds__(FNT, FMIN)
fused_kernel(const int* __restrict__ web, const T* __restrict__ prev_in,
             const T* __restrict__ cur_in, T* __restrict__ prev_out, T* __restrict__ cur_out,
             int* __restrict__ out, int* __restrict__ mn, int* __restrict__ mx, int H, int W,
             int h, int tiles_x, int tiles_y) {
  using Tl = Tile<T>;
  constexpr int C = cells_per_word<T>();
  extern __shared__ __align__(16) uint32_t fsmem[];
  const int hc = col_halo<T>(h);
  const int R = Tl::TH + 2 * h;           // staged rows
  const int WS = (Tl::TW + 2 * hc) / C;   // staged words a row
  uint32_t* const plane0 = fsmem;             // X[t0 - 1]
  uint32_t* const plane1 = fsmem + R * WS;     // X[t0]
  const int tile = blockIdx.x % (tiles_x * tiles_y);
  const long long img = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = tile / tiles_x * Tl::TH, x0 = tile % tiles_x * Tl::TW;
  const int hw = H * W;
  // Flat index of staged row 0, cell 0.
  const long long f00 = (long long)(y0 - h) * W + x0 - hc;
  const long long ibase = img * (long long)hw;

  // Stage: word (row, wc) holds cells f00 + row * W + wc * C + k.
  for (int i = threadIdx.x; i < R * WS; i += FNT) {
    const int row = i / WS, wc = i - row * WS;
    const long long f0 = f00 + (long long)row * W + wc * C;
    uint32_t wp = 0, wcur = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const long long f = f0 + k;
      if (f >= 0 && f < hw) {
        const int sh = k * 32 / C;
        if constexpr (FIRST) {
          const uint32_t v = (uint32_t)web[ibase + f];
          wcur |= (v & cell_mask<T>()) << sh;
        } else {
          wp |= (uint32_t)prev_in[ibase + f] << sh;
          wcur |= (uint32_t)cur_in[ibase + f] << sh;
        }
      }
    }
    plane0[i] = FIRST ? wcur : wp;
    plane1[i] = wcur;
  }
  __syncthreads();

  // Whether the staged range reaches outside the image (its cells then
  // stay 0): block-uniform.
  const bool masked = f00 < 0 || f00 + (long long)(R - 1) * W + WS * C > hw;
  if (masked)
    steps<T, true>(fsmem, R, WS, h, hc, f00, W, hw);
  else
    steps<T, false>(fsmem, R, WS, h, hc, f00, W, hw);

  // The owned cells: rows y0 .. y0 + TH - 1, columns x0 .. x0 + TW - 1 of
  // the image; staged at row h + dy, cell hc + dx.
  const uint32_t* fin = fsmem + ((h + 1) & 1) * R * WS;  // X[t0 + h]
  const uint32_t* pen = fsmem + (h & 1) * R * WS;        // X[t0 + h - 1]
  const int ny = min(Tl::TH, H - y0), nx = min(Tl::TW, W - x0);
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x; i < ny * Tl::TW; i += FNT) {
    const int dy = i / Tl::TW, dx = i - dy * Tl::TW;
    if (dx >= nx) continue;
    const int cell = (h + dy) * WS * C + hc + dx;
    const int sh = (cell % C) * 32 / C;
    constexpr uint32_t mask = cell_mask<T>();
    const long long g = ibase + (long long)(y0 + dy) * W + x0 + dx;
    const uint32_t v = (fin[cell / C] >> sh) & mask;
    if constexpr (LAST) {
      const int x = (int)v;
      out[g] = x;
      lo = min(lo, x);
      hi = max(hi, x);
    } else {
      cur_out[g] = (T)v;
      prev_out[g] = (T)((pen[cell / C] >> sh) & mask);
    }
  }
  if constexpr (LAST) {
    __shared__ int s_lo[FNT / 32], s_hi[FNT / 32];
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    __syncthreads();
    if (warp == 0) {
      lo = __reduce_min_sync(0xffffffffu, lane < FNT / 32 ? s_lo[lane] : INT_MAX);
      hi = __reduce_max_sync(0xffffffffu, lane < FNT / 32 ? s_hi[lane] : INT_MIN);
      if (lane == 0) {
        atomicMin(mn + img, lo);
        atomicMax(mx + img, hi);
      }
    }
  }
}

template <typename T, bool FIRST, bool LAST>
cudaError_t launch_fused(const int* web, const T* prev_in, const T* cur_in, T* prev_out,
                         T* cur_out, int* out, int* mn, int* mx, int B, int H, int W, int h,
                         cudaStream_t st) {
  const int tiles_x = (W + Tile<T>::TW - 1) / Tile<T>::TW;
  const int tiles_y = (H + Tile<T>::TH - 1) / Tile<T>::TH;
  const long long blocks = (long long)tiles_x * tiles_y * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = (int)fused_smem_bytes<T>(h);
  auto kernel = fused_kernel<T, FIRST, LAST>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, FNT, smem, st>>>(web, prev_in, cur_in, prev_out, cur_out, out, mn,
                                              mx, H, W, h, tiles_x, tiles_y);
  return cudaGetLastError();
}

// The whole diffusion at storage T: ceil(steps / HMAX) launches (one at
// steps 0), the steps split evenly; between launches both planes in
// scratch (four planes of B * H * W cells of T, two used when there are
// two launches).
template <typename T>
cudaError_t run_fused(const int* web, int* out, void* scratch, int* mn, int* mx, int B, int H,
                      int W, int steps, cudaStream_t st) {
  const int n = steps <= 0 ? 1 : (steps + Tile<T>::HMAX - 1) / Tile<T>::HMAX;
  if (n > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  const long long plane = (long long)B * H * W;
  T* s = (T*)scratch;
  T* sets[2][2] = {{s, s + plane}, {s + 2 * plane, s + 3 * plane}};  // (prev, cur)
  for (int k = 0; k < n; ++k) {
    const int h = steps <= 0 ? 0 : steps / n + (k < steps % n ? 1 : 0);
    T* const* src = sets[(k + 1) & 1];  // written by launch k - 1
    T* const* dst = sets[k & 1];
    cudaError_t e;
    if (n == 1)
      e = launch_fused<T, true, true>(web, nullptr, nullptr, nullptr, nullptr, out, mn, mx, B, H, W, h, st);
    else if (k == 0)
      e = launch_fused<T, true, false>(web, nullptr, nullptr, dst[0], dst[1], nullptr, mn, mx, B, H, W, h, st);
    else if (k == n - 1)
      e = launch_fused<T, false, true>(nullptr, src[0], src[1], nullptr, nullptr, out, mn, mx, B, H, W, h, st);
    else
      e = launch_fused<T, false, false>(nullptr, src[0], src[1], dst[0], dst[1], nullptr, mn, mx, B, H, W, h, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Most Jacobi steps one fused launch runs at a storage of `storage_bytes`
// (1, 2, 4) per cell (ops/fused_diffusion.py K2_MAX_STEPS mirrors it); 0
// for another width.
int fill_web_holes_max_steps(int storage_bytes) {
  switch (storage_bytes) {
    case 1: return Tile<uint8_t>::HMAX;
    case 2: return Tile<uint16_t>::HMAX;
    case 4: return Tile<int32_t>::HMAX;
    default: return 0;
  }
}

// Dynamic shared memory of a fused launch running `steps` steps at that
// storage (ops/fused_diffusion.py k2_smem_bytes mirrors it).
long long fill_web_holes_smem_bytes(int storage_bytes, int steps) {
  switch (storage_bytes) {
    case 1: return fused_smem_bytes<uint8_t>(steps);
    case 2: return fused_smem_bytes<uint16_t>(steps);
    case 4: return fused_smem_bytes<int32_t>(steps);
    default: return -1;
  }
}

// web: int32 [B, H, W] (read only), its values in [0, 2^(8 storage_bytes))
// unless storage_bytes is 4.  out: int32 [B, H, W] receives X[times-1].
// scratch: 4 * B * H * W cells of storage_bytes each (null when one launch
// runs all times - 1 steps).  mn/mx: int32 [B], filled by the caller with
// INT_MAX / INT_MIN.  Returns the first launch's error, else
// cudaGetLastError().
int fill_web_holes_range(const void* web, void* out, void* scratch, void* mn, void* mx, int B,
                         int H, int W, int times, int storage_bytes, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  // Flat indices of a tile's staged range, halo included, stay in int.
  if ((long long)(H + 2 * 128) * W + 2 * 128 >= INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int steps = times > 1 ? times - 1 : 0;
  const int* w = (const int*)web;
  switch (storage_bytes) {
    case 1: return (int)run_fused<uint8_t>(w, (int*)out, scratch, (int*)mn, (int*)mx, B, H, W, steps, st);
    case 2: return (int)run_fused<uint16_t>(w, (int*)out, scratch, (int*)mn, (int*)mx, B, H, W, steps, st);
    case 4: return (int)run_fused<int32_t>(w, (int*)out, scratch, (int*)mn, (int*)mx, B, H, W, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
