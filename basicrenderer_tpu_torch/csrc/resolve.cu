// Visibility-buffer attribute resolve for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/resolve_pallas.py::_resolve_kernel (K6),
// called through resolve_attributes_pallas, with and without the tangent
// channel. Wrapper and plain PyTorch version:
// basicrenderer_tpu_torch/ops/resolve.py.
//
// What it computes, per tile of tile_h x tile_w pixels: walk the tile's
// binned setup rows (32 f32 lanes, ops/raster_setup.py) and then the
// global big-triangle rows [0, big_count); wherever a row's triangle id
// (lane 9, truncated to an int) is positive and equals the pixel's vis,
// write the four perspective attribute planes (lanes 15-26) to channels
// 0-3 and the material/object combo (lane 10) to channel 4, and in
// tangent mode the flat per-triangle tangent angle (lane 27) to channel
// 5. The last writer wins. The other channels are zero. Output
// (8, H', W') f32.
//
// The walk starts at the 128-row slab below the tile's range, as the TPU
// kernel's DMA does. The extra rows precede the tile's own rows, and any
// pixel they match is matched again by the row that won it in the raster
// (in the tile's range or the big list), so they never decide a pixel.
//
// Numerics: planes are fma(a, px, b*py) + c with each step rounded to f32,
// the form of ops/raster.py::plane_eval and csrc/raster.cu (the library is
// built with --fmad=false), so the kernel equals its plain version.
//
// What bounds it on this card: the row walk. A (row, pixel) pair costs an
// integer compare; the planes are evaluated only where a pixel matches,
// at most once per pixel per matching row. Memory traffic is the rows
// (128 B each), one vis read and 8 channel writes per pixel.
//
// What the design does about it: one thread block per tile (per
// 4096-pixel slice of a larger tile); each thread owns up to 16 pixels and
// keeps their vis and five channel values (six in tangent mode) in
// registers for the whole walk. Rows are staged into shared memory 128 at a time with coalesced
// loads; a row whose id is not positive is skipped by the whole block.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;
constexpr int kChunk = 128;
constexpr int kMaxPpt = 16;
constexpr int kAttr = 5;
constexpr int kTangentLane = 27;  // flat tangent angle -> channel kAttr

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

// Channels held a pixel: 0-4, and 5 in tangent mode.
template <bool TAN>
constexpr int kCh = TAN ? kAttr + 1 : kAttr;

template <int PPT, bool TAN>
__device__ __forceinline__ void walk(const float* __restrict__ pair_data,
                                     long long start, long long end,
                                     float* rows, const float (&px)[PPT],
                                     const float (&py)[PPT],
                                     const int (&vis)[PPT],
                                     float (&ch)[kCh<TAN>][PPT]) {
  for (long long c0 = start; c0 < end; c0 += kChunk) {
    const int n = (int)min((long long)kChunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    const float* src = pair_data + c0 * kLanes;
    for (int i = threadIdx.x; i < n * kLanes; i += kThreads) rows[i] = src[i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* r = rows + j * kLanes;
      const int id = (int)r[9];
      if (id <= 0) continue;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (vis[k] != id) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ch[c][k] = plane(r[15 + 3 * c], r[16 + 3 * c], r[17 + 3 * c], px[k],
                           py[k]);
        ch[4][k] = r[10];
        if constexpr (TAN) ch[kAttr][k] = r[kTangentLane];
      }
    }
  }
}

template <int PPT, bool TAN>
__global__ void __launch_bounds__(kThreads, 1)
resolve_kernel(const int* __restrict__ tile_offsets,
               const int* __restrict__ big_count,
               const float* __restrict__ pair_data, long long n_rows,
               const int* __restrict__ vis_in, float* __restrict__ chan_out,
               int tiles_x, int tiles_y, int tile_h, int tile_w,
               int tile_row0) {
  __shared__ float rows[kChunk * kLanes];
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int npix = tile_h * tile_w;
  const int pix0 = blockIdx.y * (PPT * kThreads);
  const int width = tiles_x * tile_w;
  const size_t plane_size = (size_t)width * (size_t)(tiles_y * tile_h);

  float px[PPT], py[PPT];
  int vis[PPT];
  float ch[kCh<TAN>][PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix0 + threadIdx.x + k * kThreads;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    px[k] = (float)(tx * tile_w + x) + 0.5f;
    py[k] = (float)((ty + tile_row0) * tile_h + y) + 0.5f;
    vis[k] = p < npix ? vis_in[(size_t)(ty * tile_h + y) * width
                               + (tx * tile_w + x)]
                      : 0;
#pragma unroll
    for (int c = 0; c < kCh<TAN>; ++c) ch[c][k] = 0.0f;
  }

  const long long start =
      min((long long)(tile_offsets[tile] / kChunk) * kChunk, n_rows);
  const long long end = min((long long)tile_offsets[tile + 1], n_rows);
  walk<PPT, TAN>(pair_data, start, end, rows, px, py, vis, ch);
  const long long nbig = min((long long)big_count[0], n_rows);
  walk<PPT, TAN>(pair_data, 0, nbig, rows, px, py, vis, ch);

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix0 + threadIdx.x + k * kThreads;
    if (p >= npix) continue;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
#pragma unroll
    for (int c = 0; c < kCh<TAN>; ++c)
      chan_out[c * plane_size + o] = ch[c][k];
#pragma unroll
    for (int c = kCh<TAN>; c < 8; ++c) chan_out[c * plane_size + o] = 0.0f;
  }
}

int pixels_per_thread(int npix) {
  const int per_block = npix < kMaxPpt * kThreads ? npix : kMaxPpt * kThreads;
  int ppt = 1;
  while (ppt * kThreads < per_block) ppt *= 2;
  return ppt;
}

}  // namespace

// Launches K6 on `stream`; returns cudaGetLastError() (0 = launched).
// pair_data: (n_rows, 32) f32; tile_offsets: (tiles_x*tiles_y + 1,) i32;
// big_count: (1,) i32; vis: (tiles_y*tile_h, tiles_x*tile_w) i32;
// channels: (8, tiles_y*tile_h, tiles_x*tile_w) f32. tangent != 0 writes
// lane 27 to channel 5. All contiguous, on device.
extern "C" int br_resolve(const int* tile_offsets, const int* big_count,
                          const float* pair_data, long long n_rows,
                          const int* vis, float* channels, int tiles_x,
                          int tiles_y, int tile_h, int tile_w, int tile_row0,
                          int tangent, void* stream) {
  const int npix = tile_h * tile_w;
  const int ppt = pixels_per_thread(npix);
  const dim3 grid(tiles_x * tiles_y,
                  (npix + ppt * kThreads - 1) / (ppt * kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((tangent ? 100 : 0) + ppt) {
#define BR_CASE(T, P)                                                      \
  case T * 100 + P:                                                        \
    resolve_kernel<P, T != 0><<<grid, kThreads, 0, s>>>(                   \
        tile_offsets, big_count, pair_data, n_rows, vis, channels, tiles_x, \
        tiles_y, tile_h, tile_w, tile_row0);                               \
    break;
    BR_CASE(0, 1)
    BR_CASE(0, 2)
    BR_CASE(0, 4)
    BR_CASE(0, 8)
    BR_CASE(0, 16)
    BR_CASE(1, 1)
    BR_CASE(1, 2)
    BR_CASE(1, 4)
    BR_CASE(1, 8)
    BR_CASE(1, 16)
#undef BR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
