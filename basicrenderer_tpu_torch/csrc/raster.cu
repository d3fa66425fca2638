// Tile rasterizer with fused attribute resolve, for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/raster_pallas.py::_raster_kernel (plain
// mode, tangent channel off). Wrapper and plain PyTorch version:
// basicrenderer_tpu_torch/ops/raster.py.
//
// What it computes, per tile of tile_h x tile_w pixels: walk the tile's
// binned setup rows [tile_offsets[t], tile_offsets[t+1]) of pair_data, then
// the global big-triangle rows [0, big_count), skipping big rows whose tile
// bbox (float lanes 11-14) misses the tile. At each pixel centre evaluate
// the barycentric planes e0, e1 (e2 = 1 - e0 - e1) and the depth plane z;
// a pixel passes when it is inside, the row is live (id lane 9 > 0.5) and
// z beats the stored reverse-Z depth strictly. A passing pixel takes z, the
// id, the four perspective attribute planes (lanes 15-26) and the
// material/object combo (lane 10). Outputs are the padded depth (H', W')
// f32, vis (H', W') i32 and 8 channel planes (8, H', W') f32, channels 5-7
// zero in this mode.
//
// Numerics: every plane is evaluated as fma(a, px, b*py) + c with each step
// rounded to f32 -- the form XLA's CPU backend gives the JAX reference and
// the form the plain version emulates -- so vis and depth match it
// exactly. The library is built with --fmad=false so that no other
// expression is contracted.
//
// What bounds it on this card: instruction throughput. A (row, pixel) pair
// costs ~12 f32 instructions (three plane evaluations, the inside and depth
// tests), and a 1080p frame of ~1.3M triangles walks a few million
// (row, tile) pairs over 4096-pixel tiles, ~10^11 instructions; device
// memory traffic is only the rows (128 B each) and one write per pixel.
// Tiles carry very different row counts, so the busiest tile also bounds
// the tail of the launch.
//
// What the design does about it:
// - One thread block per tile (per 4096-pixel slice of a larger tile); each
//   thread owns up to 16 pixels and keeps their depth, id and five channel
//   values in registers for the whole walk, so the walk touches no memory
//   but the staged rows. No atomics: each block owns its pixels, so the
//   result is deterministic.
// - Rows are staged into shared memory 128 at a time with coalesced loads;
//   every thread then reads each row as a broadcast.
// - Liveness and the big-list bbox test are uniform across the block, so
//   skipped rows cost no divergence; channel planes are only evaluated for
//   passing pixels.
// - The walk covers exactly [start, end): the TPU kernel's round-down to a
//   128-row DMA slab has no reason to exist here.
// Later work: TMA / cp.async double buffering of the row chunks, a warp-
// specialised producer, and finer tiles or tile splitting for busy tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;     // setup row width (ops/raster_setup.py)
constexpr int kThreads = 256;  // threads per block
constexpr int kChunk = 128;    // rows staged in shared memory at a time
constexpr int kMaxPpt = 16;    // pixels per thread at most
constexpr int kAttr = 5;       // channels written in plain mode (0-4)

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

template <int PPT, bool kBBox>
__device__ __forceinline__ void walk_rows(
    const float* __restrict__ pair_data, long long start, long long end,
    float* rows, float txf, float tyf, const float (&px)[PPT],
    const float (&py)[PPT], float (&depth)[PPT], int (&vis)[PPT],
    float (&ch)[kAttr][PPT]) {
  for (long long c0 = start; c0 < end; c0 += kChunk) {
    const int n = (int)min((long long)kChunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    const float* src = pair_data + c0 * kLanes;
    for (int i = threadIdx.x; i < n * kLanes; i += kThreads) rows[i] = src[i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* r = rows + j * kLanes;
      const float id = r[9];
      if (!(id > 0.5f)) continue;
      if (kBBox && !(txf >= r[11] && txf <= r[12] && tyf >= r[13] &&
                     tyf <= r[14]))
        continue;
      const float a0 = r[0], b0 = r[1], c0e = r[2];
      const float a1 = r[3], b1 = r[4], c1e = r[5];
      const float az = r[6], bz = r[7], cz = r[8];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float e0 = plane(a0, b0, c0e, px[k], py[k]);
        const float e1 = plane(a1, b1, c1e, px[k], py[k]);
        const float e2 = __fsub_rn(__fsub_rn(1.0f, e0), e1);
        const float z = plane(az, bz, cz, px[k], py[k]);
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z > depth[k]) {
          depth[k] = z;
          vis[k] = (int)id;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ch[c][k] = plane(r[15 + 3 * c], r[16 + 3 * c], r[17 + 3 * c],
                             px[k], py[k]);
          ch[4][k] = r[10];
        }
      }
    }
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
raster_tiles_kernel(const int* __restrict__ tile_offsets,
                    const int* __restrict__ big_count,
                    const float* __restrict__ pair_data, long long n_rows,
                    float* __restrict__ depth_out, int* __restrict__ vis_out,
                    float* __restrict__ chan_out, int tiles_x, int tiles_y,
                    int tile_h, int tile_w, int tile_row0) {
  __shared__ float rows[kChunk * kLanes];
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int npix = tile_h * tile_w;
  const int pix0 = blockIdx.y * (PPT * kThreads);
  const int width = tiles_x * tile_w;
  const size_t plane_size = (size_t)width * (size_t)(tiles_y * tile_h);

  float px[PPT], py[PPT], depth[PPT];
  int vis[PPT];
  float ch[kAttr][PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix0 + threadIdx.x + k * kThreads;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    // Integer sums are exact in f32 below 2^24: the same pixel centres the
    // JAX package builds from f32 iotas.
    px[k] = (float)(tx * tile_w + x) + 0.5f;
    py[k] = (float)((ty + tile_row0) * tile_h + y) + 0.5f;
    depth[k] = 0.0f;
    vis[k] = 0;
#pragma unroll
    for (int c = 0; c < kAttr; ++c) ch[c][k] = 0.0f;
  }
  const float txf = (float)tx;
  const float tyf = (float)(ty + tile_row0);

  const long long start = min((long long)tile_offsets[tile], n_rows);
  const long long end = min((long long)tile_offsets[tile + 1], n_rows);
  walk_rows<PPT, false>(pair_data, start, end, rows, txf, tyf, px, py, depth,
                        vis, ch);
  const long long nbig = min((long long)big_count[0], n_rows);
  walk_rows<PPT, true>(pair_data, 0, nbig, rows, txf, tyf, px, py, depth, vis,
                       ch);

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix0 + threadIdx.x + k * kThreads;
    if (p >= npix) continue;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
    depth_out[o] = depth[k];
    vis_out[o] = vis[k];
#pragma unroll
    for (int c = 0; c < kAttr; ++c) chan_out[c * plane_size + o] = ch[c][k];
#pragma unroll
    for (int c = kAttr; c < 8; ++c) chan_out[c * plane_size + o] = 0.0f;
  }
}

template <int PPT>
void launch(dim3 grid, cudaStream_t stream, const int* tile_offsets,
            const int* big_count, const float* pair_data, long long n_rows,
            float* depth, int* vis, float* channels, int tiles_x, int tiles_y,
            int tile_h, int tile_w, int tile_row0) {
  raster_tiles_kernel<PPT><<<grid, kThreads, 0, stream>>>(
      tile_offsets, big_count, pair_data, n_rows, depth, vis, channels,
      tiles_x, tiles_y, tile_h, tile_w, tile_row0);
}

}  // namespace

// Launches the raster on `stream`; returns cudaGetLastError() (0 = launched).
// pair_data: (n_rows, 32) f32; tile_offsets: (tiles_x*tiles_y + 1,) i32;
// big_count: (1,) i32; depth/vis: (tiles_y*tile_h, tiles_x*tile_w);
// channels: (8, tiles_y*tile_h, tiles_x*tile_w). All contiguous, on device.
extern "C" int br_raster_tiles(const int* tile_offsets, const int* big_count,
                               const float* pair_data, long long n_rows,
                               float* depth, int* vis, float* channels,
                               int tiles_x, int tiles_y, int tile_h,
                               int tile_w, int tile_row0, void* stream) {
  const int npix = tile_h * tile_w;
  const int per_block = npix < kMaxPpt * kThreads ? npix : kMaxPpt * kThreads;
  int ppt = 1;
  while (ppt * kThreads < per_block) ppt *= 2;
  const int slices = (npix + ppt * kThreads - 1) / (ppt * kThreads);
  const dim3 grid(tiles_x * tiles_y, slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
#define BR_CASE(P)                                                          \
  case P:                                                                   \
    launch<P>(grid, s, tile_offsets, big_count, pair_data, n_rows, depth,   \
              vis, channels, tiles_x, tiles_y, tile_h, tile_w, tile_row0); \
    break;
    BR_CASE(1)
    BR_CASE(2)
    BR_CASE(4)
    BR_CASE(8)
    BR_CASE(16)
#undef BR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
