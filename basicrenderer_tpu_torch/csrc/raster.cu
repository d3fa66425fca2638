// Tile rasterizers with fused attribute resolve, for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/raster_pallas.py::_raster_kernel (K1,
// plain mode) and ::_raster_kernel_groups (K2, plain and seeded modes),
// tangent channel off. Wrappers and plain PyTorch versions:
// basicrenderer_tpu_torch/ops/raster.py.
//
// What they compute, per tile of tile_h x tile_w pixels: walk setup rows
// (32 f32 lanes, ops/raster_setup.py) and at each pixel centre evaluate the
// barycentric planes e0, e1 (e2 = 1 - e0 - e1) and the depth plane z; a
// pixel passes when it is inside, the row is live (id lane 9 > 0.5) and z
// beats the stored reverse-Z depth strictly. A passing pixel takes z, the
// id, the four perspective attribute planes (lanes 15-26) and the
// material/object combo (lane 10). Outputs are the padded depth (H', W')
// f32, vis (H', W') i32 and 8 channel planes (8, H', W') f32.
// - K1 walks the tile's binned rows [tile_offsets[t], tile_offsets[t+1])
//   of pair_data, then the global big-triangle rows [0, big_count),
//   skipping big rows whose tile bbox (float lanes 11-14) misses the tile.
//   Channels 5-7 are zero.
// - K2 walks the tile's (group, tile) pairs group_ids[start:end]: each
//   group is group_rows consecutive rows of the lane table, read in place
//   (no per-pair payload). Every row whose float tile bbox misses the tile
//   is skipped -- invalid rows carry inverted boxes and garbage planes, so
//   this test is part of the result, not only a saving. Then the global
//   big-group list: an entry's packed tile box (lo*2048 + hi) is tested
//   first and only covering groups are read. Seeded mode starts from a
//   previous raster's depth, vis and channels (phase 2 of the two-phase
//   occlusion) and keeps the seed's channels 5-7.
//
// Numerics: every plane is evaluated as fma(a, px, b*py) + c with each step
// rounded to f32 -- the form XLA's CPU backend gives the JAX reference and
// the form the plain versions emulate -- so vis and depth match it
// exactly. The library is built with --fmad=false so that no other
// expression is contracted.
//
// What bounds them on this card: instruction throughput. A (row, pixel)
// pair costs ~12 f32 instructions (three plane evaluations, the inside and
// depth tests); device memory traffic is only the rows (128 B each) and
// one read (seeded) and write per pixel. Tiles carry very different row
// counts, so the busiest tile also bounds the tail of a launch.
//
// What the design does about it:
// - One thread block per tile (per 4096-pixel slice of a larger tile); each
//   thread owns up to 16 pixels and keeps their depth, id and five channel
//   values in registers for the whole walk, so the walk touches no memory
//   but the staged rows. No atomics: each block owns its pixels, so the
//   result is deterministic.
// - Rows are staged into shared memory 128 at a time (K2: whole groups,
//   128 / group_rows of them) with coalesced loads; every thread then reads
//   each row as a broadcast.
// - Liveness, the row bbox test and the big-list box tests are uniform
//   across the block, so skipped rows cost no divergence; channel planes
//   are only evaluated for passing pixels.
// - The walk covers exactly the live ranges: the TPU kernel's round-down
//   to a 128-row DMA slab has no reason to exist here.
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

__device__ __forceinline__ bool row_covers(const float* r, float txf,
                                           float tyf) {
  return txf >= r[11] && txf <= r[12] && tyf >= r[13] && tyf <= r[14];
}

// One setup row against this thread's pixels.
template <int PPT>
__device__ __forceinline__ void eval_row(const float* r, const float (&px)[PPT],
                                         const float (&py)[PPT],
                                         float (&depth)[PPT], int (&vis)[PPT],
                                         float (&ch)[kAttr][PPT]) {
  const float id = r[9];
  if (!(id > 0.5f)) return;
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
        ch[c][k] = plane(r[15 + 3 * c], r[16 + 3 * c], r[17 + 3 * c], px[k],
                         py[k]);
      ch[4][k] = r[10];
    }
  }
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
      if (kBBox && !row_covers(r, txf, tyf)) continue;
      eval_row<PPT>(r, px, py, depth, vis, ch);
    }
  }
}

// Pixel centres of this thread's pixels; zeroed or seeded buffers.
template <int PPT>
__device__ __forceinline__ void init_pixels(
    int tx, int ty, int tile_row0, int tile_w, int tile_h, int npix, int pix0,
    int width, size_t plane_size, const float* depth0, const int* vis0,
    const float* chan0, float (&px)[PPT], float (&py)[PPT],
    float (&depth)[PPT], int (&vis)[PPT], float (&ch)[kAttr][PPT]) {
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
    if (depth0 != nullptr && p < npix) {
      const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
      depth[k] = depth0[o];
      vis[k] = vis0[o];
#pragma unroll
      for (int c = 0; c < kAttr; ++c) ch[c][k] = chan0[c * plane_size + o];
    }
  }
}

template <int PPT>
__device__ __forceinline__ void store_pixels(
    int tx, int ty, int tile_w, int tile_h, int npix, int pix0, int width,
    size_t plane_size, const float* chan0, const float (&depth)[PPT],
    const int (&vis)[PPT], const float (&ch)[kAttr][PPT],
    float* __restrict__ depth_out, int* __restrict__ vis_out,
    float* __restrict__ chan_out) {
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
    for (int c = kAttr; c < 8; ++c)
      chan_out[c * plane_size + o] =
          chan0 != nullptr ? chan0[c * plane_size + o] : 0.0f;
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
  init_pixels<PPT>(tx, ty, tile_row0, tile_w, tile_h, npix, pix0, width,
                   plane_size, nullptr, nullptr, nullptr, px, py, depth, vis,
                   ch);
  const float txf = (float)tx;
  const float tyf = (float)(ty + tile_row0);

  const long long start = min((long long)tile_offsets[tile], n_rows);
  const long long end = min((long long)tile_offsets[tile + 1], n_rows);
  walk_rows<PPT, false>(pair_data, start, end, rows, txf, tyf, px, py, depth,
                        vis, ch);
  const long long nbig = min((long long)big_count[0], n_rows);
  walk_rows<PPT, true>(pair_data, 0, nbig, rows, txf, tyf, px, py, depth, vis,
                       ch);
  store_pixels<PPT>(tx, ty, tile_w, tile_h, npix, pix0, width, plane_size,
                    nullptr, depth, vis, ch, depth_out, vis_out, chan_out);
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
raster_groups_kernel(const int* __restrict__ tile_offsets,
                     const int* __restrict__ group_ids,
                     const int* __restrict__ big_ids,
                     const int* __restrict__ big_count,
                     const int* __restrict__ big_bx,
                     const int* __restrict__ big_by,
                     const float* __restrict__ lanes, long long n_groups,
                     int group_rows, int n_pairs_cap, int n_big_cap,
                     const float* __restrict__ depth0,
                     const int* __restrict__ vis0,
                     const float* __restrict__ chan0,
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
  init_pixels<PPT>(tx, ty, tile_row0, tile_w, tile_h, npix, pix0, width,
                   plane_size, depth0, vis0, chan0, px, py, depth, vis, ch);
  const float txf = (float)tx;
  const float tyf = (float)(ty + tile_row0);
  const int group_floats = group_rows * kLanes;

  // This tile's own (group, tile) pairs, kChunk / group_rows groups a stage.
  const int per_stage = kChunk / group_rows;
  const int start = min(tile_offsets[tile], n_pairs_cap);
  const int end = min(tile_offsets[tile + 1], n_pairs_cap);
  for (int p0 = start; p0 < end; p0 += per_stage) {
    const int ng = min(per_stage, end - p0);
    __syncthreads();  // the previous stage is consumed
    for (int i = threadIdx.x; i < ng * group_floats; i += kThreads) {
      const int gi = i / group_floats;
      long long g = group_ids[p0 + gi];
      g = g < 0 ? 0 : (g >= n_groups ? n_groups - 1 : g);
      rows[i] = lanes[g * group_floats + (i - gi * group_floats)];
    }
    __syncthreads();
    for (int j = 0; j < ng * group_rows; ++j) {
      const float* r = rows + j * kLanes;
      if (!row_covers(r, txf, tyf)) continue;
      eval_row<PPT>(r, px, py, depth, vis, ch);
    }
  }

  // The global big-group list: box test first, rows only on overlap.
  const int nbig = min(big_count[0], n_big_cap);
  const int tyg = ty + tile_row0;
  for (int p = 0; p < nbig; ++p) {
    const int bx = big_bx[p], by = big_by[p];
    if (!(tx >= bx / 2048 && tx <= bx % 2048 && tyg >= by / 2048 &&
          tyg <= by % 2048))
      continue;
    __syncthreads();
    long long g = big_ids[p];
    g = g < 0 ? 0 : (g >= n_groups ? n_groups - 1 : g);
    for (int i = threadIdx.x; i < group_floats; i += kThreads)
      rows[i] = lanes[g * group_floats + i];
    __syncthreads();
    for (int j = 0; j < group_rows; ++j) {
      const float* r = rows + j * kLanes;
      if (!row_covers(r, txf, tyf)) continue;
      eval_row<PPT>(r, px, py, depth, vis, ch);
    }
  }
  store_pixels<PPT>(tx, ty, tile_w, tile_h, npix, pix0, width, plane_size,
                    chan0, depth, vis, ch, depth_out, vis_out, chan_out);
}

int pixels_per_thread(int npix) {
  const int per_block = npix < kMaxPpt * kThreads ? npix : kMaxPpt * kThreads;
  int ppt = 1;
  while (ppt * kThreads < per_block) ppt *= 2;
  return ppt;
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
// pair_data: (n_rows, 32) f32; tile_offsets: (tiles_x*tiles_y + 1,) i32;
// big_count: (1,) i32; depth/vis: (tiles_y*tile_h, tiles_x*tile_w);
// channels: (8, tiles_y*tile_h, tiles_x*tile_w). All contiguous, on device.
extern "C" int br_raster_tiles(const int* tile_offsets, const int* big_count,
                               const float* pair_data, long long n_rows,
                               float* depth, int* vis, float* channels,
                               int tiles_x, int tiles_y, int tile_h,
                               int tile_w, int tile_row0, void* stream) {
  const int npix = tile_h * tile_w;
  const int ppt = pixels_per_thread(npix);
  const dim3 grid(tiles_x * tiles_y, (npix + ppt * kThreads - 1) / (ppt * kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
#define BR_CASE(P)                                                         \
  case P:                                                                  \
    raster_tiles_kernel<P><<<grid, kThreads, 0, s>>>(                      \
        tile_offsets, big_count, pair_data, n_rows, depth, vis, channels,  \
        tiles_x, tiles_y, tile_h, tile_w, tile_row0);                      \
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

// Launches K2 on `stream`; returns cudaGetLastError() (0 = launched).
// lanes: (n_groups*group_rows, 32) f32; group_ids: (n_pairs_cap,) i32;
// tile_offsets: (tiles + 1,) i32 ranges into group_ids; big_ids, big_bx,
// big_by: (n_big_cap,) i32; big_count: (1,) i32. depth0/vis0/chan0 seed the
// buffers (all null: zero start). Outputs as br_raster_tiles. All
// contiguous, on device.
extern "C" int br_raster_groups(
    const int* tile_offsets, const int* group_ids, const int* big_ids,
    const int* big_count, const int* big_bx, const int* big_by,
    const float* lanes, long long n_groups, int group_rows, int n_pairs_cap,
    int n_big_cap, const float* depth0, const int* vis0, const float* chan0,
    float* depth, int* vis, float* channels, int tiles_x, int tiles_y,
    int tile_h, int tile_w, int tile_row0, void* stream) {
  if (group_rows <= 0 || group_rows > kChunk || kChunk % group_rows)
    return (int)cudaErrorInvalidValue;
  if ((depth0 == nullptr) != (vis0 == nullptr) ||
      (depth0 == nullptr) != (chan0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int npix = tile_h * tile_w;
  const int ppt = pixels_per_thread(npix);
  const dim3 grid(tiles_x * tiles_y, (npix + ppt * kThreads - 1) / (ppt * kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
#define BR_CASE(P)                                                          \
  case P:                                                                   \
    raster_groups_kernel<P><<<grid, kThreads, 0, s>>>(                      \
        tile_offsets, group_ids, big_ids, big_count, big_bx, big_by, lanes, \
        n_groups, group_rows, n_pairs_cap, n_big_cap, depth0, vis0, chan0,  \
        depth, vis, channels, tiles_x, tiles_y, tile_h, tile_w, tile_row0); \
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
