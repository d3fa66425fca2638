// Visibility-buffer attribute resolve for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/resolve_pallas.py::_resolve_kernel (K6),
// called through resolve_attributes_pallas, with and without the tangent
// channel. Wrapper and plain PyTorch version:
// basicrenderer_tpu_torch/ops/resolve.py.
//
// What it computes, per tile of tile_h x tile_w pixels: walk the tile's
// binned setup rows [off[t], off[t+1]) (32 f32 lanes, ops/raster_setup.py)
// and then the global big-triangle rows [0, big_count); wherever a row's
// triangle id (lane 9, truncated to an int) is positive and equals the
// pixel's vis, write the four perspective attribute planes (lanes 15-26)
// to channels 0-3 and the material/object combo (lane 10) to channel 4,
// and in tangent mode the flat per-triangle tangent angle (lane 27) to
// channel 5. The last writer wins. The other channels are zero. Output
// (8, H', W') f32.
//
// So a pixel's answer depends only on (its tile, its vis): the planes of
// the last row of the tile's walk whose id equals vis. The walk starts at
// off[t], as the plain version's does (the TPU kernel starts at the
// 128-row slab below; on a raster's own vis the two agree, on any other
// vis only the plain walk's answer is the function's).
//
// Numerics: planes are fma(a, px, b*py) + c with each step rounded to f32,
// the form of ops/raster.py::plane_eval and csrc/raster.cu (the library is
// built with --fmad=false), so the kernel equals its plain version.
//
// What bounds it on this card: bytes, once the work is what the function
// needs. A walked row decides something only through its id (one 32-byte
// sector of lane 9); a (tile, id) that some pixel shows needs its winning
// row once (128 bytes); a pixel reads its vis and writes 8 channels. The
// old design tested every walked row against every pixel of its tile and
// took as long as its busiest tile.
//
// What the design does about it: three short launches, none of which has
// a block walk a tile.
// 1. id_table_kernel, one block a table unit (a tile, or a 4096-pixel
//    slice of a larger tile): puts the unit's distinct positive vis ids
//    in an open-addressing hash table of 8192 slots in shared memory (at
//    most half full; one lane inserts for each run of equal ids in a
//    warp, found with __match_any_sync), then writes the table, a key of
//    -1 for each filled slot, and each pixel's slot (-1 where vis <= 0).
//    Where an id lands depends on which insert wins a slot, but nothing
//    else does: every reader finds an id by probing the same table. A
//    vis of 2^31 - 1 marks an empty slot and is no id (ids are f32 lanes,
//    exact below 2^24). A bitonic sort of each tile's 4096 ids, tried
//    first, was issue-bound: ~0.08 ms of a 0.11 ms call at 1080p on an
//    H100.
// 2. last_match_kernel, one thread a walked (row, unit) item on a
//    persistent grid: own rows [off[0], off[N]) find their tile by binary
//    search over the staged offsets; the big rows are (unit, j) items.
//    Each reads only its row's lane 9, probes the unit's table for it
//    and, on a hit, does atomicMax(key, walk position): i - off[t] for an
//    own row, kBig + j for big row j (kBig exceeds any own position, so a
//    big row beats an own row, as in the walk). A maximum has no order, so
//    the result does not depend on how the items are scheduled. The item
//    count is read on the device: no host read.
// 3. attr_pixels_kernel, one thread a pixel in image order: reads its slot
//    and key, fetches the winning row where the key is >= 0, evaluates the
//    planes and writes all 8 channels with coalesced stores.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kSlice = 4096;           // pixels a table unit holds at most
constexpr int kTableThreads = 1024;
constexpr int kPerThread = kSlice / kTableThreads;
constexpr int kHashBits = 13;
constexpr int kHash = 1 << kHashBits;  // table slots: at most half are filled
constexpr int kMatchThreads = 256;
constexpr int kMatchBlocksPerSm = 8;
constexpr int kPixelThreads = 256;
constexpr int kBig = 1 << 30;          // walk position of big row 0
constexpr int kEmpty = 0x7fffffff;     // an empty table slot (not an id)
constexpr int kAttr = 5;
constexpr int kTangentLane = 27;       // flat tangent angle -> channel kAttr
constexpr int kMaxTiles = 12287;       // offsets staged: 48 KB at most

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

// The table slot an id's probe starts at.
__device__ __forceinline__ int hash_of(int id) {
  return (int)(((unsigned)id * 2654435761u) >> (32 - kHashBits));
}

// `id`'s slot in a unit's table (linear probing), or -1.
__device__ __forceinline__ int find_slot(const int* table, int id) {
  int h = hash_of(id);
  for (int i = 0; i < kHash; ++i) {
    const int cur = table[h];
    if (cur == id) return h;
    if (cur == kEmpty) return -1;
    h = (h + 1) & (kHash - 1);
  }
  return -1;
}

// Puts `id` in the shared table (a slot only ever goes from kEmpty to an
// id) and returns its slot.
__device__ int insert_id(int* table, int id) {
  int h = hash_of(id);
  while (true) {
    const int cur = reinterpret_cast<volatile int*>(table)[h];
    if (cur == id) return h;
    if (cur == kEmpty) {
      const int prev = atomicCAS(table + h, kEmpty, id);
      if (prev == kEmpty || prev == id) return h;
    }
    h = (h + 1) & (kHash - 1);
  }
}

__global__ void __launch_bounds__(kTableThreads)
id_table_kernel(const int* __restrict__ vis_in, int* __restrict__ ids,
                int* __restrict__ keys, int* __restrict__ slots, int tiles_x,
                int tile_h, int tile_w, int slices) {
  __shared__ int table[kHash];
  const int unit = blockIdx.x;
  const int tile = unit / slices;
  const int p0 = (unit - tile * slices) * kSlice;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int width = tiles_x * tile_w;
  const int n = min(kSlice, tile_h * tile_w - p0);

  // Pixel p of the unit: its place in the image.
  auto image_at = [&](int p) {
    const int y = (p0 + p) / tile_w;
    const int x = (p0 + p) - y * tile_w;
    return (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
  };
  for (int i = threadIdx.x; i < kHash; i += kTableThreads) table[i] = kEmpty;
  int mine[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = threadIdx.x + k * kTableThreads;
    const int v = p < n ? vis_in[image_at(p)] : 0;
    mine[k] = v > 0 && v != kEmpty ? v : 0;   // 0: no slot
  }
  __syncthreads();

  // Each run of equal ids in a warp: its first lane inserts, the others
  // take the slot from it.
  const int lane = threadIdx.x & 31;
  int slot[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const unsigned peers = __match_any_sync(0xffffffffu, mine[k]);
    const int leader = __ffs(peers) - 1;
    int s = -1;
    if (lane == leader && mine[k] != 0) s = insert_id(table, mine[k]);
    slot[k] = __shfl_sync(0xffffffffu, s, leader);
  }
  __syncthreads();

  int* unit_ids = ids + (size_t)unit * kHash;
  int* unit_keys = keys + (size_t)unit * kHash;
  for (int i = threadIdx.x; i < kHash; i += kTableThreads) {
    const int id = table[i];
    unit_ids[i] = id;
    if (id != kEmpty) unit_keys[i] = -1;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = threadIdx.x + k * kTableThreads;
    if (p < n) slots[image_at(p)] = slot[k];
  }
}

__global__ void __launch_bounds__(kMatchThreads)
last_match_kernel(const int* __restrict__ tile_offsets,
                  const int* __restrict__ big_count,
                  const float* __restrict__ pair_data, long long n_rows,
                  const int* __restrict__ ids, int* __restrict__ keys,
                  int num_tiles, int slices) {
  extern __shared__ int off[];   // tile_offsets, staged
  for (int i = threadIdx.x; i <= num_tiles; i += kMatchThreads)
    off[i] = tile_offsets[i];
  __syncthreads();
  const long long first = min((long long)off[0], n_rows);
  const long long n_own =
      max(min((long long)off[num_tiles], n_rows) - first, 0LL);
  const long long nbig = min((long long)big_count[0], n_rows);
  const long long total = n_own + (long long)num_tiles * slices * nbig;
  for (long long w = (long long)blockIdx.x * kMatchThreads + threadIdx.x;
       w < total; w += (long long)gridDim.x * kMatchThreads) {
    if (w < n_own) {
      const long long row = first + w;
      const int id = (int)pair_data[row * kLanes + 9];
      if (id <= 0 || id == kEmpty) continue;
      // The tile whose range holds the row: the last t with off[t] <= row.
      int lo = 0, hi = num_tiles - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((long long)off[mid] <= row) lo = mid; else hi = mid - 1;
      }
      const int key = (int)(row - off[lo]);
      for (int s = 0; s < slices; ++s) {
        const int unit = lo * slices + s;
        const int slot = find_slot(ids + (size_t)unit * kHash, id);
        if (slot >= 0) atomicMax(keys + (size_t)unit * kHash + slot, key);
      }
    } else {
      const long long q = w - n_own;
      const int unit = (int)(q / nbig);
      const int j = (int)(q - (long long)unit * nbig);
      const int id = (int)pair_data[(long long)j * kLanes + 9];
      if (id <= 0 || id == kEmpty) continue;
      const int slot = find_slot(ids + (size_t)unit * kHash, id);
      if (slot >= 0) atomicMax(keys + (size_t)unit * kHash + slot, kBig + j);
    }
  }
}

template <bool TAN>
__global__ void __launch_bounds__(kPixelThreads)
attr_pixels_kernel(const int* __restrict__ tile_offsets,
                   const float* __restrict__ pair_data,
                   const int* __restrict__ slots, const int* __restrict__ keys,
                   float* __restrict__ chan_out, int tiles_x, int tiles_y,
                   int tile_h, int tile_w, int tile_row0, int slices) {
  const int width = tiles_x * tile_w;
  const size_t plane_size = (size_t)width * (size_t)(tiles_y * tile_h);
  const size_t o = (size_t)blockIdx.x * kPixelThreads + threadIdx.x;
  if (o >= plane_size) return;
  const int y = (int)(o / width);
  const int x = (int)(o - (size_t)y * width);
  const int ty = y / tile_h;
  const int tx = x / tile_w;
  const int yl = y - ty * tile_h;
  const int tile = ty * tiles_x + tx;
  const int unit = tile * slices + (yl * tile_w + (x - tx * tile_w)) / kSlice;
  float ch[kAttr + 1] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int slot = slots[o];
  const int key = slot >= 0 ? keys[(size_t)unit * kHash + slot] : -1;
  if (key >= 0) {
    const long long row = key >= kBig ? (long long)(key - kBig)
                                      : (long long)tile_offsets[tile] + key;
    const float* r = pair_data + row * kLanes;
    const float px = (float)x + 0.5f;
    const float py = (float)((ty + tile_row0) * tile_h + yl) + 0.5f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ch[c] = plane(r[15 + 3 * c], r[16 + 3 * c], r[17 + 3 * c], px, py);
    ch[4] = r[10];
    if constexpr (TAN) ch[kAttr] = r[kTangentLane];
  }
#pragma unroll
  for (int c = 0; c <= kAttr; ++c) chan_out[c * plane_size + o] = ch[c];
  chan_out[6 * plane_size + o] = 0.0f;
  chan_out[7 * plane_size + o] = 0.0f;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace

// Int32 scratch `br_resolve` needs, in elements.
extern "C" long long br_resolve_scratch(int tiles_x, int tiles_y, int tile_h,
                                        int tile_w) {
  const long long slices = (tile_h * tile_w + kSlice - 1) / kSlice;
  const long long units = (long long)tiles_x * tiles_y * slices;
  return units * 2LL * kHash
         + (long long)tiles_x * tile_w * tiles_y * tile_h;
}

// Resident blocks an SM of kernel `kernel` (0 id_table_kernel, 1
// last_match_kernel with num_tiles + 1 offsets staged, 2
// attr_pixels_kernel, 3 its tangent instance).
extern "C" int br_resolve_blocks_per_sm(int kernel, int num_tiles) {
  int n = 0;
  const size_t staged = (size_t)(num_tiles + 1) * sizeof(int);
  switch (kernel) {
    case 0:
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, id_table_kernel,
                                                    kTableThreads, 0);
      break;
    case 1:
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, last_match_kernel,
                                                    kMatchThreads, staged);
      break;
    case 2:
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, attr_pixels_kernel<false>, kPixelThreads, 0);
      break;
    case 3:
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, attr_pixels_kernel<true>, kPixelThreads, 0);
      break;
    default:
      return -1;
  }
  return n;
}

// Launches K6 on `stream` (3 kernels); returns cudaGetLastError() (0 =
// launched). pair_data: (n_rows, 32) f32; tile_offsets: (tiles_x*tiles_y +
// 1,) i32; big_count: (1,) i32; vis: (tiles_y*tile_h, tiles_x*tile_w) i32;
// channels: (8, tiles_y*tile_h, tiles_x*tile_w) f32; scratch:
// br_resolve_scratch(...) i32. tangent != 0 writes lane 27 to channel 5.
// All contiguous, on device.
extern "C" int br_resolve(const int* tile_offsets, const int* big_count,
                          const float* pair_data, long long n_rows,
                          const int* vis, float* channels, int* scratch,
                          int tiles_x, int tiles_y, int tile_h, int tile_w,
                          int tile_row0, int tangent, void* stream) {
  if (tiles_x <= 0 || tiles_y <= 0 || tile_h <= 0 || tile_w <= 0
      || tiles_x * tiles_y > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_tiles = tiles_x * tiles_y;
  const int slices = (tile_h * tile_w + kSlice - 1) / kSlice;
  const long long units = (long long)num_tiles * slices;
  int* ids = scratch;
  int* keys = ids + units * kHash;
  int* slots = keys + units * kHash;

  id_table_kernel<<<(unsigned)units, kTableThreads, 0, s>>>(
      vis, ids, keys, slots, tiles_x, tile_h, tile_w, slices);

  const long long most = n_rows + units * n_rows;   // items, at most
  const long long want = (most + kMatchThreads - 1) / kMatchThreads;
  const int blocks = (int)(want < (long long)sm_count() * kMatchBlocksPerSm
                               ? (want > 0 ? want : 1)
                               : (long long)sm_count() * kMatchBlocksPerSm);
  last_match_kernel<<<blocks, kMatchThreads, (num_tiles + 1) * sizeof(int),
                      s>>>(tile_offsets, big_count, pair_data, n_rows, ids,
                           keys, num_tiles, slices);

  const long long npix = (long long)tiles_x * tile_w * tiles_y * tile_h;
  const unsigned pblocks =
      (unsigned)((npix + kPixelThreads - 1) / kPixelThreads);
  if (tangent)
    attr_pixels_kernel<true><<<pblocks, kPixelThreads, 0, s>>>(
        tile_offsets, pair_data, slots, keys, channels, tiles_x, tiles_y,
        tile_h, tile_w, tile_row0, slices);
  else
    attr_pixels_kernel<false><<<pblocks, kPixelThreads, 0, s>>>(
        tile_offsets, pair_data, slots, keys, channels, tiles_x, tiles_y,
        tile_h, tile_w, tile_row0, slices);
  return (int)cudaGetLastError();
}
