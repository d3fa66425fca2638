// Tile rasterizers with fused attribute resolve, for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/raster_pallas.py::_raster_kernel (K1)
// and ::_raster_kernel_groups (K2), each in its plain, seeded, peel and
// accum modes, with and without the tangent channel. Wrappers and plain
// PyTorch versions: basicrenderer_tpu_torch/ops/raster.py.
//
// What they compute, per tile of tile_h x tile_w pixels: walk setup rows
// (32 f32 lanes, ops/raster_setup.py) and at each pixel centre evaluate the
// barycentric planes e0, e1 (e2 = 1 - e0 - e1) and the depth plane z; a
// pixel passes when it is inside, the row is live (id lane 9 > 0.5) and z
// beats the stored reverse-Z depth strictly (peel mode: and lies strictly
// in front of the peel bound). A passing pixel takes z, the id, the four
// perspective attribute planes (lanes 15-26) and the material/object combo
// (lane 10); in tangent mode also the flat per-triangle tangent angle
// (lane 27) into channel 5. Outputs are the padded depth (H', W') f32, vis
// (H', W') i32 and 8 channel planes (8, H', W') f32.
// - K1 walks the tile's binned rows [tile_offsets[t], tile_offsets[t+1])
//   of pair_data, then the global big-triangle rows [0, big_count),
//   skipping big rows whose tile bbox (float lanes 11-14) misses the tile.
// - K2 walks the tile's (group, tile) pairs group_ids[start:end]: each
//   group is group_rows consecutive rows of the lane table, read in place.
//   Every row whose float tile bbox misses the tile is skipped (invalid
//   rows carry inverted boxes and garbage planes, so this test is part of
//   the result). Then the global big-group list: an entry's packed tile
//   box (lo*2048 + hi) is tested first and only covering groups are read.
// - Seeded mode starts from a previous raster's depth, vis and channels
//   (phase 2 of the two-phase occlusion) and keeps the seed's channels 6-7,
//   and 5 unless the tangent channel is on; unseeded they are zero. Peel
//   mode (OIT layers, further alpha-MASK layers) starts from a seed depth
//   with vis and channels zero. Accum mode (the OIT tail) leaves depth at
//   its start and vis at 0, and sums per pixel, for every passing fragment
//   in walk order: w*a8/255 and w*rgb8/255 (payload lanes 30, 28) into
//   channels 0-3, the optical depths od8*4/255 (lanes 30, 31) into 4-6 and
//   1 into 7, with w = u*u + 0.05, u = clip((z - seed) / max(bound - seed,
//   1e-6), 0, 1) when a peel band is given, else 1; the weight and the four
//   weighted sums are fused multiply-adds (XLA's CPU form of the reference).
//
// Numerics: every plane is evaluated as fma(a, px, b*py) + c with each step
// rounded to f32 -- the form XLA's CPU backend gives the JAX reference and
// the form the plain versions emulate -- so vis and depth match it
// exactly. The library is built with --fmad=false so that no other
// expression is contracted.
//
// What bounds them on this card: instruction issue. A (row, pixel) pair
// costs ~16 instructions (three plane evaluations, the inside and depth
// tests); device memory traffic is only the rows (128 B each) and a few
// reads and writes per pixel. Tiles carry very different row counts (a
// 1080p soup frame: median 48.5 rows, the busiest tile 20,641), so a
// design in which one block owns a tile for its whole walk lasts as long
// as the busiest tile's walk while the other SMs sit idle.
//
// What the design does about it (plain, seeded and peel modes, +-tangent):
// - The walk's result is a maximum: the row with the largest z among the
//   rows that pass from the tile's start depth, and among equal z the first
//   in walk order. A maximum needs no order, so a tile's walk is cut into
//   spans of `span` rows (K1) or pair entries (K2), and every (span, pixel
//   slice) is a work item. A one-block kernel counts each tile's spans and
//   scans them on the device (no host read) and zeroes the item counter;
//   then a persistent grid (SMs x resident blocks) takes items from that
//   counter, and a block finds an item's tile by binary search.
// - Pass 1 (span_*_kernel): a thread keeps per pixel only the pixel centre,
//   the span's running best z (from the start depth, strict test, so the
//   first of equal z wins inside the span) and that row's walk-order index.
//   At the span's end each pixel that found a row makes one unsigned 64-bit
//   atomicMax of key = (zmap(z) << 32) | (0xFFFFFFFE - order) into a key
//   plane, where zmap is the order-preserving map of a float's bits (for
//   z > 0, its bits with the top bit set). The largest key is the larger z,
//   and among equal z the lower order: the sequential walk's winner,
//   whatever the order in which blocks run. The key plane starts at
//   (zmap(start) << 32) | 0xFFFFFFFF, which every passing row beats (z >
//   start strictly) and no row can equal.
// - Pass 2 (resolve_*_kernel), one thread a pixel: the sentinel keeps the
//   start (depth, vis and channels of the seed, or zeros); otherwise the
//   order maps back to the row (K1: own row start + order, else big row
//   order - own; K2: entry order / group_rows, row order % group_rows,
//   through group_ids or big_ids with the staging's clamp), and the thread
//   recomputes z and writes vis, the four attribute planes, lane 10 and, in
//   tangent mode, lane 27.
// - Occupancy: pass 1 holds 4 values a pixel (5 with the peel bound), 16
//   pixels a thread (peel 8), and is declared for 2 blocks of 256 threads
//   an SM (<= 128 registers); a launch of few tiles (a 128x128 VSM page
//   has 4) takes fewer pixels a block, down to 4 a thread, so that it
//   still spreads over the card.
// - Staging: a span's rows go through a double-buffered ring of 64-row
//   stages in shared memory with cp.async (16 B a thread and copy), so
//   stage c+1 lands while stage c is evaluated; every thread reads each
//   row as a broadcast. K2 copies whole groups behind their group_ids
//   entry, skipping big entries whose box misses the tile.
// - Liveness, the row bbox test and the big-list box tests are uniform
//   across the block, so skipped rows cost no divergence.
// One call launches four kernels: the work queue (one block), the key
// plane's start, pass 1 and the resolve.
//
// Accum mode sums, it does not take a maximum: each pixel's 8 sums are
// fused multiply-adds in walk order, and cutting the walk would change
// their rounding. So a tile is cut by pixels, never by walk: one pixel a
// thread, a block a 256-pixel slice of a tile (16 blocks for a 32 x 128
// tile; slice fastest in the grid, so the slices that read the same rows
// run together and the L2 serves the repeats), each pixel's sums in
// registers for the tile's whole walk. The busiest tile's walk then runs
// on 16 SMs at once. What is the same for every pixel of a row is done
// once a block: the row's liveness and tile bbox tests (K2: the entry's
// box too) and the payload's byte decode and scaling (decode_payload).
// The live covering rows of a stage are compacted, in walk order (ballot
// and popc), to 64-byte records of planes and payload; each pixel then
// evaluates only the three planes, the tests, the weight and the sums.
// - K2 (accum_groups_kernel): the groups come through pass 1's
//   double-buffered cp.async ring (stage_group_entries, kStage rows a
//   stage); warp 0 compacts each landed stage while the other warps wait
//   at a barrier, then all 8 warps sum it.
// - K1 (accum_rows_kernel): warp-specialised. A ninth warp owns no pixel:
//   it keeps the cp.async ring of rows full (stage_tile_rows) and compacts
//   stage c + 1 into the second of two record buffers while the 8 pixel
//   warps sum stage c from the first. Named barriers hand each buffer from
//   the producer to the pixel warps (full) and back (empty), so the
//   compaction's latency hides behind the sums.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;         // setup row width (ops/raster_setup.py)
constexpr int kPieces = kLanes / 4;  // 16-byte pieces of a row
constexpr int kThreads = 256;      // threads per block
constexpr int kStage = 64;         // rows a stage of pass 1's ring
constexpr int kMaxPpt = 16;        // pass 1 pixels per thread (plain)
constexpr int kMaxPptPeel = 8;     // pass 1, peel: + the bound a pixel
constexpr int kMinPpt = 4;         // pass 1 on a launch of few tiles
constexpr int kTangentLane = 27;   // flat tangent angle -> channel 5
constexpr int kAccumCh = 8;        // channels summed in accum mode
// K1 accum: named barriers (0 is __syncthreads) kBarFull + b and
// kBarEmpty + b for record buffer b.
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr unsigned kNone = 0xFFFFFFFFu;  // key low word: no row won
// Accum mode's byte scales, rounded to f32 from their double values as the
// JAX package's f32 constants are.
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kFour255 = (float)(4.0 / 255.0);
constexpr float kInv256 = 1.0f / 256.0f;   // exact

// kPlain: plain or seeded; kPeel: depth-peeling pass; kAccum: the OIT
// tail's sums. The tangent channel only changes what pass 2 writes.
enum Mode : int { kPlain = 0, kPeel = 1, kAccum = 2 };

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

// Lanes 11-14 (the row's tile bbox) of a row held as 8 float4s.
__device__ __forceinline__ bool row_covers(const float4* r, float txf,
                                           float tyf) {
  const float4 q2 = r[2], q3 = r[3];
  return txf >= q2.w && txf <= q3.x && tyf >= q3.y && tyf <= q3.z;
}

// A big-group entry's packed tile box (lo*2048 + hi) covers the tile.
__device__ __forceinline__ bool box_covers(int bx, int by, int tx, int tyg) {
  return tx >= bx / 2048 && tx <= bx % 2048 && tyg >= by / 2048 &&
         tyg <= by % 2048;
}

__device__ __forceinline__ long long clamp_group(long long g,
                                                 long long n_groups) {
  return g < 0 ? 0 : (g >= n_groups ? n_groups - 1 : g);
}

// The 64-bit key of depth z with low word `low`: zmap(z) << 32 | low.
// zmap orders floats as their values (-0 counts as +0).
__device__ __forceinline__ unsigned long long depth_key(float z,
                                                        unsigned low) {
  unsigned u = __float_as_uint(__fadd_rn(z, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | low;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Pass 1: balanced visibility over (span, pixel slice) work items.
// ---------------------------------------------------------------------------

// Takes the block's next item from the queue (queue[0] the counter,
// queue[1 + t] the first span of tile t, queue[1 + tiles] the total).
// Item i is span i / slices of the scan, pixel slice i % slices. Returns
// false when the queue is empty. Every thread of the block calls it.
__device__ __forceinline__ bool take_item(int* queue, int tiles, int slices,
                                          int* item, int& tile, int& span,
                                          int& slice) {
  __syncthreads();  // every thread has read the previous item
  if (threadIdx.x == 0) {
    const int* scan = queue + 1;
    const long long total = (long long)scan[tiles] * slices;
    const long long i = atomicAdd(queue, 1);
    item[0] = -1;
    if (i < total) {
      const int sp = (int)(i / slices);
      int lo = 0, hi = tiles;  // scan[lo] <= sp < scan[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (scan[mid] <= sp) lo = mid; else hi = mid;
      }
      item[0] = lo;
      item[1] = sp - scan[lo];
      item[2] = (int)(i - (long long)sp * slices);
    }
  }
  __syncthreads();
  tile = item[0];
  span = item[1];
  slice = item[2];
  return tile >= 0;
}

// One thread's pixels of a work item: centres, the span's running best z
// and its row's walk order (kNone: none yet), and in peel mode the bound.
template <int PPT, int MODE>
struct Best {
  float px[PPT], py[PPT], z[PPT], bound[MODE == kPeel ? PPT : 1];
  unsigned order[PPT];
};

template <int PPT, int MODE>
__device__ __forceinline__ void start_best(int tx, int ty, int tile_row0,
                                           int tile_w, int tile_h, int npix,
                                           int pix0, int width,
                                           const float* depth0,
                                           const float* peel,
                                           Best<PPT, MODE>& b) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix0 + threadIdx.x + k * kThreads;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    // Integer sums are exact in f32 below 2^24: the same pixel centres the
    // JAX package builds from f32 iotas.
    b.px[k] = (float)(tx * tile_w + x) + 0.5f;
    b.py[k] = (float)((ty + tile_row0) * tile_h + y) + 0.5f;
    b.order[k] = kNone;
    b.z[k] = __int_as_float(0x7f800000);  // past the tile: nothing passes
    if constexpr (MODE == kPeel) b.bound[k] = 0.0f;
    if (p >= npix) continue;
    const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
    b.z[k] = depth0 != nullptr ? depth0[o] : 0.0f;
    if constexpr (MODE == kPeel) b.bound[k] = peel[o];
  }
}

// One staged row (8 float4s) against this thread's pixels.
template <int PPT, int MODE>
__device__ __forceinline__ void test_row(const float4* r, unsigned order,
                                         Best<PPT, MODE>& b) {
  const float4 q0 = r[0], q1 = r[1], q2 = r[2];
  // q0 = lanes 0-3 (a0 b0 c0 a1), q1 = 4-7 (b1 c1 az bz), q2 = 8-11
  // (cz, id, combo, bbox x0).
  if (!(q2.y > 0.5f)) return;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float e0 = plane(q0.x, q0.y, q0.z, b.px[k], b.py[k]);
    const float e1 = plane(q0.w, q1.x, q1.y, b.px[k], b.py[k]);
    const float e2 = __fsub_rn(__fsub_rn(1.0f, e0), e1);
    const float z = plane(q1.z, q1.w, q2.x, b.px[k], b.py[k]);
    bool pass = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z > b.z[k];
    if constexpr (MODE == kPeel) pass = pass && z < b.bound[k];
    if (pass) {
      b.z[k] = z;
      b.order[k] = order;
    }
  }
}

// Each pixel that found a row offers its key to the key plane. A key not
// above the plane's current value (read from L2; it only grows) is dropped
// without an atomic.
template <int PPT, int MODE>
__device__ __forceinline__ void publish(const Best<PPT, MODE>& b, int tx,
                                        int ty, int tile_w, int tile_h,
                                        int pix0, int width,
                                        unsigned long long* keys) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (b.order[k] == kNone) continue;
    const int p = pix0 + threadIdx.x + k * kThreads;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
    const unsigned long long key = depth_key(b.z[k], kNone - 1u - b.order[k]);
    if (key > __ldcg(keys + o)) atomicMax(keys + o, key);
  }
}

// K1 rows [c0, c0 + n) of a tile's walk into a ring stage: walk index w is
// own row start + w below `own`, else big row w - own. Threads `tid` of
// `nthreads` copy (pass 1: the whole block; accum: the producer warp).
__device__ __forceinline__ void stage_tile_rows(float4* dst,
                                                const float* pair_data,
                                                long long start,
                                                long long own, long long c0,
                                                int n, int tid, int nthreads) {
  for (int q = tid; q < n * kPieces; q += nthreads) {
    const long long w = c0 + q / kPieces;
    const long long row = w < own ? start + w : w - own;
    cp_async16(dst + q, pair_data + row * kLanes + (q % kPieces) * 4);
  }
  cp_async_commit();
}

template <int PPT, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
span_tiles_kernel(int* __restrict__ queue, const int* __restrict__ tile_offsets,
                  const int* __restrict__ big_count,
                  const float* __restrict__ pair_data, long long n_rows,
                  const float* __restrict__ depth0,
                  const float* __restrict__ peel,
                  unsigned long long* __restrict__ keys, int tiles_x,
                  int tiles_y, int tile_h, int tile_w, int tile_row0,
                  int slices, int span) {
  __shared__ float4 ring[2][kStage * kPieces];
  __shared__ int item[3];
  const int npix = tile_h * tile_w;
  const int width = tiles_x * tile_w;
  const long long nbig = max(0LL, min((long long)big_count[0], n_rows));
  int tile, sp, slice;
  while (take_item(queue, tiles_x * tiles_y, slices, item, tile, sp, slice)) {
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const long long start = min((long long)tile_offsets[tile], n_rows);
    const long long own =
        max(0LL, min((long long)tile_offsets[tile + 1], n_rows) - start);
    const long long w0 = (long long)sp * span;
    const long long w1 = min(w0 + span, own + nbig);
    const int pix0 = slice * PPT * kThreads;
    Best<PPT, MODE> b;
    start_best<PPT, MODE>(tx, ty, tile_row0, tile_w, tile_h, npix, pix0,
                          width, depth0, peel, b);
    const float txf = (float)tx;
    const float tyf = (float)(ty + tile_row0);
    const int stages = (int)((w1 - w0 + kStage - 1) / kStage);
    stage_tile_rows(ring[0], pair_data, start, own, w0,
                    (int)min((long long)kStage, w1 - w0), threadIdx.x,
                    kThreads);
    for (int c = 0; c < stages; ++c) {
      const long long c0 = w0 + (long long)c * kStage;
      const int n = (int)min((long long)kStage, w1 - c0);
      if (c + 1 < stages) {
        stage_tile_rows(ring[(c + 1) & 1], pair_data, start, own,
                        c0 + kStage,
                        (int)min((long long)kStage, w1 - c0 - kStage),
                        threadIdx.x, kThreads);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // stage c has landed for every thread
      const float4* rows = ring[c & 1];
      for (int j = 0; j < n; ++j) {
        const float4* r = rows + j * kPieces;
        const long long w = c0 + j;
        if (w >= own && !row_covers(r, txf, tyf)) continue;
        test_row<PPT, MODE>(r, (unsigned)w, b);
      }
      __syncthreads();  // stage c is consumed before it is refilled
    }
    publish<PPT, MODE>(b, tx, ty, tile_w, tile_h, pix0, width, keys);
  }
}

// K2: the group of walk entry e of a tile (own pair below `own`, else big
// entry e - own), clamped to the lane table; -1 when a big entry's box
// misses the tile.
__device__ __forceinline__ long long entry_group(
    long long e, long long start, long long own, const int* group_ids,
    const int* big_ids, const int* big_bx, const int* big_by,
    long long n_groups, int tx, int tyg) {
  if (e < own) return clamp_group(group_ids[start + e], n_groups);
  const long long p = e - own;
  if (!box_covers(big_bx[p], big_by[p], tx, tyg)) return -1;
  return clamp_group(big_ids[p], n_groups);
}

// K2 walk entries [c0, c0 + ne) of a tile into a ring stage: the whole
// group behind each entry (own pair, then big entry), 16 B a thread and
// copy. A big entry whose box misses the tile is not copied: its slot
// keeps stale rows, and the walk skips the entry.
__device__ __forceinline__ void stage_group_entries(
    float4* dst, long long c0, int ne, long long start, long long own,
    const int* group_ids, const int* big_ids, const int* big_bx,
    const int* big_by, const float* lanes, long long n_groups,
    int group_rows, int tx, int tyg) {
  const int group_pieces = group_rows * kPieces;
  for (int q = threadIdx.x; q < ne * group_pieces; q += kThreads) {
    const int ei = q / group_pieces;
    const long long g = entry_group(c0 + ei, start, own, group_ids, big_ids,
                                    big_bx, big_by, n_groups, tx, tyg);
    if (g < 0) continue;
    cp_async16(dst + q, lanes + (g * group_rows) * kLanes +
                            (q - ei * group_pieces) * 4);
  }
  cp_async_commit();
}

template <int PPT, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
span_groups_kernel(int* __restrict__ queue,
                   const int* __restrict__ tile_offsets,
                   const int* __restrict__ group_ids,
                   const int* __restrict__ big_ids,
                   const int* __restrict__ big_count,
                   const int* __restrict__ big_bx,
                   const int* __restrict__ big_by,
                   const float* __restrict__ lanes, long long n_groups,
                   int group_rows, int n_pairs_cap, int n_big_cap,
                   const float* __restrict__ depth0,
                   const float* __restrict__ peel,
                   unsigned long long* __restrict__ keys, int tiles_x,
                   int tiles_y, int tile_h, int tile_w, int tile_row0,
                   int slices, int span) {
  __shared__ float4 ring[2][kStage * kPieces];
  __shared__ int item[3];
  const int npix = tile_h * tile_w;
  const int width = tiles_x * tile_w;
  const long long nbig = max(0, min(big_count[0], n_big_cap));
  const int per_stage = kStage / group_rows;   // entries a stage
  int tile, sp, slice;
  while (take_item(queue, tiles_x * tiles_y, slices, item, tile, sp, slice)) {
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int tyg = ty + tile_row0;
    const long long start = min(tile_offsets[tile], n_pairs_cap);
    const long long own =
        max(0LL, (long long)min(tile_offsets[tile + 1], n_pairs_cap) - start);
    const long long e0 = (long long)sp * span;
    const long long e1 = min(e0 + span, own + nbig);
    const int pix0 = slice * PPT * kThreads;
    Best<PPT, MODE> b;
    start_best<PPT, MODE>(tx, ty, tile_row0, tile_w, tile_h, npix, pix0,
                          width, depth0, peel, b);
    const float txf = (float)tx;
    const float tyf = (float)tyg;
    const int stages = (int)((e1 - e0 + per_stage - 1) / per_stage);
    auto stage = [&](float4* dst, long long c0, int ne) {
      stage_group_entries(dst, c0, ne, start, own, group_ids, big_ids, big_bx,
                          big_by, lanes, n_groups, group_rows, tx, tyg);
    };
    stage(ring[0], e0, (int)min((long long)per_stage, e1 - e0));
    for (int c = 0; c < stages; ++c) {
      const long long c0 = e0 + (long long)c * per_stage;
      const int ne = (int)min((long long)per_stage, e1 - c0);
      if (c + 1 < stages) {
        stage(ring[(c + 1) & 1], c0 + per_stage,
              (int)min((long long)per_stage, e1 - c0 - per_stage));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4* rows = ring[c & 1];
      for (int ei = 0; ei < ne; ++ei) {
        const long long e = c0 + ei;
        if (e >= own) {
          const long long p = e - own;
          if (!box_covers(big_bx[p], big_by[p], tx, tyg)) continue;
        }
        for (int j = 0; j < group_rows; ++j) {
          const float4* r = rows + (ei * group_rows + j) * kPieces;
          if (!row_covers(r, txf, tyf)) continue;
          test_row<PPT, MODE>(r, (unsigned)(e * group_rows + j), b);
        }
      }
      __syncthreads();
    }
    publish<PPT, MODE>(b, tx, ty, tile_w, tile_h, pix0, width, keys);
  }
}

// The work queue, one block: queue[0] = 0 (the item counter), queue[1 +
// t] the exclusive scan of the tiles' span counts, queue[1 + tiles] their
// total. Tile t's walk is its own range [offs[t], offs[t+1]) clamped to
// `cap`, then min(big_count, big_cap) big rows or entries, cut into
// ceil(walk / span) spans (plain version: ops/raster.py::span_queue).
__global__ void __launch_bounds__(kThreads)
span_queue_kernel(const int* __restrict__ tile_offsets, long long cap,
                  const int* __restrict__ big_count, long long big_cap,
                  int span, int tiles, int* __restrict__ queue) {
  __shared__ int part[kThreads];
  const long long nbig = max(0LL, min((long long)big_count[0], big_cap));
  const int per = (tiles + kThreads - 1) / kThreads;
  const int t0 = min(tiles, (int)threadIdx.x * per);
  const int t1 = min(tiles, t0 + per);
  auto spans = [&](int t) {  // walks fit in 32 bits: divide in 32 bits
    const long long lo = min((long long)tile_offsets[t], cap);
    const long long own = max(0LL, min((long long)tile_offsets[t + 1], cap) - lo);
    return ((int)(own + nbig) + span - 1) / span;
  };
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += spans(t);
  part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < kThreads; ++i) {
      const int v = part[i];
      part[i] = run;
      run += v;
    }
    queue[0] = 0;
    queue[1 + tiles] = run;
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (int t = t0; t < t1; ++t) {
    queue[1 + t] = run;
    run += spans(t);
  }
}

// The key plane's start: the start depth (the seed, or 0) with no row.
__global__ void init_keys_kernel(const float* __restrict__ depth0,
                                 unsigned long long* __restrict__ keys,
                                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = depth_key(depth0 != nullptr ? depth0[i] : 0.0f, kNone);
}

// ---------------------------------------------------------------------------
// Pass 2: resolve, one thread a pixel of the padded grid.
// ---------------------------------------------------------------------------

// No row won: the start (plain: zeros; seeded: depth, vis and the 8
// channels of the seed; peel: the seed depth, vis and channels zero).
__device__ __forceinline__ void write_start(size_t i, size_t plane_size,
                                            const float* depth0,
                                            const int* vis0,
                                            const float* chan0, float* depth,
                                            int* vis, float* chan) {
  depth[i] = depth0 != nullptr ? depth0[i] : 0.0f;
  vis[i] = vis0 != nullptr ? vis0[i] : 0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    chan[c * plane_size + i] =
        chan0 != nullptr ? chan0[c * plane_size + i] : 0.0f;
}

// Row r won pixel (x, yg) (yg in global screen rows): z, its id, the four
// attribute planes and lane 10, in tangent mode lane 27 into channel 5;
// the seed's other channels (zero unseeded).
__device__ __forceinline__ void write_winner(const float* __restrict__ r,
                                             int x, int yg, size_t i,
                                             size_t plane_size,
                                             const float* chan0, int tangent,
                                             float* depth, int* vis,
                                             float* chan) {
  const float px = (float)x + 0.5f;
  const float py = (float)yg + 0.5f;
  depth[i] = plane(r[6], r[7], r[8], px, py);
  vis[i] = (int)r[9];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    chan[c * plane_size + i] =
        plane(r[15 + 3 * c], r[16 + 3 * c], r[17 + 3 * c], px, py);
  chan[4 * plane_size + i] = r[10];
#pragma unroll
  for (int c = 5; c < 8; ++c)
    chan[c * plane_size + i] =
        (c == 5 && tangent) ? r[kTangentLane]
                            : (chan0 != nullptr ? chan0[c * plane_size + i]
                                                : 0.0f);
}

__global__ void resolve_tiles_kernel(
    const unsigned long long* __restrict__ keys,
    const int* __restrict__ tile_offsets, const float* __restrict__ pair_data,
    long long n_rows, const float* __restrict__ depth0,
    const int* __restrict__ vis0, const float* __restrict__ chan0,
    int tangent, float* __restrict__ depth, int* __restrict__ vis,
    float* __restrict__ chan, int tiles_x, int tile_h, int tile_w,
    int tile_row0, int width, int height) {
  const size_t plane_size = (size_t)width * height;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane_size) return;
  const unsigned low = (unsigned)keys[i];
  if (low == kNone) {
    write_start(i, plane_size, depth0, vis0, chan0, depth, vis, chan);
    return;
  }
  const long long order = kNone - 1u - low;
  const int x = (int)(i % width);
  const int y = (int)(i / width);
  const int tile = (y / tile_h) * tiles_x + x / tile_w;
  const long long start = min((long long)tile_offsets[tile], n_rows);
  const long long own =
      max(0LL, min((long long)tile_offsets[tile + 1], n_rows) - start);
  const long long row = order < own ? start + order : order - own;
  write_winner(pair_data + row * kLanes, x, y + tile_row0 * tile_h, i,
               plane_size, chan0, tangent, depth, vis, chan);
}

__global__ void resolve_groups_kernel(
    const unsigned long long* __restrict__ keys,
    const int* __restrict__ tile_offsets, const int* __restrict__ group_ids,
    const int* __restrict__ big_ids, const float* __restrict__ lanes,
    long long n_groups, int group_rows, int n_pairs_cap,
    const float* __restrict__ depth0, const int* __restrict__ vis0,
    const float* __restrict__ chan0, int tangent, float* __restrict__ depth,
    int* __restrict__ vis, float* __restrict__ chan, int tiles_x, int tile_h,
    int tile_w, int tile_row0, int width, int height) {
  const size_t plane_size = (size_t)width * height;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane_size) return;
  const unsigned low = (unsigned)keys[i];
  if (low == kNone) {
    write_start(i, plane_size, depth0, vis0, chan0, depth, vis, chan);
    return;
  }
  const long long order = kNone - 1u - low;
  const int x = (int)(i % width);
  const int y = (int)(i / width);
  const int tile = (y / tile_h) * tiles_x + x / tile_w;
  const long long start = min(tile_offsets[tile], n_pairs_cap);
  const long long own =
      max(0LL, (long long)min(tile_offsets[tile + 1], n_pairs_cap) - start);
  const long long e = order / group_rows;
  const long long g = clamp_group(
      e < own ? group_ids[start + e] : big_ids[e - own], n_groups);
  write_winner(lanes + (g * group_rows + order % group_rows) * kLanes, x,
               y + tile_row0 * tile_h, i, plane_size, chan0, tangent, depth,
               vis, chan);
}

// ---------------------------------------------------------------------------
// Accum mode: one pixel a thread, each row's uniform work once a block.
// ---------------------------------------------------------------------------

// A row's accum payload (lanes 28, 30, 31), by the JAX package's
// floor-divide chain (exact: integers below 2^24), then scaled: v = (a, r,
// g, b) / 255 and the three optical depths * 4 / 255.
__device__ __forceinline__ void decode_payload(float p28, float p30,
                                               float p31, float* v) {
  const float hi = floorf(__fmul_rn(p30, kInv256));
  const float a8 = __fsub_rn(p30, __fmul_rn(hi, 256.0f));
  const float hi2 = floorf(__fmul_rn(hi, kInv256));
  const float odr8 = __fsub_rn(hi, __fmul_rn(hi2, 256.0f));
  const float c1 = floorf(__fmul_rn(p28, kInv256));
  const float r8 = __fsub_rn(p28, __fmul_rn(c1, 256.0f));
  const float b8 = floorf(__fmul_rn(c1, kInv256));
  const float g8 = __fsub_rn(c1, __fmul_rn(b8, 256.0f));
  v[0] = __fmul_rn(a8, kInv255);
  v[1] = __fmul_rn(r8, kInv255);
  v[2] = __fmul_rn(g8, kInv255);
  v[3] = __fmul_rn(b8, kInv255);
  v[4] = __fmul_rn(odr8, kFour255);
  v[5] = __fmul_rn(hi2, kFour255);
  v[6] = __fmul_rn(p31, kFour255);
}

// One fragment's depth-warp weight: u = clip((z - seed) / max(bound -
// seed, 1e-6), 0, 1); w = u*u + 0.05 as one fma (XLA's CPU form of the
// reference).
__device__ __forceinline__ float band_weight(float z, float seed,
                                             float bound) {
  const float u = fminf(
      fmaxf(__fdiv_rn(__fsub_rn(z, seed),
                      fmaxf(__fsub_rn(bound, seed), 1e-6f)),
            0.0f),
      1.0f);
  return __fmaf_rn(u, u, 0.05f);
}

// A live row that covers the tile, as the pixels need it (4 float4s): its
// edge and depth planes (lanes 0-8) and its decoded, scaled payload.
__device__ __forceinline__ void accum_record(const float4* r, float4* rec) {
  const float4 q2 = r[2], q7 = r[7];  // lanes 8-11; 28-31
  float v[7];
  decode_payload(q7.x, q7.z, q7.w, v);
  rec[0] = r[0];
  rec[1] = r[1];
  rec[2] = make_float4(q2.x, v[0], v[1], v[2]);
  rec[3] = make_float4(v[3], v[4], v[5], v[6]);
}

// One record's fragment at this thread's pixel into its 8 sums, in the
// reference's operations and roundings.
__device__ __forceinline__ void accum_pixel(const float4* rec, float px,
                                            float py, float seed, float bound,
                                            bool banded, float* ch) {
  const float4 q0 = rec[0], q1 = rec[1], q2 = rec[2], q3 = rec[3];
  const float e0 = plane(q0.x, q0.y, q0.z, px, py);
  const float e1 = plane(q0.w, q1.x, q1.y, px, py);
  const float e2 = __fsub_rn(__fsub_rn(1.0f, e0), e1);
  const float z = plane(q1.z, q1.w, q2.x, px, py);
  if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z > seed)) return;
  if (banded && !(z < bound)) return;
  const float w = banded ? band_weight(z, seed, bound) : 1.0f;
  ch[0] = __fmaf_rn(w, q2.y, ch[0]);
  ch[1] = __fmaf_rn(w, q2.z, ch[1]);
  ch[2] = __fmaf_rn(w, q2.w, ch[2]);
  ch[3] = __fmaf_rn(w, q3.x, ch[3]);
  ch[4] = __fadd_rn(ch[4], q3.y);
  ch[5] = __fadd_rn(ch[5], q3.z);
  ch[6] = __fadd_rn(ch[6], q3.w);
  ch[7] = __fadd_rn(ch[7], 1.0f);
}

// Block = (tile, 256-pixel slice), slice fastest; thread = pixel. The
// tile's walk (own pairs, then big entries) goes through the ring in
// stages of kStage rows; warp 0 compacts each stage to its live rows that
// cover the tile, in walk order, as records; then every thread adds the
// records' fragments to its pixel's sums.
__global__ void __launch_bounds__(kThreads)
accum_groups_kernel(const int* __restrict__ tile_offsets,
                    const int* __restrict__ group_ids,
                    const int* __restrict__ big_ids,
                    const int* __restrict__ big_count,
                    const int* __restrict__ big_bx,
                    const int* __restrict__ big_by,
                    const float* __restrict__ lanes, long long n_groups,
                    int group_rows, int n_pairs_cap, int n_big_cap,
                    const float* __restrict__ depth0,
                    const float* __restrict__ peel,
                    float* __restrict__ depth_out, int* __restrict__ vis_out,
                    float* __restrict__ chan_out, int tiles_x, int tiles_y,
                    int tile_h, int tile_w, int tile_row0, int slices) {
  __shared__ float4 ring[2][kStage * kPieces];
  __shared__ float4 recs[kStage][4];
  __shared__ int n_live;
  const int tile = blockIdx.x / slices;
  const int slice = blockIdx.x - tile * slices;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tyg = ty + tile_row0;
  const int npix = tile_h * tile_w;
  const int width = tiles_x * tile_w;
  const size_t plane_size = (size_t)width * (size_t)(tiles_y * tile_h);
  const int p = slice * kThreads + threadIdx.x;
  const bool in = p < npix;
  const int y = p / tile_w;
  const int x = p - y * tile_w;
  const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
  // Integer sums are exact in f32 below 2^24: the JAX package's centres.
  const float px = (float)(tx * tile_w + x) + 0.5f;
  const float py = (float)(tyg * tile_h + y) + 0.5f;
  const bool banded = peel != nullptr;
  float seed = 0.0f, bound = 0.0f;
  if (in && depth0 != nullptr) seed = depth0[o];
  if (in && banded) bound = peel[o];
  float ch[kAccumCh];
#pragma unroll
  for (int c = 0; c < kAccumCh; ++c) ch[c] = 0.0f;

  const float txf = (float)tx;
  const float tyf = (float)tyg;
  const long long nbig = max(0, min(big_count[0], n_big_cap));
  const long long start = min(tile_offsets[tile], n_pairs_cap);
  const long long own =
      max(0LL, (long long)min(tile_offsets[tile + 1], n_pairs_cap) - start);
  const long long total = own + nbig;
  const int per_stage = kStage / group_rows;   // entries a stage
  const int stages = (int)((total + per_stage - 1) / per_stage);
  auto stage = [&](float4* dst, long long c0) {
    stage_group_entries(dst, c0, (int)min((long long)per_stage, total - c0),
                        start, own, group_ids, big_ids, big_bx, big_by,
                        lanes, n_groups, group_rows, tx, tyg);
  };
  if (stages > 0) stage(ring[0], 0);
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < stages; ++c) {
    const long long c0 = (long long)c * per_stage;
    const int nrows = (int)min((long long)per_stage, total - c0) * group_rows;
    if (c + 1 < stages) {
      stage(ring[(c + 1) & 1], c0 + per_stage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage c has landed for every thread
    if (threadIdx.x < 32) {
      // Warp 0: the stage's rows in order, 32 at a time; a kept row's
      // record goes to the count of kept rows before it.
      const float4* rows = ring[c & 1];
      int kept = 0;
      for (int r0 = 0; r0 < nrows; r0 += 32) {
        const int j = r0 + lane;
        bool keep = false;
        if (j < nrows) {
          const long long e = c0 + j / group_rows;
          const float4* r = rows + j * kPieces;
          keep = (e < own ||
                  box_covers(big_bx[e - own], big_by[e - own], tx, tyg)) &&
                 r[2].y > 0.5f && row_covers(r, txf, tyf);
        }
        const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
        if (keep)
          accum_record(rows + j * kPieces,
                       recs[kept + __popc(m & ((1u << lane) - 1u))]);
        kept += __popc(m);
      }
      if (lane == 0) n_live = kept;
    }
    __syncthreads();  // the stage's records are written
    const int nl = n_live;
    if (in)
      for (int j = 0; j < nl; ++j)
        accum_pixel(recs[j], px, py, seed, bound, banded, ch);
    __syncthreads();  // records and stage c are consumed before a refill
  }
  if (!in) return;
  depth_out[o] = seed;
  vis_out[o] = 0;
#pragma unroll
  for (int c = 0; c < kAccumCh; ++c) chan_out[c * plane_size + o] = ch[c];
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// K1: a landed stage's rows [0, n) (walk index c0 + j; own rows below
// `own`, then big rows) compacted by one warp to records of the live rows
// (big rows: those covering the tile), in walk order; returns the count.
__device__ __forceinline__ int compact_rows(const float4* rows, int n,
                                            long long c0, long long own,
                                            float txf, float tyf, int lane,
                                            float4 (*recs)[4]) {
  int kept = 0;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int j = r0 + lane;
    bool keep = false;
    if (j < n) {
      const float4* r = rows + j * kPieces;
      keep = r[2].y > 0.5f && (c0 + j < own || row_covers(r, txf, tyf));
    }
    const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
    if (keep)
      accum_record(rows + j * kPieces,
                   recs[kept + __popc(m & ((1u << lane) - 1u))]);
    kept += __popc(m);
  }
  return kept;
}

// K1: block = (tile, 256-pixel slice), slice fastest; threads 0-255 are
// the slice's pixels. The tile's walk (own rows, then big rows) goes
// through the ring in stages of kStage rows, compacted to records. Warp 8
// (the producer) owns no pixel. It copies, and compacts stage c into
// record buffer c & 1, hands it over (kBarFull) and takes it back
// (kBarEmpty) before it refills it at stage c + 2, so the compaction of
// stage c + 1 overlaps the sums of stage c.
__global__ void __launch_bounds__(kThreads + 32)
accum_rows_kernel(const int* __restrict__ tile_offsets,
                  const int* __restrict__ big_count,
                  const float* __restrict__ pair_data, long long n_rows,
                  const float* __restrict__ depth0,
                  const float* __restrict__ peel,
                  float* __restrict__ depth_out, int* __restrict__ vis_out,
                  float* __restrict__ chan_out, int tiles_x, int tiles_y,
                  int tile_h, int tile_w, int tile_row0, int slices) {
  constexpr int kBlock = kThreads + 32;
  __shared__ float4 ring[2][kStage * kPieces];
  __shared__ float4 recs[2][kStage][4];
  __shared__ int n_live[2];
  const int tile = blockIdx.x / slices;
  const int slice = blockIdx.x - tile * slices;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tyg = ty + tile_row0;
  const float txf = (float)tx;
  const float tyf = (float)tyg;
  const long long start = min((long long)tile_offsets[tile], n_rows);
  const long long own =
      max(0LL, min((long long)tile_offsets[tile + 1], n_rows) - start);
  const long long total = own + max(0LL, min((long long)big_count[0], n_rows));
  const int stages = (int)((total + kStage - 1) / kStage);
  const int lane = threadIdx.x & 31;
  // Rows [c0, c0 + kStage) of the walk into ring slot `slot`, copied by
  // the producer warp.
  auto stage = [&](int slot, long long c0) {
    stage_tile_rows(ring[slot], pair_data, start, own, c0,
                    (int)min((long long)kStage, total - c0), lane, 32);
  };

  if (threadIdx.x >= kThreads) {
    if (stages > 0) stage(0, 0);
    for (int c = 0; c < stages; ++c) {
      const long long c0 = (long long)c * kStage;
      const int b = c & 1;
      __syncwarp();  // every lane is done reading the slot refilled next
      if (c + 1 < stages) {
        stage(b ^ 1, c0 + kStage);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();  // stage c has landed for every lane
      if (c >= 2) bar_sync(kBarEmpty + b, kBlock);
      const int kept =
          compact_rows(ring[b], (int)min((long long)kStage, total - c0), c0,
                       own, txf, tyf, lane, recs[b]);
      if (lane == 0) n_live[b] = kept;
      bar_arrive(kBarFull + b, kBlock);
    }
    // Take back the buffers of the last two stages, so that every arrival
    // on a named barrier is matched before the block ends.
    for (int c = max(0, stages - 2); c < stages; ++c)
      bar_sync(kBarEmpty + (c & 1), kBlock);
    return;
  }

  const int npix = tile_h * tile_w;
  const int width = tiles_x * tile_w;
  const size_t plane_size = (size_t)width * (size_t)(tiles_y * tile_h);
  const int p = slice * kThreads + threadIdx.x;
  const bool in = p < npix;
  const int y = p / tile_w;
  const int x = p - y * tile_w;
  const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
  // Integer sums are exact in f32 below 2^24: the JAX package's centres.
  const float px = (float)(tx * tile_w + x) + 0.5f;
  const float py = (float)(tyg * tile_h + y) + 0.5f;
  const bool banded = peel != nullptr;
  float seed = 0.0f, bound = 0.0f;
  if (in && depth0 != nullptr) seed = depth0[o];
  if (in && banded) bound = peel[o];
  float ch[kAccumCh];
#pragma unroll
  for (int k = 0; k < kAccumCh; ++k) ch[k] = 0.0f;
  for (int c = 0; c < stages; ++c) {
    const int b = c & 1;
    bar_sync(kBarFull + b, kBlock);  // buffer b holds stage c
    const int nl = n_live[b];
    if (in)
      for (int j = 0; j < nl; ++j)
        accum_pixel(recs[b][j], px, py, seed, bound, banded, ch);
    bar_arrive(kBarEmpty + b, kBlock);
  }
  if (!in) return;
  depth_out[o] = seed;
  vis_out[o] = 0;
#pragma unroll
  for (int k = 0; k < kAccumCh; ++k) chan_out[k * plane_size + o] = ch[k];
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The smallest power of two pixels a thread that covers the tile in one
// block, up to max_ppt.
int pixels_per_thread(int npix, int max_ppt) {
  const int per_block = npix < max_ppt * kThreads ? npix : max_ppt * kThreads;
  int ppt = 1;
  while (ppt * kThreads < per_block) ppt *= 2;
  return ppt;
}

int slices_of(int npix, int ppt) {
  return (npix + ppt * kThreads - 1) / (ppt * kThreads);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Pass 1's pixels a thread: the mode's cap, halved (down to kMinPpt) while
// the launch has fewer tile slices than twice the SMs.
int span_ppt(int npix, int tiles, int mode) {
  int ppt = pixels_per_thread(npix, mode == kPeel ? kMaxPptPeel : kMaxPpt);
  const long long want = 2LL * sm_count();
  while (ppt > kMinPpt && (long long)tiles * slices_of(npix, ppt) < want)
    ppt /= 2;
  return ppt;
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads = kThreads) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0) !=
          cudaSuccess ||
      n < 1)
    n = 1;
  return n;
}

// The mode's pointer contract: kPlain takes no bound, and its seed is
// depth0, vis0 and chan0 together or none of them; kPeel the seed depth
// depth0 and the bound, no vis0/chan0; kAccum as kPeel, or no depth0 and
// no bound.
bool valid_mode(int mode, const void* depth0, const void* vis0,
                const void* chan0, const void* peel) {
  if (mode == kPlain)
    return peel == nullptr && (depth0 == nullptr) == (vis0 == nullptr) &&
           (depth0 == nullptr) == (chan0 == nullptr);
  if (vis0 != nullptr || chan0 != nullptr) return false;
  if (mode == kPeel) return depth0 != nullptr && peel != nullptr;
  if (mode == kAccum) return (depth0 == nullptr) == (peel == nullptr);
  return false;
}

}  // namespace

// Pass 1's instances: (mode, pixels per thread).
#define BR_SPAN_CASE(LAUNCH, M, P) \
  case M * 100 + P:                \
    LAUNCH(M, P)                   \
    break;
#define BR_SPAN_DISPATCH(LAUNCH)                                          \
  switch (mode * 100 + ppt) {                                             \
    BR_SPAN_CASE(LAUNCH, kPlain, 1) BR_SPAN_CASE(LAUNCH, kPlain, 2)       \
    BR_SPAN_CASE(LAUNCH, kPlain, 4) BR_SPAN_CASE(LAUNCH, kPlain, 8)       \
    BR_SPAN_CASE(LAUNCH, kPlain, 16)                                      \
    BR_SPAN_CASE(LAUNCH, kPeel, 1) BR_SPAN_CASE(LAUNCH, kPeel, 2)         \
    BR_SPAN_CASE(LAUNCH, kPeel, 4) BR_SPAN_CASE(LAUNCH, kPeel, 8)         \
    default:                                                              \
      return (int)cudaErrorInvalidValue;                                  \
  }
// Launches K1 on `stream`; returns the first failing launch's
// cudaGetLastError() (0 = launched). pair_data: (n_rows, 32) f32;
// tile_offsets: (tiles_x*tiles_y + 1,) i32; big_count: (1,) i32;
// depth/vis: (tiles_y*tile_h, tiles_x*tile_w); channels: (8, ...). mode 0:
// depth0/vis0/chan0 seed the buffers (all null: zero start), peel null;
// mode 1: depth0 the seed depth and peel the bound, vis0/chan0 null; mode
// 2 (accum): as mode 1, or depth0 and peel both null. tangent != 0
// writes lane 27 to channel 5 (modes 0 and 1). Modes 0 and 1 take scratch
// for the work queue, (tiles + 2,) i32, which the call fills
// (span_queue_kernel: each tile's walk cut into spans of `span` rows), and
// for the key plane, (H', W') u64; mode 2 ignores them. All
// contiguous, on device; pair_data 16-byte aligned.
extern "C" int br_raster_tiles(const int* tile_offsets, const int* big_count,
                               const float* pair_data, long long n_rows,
                               const float* depth0, const int* vis0,
                               const float* chan0, const float* peel,
                               int mode, int tangent, int* queue, int span,
                               unsigned long long* keys, float* depth,
                               int* vis, float* channels, int tiles_x,
                               int tiles_y, int tile_h, int tile_w,
                               int tile_row0, void* stream) {
  if (!valid_mode(mode, depth0, vis0, chan0, peel))
    return (int)cudaErrorInvalidValue;
  const int npix = tile_h * tile_w;
  const int tiles = tiles_x * tiles_y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kAccum) {
    const int slices = slices_of(npix, 1);
    const long long blocks = (long long)tiles * slices;
    if (blocks <= 0 || blocks > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    accum_rows_kernel<<<(unsigned)blocks, kThreads + 32, 0, s>>>(
        tile_offsets, big_count, pair_data, n_rows, depth0, peel, depth, vis,
        channels, tiles_x, tiles_y, tile_h, tile_w, tile_row0, slices);
    return (int)cudaGetLastError();
  }
  if (queue == nullptr || keys == nullptr || span <= 0)
    return (int)cudaErrorInvalidValue;
  span_queue_kernel<<<1, kThreads, 0, s>>>(tile_offsets, n_rows, big_count,
                                           n_rows, span, tiles, queue);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int width = tiles_x * tile_w, height = tiles_y * tile_h;
  const long long n = (long long)width * height;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  init_keys_kernel<<<blocks, kThreads, 0, s>>>(depth0, keys, n);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int ppt = span_ppt(npix, tiles, mode);
  const int slices = slices_of(npix, ppt);
  const int sms = sm_count();
#define BR_SPAN_TILES(M, P)                                                \
  {                                                                        \
    static const int per_sm = blocks_per_sm(span_tiles_kernel<P, M>);     \
    span_tiles_kernel<P, M><<<sms * per_sm, kThreads, 0, s>>>(             \
        queue, tile_offsets, big_count, pair_data, n_rows, depth0, peel,   \
        keys, tiles_x, tiles_y, tile_h, tile_w, tile_row0, slices, span);  \
  }
  BR_SPAN_DISPATCH(BR_SPAN_TILES)
#undef BR_SPAN_TILES
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  resolve_tiles_kernel<<<blocks, kThreads, 0, s>>>(
      keys, tile_offsets, pair_data, n_rows, depth0, vis0, chan0, tangent,
      depth, vis, channels, tiles_x, tile_h, tile_w, tile_row0, width,
      height);
  return (int)cudaGetLastError();
}

// Launches K2 on `stream`; returns the first failing launch's
// cudaGetLastError() (0 = launched). lanes: (n_groups*group_rows, 32) f32,
// 16-byte aligned; group_ids: (n_pairs_cap,) i32; tile_offsets: (tiles +
// 1,) i32 ranges into group_ids; big_ids, big_bx, big_by: (n_big_cap,) i32;
// big_count: (1,) i32. Modes, seeds, the tangent flag, the work queue (its
// spans counted in walk entries: own pairs, then big entries) and the key
// plane as br_raster_tiles. Outputs as br_raster_tiles. All contiguous, on
// device.
extern "C" int br_raster_groups(
    const int* tile_offsets, const int* group_ids, const int* big_ids,
    const int* big_count, const int* big_bx, const int* big_by,
    const float* lanes, long long n_groups, int group_rows, int n_pairs_cap,
    int n_big_cap, const float* depth0, const int* vis0, const float* chan0,
    const float* peel, int mode, int tangent, int* queue, int span,
    unsigned long long* keys, float* depth, int* vis, float* channels,
    int tiles_x, int tiles_y, int tile_h, int tile_w, int tile_row0,
    void* stream) {
  if (group_rows <= 0 || group_rows > kStage || kStage % group_rows)
    return (int)cudaErrorInvalidValue;
  if (!valid_mode(mode, depth0, vis0, chan0, peel))
    return (int)cudaErrorInvalidValue;
  const int npix = tile_h * tile_w;
  const int tiles = tiles_x * tiles_y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kAccum) {
    const int slices = slices_of(npix, 1);
    const long long blocks = (long long)tiles * slices;
    if (blocks <= 0 || blocks > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    accum_groups_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        tile_offsets, group_ids, big_ids, big_count, big_bx, big_by, lanes,
        n_groups, group_rows, n_pairs_cap, n_big_cap, depth0, peel, depth,
        vis, channels, tiles_x, tiles_y, tile_h, tile_w, tile_row0, slices);
    return (int)cudaGetLastError();
  }
  if (queue == nullptr || keys == nullptr || span <= 0)
    return (int)cudaErrorInvalidValue;
  span_queue_kernel<<<1, kThreads, 0, s>>>(tile_offsets, n_pairs_cap,
                                           big_count, n_big_cap, span, tiles,
                                           queue);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int width = tiles_x * tile_w, height = tiles_y * tile_h;
  const long long n = (long long)width * height;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  init_keys_kernel<<<blocks, kThreads, 0, s>>>(depth0, keys, n);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int ppt = span_ppt(npix, tiles, mode);
  const int slices = slices_of(npix, ppt);
  const int sms = sm_count();
#define BR_SPAN_GROUPS(M, P)                                                \
  {                                                                         \
    static const int per_sm = blocks_per_sm(span_groups_kernel<P, M>);    \
    span_groups_kernel<P, M><<<sms * per_sm, kThreads, 0, s>>>(             \
        queue, tile_offsets, group_ids, big_ids, big_count, big_bx, big_by, \
        lanes, n_groups, group_rows, n_pairs_cap, n_big_cap, depth0, peel,  \
        keys, tiles_x, tiles_y, tile_h, tile_w, tile_row0, slices, span);   \
  }
  BR_SPAN_DISPATCH(BR_SPAN_GROUPS)
#undef BR_SPAN_GROUPS
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  resolve_groups_kernel<<<blocks, kThreads, 0, s>>>(
      keys, tile_offsets, group_ids, big_ids, lanes, n_groups, group_rows,
      n_pairs_cap, depth0, vis0, chan0, tangent, depth, vis, channels,
      tiles_x, tile_h, tile_w, tile_row0, width, height);
  return (int)cudaGetLastError();
}

// Launches span_queue_kernel alone on `stream` (the first kernel of a
// br_raster_tiles / br_raster_groups call): tile_offsets (tiles + 1,) i32,
// big_count (1,) i32, queue (tiles + 2,) i32 out. Returns
// cudaGetLastError().
extern "C" int br_span_queue(const int* tile_offsets, long long cap,
                             const int* big_count, long long big_cap,
                             int span, int tiles, int* queue, void* stream) {
  if (span <= 0 || tiles <= 0) return (int)cudaErrorInvalidValue;
  span_queue_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_offsets, cap, big_count, big_cap, span, tiles, queue);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the instance a launch of (kernel, mode) picks
// for a tile of npix pixels in a grid of `tiles` tiles (kernel 0: K1, 1:
// K2); writes its pixels per thread to *ppt_out. 0 for an unknown mode.
extern "C" int br_raster_blocks_per_sm(int kernel, int mode, int npix,
                                       int tiles, int* ppt_out) {
  int ppt = 0;
  int n = 0;
  if (mode == kAccum && kernel) {
    ppt = 1;
    n = blocks_per_sm(accum_groups_kernel);
  } else if (mode == kAccum) {
    ppt = 1;
    n = blocks_per_sm(accum_rows_kernel, kThreads + 32);
  } else if (mode == kPlain || mode == kPeel) {
    ppt = span_ppt(npix, tiles, mode);
#define BR_SPAN_OCC(M, P)                               \
  n = kernel ? blocks_per_sm(span_groups_kernel<P, M>)  \
             : blocks_per_sm(span_tiles_kernel<P, M>);
    BR_SPAN_DISPATCH(BR_SPAN_OCC)
#undef BR_SPAN_OCC
  }
  if (ppt_out != nullptr) *ppt_out = ppt;
  return n;
}
