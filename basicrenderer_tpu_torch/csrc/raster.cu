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
// beats the stored reverse-Z depth strictly. A passing pixel takes z, the
// id, the four perspective attribute planes (lanes 15-26) and the
// material/object combo (lane 10); in tangent mode also the flat
// per-triangle tangent angle (lane 27) into channel 5. Outputs are the
// padded depth (H', W') f32, vis (H', W') i32 and 8 channel planes
// (8, H', W') f32.
// - K1 walks the tile's binned rows [tile_offsets[t], tile_offsets[t+1])
//   of pair_data, then the global big-triangle rows [0, big_count),
//   skipping big rows whose tile bbox (float lanes 11-14) misses the tile.
// - K2 walks the tile's (group, tile) pairs group_ids[start:end]: each
//   group is group_rows consecutive rows of the lane table, read in place
//   (no per-pair payload). Every row whose float tile bbox misses the tile
//   is skipped -- invalid rows carry inverted boxes and garbage planes, so
//   this test is part of the result, not only a saving. Then the global
//   big-group list: an entry's packed tile box (lo*2048 + hi) is tested
//   first and only covering groups are read.
// - Seeded mode (both kernels) starts from a previous raster's depth, vis
//   and channels (phase 2 of the two-phase occlusion: the cluster path's
//   K2, the soup path's K1) and keeps the seed's channels 6-7, and 5
//   unless the tangent channel is on. Unseeded, channels 5-7 are zero
//   (5: the tangent angle in tangent mode). The TPU K1 starts each
//   tile's walk at the 128-row slab below its range; the rows before the
//   range belong to other tiles, so they cover none of this tile's pixels
//   or repeat one of its own rows, which loses the strict depth test.
// - Peel mode (OIT layers, further alpha-MASK layers) starts from a seed
//   depth with vis and channels zero, and a pixel also needs z strictly
//   in front of its peel bound.
// - Accum mode (the OIT tail) leaves depth at its start (the seed, or 0)
//   and vis at 0, and sums per pixel, for every passing fragment in walk
//   order: w*a8/255 and w*rgb8/255 (payload lanes 30, 28) into channels
//   0-3, the optical depths od8*4/255 (lanes 30, 31) into 4-6 and 1 into
//   7, with w = u*u + 0.05, u = clip((z - seed) / max(bound - seed, 1e-6),
//   0, 1) when a peel band is given, else 1. The weight and the four
//   weighted sums are fused multiply-adds (the form XLA's CPU backend
//   gives the JAX reference); the sums' order is the walk order, so one
//   thread per pixel walks the rows in order, as in the other modes.
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
//   result is deterministic. Peel mode adds the bound per pixel and takes
//   at most 8 pixels a thread, accum mode (seed, bound and 8 sums) at most
//   4, and the tangent channel (a sixth value a pixel) at most 8, so none
//   spills; a tile's pixels then spread over more blocks (blockIdx.y).
//   Seeded mode reads each pixel's seed once into the same registers.
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
constexpr int kMaxPpt = 16;    // pixels per thread at most (plain mode)
constexpr int kMaxPptPeel = 8;   // peel mode: + the peel bound a pixel
constexpr int kMaxPptAccum = 4;  // accum mode: 8 sums, seed, bound a pixel
constexpr int kMaxPptTangent = 8;  // tangent channel: a sixth value a pixel
constexpr int kAttr = 5;       // channels written in plain mode (0-4)
constexpr int kTangentLane = 27;  // flat tangent angle -> channel kAttr
constexpr int kAccumCh = 8;    // channels summed in accum mode
// Accum mode's byte scales, rounded to f32 from their double values as the
// JAX package's f32 constants are.
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kFour255 = (float)(4.0 / 255.0);
constexpr float kInv256 = 1.0f / 256.0f;   // exact

// kPlain: plain or seeded; kPeel: depth-peeling pass; kAccum: the OIT
// tail's sums (weighted by the depth warp when a peel band is given). The
// tangent channel (TAN) is a template flag of kPlain and kPeel; kAccum
// ignores it, as the TPU kernel's accum mode returns before that write.
enum Mode : int { kPlain = 0, kPeel = 1, kAccum = 2 };

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

__device__ __forceinline__ bool row_covers(const float* r, float txf,
                                           float tyf) {
  return txf >= r[11] && txf <= r[12] && tyf >= r[13] && tyf <= r[14];
}

// One thread's pixels, in registers for the whole walk. In accum mode
// `depth` holds the seed and is never written, and `vis` is unused.
template <int PPT, int MODE, bool TAN>
struct Pixels {
  static constexpr int kCh =
      MODE == kAccum ? kAccumCh : (TAN ? kAttr + 1 : kAttr);
  float px[PPT], py[PPT], depth[PPT], peel[PPT];
  int vis[PPT];
  float ch[kCh][PPT];
};

// One setup row against this thread's pixels. `banded`: a peel bound
// limits the pass (always in kPeel mode; in kAccum mode when a band is
// given, which also weights each fragment by its depth warp).
template <int PPT, int MODE, bool TAN>
__device__ __forceinline__ void eval_row(const float* r,
                                         Pixels<PPT, MODE, TAN>& s,
                                         bool banded) {
  const float id = r[9];
  if (!(id > 0.5f)) return;
  const float a0 = r[0], b0 = r[1], c0e = r[2];
  const float a1 = r[3], b1 = r[4], c1e = r[5];
  const float az = r[6], bz = r[7], cz = r[8];
  // Accum mode's payload bytes, by the JAX package's floor-divide chain
  // (exact: integers below 2^24), then scaled.
  float va = 0.f, vr = 0.f, vg = 0.f, vb = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f;
  if constexpr (MODE == kAccum) {
    const float p30 = r[30];
    const float hi = floorf(__fmul_rn(p30, kInv256));
    const float a8 = __fsub_rn(p30, __fmul_rn(hi, 256.0f));
    const float hi2 = floorf(__fmul_rn(hi, kInv256));
    const float odr8 = __fsub_rn(hi, __fmul_rn(hi2, 256.0f));
    const float p28 = r[28];
    const float c1 = floorf(__fmul_rn(p28, kInv256));
    const float r8 = __fsub_rn(p28, __fmul_rn(c1, 256.0f));
    const float b8 = floorf(__fmul_rn(c1, kInv256));
    const float g8 = __fsub_rn(c1, __fmul_rn(b8, 256.0f));
    va = __fmul_rn(a8, kInv255);
    vr = __fmul_rn(r8, kInv255);
    vg = __fmul_rn(g8, kInv255);
    vb = __fmul_rn(b8, kInv255);
    o0 = __fmul_rn(odr8, kFour255);
    o1 = __fmul_rn(hi2, kFour255);
    o2 = __fmul_rn(r[31], kFour255);
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float e0 = plane(a0, b0, c0e, s.px[k], s.py[k]);
    const float e1 = plane(a1, b1, c1e, s.px[k], s.py[k]);
    const float e2 = __fsub_rn(__fsub_rn(1.0f, e0), e1);
    const float z = plane(az, bz, cz, s.px[k], s.py[k]);
    if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z > s.depth[k])) continue;
    if constexpr (MODE != kPlain) {
      if (banded && !(z < s.peel[k])) continue;
    }
    if constexpr (MODE == kAccum) {
      float w = 1.0f;
      if (banded) {
        // u = clip((z - seed) / max(bound - seed, 1e-6), 0, 1);
        // w = u*u + 0.05 as one fma (XLA's CPU form of the reference).
        const float u = fminf(
            fmaxf(__fdiv_rn(__fsub_rn(z, s.depth[k]),
                            fmaxf(__fsub_rn(s.peel[k], s.depth[k]), 1e-6f)),
                  0.0f),
            1.0f);
        w = __fmaf_rn(u, u, 0.05f);
      }
      s.ch[0][k] = __fmaf_rn(w, va, s.ch[0][k]);
      s.ch[1][k] = __fmaf_rn(w, vr, s.ch[1][k]);
      s.ch[2][k] = __fmaf_rn(w, vg, s.ch[2][k]);
      s.ch[3][k] = __fmaf_rn(w, vb, s.ch[3][k]);
      s.ch[4][k] = __fadd_rn(s.ch[4][k], o0);
      s.ch[5][k] = __fadd_rn(s.ch[5][k], o1);
      s.ch[6][k] = __fadd_rn(s.ch[6][k], o2);
      s.ch[7][k] = __fadd_rn(s.ch[7][k], 1.0f);
    } else {
      s.depth[k] = z;
      s.vis[k] = (int)id;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s.ch[c][k] = plane(r[15 + 3 * c], r[16 + 3 * c], r[17 + 3 * c],
                           s.px[k], s.py[k]);
      s.ch[4][k] = r[10];
      if constexpr (TAN) s.ch[kAttr][k] = r[kTangentLane];
    }
  }
}

template <int PPT, int MODE, bool TAN, bool kBBox>
__device__ __forceinline__ void walk_rows(
    const float* __restrict__ pair_data, long long start, long long end,
    float* rows, float txf, float tyf, Pixels<PPT, MODE, TAN>& s,
    bool banded) {
  for (long long c0 = start; c0 < end; c0 += kChunk) {
    const int n = (int)min((long long)kChunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    const float* src = pair_data + c0 * kLanes;
    for (int i = threadIdx.x; i < n * kLanes; i += kThreads) rows[i] = src[i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* r = rows + j * kLanes;
      if (kBBox && !row_covers(r, txf, tyf)) continue;
      eval_row<PPT, MODE, TAN>(r, s, banded);
    }
  }
}

// Pixel centres of this thread's pixels and their starting buffers:
// kPlain zero, or seeded from depth0 / vis0 / chan0 (the channels held in
// registers: 0-4, and 5 in tangent mode); kPeel the seed depth depth0 and
// the bound peel0, vis and channels zero; kAccum the seed and bound when
// given (else zero depth), sums zero.
template <int PPT, int MODE, bool TAN>
__device__ __forceinline__ void init_pixels(
    int tx, int ty, int tile_row0, int tile_w, int tile_h, int npix, int pix0,
    int width, size_t plane_size, const float* depth0, const int* vis0,
    const float* chan0, const float* peel0, Pixels<PPT, MODE, TAN>& s) {
  constexpr int kCh = Pixels<PPT, MODE, TAN>::kCh;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix0 + threadIdx.x + k * kThreads;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    // Integer sums are exact in f32 below 2^24: the same pixel centres the
    // JAX package builds from f32 iotas.
    s.px[k] = (float)(tx * tile_w + x) + 0.5f;
    s.py[k] = (float)((ty + tile_row0) * tile_h + y) + 0.5f;
    s.depth[k] = 0.0f;
    s.peel[k] = 0.0f;
    s.vis[k] = 0;
#pragma unroll
    for (int c = 0; c < kCh; ++c) s.ch[c][k] = 0.0f;
    if (p >= npix) continue;
    const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
    if (depth0 != nullptr) s.depth[k] = depth0[o];
    if constexpr (MODE != kPlain) {
      if (peel0 != nullptr) s.peel[k] = peel0[o];
    } else if (vis0 != nullptr) {
      s.vis[k] = vis0[o];
#pragma unroll
      for (int c = 0; c < kCh; ++c) s.ch[c][k] = chan0[c * plane_size + o];
    }
  }
}

// Writes depth, vis and the 8 channels: the channels held in registers,
// then kPlain's others (5-7, or 6-7 in tangent mode) from the seed (zero
// unseeded), kPeel zero there, kAccum the 8 sums and vis zero.
template <int PPT, int MODE, bool TAN>
__device__ __forceinline__ void store_pixels(
    int tx, int ty, int tile_w, int tile_h, int npix, int pix0, int width,
    size_t plane_size, const float* chan0, const Pixels<PPT, MODE, TAN>& s,
    float* __restrict__ depth_out, int* __restrict__ vis_out,
    float* __restrict__ chan_out) {
  constexpr int kCh = Pixels<PPT, MODE, TAN>::kCh;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix0 + threadIdx.x + k * kThreads;
    if (p >= npix) continue;
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
    depth_out[o] = s.depth[k];
    vis_out[o] = MODE == kAccum ? 0 : s.vis[k];
#pragma unroll
    for (int c = 0; c < kCh; ++c) chan_out[c * plane_size + o] = s.ch[c][k];
#pragma unroll
    for (int c = kCh; c < 8; ++c)
      chan_out[c * plane_size + o] =
          chan0 != nullptr ? chan0[c * plane_size + o] : 0.0f;
  }
}

template <int PPT, int MODE, bool TAN>
__global__ void __launch_bounds__(kThreads, 1)
raster_tiles_kernel(const int* __restrict__ tile_offsets,
                    const int* __restrict__ big_count,
                    const float* __restrict__ pair_data, long long n_rows,
                    const float* __restrict__ depth0,
                    const int* __restrict__ vis0,
                    const float* __restrict__ chan0,
                    const float* __restrict__ peel,
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
  const bool banded = peel != nullptr;

  Pixels<PPT, MODE, TAN> s;
  init_pixels<PPT, MODE, TAN>(tx, ty, tile_row0, tile_w, tile_h, npix, pix0,
                              width, plane_size, depth0, vis0, chan0, peel,
                              s);
  const float txf = (float)tx;
  const float tyf = (float)(ty + tile_row0);

  const long long start = min((long long)tile_offsets[tile], n_rows);
  const long long end = min((long long)tile_offsets[tile + 1], n_rows);
  walk_rows<PPT, MODE, TAN, false>(pair_data, start, end, rows, txf, tyf, s,
                                   banded);
  const long long nbig = min((long long)big_count[0], n_rows);
  walk_rows<PPT, MODE, TAN, true>(pair_data, 0, nbig, rows, txf, tyf, s,
                                  banded);
  store_pixels<PPT, MODE, TAN>(tx, ty, tile_w, tile_h, npix, pix0, width,
                               plane_size, MODE == kPlain ? chan0 : nullptr,
                               s, depth_out, vis_out, chan_out);
}

template <int PPT, int MODE, bool TAN>
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
                     const float* __restrict__ peel,
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
  const bool banded = peel != nullptr;

  Pixels<PPT, MODE, TAN> s;
  init_pixels<PPT, MODE, TAN>(tx, ty, tile_row0, tile_w, tile_h, npix, pix0,
                              width, plane_size, depth0, vis0, chan0, peel,
                              s);
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
      eval_row<PPT, MODE, TAN>(r, s, banded);
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
      eval_row<PPT, MODE, TAN>(r, s, banded);
    }
  }
  store_pixels<PPT, MODE, TAN>(tx, ty, tile_w, tile_h, npix, pix0, width,
                               plane_size, MODE == kPlain ? chan0 : nullptr,
                               s, depth_out, vis_out, chan_out);
}

int pixels_per_thread(int npix, int max_ppt) {
  const int per_block = npix < max_ppt * kThreads ? npix : max_ppt * kThreads;
  int ppt = 1;
  while (ppt * kThreads < per_block) ppt *= 2;
  return ppt;
}

int max_ppt(int mode, bool tangent) {
  if (mode == kAccum) return kMaxPptAccum;
  if (tangent) return kMaxPptTangent;
  return mode == kPeel ? kMaxPptPeel : kMaxPpt;
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

// One case per template instance: (tangent, mode, pixels per thread).
// Accum mode has no tangent instance (the flag does not reach its sums).
#define BR_CASE(LAUNCH, T, M, P) \
  case T * 1000 + M * 100 + P:   \
    LAUNCH(T, M, P)              \
    break;
#define BR_DISPATCH(LAUNCH)                                          \
  switch ((tangent && mode != kAccum ? 1000 : 0) + mode * 100 + ppt) { \
    BR_CASE(LAUNCH, 0, kPlain, 1) BR_CASE(LAUNCH, 0, kPlain, 2)      \
    BR_CASE(LAUNCH, 0, kPlain, 4) BR_CASE(LAUNCH, 0, kPlain, 8)      \
    BR_CASE(LAUNCH, 0, kPlain, 16)                                   \
    BR_CASE(LAUNCH, 0, kPeel, 1) BR_CASE(LAUNCH, 0, kPeel, 2)        \
    BR_CASE(LAUNCH, 0, kPeel, 4) BR_CASE(LAUNCH, 0, kPeel, 8)        \
    BR_CASE(LAUNCH, 0, kAccum, 1) BR_CASE(LAUNCH, 0, kAccum, 2)      \
    BR_CASE(LAUNCH, 0, kAccum, 4)                                    \
    BR_CASE(LAUNCH, 1, kPlain, 1) BR_CASE(LAUNCH, 1, kPlain, 2)      \
    BR_CASE(LAUNCH, 1, kPlain, 4) BR_CASE(LAUNCH, 1, kPlain, 8)      \
    BR_CASE(LAUNCH, 1, kPeel, 1) BR_CASE(LAUNCH, 1, kPeel, 2)        \
    BR_CASE(LAUNCH, 1, kPeel, 4) BR_CASE(LAUNCH, 1, kPeel, 8)        \
    default:                                                         \
      return (int)cudaErrorInvalidValue;                             \
  }

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
// pair_data: (n_rows, 32) f32; tile_offsets: (tiles_x*tiles_y + 1,) i32;
// big_count: (1,) i32; depth/vis: (tiles_y*tile_h, tiles_x*tile_w);
// channels: (8, tiles_y*tile_h, tiles_x*tile_w). mode 0: depth0/vis0/chan0
// seed the buffers (all null: zero start), peel null; mode 1: depth0 the
// seed depth and peel the bound, vis0/chan0 null; mode 2: as mode 1, or
// depth0 and peel both null. tangent != 0 writes lane 27 to channel 5
// (modes 0 and 1). All contiguous, on device.
extern "C" int br_raster_tiles(const int* tile_offsets, const int* big_count,
                               const float* pair_data, long long n_rows,
                               const float* depth0, const int* vis0,
                               const float* chan0, const float* peel,
                               int mode, int tangent, float* depth, int* vis,
                               float* channels, int tiles_x, int tiles_y,
                               int tile_h, int tile_w, int tile_row0,
                               void* stream) {
  if (!valid_mode(mode, depth0, vis0, chan0, peel))
    return (int)cudaErrorInvalidValue;
  const int npix = tile_h * tile_w;
  const int ppt = pixels_per_thread(npix, max_ppt(mode, tangent != 0));
  const dim3 grid(tiles_x * tiles_y, (npix + ppt * kThreads - 1) / (ppt * kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BR_TILES(T, M, P)                                                  \
  raster_tiles_kernel<P, M, T != 0><<<grid, kThreads, 0, s>>>(             \
      tile_offsets, big_count, pair_data, n_rows, depth0, vis0, chan0,     \
      peel, depth, vis, channels, tiles_x, tiles_y, tile_h, tile_w,        \
      tile_row0);
  BR_DISPATCH(BR_TILES)
#undef BR_TILES
  return (int)cudaGetLastError();
}

// Launches K2 on `stream`; returns cudaGetLastError() (0 = launched).
// lanes: (n_groups*group_rows, 32) f32; group_ids: (n_pairs_cap,) i32;
// tile_offsets: (tiles + 1,) i32 ranges into group_ids; big_ids, big_bx,
// big_by: (n_big_cap,) i32; big_count: (1,) i32. Modes, seeds and the
// tangent flag as br_raster_tiles. Outputs as br_raster_tiles. All
// contiguous, on device.
extern "C" int br_raster_groups(
    const int* tile_offsets, const int* group_ids, const int* big_ids,
    const int* big_count, const int* big_bx, const int* big_by,
    const float* lanes, long long n_groups, int group_rows, int n_pairs_cap,
    int n_big_cap, const float* depth0, const int* vis0, const float* chan0,
    const float* peel, int mode, int tangent, float* depth, int* vis,
    float* channels, int tiles_x, int tiles_y, int tile_h, int tile_w,
    int tile_row0, void* stream) {
  if (group_rows <= 0 || group_rows > kChunk || kChunk % group_rows)
    return (int)cudaErrorInvalidValue;
  if (!valid_mode(mode, depth0, vis0, chan0, peel))
    return (int)cudaErrorInvalidValue;
  const int npix = tile_h * tile_w;
  const int ppt = pixels_per_thread(npix, max_ppt(mode, tangent != 0));
  const dim3 grid(tiles_x * tiles_y, (npix + ppt * kThreads - 1) / (ppt * kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BR_GROUPS(T, M, P)                                                 \
  raster_groups_kernel<P, M, T != 0><<<grid, kThreads, 0, s>>>(            \
      tile_offsets, group_ids, big_ids, big_count, big_bx, big_by, lanes,  \
      n_groups, group_rows, n_pairs_cap, n_big_cap, depth0, vis0, chan0,   \
      peel, depth, vis, channels, tiles_x, tiles_y, tile_h, tile_w,        \
      tile_row0);
  BR_DISPATCH(BR_GROUPS)
#undef BR_GROUPS
  return (int)cudaGetLastError();
}
