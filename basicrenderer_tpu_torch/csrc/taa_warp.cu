// Per-tile history warp of the motion-vector TAA resolve, for NVIDIA
// Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/taa_warp.py::_warp_kernel. Wrapper and
// plain PyTorch version: basicrenderer_tpu_torch/ops/taa_warp.py.
//
// What it computes: history (H, W, C) f32, channel-last, with H and W tile
// multiples, and one fractional motion (dy, dx) per raster tile. dy is
// clipped to +-(PAD_Y - 2) = +-70 rows and dx to +-(PAD_XL - 2) = +-190
// columns. Output pixel (y, x) of tile t is the bilinear sample of the
// edge-extended history at (y + dy_t, x + dx_t):
//   y0 = floor(dy), fy = dy - y0 (x likewise), rows r = clamp(y + y0),
//   r1 = clamp(y + y0 + 1), columns c, c1 the same;
//   top = h[r, c] * (1 - fy) + h[r1, c] * fy
//   bot = h[r, c1] * (1 - fy) + h[r1, c1] * fy
//   out = top * (1 - fx) + bot * fx
// every product and sum rounded to f32 in this order, as the plain
// version computes it, so the two agree exactly. Clamping the source
// coordinates is the TPU kernel's edge pad: the clip keeps every tap
// inside the pad, where the pad repeats the edge.
//
// What bounds it on this card: bytes. The history read once and the
// output written once are 50 MB at 1088 x 1920 x 3 f32, 15 us at
// 3.35 TB/s; ~7 flops a value are far below the f32 rate.
//
// What the design does about it:
// - A block takes a band of up to kBand rows of one tile. All the rows of
//   a tile share one (dy, dx), so the band's source is a window of
//   R + 1 rows by tile_w + 1 columns: window row i is source row
//   clamp(row0 + y0 + i), window column j is source column
//   clamp(col_base + x0 + j). The edge clamp is done once, at staging.
// - Staging: each thread takes window floats e of a row (consecutive
//   threads on consecutive floats, so every row is read coalesced), loads
//   that float of all R + 1 window rows at once into registers and keeps
//   only the vertical blend v[i][e] = h[i][e] * gy + h[i + 1][e] * fy in
//   shared memory. Each source column is blended once: `top` of pixel
//   x + 1 is `bot` of pixel x, the same f32 operations.
// - Output float e of a band row is v[e] * gx + v[e + C] * fx. Each thread
//   writes 4 consecutive floats as one float4 (a tile row is 1536 bytes
//   at C = 3, an image row 23,040: both multiples of 16); a row whose
//   float count or start is not a multiple of 4 stores its tail (or all
//   of it) as scalars. For C = 3 (the TAA history's RGB) the 7 floats a
//   float4 of output needs are two float4 reads of shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 16;          // output rows a block, at most
constexpr int kMaxShared = 48 * 1024;
constexpr float kMaxDy = 70.0f;    // PAD_Y - 2
constexpr float kMaxDx = 190.0f;   // PAD_XL - 2

__device__ __forceinline__ float lerp_rn(float a, float wa, float b,
                                         float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// CT: the channel count when it is a compile-time 3, else 0 (read from
// `channels`).
template <int CT>
__global__ void __launch_bounds__(kThreads)
taa_warp_kernel(const float* __restrict__ hist,
                const float* __restrict__ tile_dy,
                const float* __restrict__ tile_dx, float* __restrict__ out,
                int height, int width, int channels_rt, int tile_h,
                int tile_w, int tiles_x, int bands, int band_rows,
                int stride, int aligned16) {
  extern __shared__ __align__(16) float v[];   // band_rows x stride
  const int C = CT > 0 ? CT : channels_rt;
  const int tx = blockIdx.x;
  const int ty = blockIdx.y / bands;
  const int band = blockIdx.y - ty * bands;
  const int tile = ty * tiles_x + tx;
  const float dy = fminf(fmaxf(tile_dy[tile], -kMaxDy), kMaxDy);
  const float dx = fminf(fmaxf(tile_dx[tile], -kMaxDx), kMaxDx);
  const float y0f = floorf(dy);
  const float x0f = floorf(dx);
  const float fy = __fsub_rn(dy, y0f);
  const float fx = __fsub_rn(dx, x0f);
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const int row0 = ty * tile_h + band * band_rows;
  const int rows = min(band_rows, tile_h - band * band_rows);
  const int col_base = tx * tile_w;
  const int run = (tile_w + 1) * C;        // window floats a row
  const int cstart = col_base + x0;        // window column 0, unclamped
  const bool inside = cstart >= 0 && cstart + tile_w <= width - 1;
  const long long row_floats = (long long)width * C;

  // Window rows' offsets, clamped once.
  long long src_row[kBand + 1];
#pragma unroll
  for (int i = 0; i <= kBand; ++i)
    src_row[i] = (long long)min(max(row0 + y0 + i, 0), height - 1)
                 * row_floats;

  for (int e = threadIdx.x; e < run; e += kThreads) {
    long long col_off;
    if (inside) {
      col_off = (long long)cstart * C + e;
    } else {
      const int j = e / C;
      const int c = e - j * C;
      col_off = (long long)min(max(cstart + j, 0), width - 1) * C + c;
    }
    float h[kBand + 1];
#pragma unroll
    for (int i = 0; i <= kBand; ++i)
      if (i <= rows) h[i] = hist[src_row[i] + col_off];
#pragma unroll
    for (int i = 0; i < kBand; ++i)
      if (i < rows) v[i * stride + e] = lerp_rn(h[i], gy, h[i + 1], fy);
  }
  __syncthreads();

  const int out_run = tile_w * C;          // output floats a band row
  const bool vec = aligned16 && row_floats % 4 == 0
                   && ((long long)col_base * C) % 4 == 0;
  const int nvec = vec ? out_run / 4 : 0;
  const int tail = out_run - 4 * nvec;
  for (int q = threadIdx.x; q < rows * nvec; q += kThreads) {
    const int k = q / nvec;
    const int e = 4 * (q - k * nvec);
    const float* vr = v + k * stride + e;
    float4 r;
    if constexpr (CT == 3) {
      const float4 a = *reinterpret_cast<const float4*>(vr);
      const float4 b = *reinterpret_cast<const float4*>(vr + 4);
      r.x = lerp_rn(a.x, gx, a.w, fx);
      r.y = lerp_rn(a.y, gx, b.x, fx);
      r.z = lerp_rn(a.z, gx, b.y, fx);
      r.w = lerp_rn(a.w, gx, b.z, fx);
    } else {
      r.x = lerp_rn(vr[0], gx, vr[C], fx);
      r.y = lerp_rn(vr[1], gx, vr[C + 1], fx);
      r.z = lerp_rn(vr[2], gx, vr[C + 2], fx);
      r.w = lerp_rn(vr[3], gx, vr[C + 3], fx);
    }
    *reinterpret_cast<float4*>(
        out + ((long long)(row0 + k) * width + col_base) * C + e) = r;
  }
  for (int q = threadIdx.x; q < rows * tail; q += kThreads) {
    const int k = q / tail;
    const int e = 4 * nvec + (q - k * tail);
    const float* vr = v + k * stride + e;
    out[((long long)(row0 + k) * width + col_base) * C + e] =
        lerp_rn(vr[0], gx, vr[C], fx);
  }
}

// Shared memory a block takes for (tile_h, tile_w) tiles of C channels,
// with its band height; 0 when even a one-row band does not fit.
size_t band_shared(int channels, int tile_h, int tile_w, int* band_rows) {
  // A shared row holds the window's (tile_w + 1) * C floats, rounded up
  // to whole float4s, plus the 4 floats a C = 3 row's last float4 read
  // can reach past it.
  const int stride = ((tile_w + 1) * channels + 3) / 4 * 4;
  int rows = tile_h < kBand ? tile_h : kBand;
  while (rows > 1 && (size_t)(rows * stride + 4) * sizeof(float) > kMaxShared)
    --rows;
  const size_t shared = (size_t)(rows * stride + 4) * sizeof(float);
  *band_rows = rows;
  return shared > kMaxShared ? 0 : shared;
}

}  // namespace

// Resident blocks an SM of the instance a (tile_h, tile_w) launch over
// `channels` channels takes.
extern "C" int br_taa_warp_blocks_per_sm(int channels, int tile_h,
                                         int tile_w) {
  int rows = 0, n = 0;
  const size_t shared = band_shared(channels, tile_h, tile_w, &rows);
  if (shared == 0) return 0;
  if (channels == 3)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, taa_warp_kernel<3>,
                                                  kThreads, shared);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, taa_warp_kernel<0>,
                                                  kThreads, shared);
  return n;
}

// Launches the warp on `stream`; returns cudaGetLastError() (0 = launched).
// hist, out: (height, width, channels) f32; tile_dy, tile_dx: (tiles_y *
// tiles_x,) f32, row-major over the tile grid. height and width are
// multiples of tile_h and tile_w. All contiguous, on device.
extern "C" int br_taa_warp(const float* hist, const float* tile_dy,
                           const float* tile_dx, float* out, int height,
                           int width, int channels, int tile_h, int tile_w,
                           void* stream) {
  if (tile_h <= 0 || tile_w <= 0 || channels <= 0 || height % tile_h
      || width % tile_w)
    return (int)cudaErrorInvalidValue;
  const int stride = ((tile_w + 1) * channels + 3) / 4 * 4;
  int band_rows = 0;
  const size_t shared = band_shared(channels, tile_h, tile_w, &band_rows);
  if (shared == 0) return (int)cudaErrorInvalidValue;
  const int bands = (tile_h + band_rows - 1) / band_rows;
  const int tiles_x = width / tile_w;
  const dim3 grid(tiles_x, (height / tile_h) * bands);
  const int aligned16 = ((reinterpret_cast<size_t>(out) & 15) == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 3)
    taa_warp_kernel<3><<<grid, kThreads, shared, s>>>(
        hist, tile_dy, tile_dx, out, height, width, channels, tile_h, tile_w,
        tiles_x, bands, band_rows, stride, aligned16);
  else
    taa_warp_kernel<0><<<grid, kThreads, shared, s>>>(
        hist, tile_dy, tile_dx, out, height, width, channels, tile_h, tile_w,
        tiles_x, bands, band_rows, stride, aligned16);
  return (int)cudaGetLastError();
}
