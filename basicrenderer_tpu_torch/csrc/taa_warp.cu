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
// What bounds it on this card: bytes. Each pixel reads four taps per
// channel (mostly from L1/L2: neighbouring pixels share taps) and writes
// one value per channel, ~7 flops each: at 1088 x 1920 x 3 f32 the
// history read once and the output written once are 50 MB, 15 us at
// 3.35 TB/s.
//
// What the design does about it: one block per tile; the tile's motion is
// read once into shared memory; each thread then walks pixels of the tile
// with consecutive threads on consecutive columns, so the tap reads and
// the output writes of a warp touch contiguous rows of the image. The
// TPU kernel's 128-lane-aligned DMA window and its hat-function matmuls
// have no counterpart: a clamped gather does the same work here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMaxDy = 70.0f;    // PAD_Y - 2
constexpr float kMaxDx = 190.0f;   // PAD_XL - 2

__global__ void __launch_bounds__(kThreads)
taa_warp_kernel(const float* __restrict__ hist, const float* __restrict__ tile_dy,
                const float* __restrict__ tile_dx, float* __restrict__ out,
                int height, int width, int channels, int tile_h, int tile_w,
                int tiles_x) {
  __shared__ float motion[4];   // y0, fy, x0, fx
  const int tile = blockIdx.y * tiles_x + blockIdx.x;
  if (threadIdx.x == 0) {
    const float dy = fminf(fmaxf(tile_dy[tile], -kMaxDy), kMaxDy);
    const float dx = fminf(fmaxf(tile_dx[tile], -kMaxDx), kMaxDx);
    const float y0 = floorf(dy);
    const float x0 = floorf(dx);
    motion[0] = y0;
    motion[1] = __fsub_rn(dy, y0);
    motion[2] = x0;
    motion[3] = __fsub_rn(dx, x0);
  }
  __syncthreads();
  const int y0 = (int)motion[0];
  const float fy = motion[1];
  const int x0 = (int)motion[2];
  const float fx = motion[3];
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  const int row_base = blockIdx.y * tile_h;
  const int col_base = blockIdx.x * tile_w;
  const int npix = tile_h * tile_w;
  for (int p = threadIdx.x; p < npix; p += kThreads) {
    const int y = row_base + p / tile_w;
    const int x = col_base + p % tile_w;
    const int r0 = min(max(y + y0, 0), height - 1);
    const int r1 = min(max(y + y0 + 1, 0), height - 1);
    const int c0 = min(max(x + x0, 0), width - 1);
    const int c1 = min(max(x + x0 + 1, 0), width - 1);
    const float* h00 = hist + ((long long)r0 * width + c0) * channels;
    const float* h10 = hist + ((long long)r1 * width + c0) * channels;
    const float* h01 = hist + ((long long)r0 * width + c1) * channels;
    const float* h11 = hist + ((long long)r1 * width + c1) * channels;
    float* o = out + ((long long)y * width + x) * channels;
    for (int c = 0; c < channels; ++c) {
      const float top = __fadd_rn(__fmul_rn(h00[c], gy), __fmul_rn(h10[c], fy));
      const float bot = __fadd_rn(__fmul_rn(h01[c], gy), __fmul_rn(h11[c], fy));
      o[c] = __fadd_rn(__fmul_rn(top, gx), __fmul_rn(bot, fx));
    }
  }
}

}  // namespace

// Launches the warp on `stream`; returns cudaGetLastError() (0 = launched).
// hist, out: (height, width, channels) f32; tile_dy, tile_dx: (tiles_y *
// tiles_x,) f32, row-major over the tile grid. height and width are
// multiples of tile_h and tile_w. All contiguous, on device.
extern "C" int br_taa_warp(const float* hist, const float* tile_dy,
                           const float* tile_dx, float* out, int height,
                           int width, int channels, int tile_h, int tile_w,
                           void* stream) {
  if (tile_h <= 0 || tile_w <= 0 || height % tile_h || width % tile_w)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(width / tile_w, height / tile_h);
  taa_warp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, tile_dy, tile_dx, out, height, width, channels, tile_h, tile_w,
      width / tile_w);
  return (int)cudaGetLastError();
}
