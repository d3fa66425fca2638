// Per-tile shading of culled local lights, for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/lighting.py::_tiled_shade_kernel. Wrapper
// and plain PyTorch version: basicrenderer_tpu_torch/ops/lighting.py.
//
// What it computes, per tile of tile_h x tile_w pixels: walk the tile's
// counts[t] culled light rows (payload[t], 16 f32 lanes each: position,
// type, direction, intensity, color, range, spot cone cosines) and sum,
// per pixel, intensity * inverse-square attenuation * range window
// (1 - (d/range)^4)^2 * spot cone^2 (type 2) * n.l * valid times the
// Cook-Torrance GGX / Smith height-correlated / Schlick specular plus the
// Lambert diffuse, over the G-buffer planes of shade_in (12 planes: normal,
// albedo, metallic, roughness, world position, valid). Output: (3, H', W')
// f32 radiance on the padded grid.
//
// Numerics: jax.lax.rsqrt is evaluated as 1 / sqrtf (IEEE sqrt and divide:
// the library is built without fast math), not the approximate rsqrtf.
// Every pixel's sum runs over the light slots in slot order with the same
// f32 operations as the plain version.
//
// What bounds it on this card: operations (118 f32 operations a pixel and
// light, ~125 MB of planes at 1088 x 1920), and below that the instruction
// issue rate: five IEEE divides and three IEEE square roots a pixel-light
// are multi-instruction sequences. Light counts per tile run from 0 to the
// cap of 64, and the tiles with the most lights are those that show sky
// (a sky pixel's depth clamps to the far distance, so the tile's box hits
// every light in range).
//
// What the design does about it:
// - One pixel a thread, 256-pixel slices of a tile a block (a 32 x 128
//   tile is 16 blocks; slice fastest in the grid, so a tile's slices are
//   neighbours). The block scheduler then shares the heavy tiles out over
//   every SM instead of one block walking a whole tile's 4096 pixels.
//   Declared for 4 blocks of 256 threads an SM (<= 64 registers).
// - Each block stages its tile's light rows (<= max_l x 64 bytes) in
//   shared memory once and at staging replaces what depends on the light
//   alone by its value, with the same f32 operations: lane 11 by
//   fmaxf(range, 1e-3f), lane 12 by fmaxf(cos_inner - cos_outer, 1e-4f),
//   lane 14 (unused by the shading) by the spot flag. Every thread reads
//   each light as a broadcast.
// - A warp whose 32 pixels all have valid == 0 (sky, the pad rows) writes
//   +0.0f and skips the light loop (one __ballot_sync). That is exact: each
//   term of such a pixel is a finite product times valid = 0, so +-0, and
//   a sum that starts at +0.0f and adds only +-0 stays +0.0f. A warp with
//   any valid pixel walks every light for all its lanes, as before.
// - The light loop is not unrolled (#pragma unroll 1), so its body's
//   instructions in the built library's SASS are one light's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM the kernel is declared for
constexpr int kStride = 16;    // LIGHT_STRIDE
constexpr int kRange = 11;     // lane: range -> fmaxf(range, 1e-3f)
constexpr int kCone = 12;      // lane: cos inner -> the cone's denominator
constexpr int kSpot = 14;      // lane: (unused) -> 1 for a spot light

__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
tiled_shade_kernel(const float* __restrict__ shade_in,
                   const float* __restrict__ payload,
                   const int* __restrict__ counts,
                   const float* __restrict__ cam_pos, float* __restrict__ out,
                   int tiles_x, int tiles_y, int tile_h, int tile_w,
                   int max_l, int slices) {
  extern __shared__ float lights[];  // max_l x kStride
  const int tile = blockIdx.x / slices;
  const int slice = blockIdx.x - tile * slices;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int n = min(counts[tile], max_l);
  const float* src = payload + (size_t)tile * max_l * kStride;
  for (int i = threadIdx.x; i < n * kStride; i += kThreads) lights[i] = src[i];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float* L = lights + j * kStride;
    L[kRange] = fmaxf(L[kRange], 1e-3f);
    L[kCone] = fmaxf(L[12] - L[13], 1e-4f);
    L[kSpot] = L[3] == 2.0f ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int npix = tile_h * tile_w;
  const int p = slice * kThreads + threadIdx.x;
  const bool in = p < npix;
  const int y = p / tile_w;
  const int x = p - y * tile_w;
  const int width = tiles_x * tile_w;
  const size_t plane = (size_t)width * (size_t)(tiles_y * tile_h);
  const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
  const float valid = in ? shade_in[11 * plane + o] : 0.0f;
  // Every thread of the block reaches the ballot: blocks are whole warps.
  const bool warp_lit = __ballot_sync(0xFFFFFFFFu, valid != 0.0f) != 0u;
  if (!in) return;
  if (!warp_lit) {
    out[o] = 0.0f;
    out[plane + o] = 0.0f;
    out[2 * plane + o] = 0.0f;
    return;
  }
  const float nx = shade_in[o], ny = shade_in[plane + o],
              nz = shade_in[2 * plane + o];
  const float ar = shade_in[3 * plane + o], ag = shade_in[4 * plane + o],
              ab = shade_in[5 * plane + o];
  const float metallic = shade_in[6 * plane + o];
  const float roughness = shade_in[7 * plane + o];
  const float wx = shade_in[8 * plane + o], wy = shade_in[9 * plane + o],
              wz = shade_in[10 * plane + o];
  const float camx = cam_pos[0], camy = cam_pos[1], camz = cam_pos[2];
  const float inv_pi = 0.3183098861837907f;

  float vx = camx - wx, vy = camy - wy, vz = camz - wz;
  const float vl = rsqrt_ieee(vx * vx + vy * vy + vz * vz + 1e-12f);
  vx *= vl;
  vy *= vl;
  vz *= vl;
  const float n_dot_v = fmaxf(nx * vx + ny * vy + nz * vz, 1e-4f);
  const float alpha = fmaxf(roughness * roughness, 1e-3f);
  const float a2 = alpha * alpha;
  const float f0r = 0.04f * (1.0f - metallic) + ar * metallic;
  const float f0g = 0.04f * (1.0f - metallic) + ag * metallic;
  const float f0b = 0.04f * (1.0f - metallic) + ab * metallic;
  const float kd = 1.0f - metallic;
  const float gv_sq = sqrtf(fmaxf(n_dot_v * n_dot_v * (1.0f - a2) + a2,
                                  1e-12f));
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float* L = lights + j * kStride;
    const float tlx = L[0] - wx, tly = L[1] - wy, tlz = L[2] - wz;
    const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
    const float inv_d = rsqrt_ieee(dist2 + 1e-12f);
    const float ux = tlx * inv_d, uy = tly * inv_d, uz = tlz * inv_d;
    float att = 1.0f / fmaxf(dist2, 1e-4f);
    const float dist = dist2 * inv_d;
    const float q = dist / L[kRange];
    const float q2 = q * q;
    const float win = fminf(fmaxf(1.0f - q2 * q2, 0.0f), 1.0f);
    att = att * win * win;
    if (L[kSpot] != 0.0f) {  // the same for every lane: no divergence
      const float cd = -(ux * L[4] + uy * L[5] + uz * L[6]);
      const float spot = fminf(fmaxf((cd - L[13]) / L[kCone], 0.0f), 1.0f);
      att = att * spot * spot;
    }
    float hx = ux + vx, hy = uy + vy, hz = uz + vz;
    const float hl = rsqrt_ieee(hx * hx + hy * hy + hz * hz + 1e-12f);
    hx *= hl;
    hy *= hl;
    hz *= hl;
    const float n_dot_l = fmaxf(nx * ux + ny * uy + nz * uz, 0.0f);
    const float n_dot_h = fmaxf(nx * hx + ny * hy + nz * hz, 0.0f);
    const float v_dot_h = fmaxf(vx * hx + vy * hy + vz * hz, 0.0f);
    const float dd = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
    const float D = a2 / fmaxf(3.14159265f * dd * dd, 1e-8f);
    const float gv = n_dot_l * gv_sq;
    const float gl = n_dot_v * sqrtf(fmaxf(n_dot_l * n_dot_l * (1.0f - a2) +
                                               a2,
                                           1e-12f));
    const float vis = 0.5f / fmaxf(gv + gl, 1e-8f);
    const float om = 1.0f - v_dot_h;
    const float om2 = om * om;
    const float fres = om2 * om2 * om;
    const float Fr = f0r + (1.0f - f0r) * fres;
    const float Fg = f0g + (1.0f - f0g) * fres;
    const float Fb = f0b + (1.0f - f0b) * fres;
    const float DV = D * vis;
    const float rad = L[7] * att * n_dot_l * valid;
    acc_r += (kd * (1.0f - Fr) * ar * inv_pi + DV * Fr) * L[8] * rad;
    acc_g += (kd * (1.0f - Fg) * ag * inv_pi + DV * Fg) * L[9] * rad;
    acc_b += (kd * (1.0f - Fb) * ab * inv_pi + DV * Fb) * L[10] * rad;
  }
  out[o] = acc_r;
  out[plane + o] = acc_g;
  out[2 * plane + o] = acc_b;
}

size_t smem_bytes(int max_l) {
  return (size_t)max_l * kStride * sizeof(float);
}

}  // namespace

// Launches the shader on `stream`; returns cudaGetLastError() (0 =
// launched). shade_in: (12, tiles_y*tile_h, tiles_x*tile_w) f32; payload:
// (tiles, max_l, 16) f32; counts: (tiles,) i32; cam_pos: (3,) f32; out:
// (3, tiles_y*tile_h, tiles_x*tile_w) f32. All contiguous, on device.
extern "C" int br_tiled_shade(const float* shade_in, const float* payload,
                              const int* counts, const float* cam_pos,
                              float* out, int tiles_x, int tiles_y, int tile_h,
                              int tile_w, int max_l, void* stream) {
  if (smem_bytes(max_l) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int slices = (tile_h * tile_w + kThreads - 1) / kThreads;
  const long long blocks = (long long)tiles_x * tiles_y * slices;
  if (blocks <= 0 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  tiled_shade_kernel<<<(unsigned)blocks, kThreads, smem_bytes(max_l),
                       static_cast<cudaStream_t>(stream)>>>(
      shade_in, payload, counts, cam_pos, out, tiles_x, tiles_y, tile_h,
      tile_w, max_l, slices);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the kernel at max_l light slots a tile (0 on
// error).
extern "C" int br_tiled_shade_blocks_per_sm(int max_l) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tiled_shade_kernel, kThreads, smem_bytes(max_l)) != cudaSuccess)
    return 0;
  return n;
}
