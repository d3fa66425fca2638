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
//
// What bounds it on this card: bytes at low light counts (12 planes in, 3
// out: ~125 MB at 1088 x 1920), operations at high ones (~150 f32
// operations per pixel and light). One block per tile, so the busiest
// tile's light count sets the tail of the launch.
//
// What the design does about it: one block per tile stages the tile's
// light rows (at most max_l x 64 bytes) in shared memory once; every thread
// then reads each light as a broadcast. Each thread owns pixels strided by
// the block size, so plane reads and writes are coalesced, and keeps one
// pixel's G-buffer values and its three sums in registers while it walks
// the lights.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 16;  // LIGHT_STRIDE
constexpr int kPlanes = 12;  // SHADE_IN_CHANNELS

__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}

__global__ void __launch_bounds__(kThreads)
tiled_shade_kernel(const float* __restrict__ shade_in,
                   const float* __restrict__ payload,
                   const int* __restrict__ counts,
                   const float* __restrict__ cam_pos, float* __restrict__ out,
                   int tiles_x, int tiles_y, int tile_h, int tile_w,
                   int max_l) {
  extern __shared__ float lights[];  // max_l x kStride
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int n = min(counts[tile], max_l);
  const float* src = payload + (size_t)tile * max_l * kStride;
  for (int i = threadIdx.x; i < n * kStride; i += kThreads) lights[i] = src[i];
  __syncthreads();

  const int width = tiles_x * tile_w;
  const size_t plane = (size_t)width * (size_t)(tiles_y * tile_h);
  const float camx = cam_pos[0], camy = cam_pos[1], camz = cam_pos[2];
  const float inv_pi = 0.3183098861837907f;
  for (int p = threadIdx.x; p < tile_h * tile_w; p += kThreads) {
    const int y = p / tile_w;
    const int x = p - y * tile_w;
    const size_t o = (size_t)(ty * tile_h + y) * width + (tx * tile_w + x);
    float g[kPlanes];
#pragma unroll
    for (int c = 0; c < kPlanes; ++c) g[c] = shade_in[c * plane + o];
    const float nx = g[0], ny = g[1], nz = g[2];
    const float ar = g[3], ag = g[4], ab = g[5];
    const float metallic = g[6], roughness = g[7];
    const float wx = g[8], wy = g[9], wz = g[10], valid = g[11];

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
    for (int j = 0; j < n; ++j) {
      const float* L = lights + j * kStride;
      const float tlx = L[0] - wx, tly = L[1] - wy, tlz = L[2] - wz;
      const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
      const float inv_d = rsqrt_ieee(dist2 + 1e-12f);
      const float ux = tlx * inv_d, uy = tly * inv_d, uz = tlz * inv_d;
      float att = 1.0f / fmaxf(dist2, 1e-4f);
      const float dist = dist2 * inv_d;
      const float q = dist / fmaxf(L[11], 1e-3f);
      const float q2 = q * q;
      const float win = fminf(fmaxf(1.0f - q2 * q2, 0.0f), 1.0f);
      att = att * win * win;
      if (L[3] == 2.0f) {
        const float cd = -(ux * L[4] + uy * L[5] + uz * L[6]);
        const float spot = fminf(fmaxf((cd - L[13]) /
                                           fmaxf(L[12] - L[13], 1e-4f),
                                       0.0f),
                                 1.0f);
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
  const size_t smem = (size_t)max_l * kStride * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  tiled_shade_kernel<<<tiles_x * tiles_y, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      shade_in, payload, counts, cam_pos, out, tiles_x, tiles_y, tile_h,
      tile_w, max_l);
  return (int)cudaGetLastError();
}
