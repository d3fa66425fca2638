// Block-window texture evaluator, for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/textures.py::_tex_block_kernel, on RGBA8
// windows and on BC3 windows (which the reference decodes with
// bc3_decode_rows before its Pallas call). Wrappers and plain PyTorch
// versions: basicrenderer_tpu_torch/ops/textures.py::tex_block_eval.
//
// What it computes, per sampling job (a 16x16 pixel block's (channel,
// layer) pair): the job's window is WR atlas rows of 128 RGBA8 texels
// packed one per u32 (rows[job, :] names them). Each of the job's P pixels
// has a fractional tap centre x_hat in window lanes and yf in window rows;
// the result is the bilinear sum of the four byte channels over the two
// lanes and two rows around it, RGBA in [0, 255]:
//   x weights  w(l) = bf16(max(0, 1-|l-x|) + max(0, 1-|l-x+128|))
//              (the second term wraps lane 127 -> 0, as the TPU kernel's
//              hat identity does; bf16 as its MXU operands are),
//   y weights  max(0, 1-|r-yf|) in f32,
//   out        (c(l0)*w(l0) + c(l1)*w(l1)) * wy(r0) + (...) * wy(r0+1).
// The TPU kernel contracts all 128 lanes on the MXU and sums all WR rows;
// every other term is an exact zero, and the byte x bf16 products are
// exact in f32, so the two-tap sums here round exactly as it does.
//
// What bounds it on this card: bytes. A job reads its WR x 512-byte window
// (12 KB) and 8 bytes per pixel and writes 16 bytes per pixel, ~20 flops a
// pixel: at 1080p / texture_downscale 2 the mask pass has 2,040 blocks x 2
// jobs, ~60 MB, ~20 us at 3.35 TB/s.
//
// What the design does about it: one block per job; the window is staged
// in shared memory with coalesced 512-byte row reads (the atlas row gather
// is fused into the kernel), then each thread evaluates one pixel's four
// taps from shared memory and writes its RGBA as one 16-byte store.
//
// BC3 mode (tex_block_bc3_kernel): the job's window is 7 block rows of 32
// BC3 blocks (7 x 128 u32, 3.5 KB, words [a_lo, a_hi, c_ends, c_idx] per
// block). The block gathers them, decodes them in shared memory into
// 28 x 128 RGBA8 texel rows (14 KB; per texel the 565 expand, the
// 4-colour palette and the 8-step alpha palette, rounded half to even to
// a byte as bc3_decode_rows does), then runs the same evaluation. The
// reference decodes in XLA between the gather and its kernel; here the
// decode is fused into the window load, so a job reads 4x fewer bytes.
// Every palette lerp is spelled as separate f32 products and sums; over
// every 565 endpoint pair and every alpha pair, that form and both
// fused contractions round to the same byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float hat_x(int lane, float x) {
  const float d = __fsub_rn((float)lane, x);
  const float w = __fadd_rn(fmaxf(__fsub_rn(1.0f, fabsf(d)), 0.0f),
                            fmaxf(__fsub_rn(1.0f, fabsf(__fadd_rn(d, 128.0f))),
                                  0.0f));
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Copies the job's `wrows` atlas rows (ids clamped into the atlas) into
// shared memory.
__device__ __forceinline__ void gather_window(
    const uint32_t* __restrict__ strips, long long n_rows,
    const int* __restrict__ rows, long long job, int wrows, uint32_t* win) {
  for (int i = threadIdx.x; i < wrows * kLanes; i += kThreads) {
    long long r = rows[job * wrows + i / kLanes];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    win[i] = strips[r * kLanes + (i % kLanes)];
  }
}

// Each thread evaluates its pixels' two-by-two taps from the window of
// `wrows` RGBA8 texel rows in shared memory.
__device__ __forceinline__ void eval_window(
    const uint32_t* win, int wrows, long long job,
    const float* __restrict__ x_hat, const float* __restrict__ yf,
    float4* __restrict__ out, int npix) {
  for (int p = threadIdx.x; p < npix; p += kThreads) {
    const float x = x_hat[job * npix + p];
    const float y = yf[job * npix + p];
    const int l0 = ((int)floorf(x)) & (kLanes - 1);
    const int l1 = (l0 + 1) & (kLanes - 1);
    const float wa = hat_x(l0, x);
    const float wb = hat_x(l1, x);
    const int r0 = (int)floorf(y);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 2; ++k) {
      const int r = r0 + k;
      if (r >= wrows) break;
      const float wy = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn((float)r, y))),
                             0.0f);
      const uint32_t ta = win[r * kLanes + l0];
      const uint32_t tb = win[r * kLanes + l1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ca = (float)((ta >> (8 * c)) & 255u);
        const float cb = (float)((tb >> (8 * c)) & 255u);
        const float xr = __fadd_rn(__fmul_rn(ca, wa), __fmul_rn(cb, wb));
        acc[c] = __fadd_rn(acc[c], __fmul_rn(xr, wy));
      }
    }
    out[job * npix + p] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
tex_block_kernel(const uint32_t* __restrict__ strips, long long n_rows,
                 const int* __restrict__ rows, const float* __restrict__ x_hat,
                 const float* __restrict__ yf, float4* __restrict__ out,
                 int wrows, int npix) {
  extern __shared__ uint32_t win[];  // wrows x 128 words
  const long long job = blockIdx.x;
  gather_window(strips, n_rows, rows, job, wrows, win);
  __syncthreads();
  eval_window(win, wrows, job, x_hat, yf, out, npix);
}

constexpr int kBcRows = 7;               // gathered block rows per window
constexpr int kBcTexelRows = 4 * kBcRows;

// Round half to even and clamp to a byte (jnp.round, then clip).
__device__ __forceinline__ uint32_t q8(float x) {
  return (uint32_t)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

// c0 * w0 + c1 * (1 - w0) as separate f32 operations.
__device__ __forceinline__ uint32_t lerp8(float c0, float c1, float w0) {
  return q8(__fadd_rn(__fmul_rn(c0, w0), __fmul_rn(c1, __fsub_rn(1.0f, w0))));
}

// One decoded RGBA8 texel: row `yy` (0-3), column `sx` (0-3) of the BC3
// block whose four words start at `b`.
__device__ __forceinline__ uint32_t bc3_texel(const uint32_t* b, int yy,
                                              int sx) {
  const uint32_t a_lo = b[0], a_hi = b[1], c_end = b[2], c_idx = b[3];
  const int t = 4 * yy + sx;
  const uint32_t q0 = c_end & 0xFFFFu, q1 = c_end >> 16;
  const float k31 = (float)(255.0 / 31.0), k63 = (float)(255.0 / 63.0);
  const uint32_t ci = (c_idx >> (2 * t)) & 3u;
  const float w0 = ci == 0 ? 1.0f
                 : ci == 1 ? 0.0f
                 : ci == 2 ? (float)(2.0 / 3.0) : (float)(1.0 / 3.0);
  const uint32_t rr = lerp8(__fmul_rn((float)((q0 >> 11) & 31u), k31),
                            __fmul_rn((float)((q1 >> 11) & 31u), k31), w0);
  const uint32_t gg = lerp8(__fmul_rn((float)((q0 >> 5) & 63u), k63),
                            __fmul_rn((float)((q1 >> 5) & 63u), k63), w0);
  const uint32_t bb = lerp8(__fmul_rn((float)(q0 & 31u), k31),
                            __fmul_rn((float)(q1 & 31u), k31), w0);
  // 48 alpha index bits: 16 in a_lo's high half, 32 in a_hi.
  const uint32_t low = (a_lo >> 16) | ((a_hi & 0xFFFFu) << 16);
  const uint32_t hi16 = a_hi >> 16;
  const int bp = 3 * t;
  const uint32_t ai = bp <= 29 ? (low >> bp) & 7u
                    : bp == 30 ? ((low >> 30) & 3u) | ((hi16 & 1u) << 2)
                               : (hi16 >> (bp - 32)) & 7u;
  const float a0 = (float)(a_lo & 0xFFu), a1 = (float)((a_lo >> 8) & 0xFFu);
  const float af = (float)ai;
  const float a = ai == 0 ? a0
                : ai == 1 ? a1
                : __fmul_rn(__fadd_rn(__fmul_rn(a0, __fsub_rn(8.0f, af)),
                                      __fmul_rn(a1, __fsub_rn(af, 1.0f))),
                            (float)(1.0 / 7.0));
  return rr | (gg << 8) | (bb << 16) | (q8(a) << 24);
}

__global__ void __launch_bounds__(kThreads)
tex_block_bc3_kernel(const uint32_t* __restrict__ strips, long long n_rows,
                     const int* __restrict__ rows,
                     const float* __restrict__ x_hat,
                     const float* __restrict__ yf, float4* __restrict__ out,
                     int npix) {
  __shared__ uint32_t blocks[kBcRows * kLanes];    // 3.5 KB
  __shared__ uint32_t win[kBcTexelRows * kLanes];  // 14 KB
  const long long job = blockIdx.x;
  gather_window(strips, n_rows, rows, job, kBcRows, blocks);
  __syncthreads();
  for (int i = threadIdx.x; i < kBcTexelRows * kLanes; i += kThreads) {
    const int trow = i / kLanes, lane = i % kLanes;
    win[i] = bc3_texel(&blocks[(trow / 4) * kLanes + (lane / 4) * 4],
                       trow % 4, lane % 4);
  }
  __syncthreads();
  eval_window(win, kBcTexelRows, job, x_hat, yf, out, npix);
}

}  // namespace

// Launches the evaluator on `stream`; returns cudaGetLastError() (0 =
// launched). strips: (n_rows, 128) u32; rows: (jobs, wrows) i32; x_hat, yf:
// (jobs, npix) f32; out: (jobs, npix, 4) f32. All contiguous, on device.
extern "C" int br_tex_block_eval(const uint32_t* strips, long long n_rows,
                                 const int* rows, const float* x_hat,
                                 const float* yf, float* out, int jobs,
                                 int wrows, int npix, void* stream) {
  const size_t smem = (size_t)wrows * kLanes * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  tex_block_kernel<<<jobs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      strips, n_rows, rows, x_hat, yf, reinterpret_cast<float4*>(out), wrows,
      npix);
  return (int)cudaGetLastError();
}

// The BC3 mode: rows (jobs, 7) i32 block-row ids of each job's window;
// the rest as br_tex_block_eval. Returns cudaGetLastError().
extern "C" int br_tex_block_eval_bc3(const uint32_t* strips, long long n_rows,
                                     const int* rows, const float* x_hat,
                                     const float* yf, float* out, int jobs,
                                     int wrows, int npix, void* stream) {
  if (wrows != kBcRows) return (int)cudaErrorInvalidValue;
  tex_block_bc3_kernel<<<jobs, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      strips, n_rows, rows, x_hat, yf, reinterpret_cast<float4*>(out), npix);
  return (int)cudaGetLastError();
}
