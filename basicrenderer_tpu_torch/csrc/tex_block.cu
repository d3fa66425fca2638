// Block-window texture evaluator, for NVIDIA Hopper (sm_90a).
//
// Replaces basicrenderer_tpu/ops/textures.py::_tex_block_kernel (RGBA8
// windows). Wrapper and plain PyTorch version:
// basicrenderer_tpu_torch/ops/textures.py::tex_block_eval.
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

__global__ void __launch_bounds__(kThreads)
tex_block_kernel(const uint32_t* __restrict__ strips, long long n_rows,
                 const int* __restrict__ rows, const float* __restrict__ x_hat,
                 const float* __restrict__ yf, float4* __restrict__ out,
                 int wrows, int npix) {
  extern __shared__ uint32_t win[];  // wrows x 128 words
  const long long job = blockIdx.x;
  for (int i = threadIdx.x; i < wrows * kLanes; i += kThreads) {
    long long r = rows[job * wrows + i / kLanes];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    win[i] = strips[r * kLanes + (i % kLanes)];
  }
  __syncthreads();
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
