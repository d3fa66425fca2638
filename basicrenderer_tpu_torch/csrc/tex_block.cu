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
// With a `live` mask (JN, P) u8 the result is eval where live, else 0:
// the frame passes the sampler's job masks, whose dead pixels it zeroes
// anyway.
//
// What bounds it on this card: bytes. A live job reads its WR x 512-byte
// window (12 KB) and 8 bytes per pixel and writes 16 bytes per pixel,
// ~60 flops a pixel: at 1080p / texture_downscale 2 the channels pass has
// 2,040 blocks x 4 jobs. A frame with no alpha-MASK material has a mask
// pass of dead jobs only, and the channels pass's sky blocks are dead.
//
// What the design does about it: one block per job, one pixel a thread.
// - A job with no live pixel reads no row and no tap centre: it writes
//   its zeros and ends.
// - A live job reads its window's row ids once into shared memory, then
//   copies the window's 512-byte rows with cp.async, 16 bytes a thread,
//   every copy in flight at once (the atlas row gather is fused into the
//   kernel; no chain of dependent loads).
// - Each thread evaluates its pixel's four taps from shared memory and
//   writes its RGBA as one 16-byte store (0 at a dead pixel).
//
// BC3 mode (tex_block_bc3_kernel): the job's window is 7 block rows of 32
// BC3 blocks (7 x 128 u32, 3.5 KB, words [a_lo, a_hi, c_ends, c_idx] per
// block), copied as above. Each tap decodes its own texel from the
// staged block words (bc3_texel: the 565 expand, the 4-colour palette and
// the 8-step alpha palette of its block, rounded half to even to a byte
// as bc3_decode_rows does), at most 4 texels a pixel, so no decoded
// window is kept: a job's 256 pixels read at most ~21 x 21 texels of the
// window's 28 x 128 (FIT_TEXELS bumps the mip beyond that), and decoding
// all of them cost ~8x the taps' decodes. The reference decodes in XLA
// between the gather and its kernel; here a job reads 4x fewer bytes.
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

constexpr int kMaxWrows = 64;   // window rows a job may have (32 KB)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Whether any of the job's pixels is live (every thread calls it); a
// dead job writes its zeros here.
__device__ __forceinline__ bool job_live(const uint8_t* __restrict__ live,
                                         long long job, int npix,
                                         float4* __restrict__ out) {
  bool any = live == nullptr;
  for (int p = threadIdx.x; p < npix && !any; p += kThreads)
    any = live[job * npix + p] != 0;
  if (__syncthreads_or(any)) return true;
  for (int p = threadIdx.x; p < npix; p += kThreads)
    out[job * npix + p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return false;
}

// Copies the job's `wrows` atlas rows (ids clamped into the atlas) into
// shared memory: the ids once, then every 16-byte piece by cp.async, all
// in flight together. Ends with the window visible to the block.
__device__ __forceinline__ void gather_window(
    const uint32_t* __restrict__ strips, long long n_rows,
    const int* __restrict__ rows, long long job, int wrows, int* ids,
    uint32_t* win) {
  if (threadIdx.x < wrows) {
    const long long r = rows[job * wrows + threadIdx.x];
    ids[threadIdx.x] = (int)(r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r));
  }
  __syncthreads();
  constexpr int kPieces = kLanes / 4;   // 16-byte pieces of a row
  for (int q = threadIdx.x; q < wrows * kPieces; q += kThreads)
    cp_async16(win + q * 4,
               strips + (long long)ids[q / kPieces] * kLanes +
                   (q % kPieces) * 4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Each thread evaluates its pixels' two-by-two taps over a window of
// `wrows` texel rows: texel(r, l) gives the RGBA8 texel of row r, lane l.
// Dead pixels (live[p] == 0) write 0.
template <typename Texel>
__device__ __forceinline__ void eval_window(
    Texel texel, int wrows, long long job, const float* __restrict__ x_hat,
    const float* __restrict__ yf, const uint8_t* __restrict__ live,
    float4* __restrict__ out, int npix) {
  for (int p = threadIdx.x; p < npix; p += kThreads) {
    const long long i = job * npix + p;
    if (live != nullptr && live[i] == 0) {
      out[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float x = x_hat[i];
    const float y = yf[i];
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
      const uint32_t ta = texel(r, l0);
      const uint32_t tb = texel(r, l1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ca = (float)((ta >> (8 * c)) & 255u);
        const float cb = (float)((tb >> (8 * c)) & 255u);
        const float xr = __fadd_rn(__fmul_rn(ca, wa), __fmul_rn(cb, wb));
        acc[c] = __fadd_rn(acc[c], __fmul_rn(xr, wy));
      }
    }
    out[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
tex_block_kernel(const uint32_t* __restrict__ strips, long long n_rows,
                 const int* __restrict__ rows, const float* __restrict__ x_hat,
                 const float* __restrict__ yf,
                 const uint8_t* __restrict__ live, float4* __restrict__ out,
                 int wrows, int npix) {
  extern __shared__ __align__(16) uint32_t win[];  // wrows x 128 words
  __shared__ int ids[kMaxWrows];
  const long long job = blockIdx.x;
  if (!job_live(live, job, npix, out)) return;
  gather_window(strips, n_rows, rows, job, wrows, ids, win);
  eval_window([&](int r, int l) { return win[r * kLanes + l]; }, wrows, job,
              x_hat, yf, live, out, npix);
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
                     const float* __restrict__ yf,
                     const uint8_t* __restrict__ live,
                     float4* __restrict__ out, int npix) {
  __shared__ __align__(16) uint32_t blocks[kBcRows * kLanes];  // 3.5 KB
  __shared__ int ids[kBcRows];
  const long long job = blockIdx.x;
  if (!job_live(live, job, npix, out)) return;
  gather_window(strips, n_rows, rows, job, kBcRows, ids, blocks);
  // Texel (r, l) of the decoded window: row r % 4, column l % 4 of block
  // l / 4 in block row r / 4.
  eval_window(
      [&](int r, int l) {
        return bc3_texel(&blocks[(r >> 2) * kLanes + (l & ~3)], r & 3, l & 3);
      },
      kBcTexelRows, job, x_hat, yf, live, out, npix);
}

}  // namespace

// Launches the evaluator on `stream`; returns cudaGetLastError() (0 =
// launched). strips: (n_rows, 128) u32, 16-byte aligned; rows: (jobs,
// wrows) i32; x_hat, yf: (jobs, npix) f32; live: (jobs, npix) u8 or null
// (every pixel live); out: (jobs, npix, 4) f32. All contiguous, on device.
extern "C" int br_tex_block_eval(const uint32_t* strips, long long n_rows,
                                 const int* rows, const float* x_hat,
                                 const float* yf, const uint8_t* live,
                                 float* out, int jobs, int wrows, int npix,
                                 void* stream) {
  if (wrows < 1 || wrows > kMaxWrows) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)wrows * kLanes * sizeof(uint32_t);
  tex_block_kernel<<<jobs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      strips, n_rows, rows, x_hat, yf, live, reinterpret_cast<float4*>(out),
      wrows, npix);
  return (int)cudaGetLastError();
}

// The BC3 mode: rows (jobs, 7) i32 block-row ids of each job's window;
// the rest as br_tex_block_eval. Returns cudaGetLastError().
extern "C" int br_tex_block_eval_bc3(const uint32_t* strips, long long n_rows,
                                     const int* rows, const float* x_hat,
                                     const float* yf, const uint8_t* live,
                                     float* out, int jobs, int wrows,
                                     int npix, void* stream) {
  if (wrows != kBcRows) return (int)cudaErrorInvalidValue;
  tex_block_bc3_kernel<<<jobs, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      strips, n_rows, rows, x_hat, yf, live, reinterpret_cast<float4*>(out),
      npix);
  return (int)cudaGetLastError();
}
