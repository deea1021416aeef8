// K17: the LayerNorm of the ViT blocks (bf16 rows in, bf16 rows out).
//
// Replaces: picha_tpu/models/vit.py::_ln (:145-152), which XLA fuses into
// the forward graph: x -> f32, mu = mean(x), var = mean((x - mu)^2),
// (x - mu) / sqrt(var + 1e-6), * scale + bias (f32 parameters), -> bf16.
// It runs 2 x depth + 1 times per forward (25 at ViT-S/16).
//
// What bounds it on an H100: memory traffic. At the forward's shape
// (256 images x 196 tokens, d = 384) it reads 38.5 MB of bf16 and writes
// 38.5 MB: 0.023 ms at HBM peak, against ~10 flops an element. The design:
// one warp per row, the row held in registers (bf16 pairs, 16 a lane at
// most: d <= 1024), so x is read once for both passes; warp shuffles for
// the two sums; 8 rows a block of 256 threads. The arithmetic keeps the
// reference's rounding order: a two-pass mean and variance, true divisions
// (__fdiv_rn), an IEEE square root, * scale + bias without FMA
// contraction (__fmul_rn, __fadd_rn), one rounding to bf16 at the end
// (__float2bfloat16_rn). Only the order of the two sums differs from the
// plain version (picha_tpu_torch/ops/layernorm.py::layer_norm_plain).
//
// Widths outside the tuned envelope (odd, or past 1024) take a second,
// simpler kernel chosen by shape: one block of 256 threads a row, single
// bf16 loads, x read again from memory (L1 / L2) for each pass, the same
// two-pass order and true divisions, the sums across the block by warp
// shuffles and then the 8 warps' sums in warp order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // rows per block
constexpr int kMaxPairs = 16;   // bf16 pairs a lane holds: d <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32) vit_layernorm(
    const __nv_bfloat162* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, int64_t rows, int pairs, float d,
    __nv_bfloat162* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat162* xr = x + row * pairs;
  float2 v[kMaxPairs];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    if (p < pairs) {
      v[i] = __bfloat1622float2(xr[p]);
      s = __fadd_rn(__fadd_rn(s, v[i].x), v[i].y);
    }
  }
  const float mu = __fdiv_rn(warp_sum(s), d);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    if (lane + 32 * i < pairs) {
      v[i].x = __fsub_rn(v[i].x, mu);
      v[i].y = __fsub_rn(v[i].y, mu);
      q = __fadd_rn(__fadd_rn(q, __fmul_rn(v[i].x, v[i].x)), __fmul_rn(v[i].y, v[i].y));
    }
  }
  const float den = __fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), d), 1e-6f));
  __nv_bfloat162* orow = out + row * pairs;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    if (p < pairs) {
      const float a0 = __fadd_rn(__fmul_rn(__fdiv_rn(v[i].x, den), scale[2 * p]), bias[2 * p]);
      const float a1 =
          __fadd_rn(__fmul_rn(__fdiv_rn(v[i].y, den), scale[2 * p + 1]), bias[2 * p + 1]);
      orow[p] = __floats2bfloat162_rn(a0, a1);
    }
  }
}

// a sum across the block, the warps' sums in warp order; every thread
// gets it (red: kWarps floats of shared memory)
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red[w]);
  __syncthreads();
  return t;
}

// any width: one block a row, x re-read for each pass
__global__ void __launch_bounds__(kWarps * 32) vit_layernorm_rows(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, int d, __nv_bfloat16* __restrict__ out) {
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * d;
  const float df = static_cast<float>(d);
  float s = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) s = __fadd_rn(s, __bfloat162float(xr[j]));
  const float mu = __fdiv_rn(block_sum(s, red), df);
  float q = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = __fsub_rn(__bfloat162float(xr[j]), mu);
    q = __fadd_rn(q, __fmul_rn(v, v));
  }
  const float den = __fsqrt_rn(__fadd_rn(__fdiv_rn(block_sum(q, red), df), 1e-6f));
  __nv_bfloat16* orow = out + row * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = __fsub_rn(__bfloat162float(xr[j]), mu);
    orow[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(__fdiv_rn(v, den), scale[j]), bias[j]));
  }
}

}  // namespace

// x, out: (rows, d) bf16 (out may not alias x); scale, bias: (d,) float32;
// d >= 1 (the tuned kernel for even d <= 1024, 4-byte aligned rows; the
// block-a-row kernel otherwise). Returns cudaGetLastError().
extern "C" int picha_vit_layernorm(const void* x, const void* scale, const void* bias,
                                   int64_t rows, int d, void* out, void* stream) {
  if (rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if ((d & 1) || d > 2 * 32 * kMaxPairs) {
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    vit_layernorm_rows<<<static_cast<unsigned>(rows), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), d, static_cast<__nv_bfloat16*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  vit_layernorm<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat162*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), rows, d / 2, static_cast<float>(d),
      static_cast<__nv_bfloat162*>(out));
  return static_cast<int>(cudaGetLastError());
}
