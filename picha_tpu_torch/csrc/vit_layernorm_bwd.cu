// K21: the backward of the ViT's LayerNorm (K17): dx, dscale and dbias.
//
// Replaces: the VJP that JAX derives from picha_tpu/models/vit.py::_ln
// (:145-152) inside jax.grad(loss_fn); XLA fuses it into the backward
// graph. With p = x - mu, r = sqrt(var + 1e-6), g = dy * scale (all f32):
//   dscale = sum over rows of (p / r) * dy,   dbias = sum over rows of dy,
//   dvar   = -(sum_k (g_k * r^-2) * p_k) * (0.5 / r) / d,
//   dx     = bf16((g / r + dvar * 2p) + (-(sum_k g_k / r) - sum_k dvar * 2p_k) / d),
// in that order of operations (JAX's derivative of the forward lines). It
// runs 2 x depth + 1 times per train step (25 at ViT-S/16).
//
// What bounds it on an H100: memory traffic. At the step's shape (256
// images x 196 tokens, d = 384) it reads x and dy (77 MB of bf16) and
// writes dx (38.5 MB): 0.035 ms at HBM peak, against ~30 flops an element.
// The design:
//   - kernel 1, one warp per row as K17, the row of x and dy in registers
//     (bf16 pairs, at most 16 a lane: d <= 1024); mu and r recomputed with
//     K17's arithmetic (two passes, true divisions, IEEE square root), so
//     they are the forward's own; the two row sums by warp shuffles; dx
//     rounded once to bf16. No FMA contraction (__fmul_rn, __fadd_rn).
//   - dscale and dbias without atomics, so two runs give the same bits: a
//     block of 8 warps takes 256 consecutive rows, each warp the rows
//     warp, warp + 8, ... in turn, each lane summing its own columns in
//     registers; the 8 warps' sums meet in shared memory in warp order and
//     the block writes one partial per column; kernel 2 sums the blocks'
//     partials of a column in block order.
// Widths outside the tuned envelope (odd, or past 1024) take a simpler
// path chosen by shape, with the same arithmetic: ln_bwd_row_any, one
// block of 256 threads a row, x and dy re-read from memory for each of
// its five passes (mu, r, the variance path's sum with -g / r, -dvar 2p,
// dx), the block's sums by warp shuffles and then the warps in order; it
// keeps each row's mu and r for ln_bwd_cols_any, one thread a column
// summing (p / r) dy and dy over a block's 256 rows in order into the same
// per-block partials, which ln_bwd_columns then sums in block order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 256;   // rows a block sums into one partial
constexpr int kMaxPairs = 16;        // bf16 pairs a lane holds: d <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// NP: pairs a lane holds (pairs <= 32 * NP)
template <int NP>
__global__ void __launch_bounds__(kWarps * 32) ln_bwd_rows(
    const __nv_bfloat162* __restrict__ x, const float2* __restrict__ scale,
    const __nv_bfloat162* __restrict__ dy, int64_t rows, int pairs, float d,
    __nv_bfloat162* __restrict__ dx, float* __restrict__ partial) {
  extern __shared__ float wsum[];   // kWarps x 2 x (2 * pairs)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2 ps[NP], pb[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) ps[i] = pb[i] = make_float2(0.0f, 0.0f);

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  for (int rr = warp; rr < kRowsPerBlock; rr += kWarps) {
    const int64_t row = row0 + rr;
    if (row >= rows) break;
    const __nv_bfloat162* xr = x + row * pairs;
    const __nv_bfloat162* gr = dy + row * pairs;
    float2 v[NP], z[NP];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs) {
        v[i] = __bfloat1622float2(xr[p]);
        z[i] = __bfloat1622float2(gr[p]);
        s = __fadd_rn(__fadd_rn(s, v[i].x), v[i].y);
      }
    }
    const float mu = __fdiv_rn(warp_sum(s), d);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (lane + 32 * i < pairs) {
        v[i].x = __fsub_rn(v[i].x, mu);
        v[i].y = __fsub_rn(v[i].y, mu);
        q = __fadd_rn(__fadd_rn(q, __fmul_rn(v[i].x, v[i].x)), __fmul_rn(v[i].y, v[i].y));
      }
    }
    const float r = __fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), d), 1e-6f));
    const float u = __fdiv_rn(1.0f, __fmul_rn(r, r));
    // the sum through the variance, and the column sums
    float a = 0.0f, bq = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs) {
        const float2 sc = scale[p];
        const float gx = __fmul_rn(z[i].x, sc.x), gy = __fmul_rn(z[i].y, sc.y);
        a = __fadd_rn(__fadd_rn(a, __fmul_rn(__fmul_rn(gx, u), v[i].x)),
                      __fmul_rn(__fmul_rn(gy, u), v[i].y));
        ps[i].x = __fadd_rn(ps[i].x, __fmul_rn(__fdiv_rn(v[i].x, r), z[i].x));
        ps[i].y = __fadd_rn(ps[i].y, __fmul_rn(__fdiv_rn(v[i].y, r), z[i].y));
        pb[i].x = __fadd_rn(pb[i].x, z[i].x);
        pb[i].y = __fadd_rn(pb[i].y, z[i].y);
        z[i].x = __fdiv_rn(gx, r);   // z now holds g / r
        z[i].y = __fdiv_rn(gy, r);
        bq = __fadd_rn(__fadd_rn(bq, -z[i].x), -z[i].y);
      }
    }
    const float dvar = __fdiv_rn(__fmul_rn(-warp_sum(a), __fdiv_rn(0.5f, r)), d);
    float by = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (lane + 32 * i < pairs) {
        v[i].x = __fmul_rn(dvar, __fmul_rn(2.0f, v[i].x));   // v now holds dvar * 2p
        v[i].y = __fmul_rn(dvar, __fmul_rn(2.0f, v[i].y));
        by = __fadd_rn(__fadd_rn(by, -v[i].x), -v[i].y);
      }
    }
    const float dmu = __fdiv_rn(__fadd_rn(warp_sum(bq), warp_sum(by)), d);
    __nv_bfloat162* orow = dx + row * pairs;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs)
        orow[p] = __floats2bfloat162_rn(__fadd_rn(__fadd_rn(z[i].x, v[i].x), dmu),
                                        __fadd_rn(__fadd_rn(z[i].y, v[i].y), dmu));
    }
  }

  // the block's partial column sums: the warps in order
  const int d2 = 2 * pairs;
  float* mine = wsum + static_cast<int64_t>(warp) * 2 * d2;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    if (p < pairs) {
      mine[2 * p] = ps[i].x;
      mine[2 * p + 1] = ps[i].y;
      mine[d2 + 2 * p] = pb[i].x;
      mine[d2 + 2 * p + 1] = pb[i].y;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d2; c += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, wsum[w * 2 * d2 + c]);
    partial[static_cast<int64_t>(blockIdx.x) * 2 * d2 + c] = acc;
  }
}

// out[c] = the sum of partial[b][c] over the blocks b in order; c < 2d
__global__ void __launch_bounds__(256) ln_bwd_columns(const float* __restrict__ partial,
                                                      int nblk, int cols,
                                                      float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.0f;
  for (int b = 0; b < nblk; ++b) acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * cols + c]);
  out[c] = acc;
}

template <int NP>
int launch_rows(const void* x, const void* scale, const void* dy, int64_t rows, int d, void* dx,
                void* partial, unsigned nblk, cudaStream_t st) {
  const size_t bytes = static_cast<size_t>(kWarps) * 2 * d * sizeof(float);
  cudaError_t rc = cudaFuncSetAttribute(ln_bwd_rows<NP>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  ln_bwd_rows<NP><<<nblk, kWarps * 32, bytes, st>>>(
      static_cast<const __nv_bfloat162*>(x), static_cast<const float2*>(scale),
      static_cast<const __nv_bfloat162*>(dy), rows, d / 2, static_cast<float>(d),
      static_cast<__nv_bfloat162*>(dx), static_cast<float*>(partial));
  return static_cast<int>(cudaGetLastError());
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

// any width: one block a row -> dx, and the row's (mu, r) into stats
__global__ void __launch_bounds__(kWarps * 32) ln_bwd_row_any(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const __nv_bfloat16* __restrict__ dy, int d, __nv_bfloat16* __restrict__ dx,
    float2* __restrict__ stats) {
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * d;
  const __nv_bfloat16* gr = dy + row * d;
  const float df = static_cast<float>(d);
  float s = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) s = __fadd_rn(s, __bfloat162float(xr[j]));
  const float mu = __fdiv_rn(block_sum(s, red), df);
  float q = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = __fsub_rn(__bfloat162float(xr[j]), mu);
    q = __fadd_rn(q, __fmul_rn(v, v));
  }
  const float r = __fsqrt_rn(__fadd_rn(__fdiv_rn(block_sum(q, red), df), 1e-6f));
  const float u = __fdiv_rn(1.0f, __fmul_rn(r, r));
  float a = 0.0f, bq = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float p = __fsub_rn(__bfloat162float(xr[j]), mu);
    const float g = __fmul_rn(__bfloat162float(gr[j]), scale[j]);
    a = __fadd_rn(a, __fmul_rn(__fmul_rn(g, u), p));
    bq = __fadd_rn(bq, -__fdiv_rn(g, r));
  }
  const float dvar = __fdiv_rn(__fmul_rn(-block_sum(a, red), __fdiv_rn(0.5f, r)), df);
  const float bqs = block_sum(bq, red);
  float by = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float p = __fsub_rn(__bfloat162float(xr[j]), mu);
    by = __fadd_rn(by, -__fmul_rn(dvar, __fmul_rn(2.0f, p)));
  }
  const float dmu = __fdiv_rn(__fadd_rn(bqs, block_sum(by, red)), df);
  __nv_bfloat16* orow = dx + row * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float p = __fsub_rn(__bfloat162float(xr[j]), mu);
    const float g = __fmul_rn(__bfloat162float(gr[j]), scale[j]);
    orow[j] = __float2bfloat16_rn(
        __fadd_rn(__fadd_rn(__fdiv_rn(g, r), __fmul_rn(dvar, __fmul_rn(2.0f, p))), dmu));
  }
  if (threadIdx.x == 0) stats[row] = make_float2(mu, r);
}

// any width: partial[b][0][c] = the sum of (p / r) dy over block b's rows
// in order, partial[b][1][c] = the sum of dy; one thread a column
__global__ void __launch_bounds__(256) ln_bwd_cols_any(const __nv_bfloat16* __restrict__ x,
                                                       const __nv_bfloat16* __restrict__ dy,
                                                       const float2* __restrict__ stats,
                                                       int64_t rows, int d,
                                                       float* __restrict__ partial) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock;
  const int64_t r1 = r0 + kRowsPerBlock < rows ? r0 + kRowsPerBlock : rows;
  float ps = 0.0f, pb = 0.0f;
  for (int64_t row = r0; row < r1; ++row) {
    const float2 st = stats[row];
    const float z = __bfloat162float(dy[row * d + c]);
    const float p = __fsub_rn(__bfloat162float(x[row * d + c]), st.x);
    ps = __fadd_rn(ps, __fmul_rn(__fdiv_rn(p, st.y), z));
    pb = __fadd_rn(pb, z);
  }
  float* out = partial + static_cast<int64_t>(blockIdx.y) * 2 * d;
  out[c] = ps;
  out[d + c] = pb;
}

}  // namespace

// x, dy, dx: (rows, d) bf16 (dx may not alias x or dy); scale: (d,) float32;
// d >= 1 (the tuned kernel for even d <= 1024, 4-byte aligned rows;
// otherwise the block-a-row path, which needs stats: (rows, 2) float32
// scratch); partial: (ceil(rows / 256), 2, d) float32 scratch; dsb: (2, d)
// float32 out, dscale then dbias. Returns cudaGetLastError().
extern "C" int picha_vit_layernorm_bwd(const void* x, const void* scale, const void* dy,
                                       int64_t rows, int d, void* dx, void* partial, void* dsb,
                                       void* stats, void* stream) {
  if (rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    const cudaError_t rc = cudaMemsetAsync(dsb, 0, static_cast<size_t>(2) * d * sizeof(float), st);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  const int64_t nblk = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (nblk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int np = (d / 2 + 31) / 32;
  const unsigned nb = static_cast<unsigned>(nblk);
  int rc;
  if ((d & 1) || d > 2 * 32 * kMaxPairs) {
    if (stats == nullptr || nblk > 65535 || rows > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    ln_bwd_row_any<<<static_cast<unsigned>(rows), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const __nv_bfloat16*>(dy), d, static_cast<__nv_bfloat16*>(dx),
        static_cast<float2*>(stats));
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    ln_bwd_cols_any<<<dim3((d + 255) / 256, nb), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<const float2*>(stats), rows, d, static_cast<float*>(partial));
    rc = static_cast<int>(cudaGetLastError());
  } else if (np <= 2) rc = launch_rows<2>(x, scale, dy, rows, d, dx, partial, nb, st);
  else if (np <= 4) rc = launch_rows<4>(x, scale, dy, rows, d, dx, partial, nb, st);
  else if (np <= 6) rc = launch_rows<6>(x, scale, dy, rows, d, dx, partial, nb, st);
  else if (np <= 8) rc = launch_rows<8>(x, scale, dy, rows, d, dx, partial, nb, st);
  else if (np <= 12) rc = launch_rows<12>(x, scale, dy, rows, d, dx, partial, nb, st);
  else rc = launch_rows<16>(x, scale, dy, rows, d, dx, partial, nb, st);
  if (rc != 0) return rc;
  const int cols = 2 * d;
  ln_bwd_columns<<<(cols + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                     static_cast<int>(nblk), cols,
                                                     static_cast<float*>(dsb));
  return static_cast<int>(cudaGetLastError());
}
