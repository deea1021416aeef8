// K23 and K24: the backward of the ViT's switch-MoE routing (K19, K20)
// around the expert products.
//
// Replaces: the VJPs that JAX derives from picha_tpu/models/vit.py::
// _switch_moe inside jax.grad(loss_fn):
//   K23, of the router softmax / max and the dispatch scatter (:213-224):
//     dy_t[t] = dxe[eidx, sidx] (0 for a dropped token: its row went to the
//     trash row the reference cuts off); dgate = dgk * keep goes back through
//     max (split equally among tied gates: _reduce_chooser_jvp_rule) and the
//     softmax, recomputed with K19's arithmetic (max, expf, the sum in expert
//     order, true divisions): dlogits = ((dg / l) + -(sum_e (dg_e * l^-2) *
//     ex_e)) * ex, ex the exponentials after the max subtract, l their sum;
//   K24, of the combine gather (:228-230): dye[eidx, sidx] = dout * bf16(gk),
//     every other slot 0, -0 written as +0 (the reference's scatter adds into
//     zeros); dgk = bf16(sum over the row of bf16(dout * ye[eidx, sidx])),
//     the products rounded to bf16 as the reference forms them, summed in
//     f32, rounded to bf16 (the gate entered the product as a bf16 value).
// Each runs once per MoE block of a train step (6 times at ViT-S/16 with
// every second block an MoE).
//
// What bounds them on an H100: memory traffic. At the step's shape (t =
// 50,176 tokens, E = 4, d = 384, cap = 18,816) K23 reads the kept rows of
// dxe (at most 38.5 MB) and 1 MB of logits and indices and writes 38.5 MB
// of dy_t and 0.8 MB of dlogits, ~0.024 ms at HBM peak; K24 reads dout and
// the kept rows of ye (77 MB) and writes dye (57.8 MB), ~0.04 ms. The
// design:
//   K23, two launches: moe_softmax_bwd, one thread a token (E <= 64, the
//   exponentials recomputed in each loop rather than kept); moe_gather, one
//   thread per 16 bytes of dy_t.
//   K24: dye cleared with one memset, then moe_combine_bwd, one warp a
//   token: lanes take the row's 16-byte chunks lane, lane + 32, ..., write
//   the scaled chunk into the token's slot and add the 8 rounded products
//   of each chunk in order; the 32 lane sums meet in a butterfly, a fixed
//   order that the plain version (picha_tpu_torch/ops/moe.py::
//   warp_order_sum) repeats, so both give the same bits. No atomics: slots
//   are unique per kept token.
// Any expert count: moe_softmax_bwd loops the router row over the experts.
// A width that is not a multiple of 8 takes scalar twins chosen by shape:
// moe_gather_any (one bf16 value a thread) and moe_combine_bwd_any (one
// warp a token as above, lanes taking the row's 8-value chunks in the same
// order, the last chunk cut short, so that the sum is warp_order_sum's).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t plus_zero(uint32_t w) {
  if ((w & 0xffffu) == 0x8000u) w &= 0xffff0000u;
  if ((w >> 16) == 0x8000u) w &= 0x0000ffffu;
  return w;
}

__global__ void __launch_bounds__(256) moe_softmax_bwd(const float* __restrict__ logits,
                                                       const int* __restrict__ eidx,
                                                       const float* __restrict__ dgk, int64_t t,
                                                       int E, float* __restrict__ dlogits) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < t;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float* l = logits + i * E;
    float m = l[0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, l[e]);
    float sum = 0.0f;
    for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, expf(__fsub_rn(l[e], m)));
    float best = 0.0f;
    for (int e = 0; e < E; ++e) {
      const float g = __fdiv_rn(expf(__fsub_rn(l[e], m)), sum);
      if (e == 0 || g > best) best = g;
    }
    int count = 0;
    for (int e = 0; e < E; ++e) count += __fdiv_rn(expf(__fsub_rn(l[e], m)), sum) == best;
    const int ei = eidx[i];
    const float dgate = __fmul_rn(dgk[i], ei >= 0 && ei < E ? 1.0f : 0.0f);
    const float q = __fdiv_rn(dgate, static_cast<float>(count));
    const float inv = __fdiv_rn(1.0f, __fmul_rn(sum, sum));
    float c = 0.0f;
    for (int e = 0; e < E; ++e) {
      const float ex = expf(__fsub_rn(l[e], m));
      const float dg = __fmul_rn(q, __fdiv_rn(ex, sum) == best ? 1.0f : 0.0f);
      const float w = __fmul_rn(__fmul_rn(dg, inv), ex);
      c = e == 0 ? w : __fadd_rn(c, w);
    }
    float* out = dlogits + i * E;
    for (int e = 0; e < E; ++e) {
      const float ex = expf(__fsub_rn(l[e], m));
      const float dg = __fmul_rn(q, __fdiv_rn(ex, sum) == best ? 1.0f : 0.0f);
      out[e] = __fmul_rn(__fadd_rn(__fdiv_rn(dg, sum), -c), ex);
    }
  }
}

__global__ void __launch_bounds__(256) moe_gather(const uint4* __restrict__ dxe,
                                                  const int* __restrict__ eidx,
                                                  const int* __restrict__ sidx, int64_t t, int E,
                                                  int cap, int chunks, uint4* __restrict__ dy) {
  const int64_t total = t * chunks;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < total;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = k / chunks;
    const int c = static_cast<int>(k - i * chunks);
    const int e = eidx[i], s = sidx[i];
    dy[k] = e >= 0 && e < E && s >= 0 && s < cap
                ? dxe[(static_cast<int64_t>(e) * cap + s) * chunks + c]
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// one 32-bit word (two bf16) of dout and of ye: the scaled word, and the two
// rounded products added to acc in order
__device__ __forceinline__ uint32_t bwd_word(uint32_t dw, uint32_t yw, float g, float& acc) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = dw;
  const float2 a = __bfloat1622float2(h);
  *reinterpret_cast<uint32_t*>(&h) = yw;
  const float2 b = __bfloat1622float2(h);
  acc = __fadd_rn(acc, round_bf16(__fmul_rn(a.x, b.x)));
  acc = __fadd_rn(acc, round_bf16(__fmul_rn(a.y, b.y)));
  h = __floats2bfloat162_rn(__fmul_rn(a.x, g), __fmul_rn(a.y, g));
  return plus_zero(*reinterpret_cast<uint32_t*>(&h));
}

__global__ void __launch_bounds__(256) moe_combine_bwd(
    const uint4* __restrict__ dout, const uint4* __restrict__ ye, const int* __restrict__ eidx,
    const int* __restrict__ sidx, const float* __restrict__ gk, int64_t t, int E, int cap,
    int chunks, uint4* __restrict__ dye, float* __restrict__ dgk) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       i < t; i += warps) {
    const int e = eidx[i], s = sidx[i];
    const bool kept = e >= 0 && e < E && s >= 0 && s < cap;
    const float g = round_bf16(gk[i]);
    const int64_t slot = kept ? (static_cast<int64_t>(e) * cap + s) * chunks : 0;
    float acc = 0.0f;
    for (int c = lane; c < chunks; c += 32) {
      const uint4 dv = dout[i * chunks + c];
      const uint4 yv = kept ? ye[slot + c] : make_uint4(0u, 0u, 0u, 0u);
      uint4 out;
      out.x = bwd_word(dv.x, yv.x, g, acc);
      out.y = bwd_word(dv.y, yv.y, g, acc);
      out.z = bwd_word(dv.z, yv.z, g, acc);
      out.w = bwd_word(dv.w, yv.w, g, acc);
      if (kept) dye[slot + c] = out;
    }
    acc = warp_sum(acc);
    if (lane == 0) dgk[i] = round_bf16(acc);
  }
}

__global__ void __launch_bounds__(256) moe_gather_any(const uint16_t* __restrict__ dxe,
                                                      const int* __restrict__ eidx,
                                                      const int* __restrict__ sidx, int64_t t,
                                                      int E, int cap, int d,
                                                      uint16_t* __restrict__ dy) {
  const int64_t total = t * d;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < total;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = k / d;
    const int c = static_cast<int>(k - i * d);
    const int e = eidx[i], s = sidx[i];
    dy[k] = e >= 0 && e < E && s >= 0 && s < cap ? dxe[(static_cast<int64_t>(e) * cap + s) * d + c]
                                                  : static_cast<uint16_t>(0);
  }
}

__global__ void __launch_bounds__(256) moe_combine_bwd_any(
    const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ ye,
    const int* __restrict__ eidx, const int* __restrict__ sidx, const float* __restrict__ gk,
    int64_t t, int E, int cap, int d, __nv_bfloat16* __restrict__ dye, float* __restrict__ dgk) {
  const int lane = threadIdx.x & 31;
  const int chunks = (d + 7) / 8;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       i < t; i += warps) {
    const int e = eidx[i], s = sidx[i];
    const bool kept = e >= 0 && e < E && s >= 0 && s < cap;
    const float g = round_bf16(gk[i]);
    const int64_t slot = kept ? (static_cast<int64_t>(e) * cap + s) * d : 0;
    float acc = 0.0f;
    for (int c = lane; c < chunks; c += 32) {
      const int j1 = 8 * c + 8 < d ? 8 * c + 8 : d;
      for (int j = 8 * c; j < j1; ++j) {
        const float a = __bfloat162float(dout[i * d + j]);
        const float b = kept ? __bfloat162float(ye[slot + j]) : 0.0f;
        acc = __fadd_rn(acc, round_bf16(__fmul_rn(a, b)));
        if (kept) {
          const __nv_bfloat16 w = __float2bfloat16_rn(__fmul_rn(a, g));
          dye[slot + j] = __bfloat16_as_ushort(w) == 0x8000u ? __ushort_as_bfloat16(0) : w;
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) dgk[i] = round_bf16(acc);
  }
}

int grid_for(int64_t items, int per_block) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (items + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

// dxe: (E, cap, d) bf16 (16-byte aligned where d is a multiple of 8); eidx,
// sidx: (t,) int32; logits: (t, E) float32; dgk: (t,) float32; dy: (t, d)
// bf16 out; dlogits: (t, E) float32 out. Returns cudaGetLastError().
extern "C" int picha_moe_dispatch_bwd(const void* dxe, const void* eidx, const void* sidx,
                                      const void* logits, const void* dgk, int64_t t, int E,
                                      int cap, int d, void* dy, void* dlogits, void* stream) {
  if (t < 0 || E < 1 || cap < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  moe_softmax_bwd<<<grid_for(t, 256), 256, 0, st>>>(
      static_cast<const float*>(logits), static_cast<const int*>(eidx),
      static_cast<const float*>(dgk), t, E, static_cast<float*>(dlogits));
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (d & 7) {
    moe_gather_any<<<grid_for(t * d, 256), 256, 0, st>>>(
        static_cast<const uint16_t*>(dxe), static_cast<const int*>(eidx),
        static_cast<const int*>(sidx), t, E, cap, d, static_cast<uint16_t*>(dy));
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = d / 8;
  moe_gather<<<grid_for(t * chunks, 256), 256, 0, st>>>(
      static_cast<const uint4*>(dxe), static_cast<const int*>(eidx),
      static_cast<const int*>(sidx), t, E, cap, chunks, static_cast<uint4*>(dy));
  return static_cast<int>(cudaGetLastError());
}

// dout: (t, d) bf16; ye, dye: (E, cap, d) bf16 (dye out; 16-byte aligned
// where d is a multiple of 8); eidx, sidx: (t,) int32; gk: (t,) float32;
// dgk: (t,) float32 out. Returns cudaGetLastError().
extern "C" int picha_moe_combine_bwd(const void* dout, const void* ye, const void* eidx,
                                     const void* sidx, const void* gk, int64_t t, int E, int cap,
                                     int d, void* dye, void* dgk, void* stream) {
  if (t < 0 || E < 1 || cap < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t mrc =
      cudaMemsetAsync(dye, 0, static_cast<size_t>(E) * cap * d * sizeof(__nv_bfloat16), st);
  if (mrc != cudaSuccess) return static_cast<int>(mrc);
  if (t == 0) return static_cast<int>(cudaGetLastError());
  if (d & 7) {
    moe_combine_bwd_any<<<grid_for(t, 8), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(ye),
        static_cast<const int*>(eidx), static_cast<const int*>(sidx),
        static_cast<const float*>(gk), t, E, cap, d, static_cast<__nv_bfloat16*>(dye),
        static_cast<float*>(dgk));
    return static_cast<int>(cudaGetLastError());
  }
  moe_combine_bwd<<<grid_for(t, 8), 256, 0, st>>>(
      static_cast<const uint4*>(dout), static_cast<const uint4*>(ye),
      static_cast<const int*>(eidx), static_cast<const int*>(sidx),
      static_cast<const float*>(gk), t, E, cap, d / 8, static_cast<uint4*>(dye),
      static_cast<float*>(dgk));
  return static_cast<int>(cudaGetLastError());
}
