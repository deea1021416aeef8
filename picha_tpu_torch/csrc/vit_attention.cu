// K18: the multi-head self-attention of the ViT blocks.
//
// Replaces: picha_tpu/models/vit.py::forward's attention (:171-180), which
// XLA lowers to two batched dots around a softmax: q, k, v sliced out of
// the qkv product's (N, S, 3, H, D) layout, att = (q . k in f32) * scale,
// softmax in f32, att -> bf16, o = (att . v in f32) -> bf16, reshaped to
// (N, S, H * D) for the proj product. It runs once per block (12 times per
// forward at ViT-S/16).
//
// What bounds it on an H100: at the forward's shape (N = 256, S = 196,
// H = 6, D = 64) the kernel reads 115.6 MB of qkv and writes 38.5 MB of o,
// 0.046 ms at HBM peak; its 15.1 GFLOP take 0.015 ms at the bf16 tensor
// peak, so bytes bound it. This first version runs the two products on
// the FP32 pipes (7.6 G FMAs, 0.23 ms at their peak); tensor-core
// products (mma / wgmma) are later work. The design:
//   - one block per (image, head), 8 warps: K and V of the head (S x D
//     bf16 each, 2 x 25 KB at S = 196) are copied into shared memory once,
//     read strided straight out of qkv (no transpose copy); K rows are
//     padded to D/2 + 1 words so that 32 lanes reading 32 different keys
//     hit 32 banks; above 48 KB the block opts into more shared memory;
//   - a warp takes 4 query rows at a time: each lane holds the scores of
//     keys lane, lane + 32, ... (S <= 256) for the 4 rows in registers, so
//     a whole score row lives in one warp. This is not an online (flash)
//     softmax: an online rescale would round the probabilities otherwise
//     than the reference;
//   - the reference's rounding order: the f32 dot of bf16 q . k, * scale
//     after the dot, max-subtract, expf, a true division (__fdiv_rn), the
//     probabilities rounded to bf16, the f32 sum of bf16 p . bf16 v, o
//     rounded to bf16. A product of two bf16 values is exact in f32, so an
//     FMA adds it with the same single rounding as a separate add; only
//     the summation orders differ from the plain version
//     (picha_tpu_torch/ops/attention.py::attention_plain).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;      // query rows a warp takes at a time
constexpr int kMaxKT = 8;     // key columns a lane holds: S <= 256

__device__ __forceinline__ float2 bf2(uint32_t w) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory (32-bit words): K (SK rows of D/2 + 1), V (SP rows of D/2),
// then per warp its q rows (kRows x D floats) and probabilities (kRows x SP
// floats). SK = S rounded up to 32, SP = S rounded up to 4; padding rows
// are zero.
inline int64_t smem_words(int s, int d) {
  const int sk = (s + 31) / 32 * 32, sp = (s + 3) / 4 * 4;
  return static_cast<int64_t>(sk) * (d / 2 + 1) + static_cast<int64_t>(sp) * (d / 2) +
         static_cast<int64_t>(kWarps) * kRows * (d + sp);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) vit_attention(const uint32_t* __restrict__ qkv,
                                                             int S, int H, float scale,
                                                             uint32_t* __restrict__ out) {
  constexpr int W = D / 2;              // bf16 pairs in a head row
  constexpr int KS = W + 1;             // padded K row stride, words
  constexpr int WPL = (W + 31) / 32;    // o words a lane owns
  extern __shared__ __align__(16) uint32_t smem[];
  const int kt = (S + 31) / 32;
  const int SK = kt * 32, SP = (S + 3) / 4 * 4;
  uint32_t* Ks = smem;
  uint32_t* Vs = Ks + SK * KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q = reinterpret_cast<float*>(Vs + SP * W) + warp * kRows * D;
  float* p = reinterpret_cast<float*>(Vs + SP * W) + kWarps * kRows * D + warp * kRows * SP;

  const int n = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int64_t tok = static_cast<int64_t>(3) * H * W;   // words per token
  const uint32_t* base = qkv + static_cast<int64_t>(n) * S * tok;
  for (int i = threadIdx.x; i < SK * W; i += blockDim.x) {
    const int s = i / W, w = i - s * W;
    Ks[s * KS + w] = s < S ? base[s * tok + (H + h) * W + w] : 0u;
  }
  for (int i = threadIdx.x; i < SP * W; i += blockDim.x) {
    const int s = i / W, w = i - s * W;
    Vs[s * W + w] = s < S ? base[s * tok + (2 * H + h) * W + w] : 0u;
  }
  __syncthreads();

  for (int r0 = warp * kRows; r0 < S; r0 += kWarps * kRows) {
    __syncwarp();
    for (int i = lane; i < kRows * W; i += 32) {
      const int r = i / W, w = i - r * W;
      const float2 f =
          r0 + r < S ? bf2(base[static_cast<int64_t>(r0 + r) * tok + h * W + w]) : make_float2(0.f, 0.f);
      q[r * D + 2 * w] = f.x;
      q[r * D + 2 * w + 1] = f.y;
    }
    __syncwarp();

    // scores: acc[t][r] = q_r . k_(lane + 32 t)
    float acc[kMaxKT][kRows];
#pragma unroll
    for (int t = 0; t < kMaxKT; ++t)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[t][r] = 0.0f;
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      float2 qa[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qa[r] = *reinterpret_cast<const float2*>(q + r * D + 2 * w);
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        if (t < kt) {
          const float2 kf = bf2(Ks[(lane + 32 * t) * KS + w]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[t][r] = fmaf(qa[r].x, kf.x, acc[t][r]);
            acc[t][r] = fmaf(qa[r].y, kf.y, acc[t][r]);
          }
        }
      }
    }

    // softmax per row, in f32, then the probabilities rounded to bf16
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        if (t < kt && lane + 32 * t < S) {
          acc[t][r] = __fmul_rn(acc[t][r], scale);
          m = fmaxf(m, acc[t][r]);
        }
      }
      m = warp_max(m);
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        if (t < kt && lane + 32 * t < S) {
          acc[t][r] = expf(__fsub_rn(acc[t][r], m));
          sum = __fadd_rn(sum, acc[t][r]);
        }
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        const int j = lane + 32 * t;
        if (t < kt && j < SP)
          p[r * SP + j] =
              j < S ? __bfloat162float(__float2bfloat16_rn(__fdiv_rn(acc[t][r], sum))) : 0.0f;
      }
    }
    __syncwarp();

    // o_r = sum_j p_rj v_j, lane owning words lane, lane + 32, ...
    float o[kRows][WPL][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < WPL; ++i) o[r][i][0] = o[r][i][1] = 0.0f;
    for (int j = 0; j < SP; j += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pr[r] = *reinterpret_cast<const float4*>(p + r * SP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < WPL; ++i) {
          const int w = lane + 32 * i;
          if (w < W) {
            const float2 vf = bf2(Vs[(j + jj) * W + w]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
              o[r][i][0] = fmaf(pj, vf.x, o[r][i][0]);
              o[r][i][1] = fmaf(pj, vf.y, o[r][i][1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= S) break;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = lane + 32 * i;
        if (w < W)
          out[((static_cast<int64_t>(n) * S + r0 + r) * H + h) * W + w] =
              pack_bf2(o[r][i][0], o[r][i][1]);
      }
    }
  }
}

template <int D>
int launch(const void* qkv, int n, int s, int h, float scale, void* out, cudaStream_t st) {
  const size_t bytes = static_cast<size_t>(smem_words(s, D)) * 4;
  cudaError_t rc = cudaFuncSetAttribute(vit_attention<D>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vit_attention<D><<<static_cast<unsigned>(n) * h, kWarps * 32, bytes, st>>>(
      static_cast<const uint32_t*>(qkv), s, h, scale, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (n, s, 3, h, d) bf16; out: (n, s, h * d) bf16; d in {32, 64, 128},
// 1 <= s <= 256. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int picha_vit_attention(const void* qkv, int n, int s, int h, int d, float scale,
                                   void* out, void* stream) {
  if (n < 0 || s < 1 || s > 32 * kMaxKT || h < 1 || static_cast<int64_t>(n) * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(qkv, n, s, h, scale, out, st);
    case 64: return launch<64>(qkv, n, s, h, scale, out, st);
    case 128: return launch<128>(qkv, n, s, h, scale, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
