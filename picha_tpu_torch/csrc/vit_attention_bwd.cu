// K22: the backward of the ViT's multi-head self-attention (K18).
//
// Replaces: the VJP that JAX derives from picha_tpu/models/vit.py::forward's
// attention (:171-180) inside jax.grad(loss_fn), which XLA lowers to batched
// dots around the softmax's derivative. Per (image, head), with s = q.k *
// scale, e = exp(s - max), l = sum e, p = bf16(e / l) as in the forward:
//   dP = bf16(do . v)                          (p was bf16, so is its cotangent)
//   c  = sum_k (dP_k * l^-2) * e_k             (the softmax's VJP on e and l,
//   dS = ((dP / l) + -c) * e * scale             not on the rounded p; f32)
//   dq = bf16(dS . k), dk = bf16(dS^T . q), dv = bf16(p^T . do),
// each summed in f32 and rounded once, written into the (N, S, 3, H, D)
// layout of the qkv product's cotangent. It runs once per block (12 times
// per train step at ViT-S/16).
//
// What bounds it on an H100: at the step's shape (N = 256, S = 196, H = 6,
// D = 64) it reads qkv and do (154 MB) and writes dqkv (116 MB), 0.081 ms
// at HBM peak; its five products (18.9 G FMAs) take 0.038 ms at the bf16
// tensor peak. This first version runs them on the FP32 pipes and
// recomputes two of them (26.4 G FMAs, 0.79 ms at the FFMA peak); tensor
// cores are later work. The design:
//   - one block per (image, head), 8 warps; q, k, v and do of the head
//     (S x D bf16 each) copied into shared memory once, rows padded to
//     D/2 + 1 words so that 32 lanes reading 32 different rows hit 32
//     banks; 187 KB at S = 196, D = 64 (the block opts in above 48 KB);
//   - pass 1, over query rows (4 a warp at a time, whole score rows in one
//     warp as in K18): the scores with K18's arithmetic (the same dot order,
//     * scale, max, expf, the sum in K18's lane order and a true division),
//     so l and p are the forward's own; dP, c, dS; dq = dS . k. Each row's
//     max, l and c go to shared memory;
//   - pass 2, over key rows (4 a warp at a time, a lane per query column):
//     the scores and dP again, bit for bit those of pass 1, then p and dS
//     from the row statistics; dk = dS^T . q and dv = p^T . do summed over
//     the query rows in order. No atomics: the sums over query rows stay in
//     one warp in a fixed order, so two runs give the same bits.
//   No FMA contraction where the reference rounds (__fmul_rn, __fadd_rn,
//   __fdiv_rn); the products of two bf16 values are exact in f32, so fmaf
//   adds them with one rounding, as a separate add would.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;      // rows a warp takes at a time
constexpr int kMaxKT = 8;     // columns a lane holds: S <= 256

__device__ __forceinline__ float2 bf2(uint32_t w) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// Shared memory (32-bit words): q, k, v, do (SK rows of D/2 + 1 each), the
// row statistics (max, l, c: 3 x SK floats), then per warp two operand rows
// blocks (kRows x D floats each) and two score blocks (kRows x SP floats
// each). SK = S rounded up to 32, SP = S rounded up to 4; padding rows are
// zero.
inline int64_t smem_words(int s, int d) {
  const int64_t sk = (s + 31) / 32 * 32, sp = (s + 3) / 4 * 4;
  return 4 * sk * (d / 2 + 1) + 3 * sk + static_cast<int64_t>(kWarps) * 2 * kRows * (d + sp);
}

// o[r][i] = sum_j a[r * SP + j] * M[j] over j < SP, in order, the lane
// owning words lane + 32 i of M's rows (stride MS words)
template <int W, int WPL>
__device__ __forceinline__ void rows_times(const float* a, int SP, const uint32_t* M, int MS,
                                           int lane, float (&o)[kRows][WPL][2]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < WPL; ++i) o[r][i][0] = o[r][i][1] = 0.0f;
  for (int j = 0; j < SP; j += 4) {
    float4 pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) pr[r] = *reinterpret_cast<const float4*>(a + r * SP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = lane + 32 * i;
        if (w < W) {
          const float2 mf = bf2(M[(j + jj) * MS + w]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
            o[r][i][0] = fmaf(pj, mf.x, o[r][i][0]);
            o[r][i][1] = fmaf(pj, mf.y, o[r][i][1]);
          }
        }
      }
    }
  }
}

// the rows r0 .. r0 + 3 of A and B (shared, stride KS) -> f32 blocks a, b
template <int W, int KS>
__device__ __forceinline__ void load_rows(const uint32_t* A, const uint32_t* B, int r0, int lane,
                                          float* a, float* b) {
  constexpr int D = 2 * W;
  for (int i = lane; i < kRows * W; i += 32) {
    const int r = i / W, w = i - r * W;
    const float2 fa = bf2(A[(r0 + r) * KS + w]);
    const float2 fb = bf2(B[(r0 + r) * KS + w]);
    a[r * D + 2 * w] = fa.x;
    a[r * D + 2 * w + 1] = fa.y;
    b[r * D + 2 * w] = fb.x;
    b[r * D + 2 * w + 1] = fb.y;
  }
}

// sc[t][r] = a_r . X_(lane + 32 t), dp[t][r] = b_r . Y_(lane + 32 t): the
// dot order of K18's scores (words in order, the pair's x then y)
template <int W, int KS>
__device__ __forceinline__ void dots(const float* a, const float* b, const uint32_t* X,
                                     const uint32_t* Y, int kt, int lane,
                                     float (&sc)[kMaxKT][kRows], float (&dp)[kMaxKT][kRows]) {
  constexpr int D = 2 * W;
#pragma unroll
  for (int t = 0; t < kMaxKT; ++t)
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[t][r] = dp[t][r] = 0.0f;
#pragma unroll 2
  for (int w = 0; w < W; ++w) {
    float2 fa[kRows], fb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      fa[r] = *reinterpret_cast<const float2*>(a + r * D + 2 * w);
      fb[r] = *reinterpret_cast<const float2*>(b + r * D + 2 * w);
    }
#pragma unroll
    for (int t = 0; t < kMaxKT; ++t) {
      if (t < kt) {
        const float2 xf = bf2(X[(lane + 32 * t) * KS + w]);
        const float2 yf = bf2(Y[(lane + 32 * t) * KS + w]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          sc[t][r] = fmaf(fa[r].x, xf.x, sc[t][r]);
          sc[t][r] = fmaf(fa[r].y, xf.y, sc[t][r]);
          dp[t][r] = fmaf(fb[r].x, yf.x, dp[t][r]);
          dp[t][r] = fmaf(fb[r].y, yf.y, dp[t][r]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) vit_attention_bwd(
    const uint32_t* __restrict__ qkv, const uint32_t* __restrict__ dout, int S, int H, float scale,
    uint32_t* __restrict__ dqkv) {
  constexpr int W = D / 2;              // bf16 pairs in a head row
  constexpr int KS = W + 1;             // padded row stride, words
  constexpr int WPL = (W + 31) / 32;    // output words a lane owns
  extern __shared__ __align__(16) uint32_t smem[];
  const int kt = (S + 31) / 32;
  const int SK = kt * 32, SP = (S + 3) / 4 * 4;
  uint32_t* Qs = smem;
  uint32_t* Ks = Qs + SK * KS;
  uint32_t* Vs = Ks + SK * KS;
  uint32_t* Gs = Vs + SK * KS;
  float* st_m = reinterpret_cast<float*>(Gs + SK * KS);
  float* st_l = st_m + SK;
  float* st_c = st_l + SK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ra = st_c + SK + warp * 2 * kRows * (D + SP);
  float* rb = ra + kRows * D;
  float* ds = rb + kRows * D;
  float* pp = ds + kRows * SP;

  const int n = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int64_t tok = static_cast<int64_t>(3) * H * W;   // qkv words per token
  const uint32_t* base = qkv + static_cast<int64_t>(n) * S * tok;
  const uint32_t* gbase = dout + static_cast<int64_t>(n) * S * H * W;
  for (int i = threadIdx.x; i < SK * W; i += blockDim.x) {
    const int s = i / W, w = i - s * W;
    const bool in = s < S;
    Qs[s * KS + w] = in ? base[s * tok + h * W + w] : 0u;
    Ks[s * KS + w] = in ? base[s * tok + (H + h) * W + w] : 0u;
    Vs[s * KS + w] = in ? base[s * tok + (2 * H + h) * W + w] : 0u;
    Gs[s * KS + w] = in ? gbase[static_cast<int64_t>(s) * H * W + h * W + w] : 0u;
  }
  __syncthreads();

  float sc[kMaxKT][kRows], dp[kMaxKT][kRows];
  float o[kRows][WPL][2];

  // pass 1: query rows -> row statistics, dq
  for (int r0 = warp * kRows; r0 < S; r0 += kWarps * kRows) {
    __syncwarp();
    load_rows<W, KS>(Qs, Gs, r0, lane, ra, rb);
    __syncwarp();
    dots<W, KS>(ra, rb, Ks, Vs, kt, lane, sc, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        if (t < kt && lane + 32 * t < S) {
          sc[t][r] = __fmul_rn(sc[t][r], scale);
          m = fmaxf(m, sc[t][r]);
        }
      }
      m = warp_max(m);
      float l = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        if (t < kt && lane + 32 * t < S) {
          sc[t][r] = expf(__fsub_rn(sc[t][r], m));
          l = __fadd_rn(l, sc[t][r]);
        }
      }
      l = warp_sum(l);
      const float inv = __fdiv_rn(1.0f, __fmul_rn(l, l));
      float c = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        if (t < kt && lane + 32 * t < S) {
          dp[t][r] = round_bf16(dp[t][r]);
          c = __fadd_rn(c, __fmul_rn(__fmul_rn(dp[t][r], inv), sc[t][r]));
        }
      }
      c = warp_sum(c);
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        const int j = lane + 32 * t;
        if (t < kt && j < SP)
          ds[r * SP + j] =
              j < S ? __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(dp[t][r], l), -c), sc[t][r]), scale)
                    : 0.0f;
      }
      if (lane == 0 && r0 + r < S) {
        st_m[r0 + r] = m;
        st_l[r0 + r] = l;
        st_c[r0 + r] = c;
      }
    }
    __syncwarp();
    rows_times<W, WPL>(ds, SP, Ks, KS, lane, o);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= S) break;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = lane + 32 * i;
        if (w < W)
          dqkv[(static_cast<int64_t>(n) * S + r0 + r) * tok + h * W + w] =
              pack_bf2(o[r][i][0], o[r][i][1]);
      }
    }
  }
  __syncthreads();

  // pass 2: key rows -> dk, dv
  for (int c0 = warp * kRows; c0 < S; c0 += kWarps * kRows) {
    __syncwarp();
    load_rows<W, KS>(Ks, Vs, c0, lane, ra, rb);
    __syncwarp();
    dots<W, KS>(ra, rb, Qs, Gs, kt, lane, sc, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int t = 0; t < kMaxKT; ++t) {
        const int i = lane + 32 * t;
        if (t < kt && i < SP) {
          float dsv = 0.0f, pv = 0.0f;
          if (i < S) {
            const float l = st_l[i];
            const float e = expf(__fsub_rn(__fmul_rn(sc[t][r], scale), st_m[i]));
            pv = round_bf16(__fdiv_rn(e, l));
            dsv = __fmul_rn(
                __fmul_rn(__fadd_rn(__fdiv_rn(round_bf16(dp[t][r]), l), -st_c[i]), e), scale);
          }
          ds[r * SP + i] = dsv;
          pp[r * SP + i] = pv;
        }
      }
    }
    __syncwarp();
    rows_times<W, WPL>(ds, SP, Qs, KS, lane, o);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (c0 + r >= S) break;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = lane + 32 * i;
        if (w < W)
          dqkv[(static_cast<int64_t>(n) * S + c0 + r) * tok + (H + h) * W + w] =
              pack_bf2(o[r][i][0], o[r][i][1]);
      }
    }
    rows_times<W, WPL>(pp, SP, Gs, KS, lane, o);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (c0 + r >= S) break;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = lane + 32 * i;
        if (w < W)
          dqkv[(static_cast<int64_t>(n) * S + c0 + r) * tok + (2 * H + h) * W + w] =
              pack_bf2(o[r][i][0], o[r][i][1]);
      }
    }
  }
}

template <int D>
int launch(const void* qkv, const void* dout, int n, int s, int h, float scale, void* dqkv,
           cudaStream_t st) {
  const size_t bytes = static_cast<size_t>(smem_words(s, D)) * 4;
  cudaError_t rc = cudaFuncSetAttribute(vit_attention_bwd<D>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vit_attention_bwd<D><<<static_cast<unsigned>(n) * h, kWarps * 32, bytes, st>>>(
      static_cast<const uint32_t*>(qkv), static_cast<const uint32_t*>(dout), s, h, scale,
      static_cast<uint32_t*>(dqkv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv, dqkv: (n, s, 3, h, d) bf16; dout: (n, s, h * d) bf16; d in {32, 64},
// 1 <= s <= 256. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int picha_vit_attention_bwd(const void* qkv, const void* dout, int n, int s, int h,
                                       int d, float scale, void* dqkv, void* stream) {
  if (n < 0 || s < 1 || s > 32 * kMaxKT || h < 1 || static_cast<int64_t>(n) * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(qkv, dout, n, s, h, scale, dqkv, st);
    case 64: return launch<64>(qkv, dout, n, s, h, scale, dqkv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
