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
// at HBM peak; its five products (37.8 GFLOP) take 0.038 ms at the bf16
// tensor peak. Past the bytes, the f32 softmax VJP costs most: two expf
// and three divisions for each of 59 M scores over the two phases, and
// a head's 163 KB of f32 scores held at once. The design:
//   - every product on the tensor cores: mma.sync.m16n8k16, bf16 operands,
//     f32 accumulators, fragments by ldmatrix (vit_attention_mma.cuh);
//   - dS stays f32 grade: it enters dq and dk as two bf16 terms, hi =
//     bf16(dS) and lo = bf16(dS - hi), two products into one accumulator
//     (within 2^-17 |dS|); a softmax row's dS sums to about 0, so a single
//     bf16 dS (2^-9) would show in dq where keys differ little. p is bf16
//     already, an exact operand;
//   - dP is rounded to bf16 as the plain version rounds it. Where a head's
//     v rows are nearly parallel (the ViT at initialisation: cosine 0.99),
//     dP / l - c cancels, so a dP that rounds to the neighbouring bf16
//     value moves dS, and a row of dq or dk, by whole percents. The tensor
//     cores sum in another order and truncate, so phase 0 computes dP =
//     do . v^T once on them together with |do| . |v|^T, which bounds each
//     sum's error; the values whose bf16 rounding that leaves ambiguous
//     are summed again in order on the FP32 pipe (d = 0, 1, ..., one FMA
//     each: the order in which the plain version's f32 product sums on
//     the card, which chip_smoke.py checks bit for bit on the step's
//     inputs), a warp's list of them 32 at a time, and the head's bf16 dP
//     stays in shared memory for phases 1 and 2 (at D = 64 past 208 tokens
//     it does not fit, and each phase computes and settles its own dP
//     tiles);
//   - persistent blocks, one a multiprocessor, each owning whole (image,
//     head) items, every query and key row of one: q, k, v and do of the
//     head (4 x 26 KB at S = 196) copied into shared memory with 16-byte
//     cp.async (the next head's while this one runs, where two copies fit
//     in 227 KB beside dP), chunks swizzled (no ldmatrix bank conflict);
//   - the scores recomputed with K18's arithmetic (attn::mma_step_rn: each
//     16-deep step of q . k from a zero accumulator, the steps added with
//     round-to-nearest), so that the max and the exponentials are the
//     forward's. l and c are summed in float64 and rounded once to f32
//     (K18 sums l in f32, so the two l may differ in their last bit):
//     where dS cancels, a few f32 ulps of l or c move a row of dq by the
//     better part of an ulp of its largest value, and f32 sums in another
//     order than the plain version's put rows past its bound;
//   - 8 warps of 255 registers. Phase 1, a warp per 16 query rows: the
//     rows' scores for every key stay in registers (MAXT key tiles), so
//     q . k^T and the expf run once: the exact row max, e = expf(s - max),
//     l = their sum; then c, then dS and dq = dS . k. max, l, 1 / l
//     and c of each row go to shared memory. Phase 2, a warp per 16 key
//     rows: s^T = k . q^T over every query tile, p^T and dS^T from the row
//     statistics, dv = p^T . do and dk = dS^T . q accumulated over the
//     query tiles in order. No atomics: each sum stays in one warp in a
//     fixed order, so two runs give the same bits;
//   - phase 1's tile loops are unrolled and branch-free (a key tile past
//     the last is clamped to it and its values masked), so the compiler
//     overlaps one tile's loads and products with the next one's
//     arithmetic;
//   - the reference's rounding points, with no FMA contraction where it
//     rounds (__fmul_rn, __fadd_rn; the divisions by l correctly rounded,
//     attn::div_rn; l^-2 by __fdiv_rn); only the summation orders inside
//     the tensor cores differ from the plain version
//     (picha_tpu_torch/ops/attention.py::attention_backward_plain).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vit_attention_mma.cuh"
#include "vit_attention_tiled.cuh"

namespace {

using attn::col_of;

constexpr int kWarps = 8;

inline int64_t pad16(int s) { return (s + 15) / 16 * 16; }
inline int64_t tiles_bytes(int s, int d) { return 4 * pad16(s) * d * 2; }
inline int64_t dp_bytes(int s) { return pad16(s) * pad16(s) * 2; }
inline int64_t stats_bytes(int s) { return 4 * pad16(s) * 4; }

// s = a . X^T for the 16 rows of `a` and the rows 16 t .. 16 t + 15 of X,
// summed as K18 sums the scores (attn::mma_step_rn)
template <int D>
__device__ __forceinline__ void dots(const uint32_t (&a)[D / 16][4], uint32_t x, int t,
                                     int lane, float (&s)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    attn::load_b_nk<D>(x, 16 * t, 16 * kk, lane, b);
    attn::mma_step_rn(s[0], a[kk], b[0], b[1], kk == 0);
    attn::mma_step_rn(s[1], a[kk], b[2], b[3], kk == 0);
  }
}

// s = |a| . |X|^T, the sum of the terms' magnitudes (a holds |a| already)
template <int D>
__device__ __forceinline__ void dots_abs(const uint32_t (&a)[D / 16][4], uint32_t x, int t,
                                         int lane, float (&s)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    attn::load_b_nk<D>(x, 16 * t, 16 * kk, lane, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] &= 0x7fff7fffu;
    attn::mma(s[0], a[kk], b[0], b[1]);
    attn::mma(s[1], a[kk], b[2], b[3]);
  }
}

// |a| of A fragments
template <int D>
__device__ __forceinline__ void abs_frags(const uint32_t (&a)[D / 16][4], uint32_t (&b)[D / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) b[kk][i] = a[kk][i] & 0x7fff7fffu;
}

// acc[t] += a . M[rows k0 .. k0+15, columns 8 t ..]
template <int D>
__device__ __forceinline__ void times(const uint32_t (&a)[4], uint32_t m, int k0, int lane,
                                      float (&acc)[D / 8][4]) {
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
    uint32_t b[4];
    attn::load_b_kn<D>(m, k0, 16 * t, lane, b);
    attn::mma(acc[2 * t], a, b[0], b[1]);
    attn::mma(acc[2 * t + 1], a, b[2], b[3]);
  }
}

// the same with an f32 A tile given as two bf16 terms
template <int D>
__device__ __forceinline__ void times2(const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                       uint32_t m, int k0, int lane, float (&acc)[D / 8][4]) {
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
    uint32_t b[4];
    attn::load_b_kn<D>(m, k0, 16 * t, lane, b);
    attn::mma(acc[2 * t], hi, b[0], b[1]);
    attn::mma(acc[2 * t], lo, b[0], b[1]);
    attn::mma(acc[2 * t + 1], hi, b[2], b[3]);
    attn::mma(acc[2 * t + 1], lo, b[2], b[3]);
  }
}

// acc += dS . M, dS given as its two bf16 terms
template <int D>
__device__ __forceinline__ void ds_times(const float (&ds)[2][4], uint32_t m, int k0, int lane,
                                         float (&acc)[D / 8][4]) {
  uint32_t hi[4], lo[4];
  attn::as_a_split(ds, hi, lo);
  times2<D>(hi, lo, m, k0, lane, acc);
}

// rows r0 + g and r0 + g + 8 (below S) of acc, rounded to bf16, at dst +
// row * stride + 8 t + 2c
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], __nv_bfloat16* dst,
                                           int64_t stride, int r0, int S, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + (lane >> 2) + 8 * half;
    if (row < S) {
      uint32_t* p = reinterpret_cast<uint32_t*>(dst + row * stride + 2 * (lane & 3));
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
        p[4 * t] = attn::pack_bf2(acc[t][2 * half], acc[t][2 * half + 1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
}

__device__ __forceinline__ float2 bf2f(uint32_t w) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  return __bfloat1622float2(h);
}

// an f32 dP tile (rows r0 + g (+ 8) of A, rows 16 t + col of B; ab: its
// terms' magnitudes) rounded to bf16, its ambiguous values summed again in
// order first
template <int D>
__device__ __forceinline__ void resum_round(uint32_t A, int r0, uint32_t B, int t, int lane,
                                            const float (&ab)[2][4], float (&dp)[2][4]) {
  uint32_t amb = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    amb |= static_cast<uint32_t>(attn::ambiguous(dp[k >> 2][k & 3], ab[k >> 2][k & 3])) << k;
  if (__any_sync(0xffffffffu, amb)) {
#pragma unroll 1
    for (int k = 0; k < 8; ++k)
      if (amb >> k & 1u)
        dp[k >> 2][k & 3] = attn::seq_dot<D>(A, r0 + (lane >> 2) + 8 * ((k & 3) >> 1), B,
                                             16 * t + col_of(lane, k >> 2, k & 3));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) dp[k >> 2][k & 3] = attn::round_bf16(dp[k >> 2][k & 3]);
}

// phase 0's list of ambiguous dP values (row << 16 | column) a warp has
// left to sum again: up to 31 carried over plus one tile's 256
constexpr int kFixCap = 288;

// the listed dP values summed again in order, one a lane, into dps
template <int D>
__device__ __forceinline__ void resum_listed(const uint32_t* fix, int count, uint32_t gs,
                                             uint32_t vs, uint32_t dps, int SP, int lane) {
  __syncwarp();
  for (int b = 0; b < count; b += 32) {
    if (b + lane < count) {
      const uint32_t en = fix[b + lane];
      const int row = en >> 16, col = en & 0xffff;
      const __nv_bfloat16 v = __float2bfloat16_rn(attn::seq_dot<D>(gs, row, vs, col));
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dps + (row * SP + col) * 2),
                   "h"(__bfloat16_as_ushort(v)));
    }
  }
  __syncwarp();
}

// one (image, head) out of its staged tiles at qs (q, k, v, do); dps: the
// head's bf16 dP (SP x SP, row = query) where it fits in shared memory
// (DPS), else each phase computes dP for itself; st: max, l, 1 / l and c
// of each query row (SP floats each); fixes: phase 0's lists, kFixCap a
// warp; out: its dq at row * stride, dk at + H * D, dv at + 2 H * D;
// MAXT >= the key tiles
template <int D, int MAXT, bool DPS>
__device__ __forceinline__ void head(uint32_t qs, uint32_t dps, float* st, uint32_t* fixes,
                                     int S, int H, float scale, __nv_bfloat16* out,
                                     int64_t stride) {
  const int SP = (S + 15) / 16 * 16, nt = SP / 16;
  const uint32_t ks = qs + SP * D * 2, vs = ks + SP * D * 2, gs = vs + SP * D * 2;
  float* st_m = st;
  float* st_l = st + SP;
  float* st_r = st + 2 * SP;
  float* st_c = st + 3 * SP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  // phase 0: dP = bf16(do . v^T) on the tensor cores, with |do| . |v|^T
  // to bound each sum's error; the values whose rounding that leaves
  // ambiguous are listed and summed again in order, a warp's worth at a
  // time
  uint32_t* fix = fixes + warp * kFixCap;
  for (int qt = warp; DPS && qt < nt; qt += warps) {
    uint32_t ga[D / 16][4], gab[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) attn::load_a<D>(gs, 16 * qt, 16 * kk, lane, ga[kk]);
    abs_frags<D>(ga, gab);
    int count = 0;
    for (int kt = 0; kt < nt; ++kt) {
      float dp[2][4], ab[2][4];
      dots<D>(ga, vs, kt, lane, dp);
      dots_abs<D>(gab, vs, kt, lane, ab);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool amb = attn::ambiguous(dp[k >> 2][k & 3], ab[k >> 2][k & 3]);
        const uint32_t mask = __ballot_sync(0xffffffffu, amb);
        if (amb)
          fix[count + __popc(mask & ((1u << lane) - 1u))] =
              static_cast<uint32_t>(16 * qt + g + 8 * ((k & 3) >> 1)) << 16 |
              static_cast<uint32_t>(16 * kt + col_of(lane, k >> 2, k & 3));
        count += __popc(mask);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           dps + ((16 * qt + g + 8 * half) * SP + 16 * kt + 8 * j + c2) * 2),
                       "r"(attn::pack_bf2(dp[j][2 * half], dp[j][2 * half + 1])));
      if (count >= 32) {
        resum_listed<D>(fix, count, gs, vs, dps, SP, lane);
        count = 0;
      }
    }
    resum_listed<D>(fix, count, gs, vs, dps, SP, lane);
  }
  __syncthreads();

  // phase 1: query rows -> max, l, c; dq = dS . k
  for (int qt = warp; qt < nt; qt += warps) {
    // the scores as K18 takes them (one q fragment live at a time)
    float e[MAXT][2][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      attn::load_a<D>(qs, 16 * qt, 16 * kk, lane, qa);
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt) {
        uint32_t b[4];
        attn::load_b_nk<D>(ks, 16 * (kt < nt ? kt : nt - 1), 16 * kk, lane, b);
        attn::mma_step_rn(e[kt][0], qa, b[0], b[1], kk == 0);
        attn::mma_step_rn(e[kt][1], qa, b[2], b[3], kk == 0);
      }
    }
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[kt][j][i] = __fmul_rn(e[kt][j][i], scale);
          m[i >> 1] = fmaxf(m[i >> 1], 16 * kt + col_of(lane, j, i) < S ? e[kt][j][i] : -INFINITY);
        }
    m[0] = attn::quad_max(m[0]);
    m[1] = attn::quad_max(m[1]);
    double ls[2] = {0.0, 0.0};
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ev = expf(__fsub_rn(e[kt][j][i], m[i >> 1]));
          e[kt][j][i] = 16 * kt + col_of(lane, j, i) < S ? ev : 0.0f;
          ls[i >> 1] = __dadd_rn(ls[i >> 1], e[kt][j][i]);
        }
    const float l[2] = {attn::quad_sum(ls[0]), attn::quad_sum(ls[1])};
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    const float inv[2] = {__fdiv_rn(1.0f, __fmul_rn(l[0], l[0])),
                          __fdiv_rn(1.0f, __fmul_rn(l[1], l[1]))};
    uint32_t ga[D / 16][4], gab[D / 16][4];
    if (!DPS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) attn::load_a<D>(gs, 16 * qt, 16 * kk, lane, ga[kk]);
      abs_frags<D>(ga, gab);
    }
    // this tile's dP, rows 16 qt + g (+ 8), columns 16 kt + 8 j + 2c (+ 1)
    auto dp_of = [&](int kt, float (&dp)[2][4]) {
      const int kc = kt < nt ? kt : nt - 1;
      if (!DPS) {
        float ab[2][4];
        dots<D>(ga, vs, kc, lane, dp);
        dots_abs<D>(gab, vs, kc, lane, ab);
        resum_round<D>(gs, 16 * qt, vs, kc, lane, ab, dp);
        return;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 f = bf2f(
              attn::lds32(dps + ((16 * qt + g + 8 * half) * SP + 16 * kc + 8 * j + c2) * 2));
          dp[j][2 * half] = f.x;
          dp[j][2 * half + 1] = f.y;
        }
    };
    double cs[2] = {0.0, 0.0};
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt) {
      float dp[2][4];
      dp_of(kt, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float term = __fmul_rn(__fmul_rn(dp[j][i], inv[i >> 1]), e[kt][j][i]);
          cs[i >> 1] = __dadd_rn(cs[i >> 1], 16 * kt + col_of(lane, j, i) < S ? term : 0.0f);
        }
    }
    const float c[2] = {attn::quad_sum(cs[0]), attn::quad_sum(cs[1])};
    float dq[D / 8][4];
    zero<D>(dq);
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt) {
      float dp[2][4];
      dp_of(kt, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const float ds = __fmul_rn(
              __fmul_rn(__fadd_rn(attn::div_rn(dp[j][i], l[r], rl[r]), -c[r]), e[kt][j][i]),
              scale);
          dp[j][i] = 16 * kt + col_of(lane, j, i) < S ? ds : 0.0f;
        }
      ds_times<D>(dp, ks, 16 * (kt < nt ? kt : nt - 1), lane, dq);
    }
    store_rows<D>(dq, out, stride, 16 * qt, S, lane);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * qt + g + 8 * r;
        st_m[row] = m[r];
        st_l[row] = l[r];
        st_r[row] = rl[r];
        st_c[row] = c[r];
      }
    }
  }
  __syncthreads();

  // phase 2: key rows -> dv = p^T . do, dk = dS^T . q over the query tiles
  for (int kt = warp; kt < nt; kt += warps) {
    const bool key_in[2] = {16 * kt + g < S, 16 * kt + g + 8 < S};
    uint32_t ka[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) attn::load_a<D>(ks, 16 * kt, 16 * kk, lane, ka[kk]);
    float dk[D / 8][4], dv[D / 8][4];
    zero<D>(dk);
    zero<D>(dv);
    for (int qt = 0; qt < nt; ++qt) {
      // rows: keys 16 kt + g (+ 8); columns: queries 16 qt + col_of(..)
      float s[2][4], pt[2][4], dpt[2][4];
      dots<D>(ka, qs, qt, lane, s);
      if (!DPS) {
        uint32_t va[D / 16][4], vab[D / 16][4];
        float ab[2][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) attn::load_a<D>(vs, 16 * kt, 16 * kk, lane, va[kk]);
        abs_frags<D>(va, vab);
        dots<D>(va, gs, qt, lane, dpt);
        dots_abs<D>(vab, gs, qt, lane, ab);
        resum_round<D>(vs, 16 * kt, gs, qt, lane, ab, dpt);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i0 = 16 * qt + 8 * j + c2;
        const float2 mm = *reinterpret_cast<const float2*>(st_m + i0);
        const float2 ll = *reinterpret_cast<const float2*>(st_l + i0);
        const float2 rr = *reinterpret_cast<const float2*>(st_r + i0);
        const float2 cc = *reinterpret_cast<const float2*>(st_c + i0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool odd = i & 1;
          const float mi = odd ? mm.y : mm.x, li = odd ? ll.y : ll.x, ri = odd ? rr.y : rr.x,
                      ci = odd ? cc.y : cc.x;
          float dpv = dpt[j][i];
          if (DPS) {
            uint16_t raw;
            asm volatile("ld.shared.u16 %0, [%1];\n"
                         : "=h"(raw)
                         : "r"(dps + ((i0 + odd) * SP + 16 * kt + g + 8 * (i >> 1)) * 2));
            dpv = __bfloat162float(__ushort_as_bfloat16(raw));
          }
          const bool in = i0 + odd < S && key_in[i >> 1];
          const float ev = expf(__fsub_rn(__fmul_rn(s[j][i], scale), mi));
          const float ds =
              __fmul_rn(__fmul_rn(__fadd_rn(attn::div_rn(dpv, li, ri), -ci), ev), scale);
          pt[j][i] = in ? attn::div_rn(ev, li, ri) : 0.0f;
          s[j][i] = in ? ds : 0.0f;
        }
      }
      uint32_t pa[4];
      attn::as_a(pt, pa);
      times<D>(pa, gs, 16 * qt, lane, dv);
      ds_times<D>(s, qs, 16 * qt, lane, dk);
    }
    store_rows<D>(dk, out + H * D, stride, 16 * kt, S, lane);
    store_rows<D>(dv, out + 2 * H * D, stride, 16 * kt, S, lane);
  }
}

// a persistent block: items (image, head) blockIdx.x, + gridDim.x, ...;
// `two`: the next item is staged into the other buffer while this one runs.
// Shared memory: the tiles (twice with `two`), dP, the row statistics,
// phase 0's lists
template <int D, int MAXT, bool DPS>
__global__ void __launch_bounds__(kWarps * 32, 1)
    vit_attention_bwd(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                      int N, int S, int H, float scale, int two,
                      __nv_bfloat16* __restrict__ dqkv) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int SP = (S + 15) / 16 * 16;
  const uint32_t buf0 = attn::smem_addr(smem), tile = SP * D * 2;
  const uint32_t dps = buf0 + (two ? 8 : 4) * tile;
  float* st = reinterpret_cast<float*>(smem + (two ? 8 : 4) * tile + (DPS ? SP * SP * 2 : 0));
  uint32_t* fixes = reinterpret_cast<uint32_t*>(st + 4 * SP);
  const int64_t tok = static_cast<int64_t>(3) * H * D;   // qkv elements per token
  const int64_t items = static_cast<int64_t>(N) * H;
  auto stage = [&](int64_t item, uint32_t buf) {
    const int64_t n = item / H, h = item - n * H;
    const __nv_bfloat16* base = qkv + n * S * tok + h * D;
    attn::stage<D>(buf, base, tok, S, SP);
    attn::stage<D>(buf + tile, base + H * D, tok, S, SP);
    attn::stage<D>(buf + 2 * tile, base + 2 * H * D, tok, S, SP);
    attn::stage<D>(buf + 3 * tile, dout + n * S * H * D + h * D, static_cast<int64_t>(H) * D, S,
                   SP);
  };
  int64_t item = blockIdx.x;
  if (item < items) stage(item, buf0);
  attn::commit();
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const uint32_t cur = buf0 + (two && (it & 1) ? 4 * tile : 0);
    const int64_t next = item + gridDim.x;
    if (two) {
      if (next < items) stage(next, buf0 + (it & 1 ? 0 : 4 * tile));
      attn::commit();
      attn::wait_all_but_newest();
    } else {
      attn::wait_all();
    }
    __syncthreads();
    const int64_t n = item / H, h = item - n * H;
    head<D, MAXT, DPS>(cur, dps, st, fixes, S, H, scale, dqkv + n * S * tok + h * D, tok);
    __syncthreads();
    if (!two && next < items) {
      stage(next, buf0);
      attn::commit();
    }
  }
}

// the build for s tokens: scores for up to 13 key tiles (208 tokens, the
// ViT's 196) or 16
struct Plan {
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, int, int, int, float, int,
                 __nv_bfloat16*);
  int threads;
  int two;
  size_t bytes;
};

// (dP in shared memory where it fits beside the tiles: at D = 32, and at
// D = 64 up to 208 tokens)
template <int D>
Plan plan(int s) {
  const int nt = (s + 15) / 16;
  const bool dps = D == 32 || nt <= 13;
  Plan p;
  p.kernel = nt <= 13 ? vit_attention_bwd<D, 13, true>
                      : dps ? vit_attention_bwd<D, 16, true> : vit_attention_bwd<D, 16, false>;
  p.threads = 32 * (nt < kWarps ? nt : kWarps);
  const int64_t one = tiles_bytes(s, D),
                rest = (dps ? dp_bytes(s) + kWarps * kFixCap * 4 : 0) + stats_bytes(s);
  p.two = 2 * one + rest <= static_cast<int64_t>(attn::kSmemMax);
  p.bytes = static_cast<size_t>((p.two ? 2 * one : one) + rest);
  return p;
}

template <int D>
int launch(const void* qkv, const void* dout, int n, int s, int h, float scale, void* dqkv,
           cudaStream_t st) {
  const Plan p = plan<D>(s);
  cudaError_t rc = attn::prepare(p.kernel, p.bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int grid = 0;
  const int g = attn::grid_of(p.kernel, p.threads, p.bytes, static_cast<int64_t>(n) * h, &grid);
  if (g != 0) return g;
  p.kernel<<<grid, p.threads, p.bytes, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout), n, s, h,
      scale, p.two, static_cast<__nv_bfloat16*>(dqkv));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int info(int s, int* out) {
  const Plan p = plan<D>(s);
  return attn::info(p.kernel, p.threads, p.bytes, out);
}

}  // namespace

// whether (s, d) takes the tuned kernel (else the tiled one,
// vit_attention_bwd_tiled.cu)
static bool tuned_shape(int s, int d) {
  return s >= 1 && s <= attn::kMaxSeq && (d == 32 || d == 64);
}

// qkv, dqkv: (n, s, 3, h, d) bf16; dout: (n, s, h * d) bf16; all 16-byte
// aligned; d >= 1, s >= 1. The tuned kernel takes d in {32, 64} and
// s <= 256, the tiled one every other shape (and every shape when
// `force_tiled` is 1), with stats: (n, h, s) float4 scratch and dp: (n,
// h, s', s') bf16 scratch, s' = s rounded up to 64 (past head width 128
// unused). Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// neither takes).
extern "C" int picha_vit_attention_bwd(const void* qkv, const void* dout, int n, int s, int h,
                                       int d, float scale, int force_tiled, void* dqkv, void* stats,
                                       void* dp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (force_tiled || !tuned_shape(s, d))
    return attn_tiled_backward(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
  if (!attn::takes(n, s, h)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  switch (d) {
    case 32: return launch<32>(qkv, dout, n, s, h, scale, dqkv, st);
    case 64: return launch<64>(qkv, dout, n, s, h, scale, dqkv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K22's build at s tokens of head width d: out[0..4] as
// picha_vit_attention_info's (the tiled one's query-side kernel when
// `force_tiled` is 1 or the shape is past the tuned one, and then its
// key-side kernel's in out[5..9]). Launches nothing.
extern "C" int picha_vit_attention_bwd_info(int s, int d, int force_tiled, int* out) {
  if (s < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (force_tiled || !tuned_shape(s, d)) return attn_tiled_backward_info(d, out);
  switch (d) {
    case 32: return info<32>(s, out);
    case 64: return info<64>(s, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
