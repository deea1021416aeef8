// K22, tiled: the backward of the ViT's attention at the shapes past the
// tuned kernel's envelope (vit_attention_bwd.cu: at most 256 tokens, head
// width 32 or 64). picha_vit_attention_bwd chooses it by shape.
//
// Replaces, like the tuned kernel: the VJP of picha_tpu/models/vit.py::
// forward's attention (:171-180) inside jax.grad(loss_fn), at any token
// count and any head width (past 128 in attn_bwd_q_wide / attn_bwd_k_wide
// below, the same passes with the fragments read from global memory and
// the outputs split over windows of 128 columns). The tuned kernel holds a head's q,
// k, v, do and its bf16 dP in shared memory: 205,568 bytes at D = 64, S =
// 196, so a head of width 128 or a long sequence does not fit and is
// tiled here, in two launches:
//   attn_bwd_q, a block per 128 query rows of an (image, head), the keys
//     in chunks of at most 256 staged with their v rows: the exact row max
//     (pass 1), l = the float64 sum of e = expf(s - max) rounded once
//     (pass 2), c = the float64 sum of (dP l^-2) e (pass 3), then dS and
//     dq = dS . k (pass 4); each row's max, l, 1 / l and c go to `stats`;
//   attn_bwd_k, a block per 128 key rows, the queries and their do rows in
//     chunks of at most 256: s^T = k . q^T, p^T and dS^T from the query
//     rows' statistics, dv = p^T . do and dk = dS^T . q summed over the
//     query tiles in order.
// dP = bf16(do . v) is computed on the tensor cores with |do| . |v| and
// its ambiguous values summed again in order (the tuned kernel's phase 0
// settling), tile by tile, where each pass needs it: every pass computes
// the same values. The scores are K18's (each 16-deep step added with
// round-to-nearest), dS enters dq and dk as two bf16 terms (hi + lo), and
// every rounding point is the tuned kernel's, so the two agree exactly
// where both run. No atomics: each sum stays in one warp in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vit_attention_tiled.cuh"

namespace {

using attn::col_of;
using namespace tiled;

template <int DP>
__global__ void __launch_bounds__(kWarps * 32, 1)
    attn_bwd_q(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
               int N, int S, int H, int D, float scale, __nv_bfloat16* __restrict__ dqkv,
               float4* __restrict__ stats) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int ST = stride_of(DP);
  uint8_t* qp = smem;
  uint8_t* gp = qp + kRows * ST;
  uint8_t* kp = gp + kRows * ST;
  uint8_t* vp = kp + kChunk * ST;
  const uint32_t qs = attn::smem_addr(qp), gs = attn::smem_addr(gp), ks = attn::smem_addr(kp),
                 vs = attn::smem_addr(vp);
  const int blocks = (S + kRows - 1) / kRows;
  int64_t n;
  int h, qb;
  item_of(blockIdx.x, H, blocks, n, h, qb);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const int q0 = qb * kRows, qrows = min(kRows, S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int r0 = 16 * warp;
  const bool active = r0 < qrows;
  const int nchunks = (S + kChunk - 1) / kChunk;
  stage<DP>(qp, base + q0 * tok, tok, qrows, kRows, D);
  stage<DP>(gp, gbase + q0 * hd, hd, qrows, kRows, D);
  int k_in = -1, v_in = -1;
  auto stage_chunk = [&](int c, bool with_v) {
    const int k0 = c * kChunk, kn = min(kChunk, S - k0), rows = (kn + 15) / 16 * 16;
    if (k_in == c && (!with_v || v_in == c)) return;
    __syncthreads();
    if (k_in != c) stage<DP>(kp, base + hd + k0 * tok, tok, kn, rows, D);
    if (with_v && v_in != c) stage<DP>(vp, base + 2 * hd + k0 * tok, tok, kn, rows, D);
    __syncthreads();
    k_in = c;
    if (with_v) v_in = c;
  };
  auto scores = [&](int kt, float (&s)[2][4]) {
    dots<DP>(qs, r0, ks, kt, lane, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = __fmul_rn(s[j][i], scale);
  };
  // bf16 dP of key tile kt of the staged chunk, settled
  auto dp_of = [&](int kt, float (&dp)[2][4]) {
    float ab[2][4];
    dots<DP>(gs, r0, vs, kt, lane, dp);
    dots_abs<DP>(gs, r0, vs, kt, lane, ab);
    resum_round<DP>(gs, r0, vs, kt, D, lane, ab, dp);
  };

  // 1. the row max
  float m[2] = {-INFINITY, -INFINITY};
  for (int c = 0; c < nchunks; ++c) {
    stage_chunk(c, false);
    const int k0 = c * kChunk, nt = (min(kChunk, S - k0) + 15) / 16;
    for (int kt = 0; active && kt < nt; ++kt) {
      float s[2][4];
      scores(kt, s);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m[i >> 1] =
              fmaxf(m[i >> 1], k0 + 16 * kt + col_of(lane, j, i) < S ? s[j][i] : -INFINITY);
    }
  }
  m[0] = attn::quad_max(m[0]);
  m[1] = attn::quad_max(m[1]);

  // 2. l, summed in float64 and rounded once
  double ls[2] = {0.0, 0.0};
  for (int c = 0; c < nchunks; ++c) {
    stage_chunk(c, false);
    const int k0 = c * kChunk, nt = (min(kChunk, S - k0) + 15) / 16;
    for (int kt = 0; active && kt < nt; ++kt) {
      float s[2][4];
      scores(kt, s);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ev = expf(__fsub_rn(s[j][i], m[i >> 1]));
          ls[i >> 1] = __dadd_rn(ls[i >> 1], k0 + 16 * kt + col_of(lane, j, i) < S ? ev : 0.0f);
        }
    }
  }
  const float l[2] = {attn::quad_sum(ls[0]), attn::quad_sum(ls[1])};
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const float inv[2] = {__fdiv_rn(1.0f, __fmul_rn(l[0], l[0])),
                        __fdiv_rn(1.0f, __fmul_rn(l[1], l[1]))};

  // 3. c = the float64 sum of (dP l^-2) e
  double cs[2] = {0.0, 0.0};
  for (int c = 0; c < nchunks; ++c) {
    stage_chunk(c, true);
    const int k0 = c * kChunk, nt = (min(kChunk, S - k0) + 15) / 16;
    for (int kt = 0; active && kt < nt; ++kt) {
      float s[2][4], dp[2][4];
      scores(kt, s);
      dp_of(kt, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ev = expf(__fsub_rn(s[j][i], m[i >> 1]));
          const float term = __fmul_rn(__fmul_rn(dp[j][i], inv[i >> 1]), ev);
          cs[i >> 1] =
              __dadd_rn(cs[i >> 1], k0 + 16 * kt + col_of(lane, j, i) < S ? term : 0.0f);
        }
    }
  }
  const float cc[2] = {attn::quad_sum(cs[0]), attn::quad_sum(cs[1])};

  // 4. dS and dq = dS . k
  float dq[DP / 8][4];
  zero<DP>(dq);
  for (int c = 0; c < nchunks; ++c) {
    stage_chunk(c, true);
    const int k0 = c * kChunk, nt = (min(kChunk, S - k0) + 15) / 16;
    for (int kt = 0; active && kt < nt; ++kt) {
      float s[2][4], dp[2][4];
      scores(kt, s);
      dp_of(kt, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const float ev = expf(__fsub_rn(s[j][i], m[r]));
          const float ds = __fmul_rn(
              __fmul_rn(__fadd_rn(attn::div_rn(dp[j][i], l[r], rl[r]), -cc[r]), ev), scale);
          dp[j][i] = k0 + 16 * kt + col_of(lane, j, i) < S ? ds : 0.0f;
        }
      ds_times<DP>(dp, ks, 16 * kt, lane, dq);
    }
  }
  if (!active) return;
  store_rows<DP>(dq, dqkv + (n * S + q0) * tok + static_cast<int64_t>(h) * D, tok, r0, qrows, D,
                 lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < qrows)
        stats[(n * H + h) * S + q0 + row] = make_float4(m[r], l[r], rl[r], cc[r]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kWarps * 32, 1)
    attn_bwd_k(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
               int N, int S, int H, int D, float scale, __nv_bfloat16* __restrict__ dqkv,
               const float4* __restrict__ stats) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int ST = stride_of(DP);
  uint8_t* kp = smem;
  uint8_t* vp = kp + kRows * ST;
  uint8_t* qp = vp + kRows * ST;
  uint8_t* gp = qp + kChunk * ST;
  const uint32_t ks = attn::smem_addr(kp), vs = attn::smem_addr(vp), qs = attn::smem_addr(qp),
                 gs = attn::smem_addr(gp);
  const int blocks = (S + kRows - 1) / kRows;
  int64_t n;
  int h, kb;
  item_of(blockIdx.x, H, blocks, n, h, kb);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const float4* st = stats + (n * H + h) * S;
  const int k0 = kb * kRows, krows = min(kRows, S - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = 16 * warp;
  const bool active = r0 < krows;
  const bool key_in[2] = {r0 + g < krows, r0 + g + 8 < krows};
  const int nchunks = (S + kChunk - 1) / kChunk;
  stage<DP>(kp, base + hd + k0 * tok, tok, krows, kRows, D);
  stage<DP>(vp, base + 2 * hd + k0 * tok, tok, krows, kRows, D);
  float dk[DP / 8][4], dv[DP / 8][4];
  zero<DP>(dk);
  zero<DP>(dv);
  for (int c = 0; c < nchunks; ++c) {
    const int q0 = c * kChunk, qn = min(kChunk, S - q0), nt = (qn + 15) / 16;
    __syncthreads();
    stage<DP>(qp, base + q0 * tok, tok, qn, nt * 16, D);
    stage<DP>(gp, gbase + q0 * hd, hd, qn, nt * 16, D);
    __syncthreads();
    for (int qt = 0; active && qt < nt; ++qt) {
      // rows: keys r0 + g (+ 8); columns: queries q0 + 16 qt + col_of(..)
      float s[2][4], dpt[2][4], ab[2][4], pt[2][4];
      dots<DP>(ks, r0, qs, qt, lane, s);
      dots<DP>(vs, r0, gs, qt, lane, dpt);
      dots_abs<DP>(vs, r0, gs, qt, lane, ab);
      resum_round<DP>(vs, r0, gs, qt, D, lane, ab, dpt);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i0 = q0 + 16 * qt + 8 * j + c2;
        const float4 z = make_float4(0.0f, 1.0f, 1.0f, 0.0f);
        const float4 s0 = i0 < S ? st[i0] : z, s1 = i0 + 1 < S ? st[i0 + 1] : z;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool odd = i & 1;
          const float4 sq = odd ? s1 : s0;
          const bool in = i0 + odd < S && key_in[i >> 1];
          const float ev = expf(__fsub_rn(__fmul_rn(s[j][i], scale), sq.x));
          const float ds = __fmul_rn(
              __fmul_rn(__fadd_rn(attn::div_rn(dpt[j][i], sq.y, sq.z), -sq.w), ev), scale);
          pt[j][i] = in ? attn::div_rn(ev, sq.y, sq.z) : 0.0f;
          s[j][i] = in ? ds : 0.0f;
        }
      }
      uint32_t pa[4];
      attn::as_a(pt, pa);
      times<DP>(pa, gs, 16 * qt, lane, dv);
      ds_times<DP>(s, qs, 16 * qt, lane, dk);
    }
  }
  if (!active) return;
  __nv_bfloat16* dst = dqkv + (n * S + k0) * tok + static_cast<int64_t>(h) * D;
  store_rows<DP>(dk, dst + hd, tok, r0, krows, D, lane);
  store_rows<DP>(dv, dst + 2 * hd, tok, r0, krows, D, lane);
}

// head widths past kMaxD: attn_bwd_q's four passes with every fragment read
// from global memory (vit_attention_tiled.cuh, namespace wide); a block
// owns 128 query rows and one window of 128 columns of dq, the scores and
// dP summed over all of D. The first window writes the rows' statistics.
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_q_wide(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dout, int N, int S, int H, int D,
                    float scale, __nv_bfloat16* __restrict__ dqkv, float4* __restrict__ stats) {
  const int blocks = (S + kRows - 1) / kRows, windows = (D + wide::kOut - 1) / wide::kOut;
  int64_t n;
  int h, qb, win;
  wide::item_of(blockIdx.x, H, blocks, windows, n, h, qb, win);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const int q0 = qb * kRows, qrows = min(kRows, S - q0), c0 = win * wide::kOut;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, r0 = 16 * warp;
  if (r0 >= qrows) return;
  const wide::Mat q = wide::mat(base, tok, q0, qrows, 0, D);
  const wide::Mat gq = wide::mat(gbase, hd, q0, qrows, 0, D);
  const wide::Mat k = wide::mat(base + hd, tok, 0, S, 0, D);
  const wide::Mat kw = wide::mat(base + hd, tok, 0, S, c0, D);
  const wide::Mat v = wide::mat(base + 2 * hd, tok, 0, S, 0, D);
  const int nt = (S + 15) / 16;
  auto scores = [&](int kt, float (&s)[2][4]) {
    wide::dots(q, r0, k, kt, lane, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = __fmul_rn(s[j][i], scale);
  };
  auto dp_of = [&](int kt, float (&dp)[2][4]) {
    float ab[2][4];
    wide::dots(gq, r0, v, kt, lane, dp);
    wide::dots_abs(gq, r0, v, kt, lane, ab);
    wide::resum_round(gq, r0, v, kt, lane, ab, dp);
  };

  float m[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < nt; ++kt) {
    float s[2][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m[i >> 1] = fmaxf(m[i >> 1], 16 * kt + col_of(lane, j, i) < S ? s[j][i] : -INFINITY);
  }
  m[0] = attn::quad_max(m[0]);
  m[1] = attn::quad_max(m[1]);

  double ls[2] = {0.0, 0.0};
  for (int kt = 0; kt < nt; ++kt) {
    float s[2][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ev = expf(__fsub_rn(s[j][i], m[i >> 1]));
        ls[i >> 1] = __dadd_rn(ls[i >> 1], 16 * kt + col_of(lane, j, i) < S ? ev : 0.0f);
      }
  }
  const float l[2] = {attn::quad_sum(ls[0]), attn::quad_sum(ls[1])};
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const float inv[2] = {__fdiv_rn(1.0f, __fmul_rn(l[0], l[0])),
                        __fdiv_rn(1.0f, __fmul_rn(l[1], l[1]))};

  double cs[2] = {0.0, 0.0};
  for (int kt = 0; kt < nt; ++kt) {
    float s[2][4], dp[2][4];
    scores(kt, s);
    dp_of(kt, dp);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ev = expf(__fsub_rn(s[j][i], m[i >> 1]));
        const float term = __fmul_rn(__fmul_rn(dp[j][i], inv[i >> 1]), ev);
        cs[i >> 1] = __dadd_rn(cs[i >> 1], 16 * kt + col_of(lane, j, i) < S ? term : 0.0f);
      }
  }
  const float cc[2] = {attn::quad_sum(cs[0]), attn::quad_sum(cs[1])};

  float dq[wide::kOut / 8][4];
  wide::zero(dq);
  for (int kt = 0; kt < nt; ++kt) {
    float s[2][4], dp[2][4];
    scores(kt, s);
    dp_of(kt, dp);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float ev = expf(__fsub_rn(s[j][i], m[r]));
        const float ds = __fmul_rn(
            __fmul_rn(__fadd_rn(attn::div_rn(dp[j][i], l[r], rl[r]), -cc[r]), ev), scale);
        dp[j][i] = 16 * kt + col_of(lane, j, i) < S ? ds : 0.0f;
      }
    wide::ds_times(dp, kw, 16 * kt, lane, dq);
  }
  wide::store_rows(dq, dqkv + (n * S + q0) * tok + static_cast<int64_t>(h) * D + c0, tok, r0,
                   qrows, min(wide::kOut, D - c0), lane);
  if (win == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < qrows)
        stats[(n * H + h) * S + q0 + row] = make_float4(m[r], l[r], rl[r], cc[r]);
    }
  }
}

// attn_bwd_k's pass for head widths past kMaxD: a block owns 128 key rows
// and one window of 128 columns of dk and dv
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_k_wide(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dout, int N, int S, int H, int D,
                    float scale, __nv_bfloat16* __restrict__ dqkv,
                    const float4* __restrict__ stats) {
  const int blocks = (S + kRows - 1) / kRows, windows = (D + wide::kOut - 1) / wide::kOut;
  int64_t n;
  int h, kb, win;
  wide::item_of(blockIdx.x, H, blocks, windows, n, h, kb, win);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const float4* st = stats + (n * H + h) * S;
  const int k0 = kb * kRows, krows = min(kRows, S - k0), c0 = win * wide::kOut;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = 16 * warp;
  if (r0 >= krows) return;
  const bool key_in[2] = {r0 + g < krows, r0 + g + 8 < krows};
  const wide::Mat kk = wide::mat(base + hd, tok, k0, krows, 0, D);
  const wide::Mat vk = wide::mat(base + 2 * hd, tok, k0, krows, 0, D);
  const wide::Mat q = wide::mat(base, tok, 0, S, 0, D);
  const wide::Mat qw = wide::mat(base, tok, 0, S, c0, D);
  const wide::Mat gall = wide::mat(gbase, hd, 0, S, 0, D);
  const wide::Mat gw = wide::mat(gbase, hd, 0, S, c0, D);
  float dk[wide::kOut / 8][4], dv[wide::kOut / 8][4];
  wide::zero(dk);
  wide::zero(dv);
  const int nt = (S + 15) / 16;
  for (int qt = 0; qt < nt; ++qt) {
    float s[2][4], dpt[2][4], ab[2][4], pt[2][4];
    wide::dots(kk, r0, q, qt, lane, s);
    wide::dots(vk, r0, gall, qt, lane, dpt);
    wide::dots_abs(vk, r0, gall, qt, lane, ab);
    wide::resum_round(vk, r0, gall, qt, lane, ab, dpt);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i0 = 16 * qt + 8 * j + c2;
      const float4 z = make_float4(0.0f, 1.0f, 1.0f, 0.0f);
      const float4 s0 = i0 < S ? st[i0] : z, s1 = i0 + 1 < S ? st[i0 + 1] : z;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool odd = i & 1;
        const float4 sq = odd ? s1 : s0;
        const bool in = i0 + odd < S && key_in[i >> 1];
        const float ev = expf(__fsub_rn(__fmul_rn(s[j][i], scale), sq.x));
        const float ds = __fmul_rn(
            __fmul_rn(__fadd_rn(attn::div_rn(dpt[j][i], sq.y, sq.z), -sq.w), ev), scale);
        pt[j][i] = in ? attn::div_rn(ev, sq.y, sq.z) : 0.0f;
        s[j][i] = in ? ds : 0.0f;
      }
    }
    uint32_t pa[4];
    attn::as_a(pt, pa);
    wide::times(pa, gw, 16 * qt, lane, dv);
    wide::ds_times(s, qw, 16 * qt, lane, dk);
  }
  __nv_bfloat16* dst = dqkv + (n * S + k0) * tok + static_cast<int64_t>(h) * D + c0;
  const int cols = min(wide::kOut, D - c0);
  wide::store_rows(dk, dst + hd, tok, r0, krows, cols, lane);
  wide::store_rows(dv, dst + 2 * hd, tok, r0, krows, cols, lane);
}

int launch_wide(const void* qkv, const void* dout, int n, int s, int h, int d, float scale,
                void* dqkv, void* stats, cudaStream_t st) {
  const int64_t grid = static_cast<int64_t>(n) * h * ((s + kRows - 1) / kRows) *
                       ((d + wide::kOut - 1) / wide::kOut);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // no shared memory: the carveout goes to L1, which the fragment loads use
  for (const void* fn : {reinterpret_cast<const void*>(attn_bwd_q_wide),
                         reinterpret_cast<const void*>(attn_bwd_k_wide)}) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxL1)));
    if (rc != 0) return rc;
  }
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* g = static_cast<const __nv_bfloat16*>(dout);
  auto* out = static_cast<__nv_bfloat16*>(dqkv);
  attn_bwd_q_wide<<<static_cast<unsigned>(grid), kWarps * 32, 0, st>>>(
      q, g, n, s, h, d, scale, out, static_cast<float4*>(stats));
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  attn_bwd_k_wide<<<static_cast<unsigned>(grid), kWarps * 32, 0, st>>>(
      q, g, n, s, h, d, scale, out, static_cast<const float4*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const void* qkv, const void* dout, int n, int s, int h, int d, float scale,
           void* dqkv, void* stats, cudaStream_t st) {
  const size_t bytes = smem_bytes(DP);
  int rc = static_cast<int>(attn::prepare(attn_bwd_q<DP>, bytes));
  if (rc == 0) rc = static_cast<int>(attn::prepare(attn_bwd_k<DP>, bytes));
  if (rc != 0) return rc;
  const int64_t grid = static_cast<int64_t>(n) * h * ((s + kRows - 1) / kRows);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* g = static_cast<const __nv_bfloat16*>(dout);
  auto* out = static_cast<__nv_bfloat16*>(dqkv);
  attn_bwd_q<DP><<<static_cast<unsigned>(grid), kWarps * 32, bytes, st>>>(
      q, g, n, s, h, d, scale, out, static_cast<float4*>(stats));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  attn_bwd_k<DP><<<static_cast<unsigned>(grid), kWarps * 32, bytes, st>>>(
      q, g, n, s, h, d, scale, out, static_cast<const float4*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int info(int* out) {
  return attn::info(attn_bwd_q<DP>, kWarps * 32, smem_bytes(DP), out);
}

}  // namespace

// qkv, dqkv: (n, s, 3, h, d) bf16; dout: (n, s, h * d) bf16 (2-byte
// aligned); stats: (n, h, s) float4 scratch (16-byte aligned); d >= 1
// (past kMaxD the wide kernels), s >= 1
int attn_tiled_backward(const void* qkv, const void* dout, int n, int s, int h, int d,
                        float scale, void* dqkv, void* stats, cudaStream_t st) {
  if (n < 0 || s < 1 || h < 1 || d < 1 || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (d > tiled::kMaxD) return launch_wide(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
  switch (tiled::pad16(d)) {
    case 16: return launch<16>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
    case 32: return launch<32>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
    case 48: return launch<48>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
    case 64: return launch<64>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
    case 80: return launch<80>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
    case 96: return launch<96>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
    case 112: return launch<112>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
    default: return launch<128>(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
  }
}

int attn_tiled_backward_info(int d, int* out) {
  if (d > tiled::kMaxD) return attn::info(attn_bwd_q_wide, kWarps * 32, 0, out);
  switch (tiled::pad16(d)) {
    case 16: return info<16>(out);
    case 32: return info<32>(out);
    case 48: return info<48>(out);
    case 64: return info<64>(out);
    case 80: return info<80>(out);
    case 96: return info<96>(out);
    case 112: return info<112>(out);
    default: return info<128>(out);
  }
}
