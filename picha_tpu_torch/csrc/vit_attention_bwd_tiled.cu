// K22, tiled: the backward of the ViT's attention at the shapes past the
// tuned kernel's envelope (vit_attention_bwd.cu: at most 256 tokens, head
// width 32 or 64). picha_vit_attention_bwd chooses it by shape.
//
// Replaces, like the tuned kernel: the VJP of picha_tpu/models/vit.py::
// forward's attention (:171-180) inside jax.grad(loss_fn), at any token
// count and any head width (past 128 in attn_bwd_q_wide / attn_bwd_k_wide
// below, the same passes with the fragments read from global memory and
// the outputs split over windows of 128 columns). The tuned kernel holds a
// head's q, k, v, do and its bf16 dP in shared memory: 205,568 bytes at
// D = 64, S = 196, so a head of width 128 or a long sequence does not fit
// and is tiled here, in two launches of 4-warp blocks that stream the
// other side's rows through a double-buffered ring of 64-row chunks
// (vit_attention_tiled.cuh):
//   attn_bwd_q, a block per 64 query rows of an (image, head), their q
//     fragments in registers: dP = bf16(do . v) of every key, settled
//     (pass 0, into `dp`), the exact row max (pass 1), l = the float64 sum
//     of e = expf(s - max) rounded once (pass 2), c = the float64 sum of
//     (dP l^-2) e (pass 3), then dS and dq = dS . k (pass 4); each row's
//     max, l, 1 / l and c go to `stats`;
//   attn_bwd_k, a block per 64 key rows, the queries, their do rows and
//     their settled dP streamed: s^T = k . q^T, p^T and dS^T from the
//     query rows' statistics, dv = p^T . do and dk = dS^T . q summed over
//     the query tiles in order.
// What bounds it on an H100: qkv and do read once, dqkv written once (at
// N = 128, S = 576, H = 6, D = 64: 283 MB, 0.085 ms at HBM peak) and five
// products (163 GFLOP, 0.165 ms at the bf16 tensor peak). The reference's
// rounding points add products: the scores four times in attn_bwd_q and
// once in attn_bwd_k (the exact max, then l, before any e is used), |do| .
// |v| beside dP, and dS's two bf16 terms (hi + lo) in dq and dk.
// dP = bf16(do . v) is settled as the tuned kernel settles it: the tensor
// cores' sum, with the values whose bf16 rounding |do| . |v| leaves
// ambiguous summed again in order on the FP32 pipe (tiled::seq_dot, a
// chain of D FMAs). That chain is long, so dP is settled once a value:
// pass 0 lists a warp's ambiguous values and sums them again 32 at a time,
// one a lane (the tuned kernel's phase 0), and writes the settled bf16 dP
// to a scratch in device memory (n, h, S', S' with S' = S rounded up to 64;
// 510 MB at N = 128, S = 576, H = 6, written once and read back by passes
// 3 and 4 and by attn_bwd_k). Settling each dP tile where it is used
// (three times, a tile at a time) spent most of the time at 576 tokens on
// those in-order sums; keeping a block's dP rows in shared memory between
// its passes (recomputed past the size that fits) still left attn_bwd_k
// to settle its own tiles.
// Every rounding point is the tuned kernel's, so the two agree exactly
// where both run. No atomics: each sum stays in one warp in a fixed
// order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "vit_attention_tiled.cuh"

namespace {

using attn::col_of;
using namespace tiled;

// bytes of a staged 64 x 64 block of the dP scratch (rows + 16 bytes: the
// 8 row addresses of an ldmatrix phase in 8 bank groups)
constexpr int kDpRow = kChunk * 2 + 16;
constexpr int kDpTile = kChunk * kDpRow;

// the scratch's row length: S rounded up to whole chunks
__host__ __device__ constexpr int dp_cols(int s) { return chunks(s) * kChunk; }

// the listed dP values (row << 16 | key, row within the block's) summed
// again in order, one a lane: do rows of the tile at gs, the keys' v rows
// at vs from key k0; each result rounded to bf16 into the dP rows at dpg
template <int DP>
__device__ __forceinline__ void resum_listed(const uint32_t* fix, int count, uint32_t gs,
                                             uint32_t vs, int k0, __nv_bfloat16* dpg, int cols,
                                             int D, int lane) {
  __syncwarp();
  for (int b = 0; b < count; b += 32) {
    if (b + lane < count) {
      const uint32_t en = fix[b + lane];
      const int row = en >> 16, key = en & 0xffff;
      dpg[static_cast<int64_t>(row) * cols + key] =
          __float2bfloat16_rn(seq_dot<DP>(gs, row, vs, key - k0, D));
    }
  }
  __syncwarp();
}

// a 64 x 64 block of the dP scratch (64 query rows from src, 64 keys) into
// a tile of kDpRow-byte rows, 16-byte cp.async copies (the scratch's rows
// are whole chunks, so every copy is aligned and in bounds; its entries
// past S hold what attn_bwd_q left there, which no sum takes)
__device__ __forceinline__ void stage_dp(uint8_t* tile, const __nv_bfloat16* src, int64_t cols) {
  const uint32_t t = attn::smem_addr(tile);
  for (int i = threadIdx.x; i < kChunk * 8; i += blockDim.x) {
    const int r = i >> 3, c = i & 7;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(t + r * kDpRow + 16 * c),
                 "l"(src + r * cols + 8 * c));
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 4 : 2)
    attn_bwd_q(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
               int N, int S, int H, int D, float scale, int vec, __nv_bfloat16* __restrict__ dqkv,
               float4* __restrict__ stats, __nv_bfloat16* dp) {
  extern __shared__ __align__(128) uint8_t smem[];
  // NG key tiles at once: two up to D = 64 (one where a tile's operands
  // fill the registers)
  constexpr int TB = tile_bytes(DP), NG = DP <= 64 ? 2 : 1;
  // the block's do rows, two ring slots of a v (pass 0) or k chunk and
  // (passes 3 and 4) the block's dP rows of the chunk's keys, the warps'
  // lists of dP values to sum again
  auto slot = [&](int t) { return smem + TB + (t & 1) * (TB + kDpTile); };
  const uint32_t gs = attn::smem_addr(smem);
  const int blocks = (S + kRows - 1) / kRows, cols = dp_cols(S);
  int64_t n;
  int h, qb;
  item_of(blockIdx.x, H, blocks, n, h, qb);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const int q0 = qb * kRows, qrows = min(kRows, S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = 16 * warp;
  const bool active = r0 < qrows;
  uint32_t* fix = reinterpret_cast<uint32_t*>(smem + 3 * TB + 2 * kDpTile) + warp * kFixCap;
  // the block's rows of the dP scratch
  __nv_bfloat16* dpg = dp + ((n * H + h) * cols + q0) * static_cast<int64_t>(cols);
  // the bf16 pair at (row, key) of the block's dP rows: the accumulator
  // layout's columns 2c, 2c + 1
  auto dp_at = [&](int row, int key) {
    return reinterpret_cast<uint32_t*>(dpg + static_cast<int64_t>(row) * cols + key);
  };
  // step t: pass t / nc over key chunk t % nc, in ring slot t & 1
  const int nc = chunks(S), steps = 5 * nc;
  auto fetch = [&](int t) {
    const int k0 = (t % nc) * kChunk, kn = min(kChunk, S - k0);
    stage<DP>(slot(t), base + (t < nc ? 2 : 1) * hd + k0 * tok, tok, kn, D, vec);
    if (t >= 3 * nc) stage_dp(slot(t) + TB, dpg + k0, cols);
    attn::commit();
  };
  // q through slot 1 into registers, and the do rows, while chunk 0 comes
  stage<DP>(slot(1), base + q0 * tok, tok, qrows, D, vec);
  stage<DP>(smem, gbase + q0 * hd, hd, qrows, D, vec);
  attn::commit();
  fetch(0);
  attn::wait_all();
  __syncthreads();
  RegA<DP> qa;
  qa.init(attn::smem_addr(slot(1)), r0, lane);
  __syncthreads();
  SmemA<DP> ga;
  ga.init(gs, r0, lane);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {1.0f, 1.0f}, rl[2] = {1.0f, 1.0f},
        inv[2] = {1.0f, 1.0f}, cc[2] = {0.0f, 0.0f};
  double ls[2] = {0.0, 0.0}, cs[2] = {0.0, 0.0};
  float dq[DP / 8][4];
  zero<DP>(dq);
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      fetch(t + 1);
      attn::wait_all_but_newest();
    } else {
      attn::wait_all();
    }
    __syncthreads();
    const int pass = t / nc, k0 = (t - pass * nc) * kChunk;
    const int nt = (min(kChunk, S - k0) + 15) / 16;
    const uint32_t ks = attn::smem_addr(slot(t)), dps = ks + TB;
    if (k0 == 0 && pass == 2) {
      m[0] = attn::quad_max(m[0]);
      m[1] = attn::quad_max(m[1]);
    }
    if (k0 == 0 && pass == 3) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = attn::quad_sum(ls[r]);
        rl[r] = __frcp_rn(l[r]);
        inv[r] = __fdiv_rn(1.0f, __fmul_rn(l[r], l[r]));
      }
    }
    if (k0 == 0 && pass == 4) {
      cc[0] = attn::quad_sum(cs[0]);
      cc[1] = attn::quad_sum(cs[1]);
    }
    if (pass == 0) {
      // 0. dP = bf16(do . v) of the chunk's keys (ks holds their v rows),
      // settled: the ambiguous values listed and summed again a warp's
      // worth at a time, before the chunk leaves the ring
      int count = 0;
      for (int t0 = 0; active && t0 < nt; t0 += NG) {
        float dpt[NG][2][4], ab[NG][2][4];
        dots_abs<DP, NG>(ga, ks, t0, lane, dpt, ab);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const bool amb = attn::ambiguous(dpt[i][k >> 2][k & 3], ab[i][k >> 2][k & 3]);
            const uint32_t mask = __ballot_sync(0xffffffffu, amb);
            if (amb)
              fix[count + __popc(mask & ((1u << lane) - 1u))] =
                  static_cast<uint32_t>(r0 + g + 8 * ((k & 3) >> 1)) << 16 |
                  static_cast<uint32_t>(k0 + 16 * (t0 + i) + col_of(lane, k >> 2, k & 3));
            count += __popc(mask);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *dp_at(r0 + g + 8 * half, k0 + 16 * (t0 + i) + 8 * j + c2) =
                  attn::pack_bf2(dpt[i][j][2 * half], dpt[i][j][2 * half + 1]);
          if (count >= 32) {
            resum_listed<DP>(fix, count, gs, ks, k0, dpg, cols, D, lane);
            count = 0;
          }
        }
      }
      if (active) resum_listed<DP>(fix, count, gs, ks, k0, dpg, cols, D, lane);
    }
    // passes 1-4 over the chunk's key tiles, in two builds: a chunk of S's
    // keys only needs no mask (whole: std::true_type)
    auto tiles = [&](auto whole) {
      const int nw = decltype(whole)::value ? kChunk / 16 : nt;
      // whether column (j, e) of key tile t is one of the S keys
      auto key = [&](int t, int j, int e) {
        return decltype(whole)::value || k0 + 16 * t + col_of(lane, j, e) < S;
      };
      for (int t0 = 0; active && t0 < nw; t0 += NG) {
        float s[NG][2][4];
        dots<DP, NG>(qa, ks, t0, lane, s);
        scaled<NG>(s, scale);
        if (pass == 1) {
          // 1. the row max
#pragma unroll
          for (int i = 0; i < NG; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                m[e >> 1] = fmaxf(m[e >> 1], key(t0 + i, j, e) ? s[i][j][e] : -INFINITY);
          continue;
        }
        if (pass == 2) {
          // 2. l, summed in float64 and rounded once
#pragma unroll
          for (int i = 0; i < NG; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float ev = expf(__fsub_rn(s[i][j][e], m[e >> 1]));
                if (t0 + i < nw)
                  ls[e >> 1] = __dadd_rn(ls[e >> 1], key(t0 + i, j, e) ? ev : 0.0f);
              }
          continue;
        }
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          if (t0 + i >= nw) break;
          // the tile's settled bf16 dP, staged from the scratch
          float dpt[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              __nv_bfloat162 w;
              *reinterpret_cast<uint32_t*>(&w) = attn::lds32(
                  dps + (r0 + g + 8 * half) * kDpRow + (16 * (t0 + i) + 8 * j + c2) * 2);
              const float2 f = __bfloat1622float2(w);
              dpt[j][2 * half] = f.x;
              dpt[j][2 * half + 1] = f.y;
            }
          if (pass == 3) {
            // 3. c = the float64 sum of (dP l^-2) e
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float ev = expf(__fsub_rn(s[i][j][e], m[e >> 1]));
                const float term = __fmul_rn(__fmul_rn(dpt[j][e], inv[e >> 1]), ev);
                cs[e >> 1] = __dadd_rn(cs[e >> 1], key(t0 + i, j, e) ? term : 0.0f);
              }
            continue;
          }
          // 4. dS and dq = dS . k
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float ev = expf(__fsub_rn(s[i][j][e], m[r]));
              const float ds = __fmul_rn(
                  __fmul_rn(__fadd_rn(attn::div_rn(dpt[j][e], l[r], rl[r]), -cc[r]), ev), scale);
              dpt[j][e] = key(t0 + i, j, e) ? ds : 0.0f;
            }
          ds_times<DP>(dpt, ks, 16 * (t0 + i), lane, dq);
        }
      }
    };
    if (pass > 0 && k0 + kChunk <= S)
      tiles(std::true_type{});
    else if (pass > 0)
      tiles(std::false_type{});
    __syncthreads();
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
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 3 : 2)
    attn_bwd_k(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
               int N, int S, int H, int D, float scale, int vec, __nv_bfloat16* __restrict__ dqkv,
               const float4* __restrict__ stats, const __nv_bfloat16* __restrict__ dp) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int TB = tile_bytes(DP);
  // the block's k rows, then two ring slots of a q chunk, its do rows and
  // its 64 x 64 block of dP
  auto slot = [&](int t) { return smem + TB + (t & 1) * (2 * TB + kDpTile); };
  const uint32_t ksm = attn::smem_addr(smem);
  const int blocks = (S + kRows - 1) / kRows, cols = dp_cols(S);
  int64_t n;
  int h, kb;
  item_of(blockIdx.x, H, blocks, n, h, kb);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const float4* st = stats + (n * H + h) * S;
  const int k0 = kb * kRows, krows = min(kRows, S - k0);
  const __nv_bfloat16* dph = dp + (n * H + h) * static_cast<int64_t>(cols) * cols + k0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = 16 * warp;
  const bool active = r0 < krows;
  const bool key_in[2] = {r0 + g < krows, r0 + g + 8 < krows};
  const int nc = chunks(S);
  auto fetch = [&](int t) {
    const int q0 = t * kChunk, qn = min(kChunk, S - q0);
    stage<DP>(slot(t), base + q0 * tok, tok, qn, D, vec);
    stage<DP>(slot(t) + TB, gbase + q0 * hd, hd, qn, D, vec);
    stage_dp(slot(t) + 2 * TB, dph + static_cast<int64_t>(q0) * cols, cols);
    attn::commit();
  };
  stage<DP>(smem, base + hd + k0 * tok, tok, krows, D, vec);
  attn::commit();
  fetch(0);
  attn::wait_all();
  __syncthreads();
  // the k fragments in registers where they leave room for dk and dv
  typename std::conditional<(DP <= 64), RegA<DP>, SmemA<DP>>::type ka;
  ka.init(ksm, r0, lane);
  float dk[DP / 8][4], dv[DP / 8][4];
  zero<DP>(dk);
  zero<DP>(dv);
  for (int t = 0; t < nc; ++t) {
    if (t + 1 < nc) {
      fetch(t + 1);
      attn::wait_all_but_newest();
    } else {
      attn::wait_all();
    }
    __syncthreads();
    const int q0 = t * kChunk, nt = (min(kChunk, S - q0) + 15) / 16;
    const uint32_t qs = attn::smem_addr(slot(t)), gs = qs + TB, dsm = gs + TB;
    // the chunk's query tiles, in two builds: S's queries only against a
    // block of 64 keys needs no mask (whole: std::true_type)
    auto tiles = [&](auto wt) {
      constexpr bool whole = decltype(wt)::value;
      const int nw = whole ? kChunk / 16 : nt;
      for (int qt = 0; active && qt < nw; ++qt) {
        // rows: keys r0 + g (+ 8); columns: queries q0 + 16 qt + col_of(..)
        // (one tile at a time: two together cost registers and time)
        float s[1][2][4];
        dots<DP, 1>(ka, qs, qt, lane, s);
        // dP^T of the tile: its 16 x 16 block of the scratch, transposed
        uint32_t w[4];
        {
          const int mi = lane >> 3, r = lane & 7;
          attn::ldsm_x4_t(dsm + (16 * qt + r + 8 * (mi >> 1)) * kDpRow +
                              (((r0 >> 3) + (mi & 1)) << 4),
                          w);
        }
        float pt[2][4], dst[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i0 = q0 + 16 * qt + 8 * j + c2;
          const float4 z = make_float4(0.0f, 1.0f, 1.0f, 0.0f);
          const float4 s0 = whole || i0 < S ? st[i0] : z,
                       s1 = whole || i0 + 1 < S ? st[i0 + 1] : z;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            __nv_bfloat162 wb;
            *reinterpret_cast<uint32_t*>(&wb) = w[2 * j + half];
            const float2 f = __bfloat1622float2(wb);
#pragma unroll
            for (int odd = 0; odd < 2; ++odd) {
              const int e = 2 * half + odd;
              const float4 sq = odd ? s1 : s0;
              const bool in = whole || (i0 + odd < S && key_in[half]);
              const float ev = expf(__fsub_rn(__fmul_rn(s[0][j][e], scale), sq.x));
              const float ds = __fmul_rn(
                  __fmul_rn(__fadd_rn(attn::div_rn(odd ? f.y : f.x, sq.y, sq.z), -sq.w), ev),
                  scale);
              pt[j][e] = in ? attn::div_rn(ev, sq.y, sq.z) : 0.0f;
              dst[j][e] = in ? ds : 0.0f;
            }
          }
        }
        uint32_t pa[4];
        attn::as_a(pt, pa);
        times<DP>(pa, gs, 16 * qt, lane, dv);
        ds_times<DP>(dst, qs, 16 * qt, lane, dk);
      }
    };
    if (q0 + kChunk <= S && krows == kRows)
      tiles(std::true_type{});
    else
      tiles(std::false_type{});
    __syncthreads();
  }
  if (!active) return;
  __nv_bfloat16* out = dqkv + (n * S + k0) * tok + static_cast<int64_t>(h) * D;
  store_rows<DP>(dk, out + hd, tok, r0, krows, D, lane);
  store_rows<DP>(dv, out + 2 * hd, tok, r0, krows, D, lane);
}

// head widths past kMaxD: attn_bwd_q's four passes with every fragment read
// from global memory (vit_attention_tiled.cuh, namespace wide); a block
// owns 128 query rows and one window of 128 columns of dq, the scores and
// dP summed over all of D. The first window writes the rows' statistics.
__global__ void __launch_bounds__(wide::kWarps * 32)
    attn_bwd_q_wide(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dout, int N, int S, int H, int D,
                    float scale, __nv_bfloat16* __restrict__ dqkv, float4* __restrict__ stats) {
  const int blocks = (S + wide::kRows - 1) / wide::kRows;
  const int windows = (D + wide::kOut - 1) / wide::kOut;
  int64_t n;
  int h, qb, win;
  wide::item_of(blockIdx.x, H, blocks, windows, n, h, qb, win);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const int q0 = qb * wide::kRows, qrows = min(wide::kRows, S - q0), c0 = win * wide::kOut;
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
__global__ void __launch_bounds__(wide::kWarps * 32)
    attn_bwd_k_wide(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dout, int N, int S, int H, int D,
                    float scale, __nv_bfloat16* __restrict__ dqkv,
                    const float4* __restrict__ stats) {
  const int blocks = (S + wide::kRows - 1) / wide::kRows;
  const int windows = (D + wide::kOut - 1) / wide::kOut;
  int64_t n;
  int h, kb, win;
  wide::item_of(blockIdx.x, H, blocks, windows, n, h, kb, win);
  const int64_t tok = static_cast<int64_t>(3) * H * D, hd = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* gbase = dout + n * S * hd + static_cast<int64_t>(h) * D;
  const float4* st = stats + (n * H + h) * S;
  const int k0 = kb * wide::kRows, krows = min(wide::kRows, S - k0), c0 = win * wide::kOut;
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
  const int64_t grid = static_cast<int64_t>(n) * h * ((s + wide::kRows - 1) / wide::kRows) *
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
  attn_bwd_q_wide<<<static_cast<unsigned>(grid), wide::kWarps * 32, 0, st>>>(
      q, g, n, s, h, d, scale, out, static_cast<float4*>(stats));
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  attn_bwd_k_wide<<<static_cast<unsigned>(grid), wide::kWarps * 32, 0, st>>>(
      q, g, n, s, h, d, scale, out, static_cast<const float4*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// shared bytes: attn_bwd_q's do rows, two ring slots of a chunk and its
// dP block, and the warps' lists;
// attn_bwd_k's k rows and two ring slots of a q chunk, its do rows and
// its dP block
template <int DP>
size_t q_bytes() {
  return static_cast<size_t>(3) * tile_bytes(DP) + 2 * kDpTile + kWarps * kFixCap * 4;
}

template <int DP>
size_t k_bytes() {
  return static_cast<size_t>(5) * tile_bytes(DP) + 2 * kDpTile;
}

template <int DP>
int launch(const void* qkv, const void* dout, int n, int s, int h, int d, float scale,
           void* dqkv, void* stats, void* dp, cudaStream_t st) {
  const size_t qb = q_bytes<DP>(), kb = k_bytes<DP>();
  int rc = static_cast<int>(attn::prepare(attn_bwd_q<DP>, qb));
  if (rc == 0) rc = static_cast<int>(attn::prepare(attn_bwd_k<DP>, kb));
  if (rc != 0) return rc;
  const int64_t grid = static_cast<int64_t>(n) * h * ((s + kRows - 1) / kRows);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* g = static_cast<const __nv_bfloat16*>(dout);
  auto* out = static_cast<__nv_bfloat16*>(dqkv);
  auto* p = static_cast<__nv_bfloat16*>(dp);
  attn_bwd_q<DP><<<static_cast<unsigned>(grid), kThreads, qb, st>>>(
      q, g, n, s, h, d, scale, vec, out, static_cast<float4*>(stats), p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  attn_bwd_k<DP><<<static_cast<unsigned>(grid), kThreads, kb, st>>>(
      q, g, n, s, h, d, scale, vec, out, static_cast<const float4*>(stats), p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..4]: attn_bwd_q's build (attn::info), out[5..9]: attn_bwd_k's
template <int DP>
int info(int* out) {
  const int rc = attn::info(attn_bwd_q<DP>, kThreads, q_bytes<DP>(), out);
  return rc != 0 ? rc : attn::info(attn_bwd_k<DP>, kThreads, k_bytes<DP>(), out + 5);
}

}  // namespace

// qkv, dqkv: (n, s, 3, h, d) bf16; dout: (n, s, h * d) bf16 (2-byte
// aligned); stats: (n, h, s) float4 scratch; dp: (n, h, s', s') bf16
// scratch, s' = s rounded up to 64 (both 16-byte aligned; dp unused past
// kMaxD); d >= 1 (past kMaxD the wide kernels), s >= 1
int attn_tiled_backward(const void* qkv, const void* dout, int n, int s, int h, int d,
                        float scale, void* dqkv, void* stats, void* dp, cudaStream_t st) {
  if (n < 0 || s < 1 || h < 1 || d < 1 || stats == nullptr ||
      (d <= tiled::kMaxD && dp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (d > tiled::kMaxD) return launch_wide(qkv, dout, n, s, h, d, scale, dqkv, stats, st);
  switch (tiled::pad16(d)) {
    case 16: return launch<16>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
    case 32: return launch<32>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
    case 48: return launch<48>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
    case 64: return launch<64>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
    case 80: return launch<80>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
    case 96: return launch<96>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
    case 112: return launch<112>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
    default: return launch<128>(qkv, dout, n, s, h, d, scale, dqkv, stats, dp, st);
  }
}

// out: 10 ints (info above; past kMaxD attn_bwd_q_wide's and
// attn_bwd_k_wide's)
int attn_tiled_backward_info(int d, int* out) {
  if (d > tiled::kMaxD) {
    const int rc = attn::info(attn_bwd_q_wide, wide::kWarps * 32, 0, out);
    return rc != 0 ? rc : attn::info(attn_bwd_k_wide, wide::kWarps * 32, 0, out + 5);
  }
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
