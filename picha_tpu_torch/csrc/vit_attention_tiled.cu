// K18, tiled: the ViT's multi-head self-attention at the shapes past the
// tuned kernel's envelope (vit_attention.cu: at most 256 tokens, head
// width 32, 64 or 128). picha_vit_attention chooses it by shape.
//
// Replaces, like the tuned kernel: picha_tpu/models/vit.py::forward's
// attention (:171-180) at any token count and any head width
// (ViTConfig(image_size=384): 576 tokens; ViT-H/14's heads of 80;
// ViTConfig(dim=768, heads=3): heads of 256, in attn_fwd_wide below).
//
// What bounds it on an H100: qkv read once and o written once (at N = 128,
// S = 576, H = 6, D = 64: 170 MB, 0.051 ms at HBM peak) and the two
// products q . k^T and p . v (65 GFLOP, 0.066 ms at the bf16 tensor
// peak). The reference's softmax order costs a third and a fourth
// product: the max and the row sum go over all keys before any p is
// formed, and p is rounded with the final l (no online, flash rescale,
// which rounds otherwise), so the scores are computed three times. A
// block of 4 warps owns 64 query rows of one (image, head)
// (vit_attention_tiled.cuh), holds their q fragments in registers, and
// streams the keys through a double-buffered ring of 64-key chunks in
// three passes, one sequence of 3 x chunks steps:
//   1. the scores of every key (q . k^T on the tensor cores, each 16-deep
//      step added with round-to-nearest, then `* scale`): the exact row
//      max over all S keys;
//   2. the scores again: e = expf(s - max) and l, their f32 sum;
//   3. the scores again, with the chunk's v rows: p = bf16(e / l) (the
//      correctly rounded quotient, attn::div_rn) packed as the A operand
//      of p . v.
// Two ring slots of a k and a v chunk: 4 x 64 x (2 DP + 16) bytes, 69,632
// at D = 128, so three blocks (12 warps) share a multiprocessor (four up
// to D = 64), where 128-row blocks with 256-key chunks took 208,896 bytes
// and one.
// q and k are zero-padded to the mma's 16-deep step; keys past S are
// masked out of the max and the sum and get p = 0 (their rows staged as
// zeros). The scores, e, l and p are the tuned kernel's to the bit, and o
// is summed over the key tiles in the same order, so the two agree
// exactly where both run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "vit_attention_tiled.cuh"

namespace {

using attn::col_of;
using namespace tiled;

template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 4 : 3)
    attn_fwd_tiled(const __nv_bfloat16* __restrict__ qkv, int N, int S, int H, int D,
                   float scale, int vec, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int TB = tile_bytes(DP);
  const int blocks = (S + kRows - 1) / kRows;
  int64_t n;
  int h, qb;
  item_of(blockIdx.x, H, blocks, n, h, qb);
  const int64_t tok = static_cast<int64_t>(3) * H * D;   // qkv elements per token
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const int q0 = qb * kRows, qrows = min(kRows, S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = 16 * warp;
  const bool active = r0 < qrows;
  const int nc = chunks(S), steps = 3 * nc;
  // step t: pass t / nc over key chunk t % nc, in ring slot t & 1 (a k
  // chunk, then a v chunk in pass 3)
  auto slot = [&](int t) { return smem + (t & 1) * 2 * TB; };
  auto fetch = [&](int t) {
    const int k0 = (t % nc) * kChunk, kn = min(kChunk, S - k0);
    stage<DP>(slot(t), base + H * D + k0 * tok, tok, kn, D, vec);
    if (t >= 2 * nc) stage<DP>(slot(t) + TB, base + 2 * H * D + k0 * tok, tok, kn, D, vec);
    attn::commit();
  };
  // q through slot 1 into registers while key chunk 0 comes into slot 0
  stage<DP>(slot(1), base + q0 * tok, tok, qrows, D, vec);
  attn::commit();
  fetch(0);
  attn::wait_all();
  __syncthreads();
  RegA<DP> qa;
  qa.init(attn::smem_addr(slot(1)), r0, lane);
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.0f, 0.0f}, l[2] = {1.0f, 1.0f},
        rl[2] = {1.0f, 1.0f};
  float o[DP / 8][4];
  zero<DP>(o);
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      fetch(t + 1);
      attn::wait_all_but_newest();
    } else {
      attn::wait_all();
    }
    __syncthreads();
    const int pass = t / nc, c = t - pass * nc, k0 = c * kChunk;
    const int nt = (min(kChunk, S - k0) + 15) / 16;
    const uint32_t ks = attn::smem_addr(slot(t)), vs = ks + TB;
    if (c == 0 && pass == 1) {
      m[0] = attn::quad_max(m[0]);
      m[1] = attn::quad_max(m[1]);
    }
    if (c == 0 && pass == 2) {
      l[0] = attn::quad_sum(ls[0]);
      l[1] = attn::quad_sum(ls[1]);
      rl[0] = __frcp_rn(l[0]);
      rl[1] = __frcp_rn(l[1]);
    }
    // the chunk's key tiles, in two builds: a chunk of S's keys only
    // needs no mask (whole: std::true_type)
    auto tiles = [&](auto whole) {
      // whether column (j, e) of key tile kt is one of the S keys
      auto key = [&](int kt, int j, int e) {
        return decltype(whole)::value || k0 + 16 * kt + col_of(lane, j, e) < S;
      };
      for (int kt = 0; active && kt < nt; ++kt) {
        // the scaled scores of key tile kt (one tile at a time: computing
        // two or four together cost the block registers and a
        // multiprocessor a block, and time)
        float s[1][2][4];
        dots<DP, 1>(qa, ks, kt, lane, s);
        scaled<1>(s, scale);
        if (pass == 0) {
          // 1. the exact max over all S keys of rows g and g + 8
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              m[e >> 1] = fmaxf(m[e >> 1], key(kt, j, e) ? s[0][j][e] : -INFINITY);
        } else if (pass == 1) {
          // 2. l = the f32 sum of e = expf(s - max) (0 past S)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ev = expf(__fsub_rn(s[0][j][e], m[e >> 1]));
              ls[e >> 1] = __fadd_rn(ls[e >> 1], key(kt, j, e) ? ev : 0.0f);
            }
        } else {
          // 3. o += p . v, p = bf16(e / l) packed tile by tile as the A
          // operand
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ev = expf(__fsub_rn(s[0][j][e], m[e >> 1]));
              s[0][j][e] = attn::div_rn(key(kt, j, e) ? ev : 0.0f, l[e >> 1], rl[e >> 1]);
            }
          uint32_t pa[4];
          attn::as_a(s[0], pa);
          times<DP>(pa, vs, 16 * kt, lane, o);
        }
      }
    };
    if (k0 + kChunk <= S)
      tiles(std::true_type{});
    else
      tiles(std::false_type{});
    __syncthreads();
  }
  if (active)
    store_rows<DP>(o, out + (n * S + q0) * H * D + static_cast<int64_t>(h) * D,
                   static_cast<int64_t>(H) * D, r0, qrows, D, lane);
}

// head widths past kMaxD: the three passes above with every fragment read
// from global memory (vit_attention_tiled.cuh, namespace wide); a block
// owns 128 query rows and one window of 128 output columns, and sums each
// score over all of D in the 16-deep round-to-nearest steps
__global__ void __launch_bounds__(wide::kWarps * 32)
    attn_fwd_wide(const __nv_bfloat16* __restrict__ qkv, int N, int S, int H, int D, float scale,
                  __nv_bfloat16* __restrict__ out) {
  const int blocks = (S + wide::kRows - 1) / wide::kRows;
  const int windows = (D + wide::kOut - 1) / wide::kOut;
  int64_t n;
  int h, qb, win;
  wide::item_of(blockIdx.x, H, blocks, windows, n, h, qb, win);
  const int64_t tok = static_cast<int64_t>(3) * H * D;
  const __nv_bfloat16* base = qkv + n * S * tok + static_cast<int64_t>(h) * D;
  const int q0 = qb * wide::kRows, qrows = min(wide::kRows, S - q0), c0 = win * wide::kOut;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = 16 * warp;
  if (r0 >= qrows) return;
  const wide::Mat q = wide::mat(base, tok, q0, qrows, 0, D);
  const wide::Mat k = wide::mat(base + H * D, tok, 0, S, 0, D);
  const wide::Mat v = wide::mat(base + 2 * H * D, tok, 0, S, c0, D);
  const int nt = (S + 15) / 16;
  auto scores = [&](int kt, float (&s)[2][4]) {
    wide::dots(q, r0, k, kt, lane, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
  };
  float m[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < nt; ++kt) {
    float s[2][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[e >> 1] = fmaxf(m[e >> 1], 16 * kt + col_of(lane, j, e) < S ? s[j][e] : -INFINITY);
  }
  m[0] = attn::quad_max(m[0]);
  m[1] = attn::quad_max(m[1]);
  float ls[2] = {0.0f, 0.0f};
  for (int kt = 0; kt < nt; ++kt) {
    float s[2][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = expf(__fsub_rn(s[j][e], m[e >> 1]));
        ls[e >> 1] = __fadd_rn(ls[e >> 1], 16 * kt + col_of(lane, j, e) < S ? ev : 0.0f);
      }
  }
  const float l[2] = {attn::quad_sum(ls[0]), attn::quad_sum(ls[1])};
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  float o[wide::kOut / 8][4];
  wide::zero(o);
  for (int kt = 0; kt < nt; ++kt) {
    float s[2][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = expf(__fsub_rn(s[j][e], m[e >> 1]));
        s[j][e] = attn::div_rn(16 * kt + col_of(lane, j, e) < S ? ev : 0.0f, l[e >> 1],
                               rl[e >> 1]);
      }
    uint32_t pa[4];
    attn::as_a(s, pa);
    wide::times(pa, v, 16 * kt, lane, o);
  }
  wide::store_rows(o, out + (n * S + q0) * H * D + static_cast<int64_t>(h) * D + c0,
                   static_cast<int64_t>(H) * D, r0, qrows, min(wide::kOut, D - c0), lane);
}

int launch_wide(const void* qkv, int n, int s, int h, int d, float scale, void* out,
                cudaStream_t st) {
  const int64_t grid = static_cast<int64_t>(n) * h * ((s + wide::kRows - 1) / wide::kRows) *
                       ((d + wide::kOut - 1) / wide::kOut);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // no shared memory: the carveout goes to L1, which the fragment loads use
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      attn_fwd_wide, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxL1)));
  if (rc != 0) return rc;
  attn_fwd_wide<<<static_cast<unsigned>(grid), wide::kWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), n, s, h, d, scale,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const void* qkv, int n, int s, int h, int d, float scale, void* out,
           cudaStream_t st) {
  const size_t bytes = 4 * tile_bytes(DP);
  const int rc = static_cast<int>(attn::prepare(attn_fwd_tiled<DP>, bytes));
  if (rc != 0) return rc;
  const int64_t grid = static_cast<int64_t>(n) * h * ((s + kRows - 1) / kRows);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  attn_fwd_tiled<DP><<<static_cast<unsigned>(grid), kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), n, s, h, d, scale, vec,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int info(int* out) {
  return attn::info(attn_fwd_tiled<DP>, kThreads, 4 * tile_bytes(DP), out);
}

}  // namespace

// qkv: (n, s, 3, h, d) bf16 (2-byte aligned); out: (n, s, h * d) bf16;
// d >= 1 (past kMaxD the wide kernel), s >= 1
int attn_tiled_forward(const void* qkv, int n, int s, int h, int d, float scale, void* out,
                       cudaStream_t st) {
  if (n < 0 || s < 1 || h < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (d > tiled::kMaxD) return launch_wide(qkv, n, s, h, d, scale, out, st);
  switch (tiled::pad16(d)) {
    case 16: return launch<16>(qkv, n, s, h, d, scale, out, st);
    case 32: return launch<32>(qkv, n, s, h, d, scale, out, st);
    case 48: return launch<48>(qkv, n, s, h, d, scale, out, st);
    case 64: return launch<64>(qkv, n, s, h, d, scale, out, st);
    case 80: return launch<80>(qkv, n, s, h, d, scale, out, st);
    case 96: return launch<96>(qkv, n, s, h, d, scale, out, st);
    case 112: return launch<112>(qkv, n, s, h, d, scale, out, st);
    default: return launch<128>(qkv, n, s, h, d, scale, out, st);
  }
}

int attn_tiled_forward_info(int d, int* out) {
  if (d > tiled::kMaxD) return attn::info(attn_fwd_wide, wide::kWarps * 32, 0, out);
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
