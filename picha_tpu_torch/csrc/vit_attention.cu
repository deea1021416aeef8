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
// peak. Past the bytes, the exact softmax costs most: an expf and a
// division for each of 59 M scores, and a head's 196 x 208 f32 scores
// (163 KB) held at once. The design:
//   - both products on the tensor cores: mma.sync.m16n8k16, bf16 operands,
//     f32 accumulators, fragments by ldmatrix (vit_attention_mma.cuh).
//     mma.sync, not wgmma: a warp's own 16 query rows keep their softmax
//     in the warp's registers, and the scores come back as the A operand
//     of p . v without leaving them;
//   - persistent blocks, one a multiprocessor, each walking (image, head)
//     items: q, k and v of the next head (S x D bf16 each, 3 x 26 KB at
//     S = 196) stream into shared memory with 16-byte cp.async while the
//     current one is computed (two buffers where they fit in 227 KB),
//     read strided straight out of qkv, chunks swizzled so that ldmatrix
//     meets no bank conflict;
//   - 8 warps of 255 registers, a warp taking 16 query rows at a time and
//     keeping their scores for every key in registers (MAXT key tiles, 8
//     floats a tile), so q . k^T and the expf run once: the exact row max
//     over all S keys, l = the f32 sum of expf(s - max), p = bf16(e / l)
//     with the correctly rounded quotient (attn::div_rn), repacked tile by
//     tile from the scores' accumulator layout as the A operand of p . v.
//     No online (flash) rescale: the reference's p is bf16(e / l) with the
//     final l. More warps would get 128 registers and spill the scores;
//   - the tile loops are unrolled and branch-free: a key tile past the last
//     is clamped to it and its scores masked, so that the compiler overlaps
//     one tile's ldmatrix and products with the next one's (a branch per
//     tile left the tensor cores at a fifth of their rate);
//   - the reference's rounding points: the f32 dot of bf16 q . k, then
//     `* scale` in f32 (not folded into q), max-subtract, expf, the
//     division, p rounded to bf16, the f32 sum of bf16 p . bf16 v, o
//     rounded to bf16. Only the summation orders differ from the plain
//     version (picha_tpu_torch/ops/attention.py::attention_plain). Each
//     16-deep step of q . k is added with round-to-nearest, as the tensor
//     cores truncate when they add into an accumulator: without it p
//     rounded to another bf16 value than the plain version's often enough
//     to put the MoE step's most cancelling gradient leaf (a router's)
//     twice as far from the plain path's as with the earlier FP32 kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vit_attention_mma.cuh"
#include "vit_attention_tiled.cuh"

namespace {

using attn::col_of;

constexpr int kWarps = 8;

inline int64_t head_bytes(int s, int d) {
  return static_cast<int64_t>(3) * ((s + 15) / 16 * 16) * d * 2;
}

// one (image, head) out of its staged tiles at qs (q, then k, then v);
// MAXT >= the key tiles
template <int D, int MAXT>
__device__ __forceinline__ void head(uint32_t qs, int S, float scale, __nv_bfloat16* o_base,
                                     int64_t o_stride) {
  const int SP = (S + 15) / 16 * 16, nt = SP / 16;
  const uint32_t ks = qs + SP * D * 2, vs = ks + SP * D * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int qt = warp; qt < nt; qt += warps) {
    // q . k^T for every key tile, depth step by depth step (one q fragment
    // live at a time); each 16-deep step from a zero accumulator, the steps
    // added with round-to-nearest (the tensor cores truncate as they add
    // into an accumulator)
    float s[MAXT][2][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      attn::load_a<D>(qs, 16 * qt, 16 * kk, lane, qa);
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt) {
        uint32_t b[4];
        attn::load_b_nk<D>(ks, 16 * (kt < nt ? kt : nt - 1), 16 * kk, lane, b);
        attn::mma_step_rn(s[kt][0], qa, b[0], b[1], kk == 0);
        attn::mma_step_rn(s[kt][1], qa, b[2], b[3], kk == 0);
      }
    }
    // `* scale`, then the exact max over all S keys of each row (rows g
    // and g + 8 of the tile)
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[kt][j][e] = __fmul_rn(s[kt][j][e], scale);
          m[e >> 1] = fmaxf(m[e >> 1], 16 * kt + col_of(lane, j, e) < S ? s[kt][j][e] : -INFINITY);
        }
    m[0] = attn::quad_max(m[0]);
    m[1] = attn::quad_max(m[1]);

    // e = expf(s - max) (0 past S) in place, l = their f32 sum
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ev = expf(__fsub_rn(s[kt][j][e], m[e >> 1]));
          s[kt][j][e] = 16 * kt + col_of(lane, j, e) < S ? ev : 0.0f;
          ls[e >> 1] = __fadd_rn(ls[e >> 1], s[kt][j][e]);
        }
    const float l[2] = {attn::quad_sum(ls[0]), attn::quad_sum(ls[1])};
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

    // p = e / l, in place
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kt][j][e] = attn::div_rn(s[kt][j][e], l[e >> 1], rl[e >> 1]);
    // o = p . v, p rounded to bf16 and packed tile by tile as the A operand
    float o[D / 8][4];
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt) {
      uint32_t pa[4];
      attn::as_a(s[kt], pa);
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        uint32_t b[4];
        attn::load_b_kn<D>(vs, 16 * (kt < nt ? kt : nt - 1), 16 * t, lane, b);
        attn::mma(o[2 * t], pa, b[0], b[1]);
        attn::mma(o[2 * t + 1], pa, b[2], b[3]);
      }
    }

    // o rounded to bf16, rows 16 qt + g and + 8, columns 8 t + 2c
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * qt + (lane >> 2) + 8 * half;
      if (row < S) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(o_base + row * o_stride + 2 * (lane & 3));
#pragma unroll
        for (int t = 0; t < D / 8; ++t)
          dst[4 * t] = attn::pack_bf2(o[t][2 * half], o[t][2 * half + 1]);
      }
    }
  }
}

// a persistent block: items (image, head) blockIdx.x, + gridDim.x, ...;
// `two`: the next item is staged into the other buffer while this one runs
template <int D, int MAXT>
__global__ void __launch_bounds__(kWarps * 32, 1)
    vit_attention(const __nv_bfloat16* __restrict__ qkv, int N, int S, int H, float scale,
                  int two, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int SP = (S + 15) / 16 * 16;
  const uint32_t buf0 = attn::smem_addr(smem), tile = SP * D * 2;
  const int64_t tok = static_cast<int64_t>(3) * H * D;   // qkv elements per token
  const int64_t items = static_cast<int64_t>(N) * H;
  auto stage = [&](int64_t item, uint32_t buf) {
    const int64_t n = item / H, h = item - n * H;
    const __nv_bfloat16* base = qkv + n * S * tok + h * D;
    attn::stage<D>(buf, base, tok, S, SP);
    attn::stage<D>(buf + tile, base + H * D, tok, S, SP);
    attn::stage<D>(buf + 2 * tile, base + 2 * H * D, tok, S, SP);
  };
  int64_t item = blockIdx.x;
  if (item < items) stage(item, buf0);
  attn::commit();
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const uint32_t cur = buf0 + (two && (it & 1) ? 3 * tile : 0);
    const int64_t next = item + gridDim.x;
    if (two) {
      if (next < items) stage(next, buf0 + (it & 1 ? 0 : 3 * tile));
      attn::commit();
      attn::wait_all_but_newest();
    } else {
      attn::wait_all();
    }
    __syncthreads();
    const int64_t n = item / H, h = item - n * H;
    head<D, MAXT>(cur, S, scale, out + n * S * H * D + h * D, static_cast<int64_t>(H) * D);
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
  void (*kernel)(const __nv_bfloat16*, int, int, int, float, int, __nv_bfloat16*);
  int threads;
  int two;
  size_t bytes;
};

template <int D>
Plan plan(int s) {
  const int nt = (s + 15) / 16;
  Plan p;
  p.kernel = nt <= 13 ? vit_attention<D, 13> : vit_attention<D, 16>;
  p.threads = 32 * (nt < kWarps ? nt : kWarps);
  const int64_t one = head_bytes(s, D);
  p.two = 2 * one <= static_cast<int64_t>(attn::kSmemMax);
  p.bytes = static_cast<size_t>(p.two ? 2 * one : one);
  return p;
}

template <int D>
int launch(const void* qkv, int n, int s, int h, float scale, void* out, cudaStream_t st) {
  const Plan p = plan<D>(s);
  cudaError_t rc = attn::prepare(p.kernel, p.bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int grid = 0;
  const int g = attn::grid_of(p.kernel, p.threads, p.bytes, static_cast<int64_t>(n) * h, &grid);
  if (g != 0) return g;
  p.kernel<<<grid, p.threads, p.bytes, st>>>(static_cast<const __nv_bfloat16*>(qkv), n, s, h,
                                            scale, p.two, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int info(int s, int* out) {
  const Plan p = plan<D>(s);
  return attn::info(p.kernel, p.threads, p.bytes, out);
}

}  // namespace

// whether (s, d) takes the tuned kernel (else the tiled one,
// vit_attention_tiled.cu)
static bool tuned_shape(int s, int d) {
  return s >= 1 && s <= attn::kMaxSeq && (d == 32 || d == 64 || d == 128);
}

// qkv: (n, s, 3, h, d) bf16, 16-byte aligned; out: (n, s, h * d) bf16;
// d >= 1, s >= 1. The tuned kernel takes d in {32, 64, 128} and s
// <= 256, the tiled one every other shape (and every shape when
// `force_tiled` is 1). Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// neither takes).
extern "C" int picha_vit_attention(const void* qkv, int n, int s, int h, int d, float scale,
                                   int force_tiled, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (force_tiled || !tuned_shape(s, d)) return attn_tiled_forward(qkv, n, s, h, d, scale, out, st);
  if (!attn::takes(n, s, h)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  switch (d) {
    case 32: return launch<32>(qkv, n, s, h, scale, out, st);
    case 64: return launch<64>(qkv, n, s, h, scale, out, st);
    case 128: return launch<128>(qkv, n, s, h, scale, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K18's build at s tokens of head width d (the tiled one when `force_tiled` is 1
// or the shape is past the tuned one): out[0..4] = registers a thread,
// local (spill) bytes a thread, dynamic shared bytes, threads and resident
// blocks a multiprocessor. Launches nothing.
extern "C" int picha_vit_attention_info(int s, int d, int force_tiled, int* out) {
  if (s < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (force_tiled || !tuned_shape(s, d)) return attn_tiled_forward_info(d, out);
  switch (d) {
    case 32: return info<32>(s, out);
    case 64: return info<64>(s, out);
    case 128: return info<128>(s, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
