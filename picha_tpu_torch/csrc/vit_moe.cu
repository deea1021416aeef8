// K19 and K20: the top-1 switch routing of the ViT's MoE blocks around the
// expert products.
//
// Replaces: picha_tpu/models/vit.py::_switch_moe (:194-230), which XLA
// lowers to a softmax, an argmax, a cumsum over a (t, E) one-hot, a
// scatter-add into the (E + 1, cap, d) expert buffers (K19, :211-224) and
// a gather times the gate (K20, :228-230). Each runs once per MoE block.
//
// What bounds them on an H100: memory traffic. At the forward's shape
// (t = 256 x 196 = 50,176 tokens, E = 4, d = 384, cap = 18,816) K19 reads
// 0.8 MB of logits and 38.5 MB of rows and writes the 57.8 MB expert
// buffer (kept rows and zero rows), ~0.03 ms at HBM peak; K20 reads the
// kept rows and writes 38.5 MB, ~0.02 ms. The design:
//   K19, two launches over blocks of 256 tokens (one thread a token):
//   (a) moe_route: per token the softmax (max-subtract, expf, the sum in
//       expert order, a true division), the first maximum of the gates,
//       and per block the count of each expert's tokens (warp ballots);
//   (b) moe_dispatch: the slot of a token is its rank among the tokens of
//       its expert in token order, as cumsum(one_hot) gives it: the counts
//       of the earlier blocks (a scan over the block table), plus the
//       earlier warps' ballots in the block, plus the lanes below in its
//       warp's ballot. No atomics: their order would change from run to
//       run, and with it which tokens are dropped past capacity. Kept rows
//       are copied into the buffer one warp a row in 16-byte pieces (a -0
//       written as +0, as the reference's add into zeros leaves it); the
//       rows past each expert's count are zeroed by all blocks together,
//       so every byte of the buffer is written once.
//   K20, moe_combine: one thread per 16 bytes of output: the token's row of
//   the expert output times the gate rounded to bf16, each product rounded
//   once to bf16 (the product of two bf16 values is exact in f32); a
//   dropped token gives 0.
//
// Past the tuned envelope (more than 64 experts, or a width that is not a
// multiple of 8) a second set of kernels, chosen by shape, computes the
// same slots, still without atomics: moe_route_any, one thread a token,
// loops the router row over the experts for the softmax and the first
// maximum, ranks each token among the earlier tokens of its block with the
// same expert (a loop over the block's experts in shared memory) and
// writes each expert's count in the block from the block's last token of
// that expert (the table zeroed first); moe_scan_any, one thread an
// expert, turns the block table into each block's count of earlier tokens
// and the expert's total; moe_dispatch_any takes the slot as that count
// plus the rank and copies kept rows a warp a row, in 16-byte pieces where
// the width is a multiple of 8 and one bf16 value at a time otherwise, and
// zeroes the rows past each expert's count a warp a row. K20's
// moe_combine_any takes one bf16 value a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTok = 256;          // tokens per block
constexpr int kWarps = kTok / 32;
constexpr int kMaxE = 64;

__global__ void __launch_bounds__(kTok) moe_route(const float* __restrict__ logits, int64_t t,
                                                  int E, int* __restrict__ expert,
                                                  float* __restrict__ gate,
                                                  int* __restrict__ counts) {
  __shared__ int wcount[kWarps][kMaxE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTok + threadIdx.x;
  int best_e = -1;
  if (i < t) {
    const float* l = logits + i * E;
    float m = l[0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, l[e]);
    float sum = 0.0f;
    for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, expf(__fsub_rn(l[e], m)));
    float best = 0.0f;
    for (int e = 0; e < E; ++e) {
      const float g = __fdiv_rn(expf(__fsub_rn(l[e], m)), sum);
      if (best_e < 0 || g > best) {   // strictly greater: the first maximum wins
        best = g;
        best_e = e;
      }
    }
    expert[i] = best_e;
    gate[i] = best;
  }
  for (int e = 0; e < E; ++e) {
    const unsigned b = __ballot_sync(0xffffffffu, best_e == e);
    if (lane == 0) wcount[warp][e] = __popc(b);
  }
  __syncthreads();
  if (threadIdx.x < E) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += wcount[w][threadIdx.x];
    counts[static_cast<int64_t>(blockIdx.x) * E + threadIdx.x] = c;
  }
}

__device__ __forceinline__ uint32_t plus_zero(uint32_t w) {
  if ((w & 0xffffu) == 0x8000u) w &= 0xffff0000u;
  if ((w >> 16) == 0x8000u) w &= 0x0000ffffu;
  return w;
}

__global__ void __launch_bounds__(kTok) moe_dispatch(
    const uint4* __restrict__ y, int64_t t, int E, int chunks, int cap,
    const int* __restrict__ counts, int nblk, int* __restrict__ eidx, int* __restrict__ sidx,
    float* __restrict__ gk, uint4* __restrict__ xe) {
  __shared__ int before[kMaxE], total[kMaxE];
  __shared__ int wcount[kWarps][kMaxE];
  __shared__ int row_e[kTok], row_s[kTok];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < E) {
    int pre = 0, tot = 0;
    for (int b = 0; b < nblk; ++b) {
      const int c = counts[static_cast<int64_t>(b) * E + threadIdx.x];
      if (b < static_cast<int>(blockIdx.x)) pre += c;
      tot += c;
    }
    before[threadIdx.x] = pre;
    total[threadIdx.x] = tot;
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTok + threadIdx.x;
  const int e = i < t ? eidx[i] : -1;   // moe_route's expert
  int rank = 0;
  for (int ee = 0; ee < E; ++ee) {
    const unsigned b = __ballot_sync(0xffffffffu, e == ee);
    if (e == ee) rank = __popc(b & ((1u << lane) - 1u));
    if (lane == 0) wcount[warp][ee] = __popc(b);
  }
  __syncthreads();
  row_e[threadIdx.x] = -1;
  if (e >= 0) {
    int slot = before[e] + rank;
    for (int w = 0; w < warp; ++w) slot += wcount[w][e];
    const bool keep = slot < cap;
    eidx[i] = keep ? e : E;
    sidx[i] = keep ? slot : 0;
    gk[i] = keep ? gk[i] : 0.0f;
    if (keep) {
      row_e[threadIdx.x] = e;
      row_s[threadIdx.x] = slot;
    }
  }
  __syncthreads();
  // kept rows: one warp a row
  for (int r = warp; r < kTok; r += kWarps) {
    const int re = row_e[r];
    if (re < 0) continue;
    const uint4* src = y + (static_cast<int64_t>(blockIdx.x) * kTok + r) * chunks;
    uint4* dst = xe + (static_cast<int64_t>(re) * cap + row_s[r]) * chunks;
    for (int c = lane; c < chunks; c += 32) {
      uint4 v = src[c];
      v.x = plus_zero(v.x);
      v.y = plus_zero(v.y);
      v.z = plus_zero(v.z);
      v.w = plus_zero(v.w);
      dst[c] = v;
    }
  }
  // the rows past each expert's count, zeroed by all blocks together
  int64_t tail = 0;
  for (int ee = 0; ee < E; ++ee) tail += cap - min(total[ee], cap);
  tail *= chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTok;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kTok + threadIdx.x; k < tail; k += stride) {
    int64_t off = k / chunks;
    const int c = static_cast<int>(k - off * chunks);
    int ee = 0;
    for (; ee < E; ++ee) {
      const int64_t rows = cap - min(total[ee], cap);
      if (off < rows) break;
      off -= rows;
    }
    xe[(static_cast<int64_t>(ee) * cap + min(total[ee], cap) + off) * chunks + c] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint32_t scale_bf2(uint32_t w, float g) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(__fmul_rn(f.x, g), __fmul_rn(f.y, g));
  return *reinterpret_cast<uint32_t*>(&h);
}

__global__ void __launch_bounds__(256) moe_combine(const uint4* __restrict__ ye,
                                                   const int* __restrict__ eidx,
                                                   const int* __restrict__ sidx,
                                                   const float* __restrict__ gk, int64_t t,
                                                   int E, int cap, int chunks,
                                                   uint4* __restrict__ out) {
  const int64_t total = t * chunks;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < total;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = k / chunks;
    const int c = static_cast<int>(k - i * chunks);
    const int e = eidx[i], s = sidx[i];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (e >= 0 && e < E && s >= 0 && s < cap) {
      const float g = __bfloat162float(__float2bfloat16_rn(gk[i]));
      v = ye[(static_cast<int64_t>(e) * cap + s) * chunks + c];
      v.x = scale_bf2(v.x, g);
      v.y = scale_bf2(v.y, g);
      v.z = scale_bf2(v.z, g);
      v.w = scale_bf2(v.w, g);
    }
    out[k] = v;
  }
}

// -- the kernels past the tuned envelope ---------------------------------

__device__ __forceinline__ uint16_t plus_zero16(uint16_t w) { return w == 0x8000u ? 0 : w; }

__device__ __forceinline__ uint4 plus_zero_chunk(uint4 v) {
  v.x = plus_zero(v.x);
  v.y = plus_zero(v.y);
  v.z = plus_zero(v.z);
  v.w = plus_zero(v.w);
  return v;
}

// any E: expert[i], gate[i] and the rank rank[i] of token i among its
// block's earlier tokens of the same expert; counts[b * E + e] = block b's
// tokens of expert e (the table zeroed before)
__global__ void __launch_bounds__(kTok) moe_route_any(const float* __restrict__ logits, int64_t t,
                                                      int E, int* __restrict__ expert,
                                                      float* __restrict__ gate,
                                                      int* __restrict__ rank,
                                                      int* __restrict__ counts) {
  __shared__ int row_e[kTok];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTok + threadIdx.x;
  int best_e = -1;
  if (i < t) {
    const float* l = logits + i * E;
    float m = l[0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, l[e]);
    float sum = 0.0f;
    for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, expf(__fsub_rn(l[e], m)));
    float best = 0.0f;
    for (int e = 0; e < E; ++e) {
      const float g = __fdiv_rn(expf(__fsub_rn(l[e], m)), sum);
      if (best_e < 0 || g > best) {   // strictly greater: the first maximum wins
        best = g;
        best_e = e;
      }
    }
    expert[i] = best_e;
    gate[i] = best;
  }
  row_e[threadIdx.x] = best_e;
  __syncthreads();
  if (best_e < 0) return;
  int r = 0;
  for (int j = 0; j < static_cast<int>(threadIdx.x); ++j) r += row_e[j] == best_e;
  rank[i] = r;
  bool last = true;
  for (int j = threadIdx.x + 1; j < kTok && last; ++j) last = row_e[j] != best_e;
  if (last) counts[static_cast<int64_t>(blockIdx.x) * E + best_e] = r + 1;
}

// one thread an expert: counts[b][e] -> the tokens of expert e in the
// blocks before b; counts[nblk][e] -> the expert's total
__global__ void __launch_bounds__(256) moe_scan_any(int* __restrict__ counts, int nblk, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int run = 0;
  for (int b = 0; b < nblk; ++b) {
    const int c = counts[static_cast<int64_t>(b) * E + e];
    counts[static_cast<int64_t>(b) * E + e] = run;
    run += c;
  }
  counts[static_cast<int64_t>(nblk) * E + e] = run;
}

// kVec: 16-byte pieces (d a multiple of 8), else one bf16 value a lane
template <bool kVec>
__global__ void __launch_bounds__(kTok) moe_dispatch_any(
    const void* __restrict__ y, int64_t t, int E, int d, int cap, const int* __restrict__ counts,
    int nblk, const int* __restrict__ rank, int* __restrict__ eidx, int* __restrict__ sidx,
    float* __restrict__ gk, void* __restrict__ xe) {
  __shared__ int row_e[kTok], row_s[kTok];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTok + threadIdx.x;
  row_e[threadIdx.x] = -1;
  if (i < t) {
    const int e = eidx[i];   // moe_route_any's expert
    const int slot = counts[static_cast<int64_t>(blockIdx.x) * E + e] + rank[i];
    const bool keep = slot < cap;
    eidx[i] = keep ? e : E;
    sidx[i] = keep ? slot : 0;
    gk[i] = keep ? gk[i] : 0.0f;
    if (keep) {
      row_e[threadIdx.x] = e;
      row_s[threadIdx.x] = slot;
    }
  }
  __syncthreads();
  const int n = kVec ? d / 8 : d;
  for (int r = warp; r < kTok; r += kWarps) {
    const int re = row_e[r];
    if (re < 0) continue;
    const int64_t src = (static_cast<int64_t>(blockIdx.x) * kTok + r) * n;
    const int64_t dst = (static_cast<int64_t>(re) * cap + row_s[r]) * n;
    for (int c = lane; c < n; c += 32) {
      if (kVec)
        static_cast<uint4*>(xe)[dst + c] = plus_zero_chunk(static_cast<const uint4*>(y)[src + c]);
      else
        static_cast<uint16_t*>(xe)[dst + c] = plus_zero16(static_cast<const uint16_t*>(y)[src + c]);
    }
  }
  // the rows past each expert's count: a warp a row, all blocks together
  const int* total = counts + static_cast<int64_t>(nblk) * E;
  const int64_t rows = static_cast<int64_t>(E) * cap;
  for (int64_t rr = static_cast<int64_t>(blockIdx.x) * kWarps + warp; rr < rows;
       rr += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int e = static_cast<int>(rr / cap), s = static_cast<int>(rr - static_cast<int64_t>(e) * cap);
    if (s < total[e]) continue;
    for (int c = lane; c < n; c += 32) {
      if (kVec)
        static_cast<uint4*>(xe)[rr * n + c] = make_uint4(0u, 0u, 0u, 0u);
      else
        static_cast<uint16_t*>(xe)[rr * n + c] = 0;
    }
  }
}

// K20 past the tuned envelope: one bf16 value a thread
__global__ void __launch_bounds__(256) moe_combine_any(const __nv_bfloat16* __restrict__ ye,
                                                       const int* __restrict__ eidx,
                                                       const int* __restrict__ sidx,
                                                       const float* __restrict__ gk, int64_t t,
                                                       int E, int cap, int d,
                                                       __nv_bfloat16* __restrict__ out) {
  const int64_t total = t * d;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < total;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = k / d;
    const int c = static_cast<int>(k - i * d);
    const int e = eidx[i], s = sidx[i];
    float v = 0.0f;
    if (e >= 0 && e < E && s >= 0 && s < cap) {
      const float g = __bfloat162float(__float2bfloat16_rn(gk[i]));
      v = __fmul_rn(__bfloat162float(ye[(static_cast<int64_t>(e) * cap + s) * d + c]), g);
    }
    out[k] = __float2bfloat16_rn(v);
  }
}

int grid_for(int64_t items, int threads) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (items + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

// logits: (t, E) float32; y: (t, d) bf16 (16-byte aligned rows where d is
// a multiple of 8); counts: (nblk + 1, E) int32 scratch, nblk = ceil(t /
// 256); rank: (t,) int32 scratch (past the tuned envelope); eidx, sidx:
// (t,) int32 and gk: (t,) float32 out (expert and slot, E and 0 when
// dropped; gate * keep); xe: (E, cap, d) bf16 out. The tuned kernels take
// E <= 64 and d a multiple of 8, the others any E >= 1 and d >= 1.
// Returns cudaGetLastError().
extern "C" int picha_moe_route_dispatch(const void* logits, const void* y, int64_t t, int E,
                                        int d, int cap, void* counts, void* rank, void* eidx,
                                        void* sidx, void* gk, void* xe, void* stream) {
  if (t < 0 || E < 1 || d < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nblk = (t + kTok - 1) / kTok;
  if (nblk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t == 0) {   // no token: the buffer is all zero rows
    const cudaError_t rc =
        cudaMemsetAsync(xe, 0, static_cast<size_t>(E) * cap * d * 2, st);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  if (E > kMaxE || (d & 7)) {
    if (rank == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t mrc =
        cudaMemsetAsync(counts, 0, static_cast<size_t>(nblk) * E * sizeof(int), st);
    if (mrc != cudaSuccess) return static_cast<int>(mrc);
    moe_route_any<<<static_cast<unsigned>(nblk), kTok, 0, st>>>(
        static_cast<const float*>(logits), t, E, static_cast<int*>(eidx),
        static_cast<float*>(gk), static_cast<int*>(rank), static_cast<int*>(counts));
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    moe_scan_any<<<(E + 255) / 256, 256, 0, st>>>(static_cast<int*>(counts),
                                                  static_cast<int>(nblk), E);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    auto kernel = (d & 7) ? moe_dispatch_any<false> : moe_dispatch_any<true>;
    kernel<<<static_cast<unsigned>(nblk), kTok, 0, st>>>(
        y, t, E, d, cap, static_cast<const int*>(counts), static_cast<int>(nblk),
        static_cast<const int*>(rank), static_cast<int*>(eidx), static_cast<int*>(sidx),
        static_cast<float*>(gk), xe);
    return static_cast<int>(cudaGetLastError());
  }
  moe_route<<<static_cast<unsigned>(nblk), kTok, 0, st>>>(
      static_cast<const float*>(logits), t, E, static_cast<int*>(eidx),
      static_cast<float*>(gk), static_cast<int*>(counts));
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  moe_dispatch<<<static_cast<unsigned>(nblk), kTok, 0, st>>>(
      static_cast<const uint4*>(y), t, E, d / 8, cap, static_cast<const int*>(counts),
      static_cast<int>(nblk), static_cast<int*>(eidx), static_cast<int*>(sidx),
      static_cast<float*>(gk), static_cast<uint4*>(xe));
  return static_cast<int>(cudaGetLastError());
}

// ye: (E, cap, d) bf16 (16-byte aligned where d is a multiple of 8); eidx,
// sidx: (t,) int32; gk: (t,) float32; out: (t, d) bf16. Returns
// cudaGetLastError().
extern "C" int picha_moe_combine(const void* ye, const void* eidx, const void* sidx,
                                 const void* gk, int64_t t, int E, int cap, int d, void* out,
                                 void* stream) {
  if (t < 0 || E < 1 || cap < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return static_cast<int>(cudaGetLastError());
  if (d & 7) {
    moe_combine_any<<<grid_for(t * d, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(ye), static_cast<const int*>(eidx),
        static_cast<const int*>(sidx), static_cast<const float*>(gk), t, E, cap, d,
        static_cast<__nv_bfloat16*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = d / 8;
  moe_combine<<<grid_for(t * chunks, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ye), static_cast<const int*>(eidx),
      static_cast<const int*>(sidx), static_cast<const float*>(gk), t, E, cap, chunks,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
