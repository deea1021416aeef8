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
// kept rows and writes 38.5 MB, ~0.02 ms. The designs:
//   K19, moe_route_dispatch_tiles: one launch (after a memset of its
//   ticket and descriptors) of a persistent grid, planned from the card's
//   occupancy once a device, that takes tiles of kTileTok tokens in token
//   order by an atomic ticket. A tile first puts its rows in flight
//   (kPrefetch 16-byte words a thread: two thirds of a tile of 64 rows of
//   384; 12 words in 2 blocks an SM were no faster, PERF.md §6), then
//   routes its tokens, one thread a token: the softmax
//   (max-subtract, expf, the sum in expert order, a true division) and
//   the first maximum of the gates. Its per-expert counts come from
//   __match_any_sync a warp; the tile publishes them and takes its
//   exclusive prefix by a decoupled look-back over the earlier tiles (a
//   warp an expert, 32 descriptors a step: aggregates published at once,
//   inclusive prefixes after the look-back). A token's slot is that
//   prefix plus its rank in the tile: its rank among the tokens of its
//   expert in token order, as cumsum(one_hot) gives it. The ticket only
//   picks which CTA takes a tile; no slot depends on an atomic, so which
//   tokens drop past capacity never changes from run to run. Kept rows
//   are stored from the registers that hold them (a -0 written as +0, as
//   the reference's add into zeros leaves it). Once a CTA finds no tile
//   left, every tile has been taken by a running CTA, so it waits for
//   the last tile's inclusive prefixes (each expert's total) and zeroes
//   its share of the rows past each expert's count: E contiguous ranges
//   of 16-byte stores. Every byte of the buffer is written once.
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

#include <map>
#include <mutex>

namespace {

constexpr int kTok = 256;          // tokens per block past the tuned envelope
constexpr int kWarps = kTok / 32;
constexpr int kMaxE = 64;
constexpr int kThreads = 256;      // the tuned K19's threads a CTA
constexpr int kTileTok = 64;       // its tokens a tile, one a thread of the first warps
constexpr int kTileWarps = kTileTok / 32;
constexpr int kPrefetch = 8;       // 16-byte words of rows a thread holds
constexpr unsigned long long kAggregate = 1ull << 62, kInclusive = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ uint32_t plus_zero(uint32_t w) {
  if ((w & 0xffffu) == 0x8000u) w &= 0xffff0000u;
  if ((w >> 16) == 0x8000u) w &= 0x0000ffffu;
  return w;
}

__device__ __forceinline__ uint4 plus_zero_chunk(uint4 v) {
  v.x = plus_zero(v.x);
  v.y = plus_zero(v.y);
  v.z = plus_zero(v.z);
  v.w = plus_zero(v.w);
  return v;
}

// the softmax of one router row, and its first maximum: (expert, gate)
__device__ __forceinline__ int route_row(const float* l, int E, float* gate) {
  float m = l[0];
  for (int e = 1; e < E; ++e) m = fmaxf(m, l[e]);
  float sum = 0.0f;
  for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, expf(__fsub_rn(l[e], m)));
  float best = 0.0f;
  int best_e = -1;
  for (int e = 0; e < E; ++e) {
    const float g = __fdiv_rn(expf(__fsub_rn(l[e], m)), sum);
    if (best_e < 0 || g > best) {   // strictly greater: the first maximum wins
      best = g;
      best_e = e;
    }
  }
  *gate = best;
  return best_e;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The exclusive prefix of expert e's count over the tiles before `tile`,
// by one warp: publishes the tile's aggregate `agg`, then walks back 32
// descriptors a step (lane l reads tile p - l, waiting until it is
// published; before tile 0 an inclusive 0) and adds the aggregates up to
// the nearest inclusive prefix; then publishes the tile's inclusive one.
__device__ int look_back(unsigned long long* desc, int tile, int E, int e, int agg, int lane) {
  unsigned long long* mine = desc + static_cast<int64_t>(tile) * E + e;
  if (tile == 0) {
    if (lane == 0) st_release(mine, kInclusive | static_cast<unsigned long long>(agg));
    return 0;
  }
  if (lane == 0) st_release(mine, kAggregate | static_cast<unsigned long long>(agg));
  int excl = 0;
  for (int p = tile - 1;; p -= 32) {
    const int q = p - lane;
    unsigned long long d = kInclusive;
    if (q >= 0) {
      do {
        d = ld_acquire(desc + static_cast<int64_t>(q) * E + e);
      } while (d == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (d & kInclusive) != 0);
    const int last = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= last ? static_cast<int>(d & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (incl) break;
  }
  if (lane == 0) st_release(mine, kInclusive | static_cast<unsigned long long>(excl + agg));
  return excl;
}

// A thread's run of the tile's row words k = tid, tid + kThreads, ...:
// (row, c) of word k, stepped without a division.
struct WordWalk {
  int row, c, q, r, chunks;
  __device__ WordWalk(int tid, int chunks_)
      : row(tid / chunks_), c(tid % chunks_), q(kThreads / chunks_), r(kThreads % chunks_),
        chunks(chunks_) {}
  __device__ __forceinline__ void next() {
    row += q;
    c += r;
    if (c >= chunks) {
      c -= chunks;
      ++row;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 3) moe_route_dispatch_tiles(
    const float* __restrict__ logits, const uint4* __restrict__ y, int t, int E, int chunks,
    int cap, int ntiles, unsigned long long* __restrict__ desc, int* __restrict__ ticket,
    int* __restrict__ eidx, int* __restrict__ sidx, float* __restrict__ gk,
    uint4* __restrict__ xe) {
  __shared__ int tile_s;
  __shared__ int wcount[kTileWarps][kMaxE];
  __shared__ int excl_s[kMaxE];
  __shared__ long long dst_s[kTileTok];   // a kept row's first word in xe, else -1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (;;) {
    if (tid == 0) tile_s = atomicAdd(ticket, 1);
    for (int i = tid; i < kTileWarps * kMaxE; i += kThreads) (&wcount[0][0])[i] = 0;
    __syncthreads();
    const int tile = tile_s;
    if (tile >= ntiles) break;
    const int row0 = tile * kTileTok;
    const int nrows = min(kTileTok, t - row0);
    const uint4* src = y + static_cast<int64_t>(row0) * chunks;
    // the tile's first words in flight before its slots are known
    uint4 v[kPrefetch];
    {
      WordWalk w(tid, chunks);
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        if (w.row < nrows) v[j] = __ldcs(src + static_cast<int64_t>(w.row) * chunks + w.c);
        w.next();
      }
    }
    // route: token row0 + tid in the first kTileWarps warps
    int best_e = -1, rank = 0;
    float gate = 0.0f;
    if (tid < nrows) best_e = route_row(logits + static_cast<int64_t>(row0 + tid) * E, E, &gate);
    if (warp < kTileWarps) {
      const unsigned grp = __match_any_sync(0xffffffffu, best_e);
      rank = __popc(grp & ((1u << lane) - 1u));
      if (best_e >= 0 && rank == 0) wcount[warp][best_e] = __popc(grp);
    }
    __syncthreads();
    // the tile's count of each expert, and its exclusive prefix: a warp an expert
    for (int e = warp; e < E; e += kThreads / 32) {
      int agg = 0;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) agg += wcount[w][e];
      const int excl = look_back(desc, tile, E, e, agg, lane);
      if (lane == 0) excl_s[e] = excl;
    }
    __syncthreads();
    if (best_e >= 0) {
      int slot = excl_s[best_e] + rank;
      for (int w = 0; w < warp; ++w) slot += wcount[w][best_e];
      const bool keep = slot < cap;
      const int64_t i = row0 + tid;
      eidx[i] = keep ? best_e : E;
      sidx[i] = keep ? slot : 0;
      gk[i] = keep ? gate : 0.0f;
      dst_s[tid] = keep ? (static_cast<int64_t>(best_e) * cap + slot) * chunks : -1;
    }
    __syncthreads();
    // the kept rows: the words in flight, then the rest kPrefetch at a time
    WordWalk w(tid, chunks);
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      if (w.row < nrows && dst_s[w.row] >= 0) xe[dst_s[w.row] + w.c] = plus_zero_chunk(v[j]);
      w.next();
    }
    while (w.row < nrows) {
      WordWalk s = w;
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        if (w.row < nrows && dst_s[w.row] >= 0)
          v[j] = __ldcs(src + static_cast<int64_t>(w.row) * chunks + w.c);
        w.next();
      }
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        if (s.row < nrows && dst_s[s.row] >= 0) xe[dst_s[s.row] + s.c] = plus_zero_chunk(v[j]);
        s.next();
      }
    }
    __syncthreads();
  }
  // Every tile is taken by a running CTA: the last one's inclusive
  // prefixes (the experts' totals) come. Then the rows past each
  // expert's count, E contiguous ranges, shared by the whole grid.
  if (tid < E) {
    unsigned long long d;
    do {
      d = ld_acquire(desc + static_cast<int64_t>(ntiles - 1) * E + tid);
    } while (!(d & kInclusive));
    excl_s[tid] = min(static_cast<int>(d & kValue), cap);
  }
  __syncthreads();
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const int64_t gs = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int e = 0; e < E; ++e) {
    const int64_t b = (static_cast<int64_t>(e) + 1) * cap * chunks;
    for (int64_t k = (static_cast<int64_t>(e) * cap + excl_s[e]) * chunks + g; k < b; k += gs)
      xe[k] = make_uint4(0u, 0u, 0u, 0u);
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
    float best;
    best_e = route_row(logits + i * E, E, &best);
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

// moe_route_dispatch_tiles's blocks an SM and the card's SMs, asked of the
// card once a device
struct Card {
  int sms, occ;
};

int card_plan(Card* out) {
  static std::mutex mu;
  static std::map<int, Card> cards;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cards.find(dev);
  if (it == cards.end()) {
    Card c{0, 0};
    rc = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, moe_route_dispatch_tiles,
                                                         kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (c.occ < 1 || c.sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    it = cards.emplace(dev, c).first;
  }
  *out = it->second;
  return 0;
}

// the tuned K19's scratch: a ticket (16 bytes), then a descriptor a tile
// and expert
int64_t tiles_scratch(int64_t t, int E) {
  return 16 + (t + kTileTok - 1) / kTileTok * E * 8;
}

}  // namespace

// The tuned K19's build and plan: out[0..7] = registers, local bytes,
// static shared bytes, blocks an SM, SMs, tokens a tile, threads a CTA,
// 16-byte row words a thread keeps in flight. Returns a CUDA error code.
extern "C" int picha_moe_route_dispatch_info(int* out) {
  Card card;
  const int rc = card_plan(&card);
  if (rc != 0) return rc;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, moe_route_dispatch_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = card.occ;
  out[4] = card.sms;
  out[5] = kTileTok;
  out[6] = kThreads;
  out[7] = kPrefetch;
  return 0;
}

// logits: (t, E) float32; y: (t, d) bf16 (16-byte aligned rows where d is
// a multiple of 8); scratch: scratch_bytes of device memory, at least
// 16 + ceil(t / 64) * E * 8 (the tuned kernel's ticket and descriptors,
// zeroed here) or, past the tuned envelope, (ceil(t / 256) + 1) * E * 4
// (the block counts); rank: (t,) int32 scratch (past the tuned envelope);
// eidx, sidx: (t,) int32 and gk: (t,) float32 out (expert and slot, E and
// 0 when dropped; gate * keep); xe: (E, cap, d) bf16 out. The tuned
// kernel takes E <= 64, d a multiple of 8 and t < 2^31, the others any E
// >= 1 and d >= 1. Returns cudaGetLastError().
extern "C" int picha_moe_route_dispatch(const void* logits, const void* y, int64_t t, int E,
                                        int d, int cap, void* scratch, int64_t scratch_bytes,
                                        void* rank, void* eidx, void* sidx, void* gk, void* xe,
                                        void* stream) {
  if (t < 0 || E < 1 || d < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nblk = (t + kTok - 1) / kTok;
  if (nblk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t == 0) {   // no token: the buffer is all zero rows
    const cudaError_t rc =
        cudaMemsetAsync(xe, 0, static_cast<size_t>(E) * cap * d * 2, st);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  if (E > kMaxE || (d & 7) || t > 0x7fffffffLL) {
    if (rank == nullptr || scratch_bytes < (nblk + 1) * E * 4)
      return static_cast<int>(cudaErrorInvalidValue);
    int* counts = static_cast<int*>(scratch);
    const cudaError_t mrc =
        cudaMemsetAsync(counts, 0, static_cast<size_t>(nblk) * E * sizeof(int), st);
    if (mrc != cudaSuccess) return static_cast<int>(mrc);
    moe_route_any<<<static_cast<unsigned>(nblk), kTok, 0, st>>>(
        static_cast<const float*>(logits), t, E, static_cast<int*>(eidx),
        static_cast<float*>(gk), static_cast<int*>(rank), counts);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    moe_scan_any<<<(E + 255) / 256, 256, 0, st>>>(counts, static_cast<int>(nblk), E);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    auto kernel = (d & 7) ? moe_dispatch_any<false> : moe_dispatch_any<true>;
    kernel<<<static_cast<unsigned>(nblk), kTok, 0, st>>>(
        y, t, E, d, cap, counts, static_cast<int>(nblk), static_cast<const int*>(rank),
        static_cast<int*>(eidx), static_cast<int*>(sidx), static_cast<float*>(gk), xe);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t need = tiles_scratch(t, E);
  if (scratch_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  Card card;
  const int prc = card_plan(&card);
  if (prc != 0) return prc;
  const cudaError_t mrc = cudaMemsetAsync(scratch, 0, static_cast<size_t>(need), st);
  if (mrc != cudaSuccess) return static_cast<int>(mrc);
  const int ntiles = static_cast<int>((t + kTileTok - 1) / kTileTok);
  const int64_t most = static_cast<int64_t>(card.sms) * card.occ;
  const int grid = static_cast<int>(ntiles < most ? ntiles : most);
  moe_route_dispatch_tiles<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(logits), static_cast<const uint4*>(y), static_cast<int>(t), E,
      d / 8, cap, ntiles,
      reinterpret_cast<unsigned long long*>(static_cast<char*>(scratch) + 16),
      static_cast<int*>(scratch), static_cast<int*>(eidx), static_cast<int*>(sidx),
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
