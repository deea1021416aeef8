// K12: the PNG encode filters over a batch of images, with the per-row
// adaptive pick, writing one or more candidate streams in one launch.
//
// Replaces: picha_tpu/ops/png_filter_tpu.py::_build (:32-73), the device
// filter behind picha_tpu/pipeline/png_batch.py::encode_filtered, which
// takes the candidates (2, 1, -1) at :190. The encode direction predicts
// every byte from the ORIGINAL (unfiltered) neighbours, so each row is
// independent: a = the byte bpp to the left, b = the byte above, c = the
// byte above-left, each 0 outside the image (the first row's prev is
// zeros; a and c are 0 in the first bpp columns, and in every column of a
// row no wider than bpp). Residuals are (x - pred) & 0xFF for the five
// predictors none, sub (a), up (b), average ((a + b) >> 1) and Paeth (p =
// a + b - c; a when |p-a| <= |p-b| and |p-a| <= |p-c|, else b when |p-b|
// <= |p-c|, else c). Strategy 0..4 writes that filter's residuals;
// strategy -1 picks per row the filter with the least sum(min(v, 256 -
// v)) (the |int8| sum), the first minimum in type order 0..4. A launch
// writes a stream per requested strategy: stream j at out + j * stride.
//
// What bounds it on an H100: memory traffic, the rows read once and each
// stream's rows + 1 bytes written once (config 4's probe: 20.2 MB in,
// 60.6 MB out, 0.024 ms at 3.35 TB/s). The first design (a block of 256
// threads a row, byte loads, a switch a byte and filter, a shared-memory
// tree for the costs, a launch a stream) took 10x that on an H100 80GB
// HBM3 (700 W). The design:
//   - a block takes a band of 8 consecutive rows (across image
//     boundaries), a warp a row; the band's rows and the row above it are
//     staged in shared memory by 16-byte cp.async of the aligned words
//     that cover them, each row at its own byte shift; a row too wide for
//     the staging goes in column chunks (a halo of 16 bytes to the left),
//     the adaptive costs summed over the chunks. (A persistent grid
//     walking bands through a ring of 2 or 3 staged tiles ran 1.0-1.3x
//     slower: the adaptive rows' work varies with their pick.)
//   - a lane takes four bytes (one 32-bit word) at a time: x, a, b and c
//     are funnel-shifted out of two staged words; the residuals are SWAR
//     on the word with plain 32-bit operations (the byte SIMD intrinsics
//     other than __vabsdiffu4 / __vsadu4, which map to VABSDIFF4, compile
//     to long sequences on sm_90): borrow-free byte subtraction and
//     compares, a byte mask from each byte's top bit by PRMT; Paeth needs
//     no 9-bit |a + b - 2c|: with u = a - c and v = b - c of one sign it
//     picks a where |v| <= |u|, else b; of opposite signs a where 2|v| <=
//     |u|, b where 2|u| <= |v|, else c; the |int8| cost of a word is
//     __vsadu4 of its bytes' magnitudes;
//   - the fixed streams' count is compiled in (with an adaptive stream,
//     their filters are picked from the five residual words by masks,
//     with no branch); the pick reduces the five costs with
//     __reduce_add_sync (integers: exact in any order), the first minimum
//     in type order winning;
//   - a residual word goes to each stream's row at that row's alignment:
//     the word a lane stores is the funnel shift of its residual word and
//     the previous lane's (a shuffle; the word before a chunk recomputed),
//     so every store is an aligned 32-bit word and a warp's stores are one
//     contiguous run; only the bytes at a row's two ends (and its type
//     byte) are stored byte by byte;
//   - fixed streams are written in the pass that sums the costs; the
//     adaptive stream right after it, from the five residual words a word
//     that pass left in shared memory (chunked rows: computed again from a
//     second staging, chunk by chunk).
// The design is bound by its instructions a word, not by its bytes: built
// without its global loads, or without its stores, it ran within 6 % of
// its time (PERF.md section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBand = kWarps;        // rows a band: a warp a row
constexpr int kMaxStreams = 6;
constexpr int kHalo = 16;            // bytes staged left of a chunk
constexpr int kPad = 64;             // a slot's bytes past its chunk
constexpr int kTileBudget = (kBand + 1) * 1408 + 16;   // bytes staged at most
constexpr uint32_t kHi = 0x80808080u, kLo7 = 0x7f7f7f7fu;

struct Plan {
  int chunk;    // staged columns a chunk (a multiple of 128)
  int nchunks;
  int pitch;    // bytes a staged row slot
  int cache;    // offset of the residual cache in shared memory, 0 for none
  int smem;     // shared bytes: the staged rows, then the cache
  int words;    // output words a row spans at most, (rb + 2) / 4 + 1
};

// a launch's streams: the fixed ones (strategies 0..4: stream index and
// filter) and a bit a stream for the adaptive ones
struct Streams {
  int nfixed, adaptive;
  int fixed_stream[kMaxStreams], fixed_filter[kMaxStreams];
};

// (x - y) & 0xff a byte: the low 7 bits from a borrow-free subtraction,
// the top bit fixed up
__device__ __forceinline__ uint32_t sub_bytes(uint32_t x, uint32_t y) {
  return ((x | kHi) - (y & kLo7)) ^ ((x ^ ~y) & kHi);
}

// top bit of each byte: y >= x, unsigned (no borrow crosses a byte: each
// byte of (y | 0x80) - (x & 0x7f) is at least 1)
__device__ __forceinline__ uint32_t ge_top(uint32_t y, uint32_t x) {
  const uint32_t t = (y | kHi) - (x & kLo7);
  return ((y & ~x) | (~(x ^ y) & t)) & kHi;
}

// each byte 0xff where its top bit is set, else 0 (prmt's sign-replicate
// selectors; __byte_perm keeps only a selector's low three bits)
__device__ __forceinline__ uint32_t byte_mask(uint32_t top) {
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0xba98;" : "=r"(m) : "r"(top));
  return m;
}

__device__ __forceinline__ uint32_t paeth(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t pa = __vabsdiffu4(b, c);   // |p - a| = |v|, v = b - c
  const uint32_t pb = __vabsdiffu4(a, c);   // |p - b| = |u|, u = a - c
  const uint32_t same = ~(ge_top(a, c) ^ ge_top(b, c)) & kHi;
  const uint32_t c1 = ge_top(pb, pa);                    // |v| <= |u|
  const uint32_t c2 = ge_top((pb >> 1) & kLo7, pa);      // 2|v| <= |u|
  const uint32_t c3 = ge_top((pa >> 1) & kLo7, pb);      // 2|u| <= |v|
  const uint32_t ma = byte_mask((same & c1) | (~same & c2));
  const uint32_t mb = byte_mask((same & ~c1 & kHi) | (~same & c3));
  return (a & ma) | (b & mb) | (c & ~(ma | mb));
}

__device__ __forceinline__ uint32_t average(uint32_t a, uint32_t b) {  // (a + b) >> 1 a byte
  return (a & b) + (((a ^ b) >> 1) & kLo7);
}

__device__ __forceinline__ uint32_t predict(int f, uint32_t a, uint32_t b, uint32_t c) {
  switch (f) {
    case 0: return 0u;
    case 1: return a;
    case 2: return b;
    case 3: return average(a, b);
    default: return paeth(a, b, c);
  }
}

// the |int8| sum of the bytes of residual word r that `valid` keeps: the
// magnitudes min(v, 256 - v) summed by __vsadu4
__device__ __forceinline__ uint32_t cost_of(uint32_t r, uint32_t valid) {
  const uint32_t neg = byte_mask(r & kHi);
  const uint32_t mag = (sub_bytes(0u, r) & neg) | (r & ~neg);
  return __vsadu4(mag & valid, 0u);
}

// the 4 bytes at shared byte offset q of s (any alignment)
__device__ __forceinline__ uint32_t ld_word(const uint8_t* s, int q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s + (q & ~3));
  return __funnelshift_r(w[0], w[1], (q & 3) * 8);
}

// A row's staged bytes: column col at s + base + col; the row above at
// s + up_base + col, masked by `up` (0 on an image's first row).
struct RowView {
  const uint8_t* s;
  int base, up_base, bpp;
  uint32_t up;

  // x, a, b, c of the word at columns col .. col + 3
  __device__ __forceinline__ void words(int col, uint32_t& x, uint32_t& a, uint32_t& b,
                                        uint32_t& c) const {
    const int k = bpp - col;  // bytes of the word left of column bpp
    const uint32_t left = k <= 0 ? 0xffffffffu : (k >= 4 ? 0u : 0xffffffffu << (8 * k));
    x = ld_word(s, base + col);
    a = ld_word(s, base + col - bpp) & left;
    b = ld_word(s, up_base + col) & up;
    c = ld_word(s, up_base + col - bpp) & left & up;
  }
  // the residual word of filter f at columns col .. col + 3
  __device__ __forceinline__ uint32_t residual(int f, int col) const {
    uint32_t x, a, b, c;
    words(col, x, a, b, c);
    return sub_bytes(x, predict(f, a, b, c));
  }
};

// Residual word m of a row (residual bytes 4m - s .. 4m - s + 3, from the
// residual words m - 1 = `prev` and m = `r`) to its aligned place in the
// stream's row, whose first residual byte is at dst (s = dst & 3): one
// 32-bit store, or byte stores where the word holds bytes outside the
// row's residuals.
__device__ __forceinline__ void emit(uint8_t* dst, int m, int rb, uint32_t prev, uint32_t r) {
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 3);
  const uint32_t v = __funnelshift_rc(prev, r, 8 * (4 - s));
  const int i0 = 4 * m - s;
  uint8_t* p = dst + i0;
  if (i0 >= 0 && i0 + 4 <= rb) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (i0 + t >= 0 && i0 + t < rb) p[t] = static_cast<uint8_t>(v >> (8 * t));
}

// Stage band rows r0 - 1 .. r0 + nr - 1 (the first only when r0 > 0),
// columns [max(c0 - kHalo, 0), min(c0 + chunk, rb)), each as the aligned
// 16-byte words that cover it, into slot t at tile + 16 + t * pitch (a
// row's byte shift in its slot is its address & 15).
__device__ __forceinline__ void stage(const uint8_t* __restrict__ src, int64_t r0, int nr, int rb,
                                      int c0, const Plan& pl, uint8_t* tile) {
  __syncthreads();  // the previous chunk's readers are done
  const int off0 = c0 > kHalo ? c0 - kHalo : 0;
  const int end = c0 + pl.chunk < rb ? c0 + pl.chunk : rb;
  // a warp a slot (the 9th slot to warp 0), a lane a word
  for (int t = (r0 > 0 ? 0 : 1) + (threadIdx.x >> 5); t <= nr; t += kWarps) {
    const uint8_t* g = src + (r0 - 1 + t) * static_cast<int64_t>(rb) + off0;
    const int d = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
    const uint8_t* g0 = g - d;
    const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(tile + 16 + t * pl.pitch));
    for (int w = threadIdx.x & 31; 16 * w < d + (end - off0); w += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s0 + 16 * w),
                   "l"(g0 + 16 * w));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// The view of band row i (slot i + 1) for the chunk at c0
__device__ __forceinline__ RowView view_of(const uint8_t* __restrict__ src, int64_t r0, int i, int h,
                                           int rb, int bpp, int c0, const Plan& pl,
                                           const uint8_t* tile) {
  const int off0 = c0 > kHalo ? c0 - kHalo : 0;
  const int64_t gr = r0 + i;
  const int d = static_cast<int>(
      reinterpret_cast<uintptr_t>(src + gr * static_cast<int64_t>(rb) + off0) & 15);
  const int du = static_cast<int>(
      reinterpret_cast<uintptr_t>(src + (gr - 1) * static_cast<int64_t>(rb) + off0) & 15);
  RowView v;
  v.s = tile;
  v.base = 16 + (i + 1) * pl.pitch + d - off0;
  v.up_base = 16 + i * pl.pitch + du - off0;
  v.bpp = bpp;
  v.up = gr % h == 0 ? 0u : 0xffffffffu;
  return v;
}

// The adaptive streams of a row's chunk, words [k0, k1), filter `best`:
// the residual words from `cached` (the row's words of filter `best`, one
// chunk from word 0) or, without, computed again from the staged rows
__device__ __forceinline__ void write_adaptive(const RowView& v, const uint32_t* cached, int best,
                                               int k0, int k1, int rb, const Streams& st,
                                               uint8_t* out, int64_t stride, int64_t orow) {
  const int lane = threadIdx.x & 31;
  uint32_t carry = k0 > 0 ? v.residual(best, 4 * (k0 - 1)) : 0u;
  for (int kb = k0; kb < k1; kb += 32) {
    const int k = kb + lane, kk = k < k1 ? k : k1 - 1;
    const uint32_t r = cached ? cached[kk] : v.residual(best, 4 * kk);
    uint32_t prev = __shfl_up_sync(0xffffffffu, r, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(0xffffffffu, r, 31);
#pragma unroll
    for (int j = 0; j < kMaxStreams; ++j) {
      if (!((st.adaptive >> j) & 1)) continue;
      uint8_t* dst = out + j * stride + orow;
      if (k < k1) emit(dst + 1, k, rb, prev, r);
      if (k == 0) dst[0] = static_cast<uint8_t>(best);
    }
  }
}

// kFixed: fixed streams compiled in (at least st.nfixed; the extra ones
// are skipped)
template <bool kAdaptive, int kFixed>
__global__ void __launch_bounds__(kThreads, 4) png_filter_bands(
    const uint8_t* __restrict__ src, int64_t rows, int h, int rb, int bpp, Streams st,
    uint8_t* __restrict__ out, int64_t stride, Plan pl) {
  extern __shared__ __align__(16) uint8_t tile[];
  __shared__ uint32_t cost_s[kBand][5];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kBand;
  const int nr = static_cast<int>(rows - r0 < kBand ? rows - r0 : kBand);
  const int cw = pl.chunk / 4;
  // a single-chunk band's five residual words a word, a warp's row each
  uint32_t* cache =
      pl.cache ? reinterpret_cast<uint32_t*>(tile + pl.cache) + warp * 5 * cw : nullptr;
  // with the adaptive costs all five residual words are at hand: a fixed
  // stream's filter as five masks, its residual word the OR of the five
  // masked words; without, each fixed stream computes its own filter
  uint32_t pickm[kFixed > 0 ? kFixed : 1][5];
#pragma unroll
  for (int j = 0; j < kFixed; ++j)
#pragma unroll
    for (int f = 0; f < 5; ++f) pickm[j][f] = st.fixed_filter[j] == f ? 0xffffffffu : 0u;

  // pass 1: the fixed streams, and the adaptive costs
  for (int ch = 0; ch < pl.nchunks; ++ch) {
    const int c0 = ch * pl.chunk;
    stage(src, r0, nr, rb, c0, pl, tile);
    const int k0 = ch * cw, k1 = k0 + cw < pl.words ? k0 + cw : pl.words;
    if (warp < nr) {
      const RowView v = view_of(src, r0, warp, h, rb, bpp, c0, pl, tile);
      const int64_t orow = (r0 + warp) * static_cast<int64_t>(rb + 1);
      uint8_t* dst[kFixed > 0 ? kFixed : 1];
      uint32_t carry[kFixed > 0 ? kFixed : 1];
#pragma unroll
      for (int j = 0; j < kFixed; ++j) {
        dst[j] = out + st.fixed_stream[j] * stride + orow;
        carry[j] = j < st.nfixed && k0 > 0 ? v.residual(st.fixed_filter[j], 4 * (k0 - 1)) : 0u;
      }
      uint32_t cost[5] = {0u, 0u, 0u, 0u, 0u};
      for (int kb = k0; kb < k1; kb += 32) {
        // a lane past the chunk reads the chunk's last word (its results
        // are never stored or counted)
        const int k = kb + lane, col = 4 * (k < k1 ? k : k1 - 1);
        uint32_t x, a, b, c;
        v.words(col, x, a, b, c);
        uint32_t res[5];
        if (kAdaptive) {
          res[0] = x;
          res[1] = sub_bytes(x, a);
          res[2] = sub_bytes(x, b);
          res[3] = sub_bytes(x, average(a, b));
          res[4] = sub_bytes(x, paeth(a, b, c));
          const int left = k < k1 ? rb - col : 0;  // the word's bytes in the row
          const uint32_t valid =
              left >= 4 ? 0xffffffffu : (left <= 0 ? 0u : 0xffffffffu >> (8 * (4 - left)));
#pragma unroll
          for (int f = 0; f < 5; ++f) cost[f] += cost_of(res[f], valid);
          if (cache && k < k1) {
#pragma unroll
            for (int f = 0; f < 5; ++f) cache[f * cw + k] = res[f];
          }
        }
#pragma unroll
        for (int j = 0; j < kFixed; ++j) {
          if (j >= st.nfixed) break;
          const uint32_t r = kAdaptive ? (res[0] & pickm[j][0]) | (res[1] & pickm[j][1]) |
                                             (res[2] & pickm[j][2]) | (res[3] & pickm[j][3]) |
                                             (res[4] & pickm[j][4])
                                       : sub_bytes(x, predict(st.fixed_filter[j], a, b, c));
          uint32_t prev = __shfl_up_sync(0xffffffffu, r, 1);
          if (lane == 0) prev = carry[j];
          carry[j] = __shfl_sync(0xffffffffu, r, 31);
          if (k < k1) emit(dst[j] + 1, k, rb, prev, r);
          if (k == 0) dst[j][0] = static_cast<uint8_t>(st.fixed_filter[j]);
        }
      }
      if (kAdaptive) {
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          const uint32_t sum = __reduce_add_sync(0xffffffffu, cost[f]);
          if (lane == 0) cost_s[warp][f] = ch == 0 ? sum : cost_s[warp][f] + sum;
        }
        __syncwarp();
        if (pl.nchunks == 1) {  // the adaptive streams on the same staged rows
          int best = 0;
#pragma unroll
          for (int f = 1; f < 5; ++f)
            if (cost_s[warp][f] < cost_s[warp][best]) best = f;
          write_adaptive(v, cache ? cache + best * cw : nullptr, best, k0, k1, rb, st, out,
                         stride, orow);
        }
      }
    }
  }
  if (!kAdaptive || pl.nchunks == 1) return;

  // pass 2 (chunked rows): the adaptive streams, the chunks staged again
  for (int ch = 0; ch < pl.nchunks; ++ch) {
    const int c0 = ch * pl.chunk;
    stage(src, r0, nr, rb, c0, pl, tile);
    const int k0 = ch * cw, k1 = k0 + cw < pl.words ? k0 + cw : pl.words;
    if (warp < nr) {
      int best = 0;
#pragma unroll
      for (int f = 1; f < 5; ++f)
        if (cost_s[warp][f] < cost_s[warp][best]) best = f;
      const RowView v = view_of(src, r0, warp, h, rb, bpp, c0, pl, tile);
      write_adaptive(v, nullptr, best, k0, k1, rb, st, out, stride,
                     (r0 + warp) * static_cast<int64_t>(rb + 1));
    }
  }
}

// The plan of a launch over rows of rb bytes: the chunk (the whole row
// when a band's nine rows fit kTileBudget), the bytes staged and, with an
// adaptive stream on single-chunk rows, the residual cache after them.
Plan plan_of(int rb, bool adaptive) {
  Plan pl;
  pl.words = (rb + 2) / 4 + 1;
  const int need = (4 * pl.words + 127) / 128 * 128;
  const int slots = kBand + 1;
  if (slots * (need + kPad) + 16 <= kTileBudget) {
    pl.chunk = need;
    pl.nchunks = 1;
  } else {
    const int cmax = ((kTileBudget - 16) / slots - kPad) / 128 * 128;
    pl.nchunks = (need + cmax - 1) / cmax;
    pl.chunk = ((need + pl.nchunks - 1) / pl.nchunks + 127) / 128 * 128;
  }
  pl.pitch = pl.chunk + kPad;
  pl.smem = slots * pl.pitch + 16;
  pl.cache = 0;
  if (adaptive && pl.nchunks == 1) {
    pl.cache = (pl.smem + 15) / 16 * 16;
    pl.smem = pl.cache + kBand * 5 * pl.chunk;
  }
  return pl;
}

using KernelFn = void (*)(const uint8_t*, int64_t, int, int, int, Streams, uint8_t*, int64_t, Plan);

// the build for a stream set: adaptive or not, and the fixed streams
// compiled in (0, 1, 2 or 5, the fewest that hold nfixed)
KernelFn kernel_for(bool adaptive, int nfixed) {
  if (adaptive) {
    if (nfixed == 0) return png_filter_bands<true, 0>;
    if (nfixed == 1) return png_filter_bands<true, 1>;
    if (nfixed == 2) return png_filter_bands<true, 2>;
    return png_filter_bands<true, 5>;
  }
  if (nfixed == 1) return png_filter_bands<false, 1>;
  if (nfixed == 2) return png_filter_bands<false, 2>;
  return png_filter_bands<false, 5>;
}

// codes: stream j's strategy + 1 in bits 3j..3j+2 -> the stream set, or
// false if a code is out of range
bool streams_of(int nstreams, int codes, Streams* st) {
  st->nfixed = st->adaptive = 0;
  for (int j = 0; j < nstreams; ++j) {
    const int f = ((codes >> (3 * j)) & 7) - 1;
    if (f < -1 || f > 4) return false;
    if (f < 0) {
      st->adaptive |= 1 << j;
    } else {
      st->fixed_stream[st->nfixed] = j;
      st->fixed_filter[st->nfixed++] = f;
    }
  }
  for (int j = st->nfixed; j < kMaxStreams; ++j) st->fixed_stream[j] = st->fixed_filter[j] = 0;
  return true;
}

}  // namespace

// src: (n, h, rb) uint8 source rows (any alignment); out: nstreams
// streams of (n, h, rb + 1) uint8 filtered rows (type byte, then the
// residuals), stream j at out + j * stride; codes: stream j's strategy + 1
// (0 adaptive, 1..5 filters 0..4) in bits 3j..3j+2; 1 <= nstreams <= 6;
// 1 <= bpp <= 8. Returns cudaGetLastError().
extern "C" int picha_png_filter(const void* src, int n, int h, int rb, int bpp, int nstreams,
                                int codes, void* out, int64_t stride, void* stream) {
  Streams st;
  if (n < 0 || h < 1 || rb < 1 || bpp < 1 || bpp > 8 || nstreams < 1 ||
      nstreams > kMaxStreams || stride < 0 || !streams_of(nstreams, codes, &st))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(n) * h;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (rows + kBand - 1) / kBand;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_of(rb, st.adaptive != 0);
  const KernelFn k = kernel_for(st.adaptive != 0, st.nfixed);
  if (pl.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k<<<static_cast<unsigned>(blocks), kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), rows, h, rb, bpp, st, static_cast<uint8_t*>(out), stride,
      pl);
  return static_cast<int>(cudaGetLastError());
}

// The plan and build of a launch over `rows` rows of rb bytes with
// `nfixed` fixed streams and adaptive ones or not: out[0..5] band rows,
// chunk bytes, chunks, pitch, dynamic shared bytes (with the residual
// cache), words a row;
// out[6..10] the kernel's registers, local bytes, static shared bytes,
// blocks an SM at this plan's shared bytes, SMs; out[11] blocks.
extern "C" int picha_png_filter_info(int64_t rows, int rb, int adaptive, int nfixed, int* out) {
  if (rows < 1 || rb < 1 || nfixed < 0 || nfixed > kMaxStreams || (!adaptive && nfixed < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_of(rb, adaptive != 0);
  const KernelFn kf = kernel_for(adaptive != 0, nfixed);
  const void* k = reinterpret_cast<const void*>(kf);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err == cudaSuccess && pl.smem > 48 * 1024)
    err = cudaFuncSetAttribute(kf, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  int blocks = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, pl.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[12] = {kBand, pl.chunk, pl.nchunks, pl.pitch, pl.smem, pl.words,
                     fa.numRegs, static_cast<int>(fa.localSizeBytes),
                     static_cast<int>(fa.sharedSizeBytes), blocks, sms,
                     static_cast<int>((rows + kBand - 1) / kBand)};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}
