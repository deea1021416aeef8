// K4: speculative chunked baseline JPEG Huffman decode, for scans without
// restart markers (and restart scans whose segments no lane can hold
// whole). K5, at the end of this file: the DC scan that makes DC absolute.
//
// Replaces: picha_tpu/ops/jpeg_huffman_decode_tpu.py::build_decoder_core
// with single_pass=False: the Jacobi passes with frontier compaction
// (:805-942), the convergence test and block starts (:951-973), the
// merged emission (:1021-1081) and the one-hot densify and owner/straddle
// placement (:1103-1197); K5 replaces the DC associative scan
// (:1218-1243). Every C-bit chunk of a segment is a lane that decodes
// from a guessed entry state (bit offset, MCU slot, coefficient index);
// chunk i+1's entry becomes chunk i's exit until no entry changes.
//
// What bounds it on an H100: each pass is as long as its slowest lane's
// serial chain (bit window -> table lookup -> next position), ~1,000
// symbols of a 4096-bit lane, some 250 ns a symbol on an H100 (the loop's
// dependent instructions, not its loads: shared-memory tables, branch-
// free variants and fewer lanes a warp measured no faster); then the
// emission writes the (N, mcus*B, 64) int32 output, 200 MB at 16 x
// 1080p and 3.2 GB at 256, the bytes of the bound. The first port spent
// ~1,000 cycles a symbol (global loads and 16 compares a symbol),
// enqueued all 48 pass launches, and emitted by scattering 4-byte
// values a lane at a time into a zeroed output: at 256 images that
// emission alone took 8.5 ms, a partial-sector write a value.
//
// What the design does about it:
//  * a symbol is one shared-memory load of a 2^10-entry table per unique
//    Huffman table row, built on the card (huffman_lut.cuh, the lookup
//    and step K1 shares): the bits it takes, its code
//    length, its AC index step and its byte, for every 10-bit prefix the
//    exact rule gives one length <= 10; the longer codes of a prefix
//    through a second 64-entry table of the next 6 bits (up to 16 such
//    prefixes a row; the 16-compare rule of huffman_symbol.cuh past
//    that); the stream words in registers, the next one loaded a word
//    ahead; the slot -> component map packed in a register;
//  * a thread a lane for the Jacobi passes (windows of a lane decoded by
//    several threads from guessed entries needed a round a window to
//    agree, as long as the serial decode, and two to three times the
//    work at 256 images); one cooperative launch runs them with a grid
//    barrier between passes and stops at the fixpoint (no empty
//    launches), then the settle test and a two-level block-start scan;
//  * each decode records the lane's state where it first passes each of
//    kWindows equal bit offsets (checkpoints); a later decode of the
//    lane that meets an old checkpoint takes over the rest of the old
//    decode;
//  * the emission runs a thread a window from the checkpoints, each
//    replaying its share of the lane's (already capped) symbols. A
//    window builds each block in a shared-memory row; the blocks it
//    starts and ends its warp stores together, a 256-byte row an
//    instruction; the rows of blocks it shares with a neighbour window
//    (at most its first and last) are zeroed first and get only its
//    cells, as are the rows no lane reaches; nothing else is zeroed.
//    Writes are bounded by blk_limit. Without convergence (ok false) the
//    output is zeroed whole and every value scattered.
// Semantics held exactly to the reference (and to the plain twin
// picha_tpu_torch/ops/jpeg_huffman_decode.py::decode_scan_chunked_plain):
//  * a lane reads only the words of its window [word_base, word_base +
//    C/32 + 2); reads outside it give 0 bits, as the reference's window
//    gather does (an entry taken from an overflowed lane points before
//    the window);
//  * a pass decodes at most `steps` symbols per lane and stops at
//    bit_end; exit offset = pos - (word_base*32 + C), overflow = pos <
//    bit_end; exits are double-buffered by pass parity, so pass p reads
//    only pass p-1's exits of the previous lane (Jacobi);
//  * passes run while an entry changed, at most max_passes; ok = the
//    last propagation changed nothing and no lane overflowed.
// No atomics: flags are plain stores of 1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_lut.cuh"

namespace cg = cooperative_groups;

namespace {

using picha::kRowLut;
using picha::lut_build_kernel;
using picha::Run;
using picha::symbol_value;
using picha::table_smem;
using picha::Tabs;

constexpr int kMaxB = 64;                   // blocks per MCU handled here
constexpr int kPackedB = 16;                // slot -> component in a register
constexpr int kMaxComp = 4;
constexpr int kThreads = 256;               // K4's blocks
constexpr int kMaxGrid = 2048;              // block sums of the lane scan
constexpr int kWindowBits = 3;              // checkpoints a lane (emission
constexpr int kWindows = 1 << kWindowBits;  // threads a lane): 8
constexpr int kSmemTableLimit = 96 * 1024;  // tables in shared memory
constexpr int kScanThreads = 256;           // K5
constexpr int kDcPerThread = 8;             // K5: blocks a thread
constexpr int kDcTile = kScanThreads * kDcPerThread;
constexpr unsigned kFull = 0xffffffffu;

// the wire's lane arrays and tables (ScanBatch.args() order)
struct Wire {
  const uint32_t* words;
  const int* word_base;
  const int* bits;
  const uint8_t* pinned;
  const int* seg_first;
  const int* blk_base;
  const int* blk_limit;
  const uint8_t* uid6;
  const int* limit;
  const int* delta;
  const int* hv;
  const int* comp_of;
  int n_uniq, B, n_lanes, C, W, steps;
  unsigned comp2;  // slot s -> component in bits 2s..2s+1 (B <= kPackedB)
};

// Carved from the caller's int32 workspace (16-byte aligned; no zeroing
// needed: the kernel clears chg and flags itself):
//   lut   the lookup tables (n_uniq * kRowLut), 16-byte aligned for
//         load_tables' copy
//   path  (L, kWindows) int4  the lane's last decode where it first
//                       reached bit offset t * C / kWindows: pos - start,
//                       slot | z << 8, symbols and blocks before it;
//                       [L * kWindows] the end of the decode
//   12 lane arrays, max_passes change flags, 2 flags, kMaxGrid block
//   sums.
struct Work {
  unsigned* lut;
  int4* path;
  int* ent[3];     // the entry (off, slot, z) of each lane's last decode
  int* ex[2][3];   // exits by pass parity
  int* nblk;       // blocks the lane's last decode ended
  int* over;       // 1: its last decode stopped short of bit_end
  int* prev;       // exclusive prefix of nblk over all lanes
  int* chg;        // chg[p] = 1: propagating pass p's exits changed an entry
  int* flags;      // [0]: some lane's last decode overflowed, [1]: converged
  int* csum;       // per-block sums of the lane scan
};

Work carve(int* w, int n_lanes, int max_passes, int n_uniq) {
  Work k;
  k.lut = reinterpret_cast<unsigned*>(w);
  w += n_uniq * kRowLut;
  k.path = reinterpret_cast<int4*>(w);
  w += 4 * (kWindows + 1) * n_lanes;
  for (int i = 0; i < 3; ++i, w += n_lanes) k.ent[i] = w;
  for (int p = 0; p < 2; ++p)
    for (int i = 0; i < 3; ++i, w += n_lanes) k.ex[p][i] = w;
  k.nblk = w;
  w += n_lanes;
  k.over = w;
  w += n_lanes;
  k.prev = w;
  w += n_lanes;
  k.chg = w;
  w += max_passes;
  k.flags = w;
  w += 2;
  k.csum = w;
  return k;
}

// Loads comp_of, the zigzag order and (kSmem) the lookup tables and
// table rows into shared memory at `smem` (huffman_lut.cuh); the caller
// synchronises.
template <bool kSmem>
__device__ __forceinline__ Tabs load_tables(const Wire& wr, const unsigned* lut,
                                            unsigned char* smem, int* comp_s,
                                            int* zz_s) {
  return picha::load_tables<kSmem>(lut, wr.limit, wr.delta, wr.hv, wr.n_uniq, wr.comp_of,
                                   wr.B, smem, comp_s, zz_s);
}

struct Lane {
  int base, start, bit_end, blk_limit;
  unsigned long long uid;  // the lane's 6 table-row ids, byte t = row t
};

__device__ __forceinline__ Lane lane_of(const Wire& wr, int lane) {
  Lane l;
  l.base = wr.word_base[lane];
  l.start = l.base * 32;
  l.bit_end = l.start + wr.bits[lane];
  l.blk_limit = wr.blk_limit[lane];
  l.uid = 0;
  for (int t = 0; t < 6; ++t)
    l.uid |= static_cast<unsigned long long>(wr.uid6[lane * 6 + t]) << (8 * t);
  return l;
}

struct St {
  int pos, slot, z;
};

__device__ __forceinline__ uint32_t stream_word(const Wire& wr, const Lane& ln, int i) {
  const int rel = i - ln.base;
  return (rel >= 0 && rel < wr.W) ? __ldg(wr.words + i) : 0u;
}

__device__ __forceinline__ void set_rows(const Wire& wr, const int* comp_s,
                                         const Lane& ln, Run& r) {
  const int c = wr.B <= kPackedB ? static_cast<int>((wr.comp2 >> (2 * r.slot)) & 3u)
                                 : comp_s[r.slot];
  r.dc = static_cast<int>((ln.uid >> (16 * c)) & 0xffu);
  r.ac = static_cast<int>((ln.uid >> (16 * c + 8)) & 0xffu);
}

__device__ __forceinline__ Run run_from(const Wire& wr, const int* comp_s,
                                        const Lane& ln, St s) {
  Run r;
  r.pos = s.pos;
  r.slot = s.slot;
  r.z = s.z;
  r.cnt = 0;
  r.blocks = 0;
  r.wl = s.pos >> 5;
  r.w0 = stream_word(wr, ln, r.wl);
  r.w1 = stream_word(wr, ln, r.wl + 1);
  r.w2 = stream_word(wr, ln, r.wl + 2);
  set_rows(wr, comp_s, ln, r);
  return r;
}

// One symbol of lane ln (huffman_lut.cuh's step): its table entry, r
// moved past it.
__device__ __forceinline__ unsigned step(const Wire& wr, const Tabs& tb,
                                         const int* comp_s, const Lane& ln, Run& r,
                                         uint32_t& w32) {
  return picha::step(
      tb, wr.B, r, w32, [&](int i) { return stream_word(wr, ln, i); },
      [&](Run& x) { set_rows(wr, comp_s, ln, x); });
}

__device__ __forceinline__ int4 pack_state(const Run& r, int start) {
  return make_int4(r.pos - start, r.slot | (r.z << 8), r.cnt, r.blocks);
}

// One Jacobi pass of `lane` (a thread a lane).
__device__ __forceinline__ void lane_pass(const Wire& wr, const Work& wk, const Tabs& tb,
                          const int* comp_s, int lane, int p) {
  int e0 = 0, e1 = 0, e2 = 0;
  if (p > 0) {
    if (lane > 0 && !wr.pinned[lane]) {
      const int par = (p - 1) & 1;
      e0 = wk.ex[par][0][lane - 1];
      e1 = wk.ex[par][1][lane - 1];
      e2 = wk.ex[par][2][lane - 1];
    }
    if (e0 == wk.ent[0][lane] && e1 == wk.ent[1][lane] && e2 == wk.ent[2][lane]) {
      for (int k = 0; k < 3; ++k) wk.ex[p & 1][k][lane] = wk.ex[(p & 1) ^ 1][k][lane];
      return;  // same entry, same exit
    }
    wk.chg[p - 1] = 1;
  }
  wk.ent[0][lane] = e0;
  wk.ent[1][lane] = e1;
  wk.ent[2][lane] = e2;
  const Lane ln = lane_of(wr, lane);
  Run r = run_from(wr, comp_s, ln, St{ln.start + e0, e1, e2});
  // checkpoints: the state where the decode first reaches each window.
  // After the first pass, where a checkpoint's state (pos, slot, z) is
  // the lane's previous decode's, the rest of the decode is that one's,
  // symbol and block counts shifted, unless the previous decode stopped
  // at `steps` or the shift takes the count past it.
  const int S = wr.C / kWindows;
  int4* cp = wk.path + static_cast<int64_t>(lane) * kWindows;
  int4* cp_end = wk.path + static_cast<int64_t>(wr.n_lanes) * kWindows + lane;
  const int4 old_end = p > 0 ? *cp_end : make_int4(0, 0, 0, 0);
  const bool may_merge = p > 0 && ln.start + old_end.x >= ln.bit_end;
  cp[0] = pack_state(r, ln.start);
  int t = 1;
  int bound = ln.start + S;
  int4 end = make_int4(0, 0, 0, 0);
  bool merged = false;
  while (!merged && r.cnt < wr.steps && r.pos < ln.bit_end) {
    while (t < kWindows && r.pos >= bound) {
      const int4 now = pack_state(r, ln.start);
      if (may_merge) {
        const int4 was = cp[t];
        const int dn = now.z - was.z, db = now.w - was.w;
        if (was.x == now.x && was.y == now.y && old_end.z + dn <= wr.steps) {
          for (; t < kWindows; ++t) {
            const int4 c = cp[t];
            cp[t] = make_int4(c.x, c.y, c.z + dn, c.w + db);
          }
          end = make_int4(old_end.x, old_end.y, old_end.z + dn, old_end.w + db);
          merged = true;
          break;
        }
      }
      cp[t++] = now;
      bound += S;
    }
    if (merged) break;
    uint32_t w32;
    step(wr, tb, comp_s, ln, r, w32);
  }
  if (!merged) {
    for (; t < kWindows; ++t) cp[t] = pack_state(r, ln.start);
    end = pack_state(r, ln.start);
  }
  *cp_end = end;
  wk.ex[p & 1][0][lane] = end.x - wr.C;
  wk.ex[p & 1][1][lane] = end.y & 0xff;
  wk.ex[p & 1][2][lane] = end.y >> 8;
  wk.nblk[lane] = end.w;
  wk.over[lane] = ln.start + end.x < ln.bit_end ? 1 : 0;
}

// The entry pass p gives `lane` (settle's check after the last pass).
__device__ bool entry_changes(const Wire& wr, const Work& wk, int lane, int p) {
  int e[3] = {0, 0, 0};
  if (lane > 0 && !wr.pinned[lane])
    for (int k = 0; k < 3; ++k) e[k] = wk.ex[(p - 1) & 1][k][lane - 1];
  return e[0] != wk.ent[0][lane] || e[1] != wk.ent[1][lane] || e[2] != wk.ent[2][lane];
}

__device__ __forceinline__ int load_flag(const int* f) {
  return *reinterpret_cast<const volatile int*>(f);
}

// Sum over the block (every thread calls it; red holds 32 ints).
__device__ int block_sum(int v, int* red) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();
  return s;
}

// Exclusive prefix over the block's threads in thread order.
__device__ int block_exclusive_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += red[w];
  __syncthreads();
  return before + inc - v;
}

__device__ __forceinline__ int blk_start(const Wire& wr, const Work& wk, int lane) {
  const int f = min(max(wr.seg_first[lane], 0), wr.n_lanes - 1);
  return wr.blk_base[lane] + wk.prev[lane] - wk.prev[f];
}

__device__ __forceinline__ void zero_row(int* out, int blk) {
  int4* row = reinterpret_cast<int4*>(out + static_cast<int64_t>(blk) * 64);
  for (int c = 0; c < 16; ++c) row[c] = make_int4(0, 0, 0, 0);
}

// K4's passes in one cooperative launch: the Jacobi passes to the
// fixpoint (at most max_passes), settle, block starts, and the rows the
// emission does not write whole zeroed (all of them without convergence).
template <bool kSmem>
__global__ void __launch_bounds__(kThreads) chunk_pass_kernel(
    Wire wr, Work wk, int max_passes, int* __restrict__ out, int64_t out_rows,
    int* __restrict__ info) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int comp_s[kMaxB];
  __shared__ int zz_s[64];
  __shared__ int red[32];
  const Tabs tb = load_tables<kSmem>(wr, wk.lut, smem, comp_s, zz_s);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i <= max_passes; i += blockDim.x)
      (i < max_passes ? wk.chg[i] : wk.flags[0]) = 0;
  __syncthreads();
  const int L = wr.n_lanes;
  const int stride = gridDim.x * blockDim.x;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  int p = 0;
  for (; p < max_passes; ++p) {
    if (p >= 2 && load_flag(wk.chg + p - 2) == 0) break;  // fixpoint reached
    for (int lane = gid; lane < L; lane += stride) lane_pass(wr, wk, tb, comp_s, lane, p);
    grid.sync();
  }
  // settle: overflow, and when every pass changed an entry (no early
  // stop, and the last pass changed one), whether propagating the last
  // pass's exits changes one more
  const bool all_changed =
      p == max_passes && (max_passes < 2 || load_flag(wk.chg + max_passes - 2) != 0);
  for (int lane = gid; lane < L; lane += stride) {
    if (wk.over[lane]) wk.flags[0] = 1;
    if (all_changed && entry_changes(wr, wk, lane, max_passes)) wk.chg[max_passes - 1] = 1;
  }
  // block starts: each block's contiguous share of the lanes, its sum,
  // then the sums of the blocks before it
  const int chunk = (L + gridDim.x - 1) / gridDim.x;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, L);
  const int hi = min(lo + chunk, L);
  const int per = (hi - lo + blockDim.x - 1) / blockDim.x;
  const int a = min(lo + static_cast<int>(threadIdx.x) * per, hi);
  const int z = min(a + per, hi);
  int sum = 0;
  for (int i = a; i < z; ++i) sum += wk.nblk[i];
  const int total = block_sum(sum, red);
  if (threadIdx.x == 0) wk.csum[blockIdx.x] = total;
  grid.sync();
  int before = 0;
  for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x); i += blockDim.x)
    before += wk.csum[i];
  int acc = block_sum(before, red);
  acc += block_exclusive_sum(sum, red);
  for (int i = a; i < z; ++i) {
    wk.prev[i] = acc;
    acc += wk.nblk[i];
  }
  int passes = max_passes, converged = 0;
  for (int j = 0; j < max_passes; ++j) {
    if (load_flag(wk.chg + j) == 0) {
      passes = j + 1;
      converged = 1;
      break;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int overflow = load_flag(wk.flags);
    info[0] = converged && !overflow;
    info[1] = passes;
    info[2] = overflow;
    wk.flags[1] = converged;
  }
  grid.sync();
  if (!converged) {  // the emission scatters every value
    int4* o = reinterpret_cast<int4*>(out);
    for (int64_t i = gid; i < out_rows * 16; i += stride) o[i] = make_int4(0, 0, 0, 0);
    return;
  }
  // the rows a window shares with its neighbour, and those past the
  // decode of a segment's last lane, are zeroed here
  for (int64_t g = gid; g < static_cast<int64_t>(L) * kWindows; g += stride) {
    const int lane = static_cast<int>(g >> kWindowBits);
    const int t = static_cast<int>(g & (kWindows - 1));
    const int4 c0 = wk.path[g];
    const int4 c1 = t + 1 < kWindows ? wk.path[g + 1]
                                     : wk.path[static_cast<int64_t>(L) * kWindows + lane];
    const int limit = wr.blk_limit[lane];
    const int b0 = blk_start(wr, wk, lane) + c0.w;
    if (c1.z > c0.z) {  // the window decodes symbols
      if ((c0.y >> 8) > 0 && b0 < limit) zero_row(out, b0);
      const int b1 = blk_start(wr, wk, lane) + c1.w;
      if ((c1.y >> 8) > 0 && b1 < limit) zero_row(out, b1);
    }
    const bool last = lane + 1 == L || wr.pinned[lane + 1];
    if (last && t == kWindows - 1) {
      for (int b = blk_start(wr, wk, lane) + c1.w + ((c1.y >> 8) > 0 ? 1 : 0); b < limit; ++b)
        zero_row(out, b);
    }
  }
}

// The emission: a thread a window of a lane, from its checkpoint, the
// window's symbols only; each block built in the thread's shared-memory
// row (16-byte chunks swizzled by thread). The blocks a window starts
// and ends are stored whole by its warp together, a 256-byte row an
// instruction; the others (and all of them without convergence) cell by
// cell into their zeroed rows. DC stays as diffs.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads) chunk_emit_kernel(
    Wire wr, Work wk, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int comp_s[kMaxB];
  __shared__ int zz_s[64];
  const Tabs tb = load_tables<kSmem>(wr, wk.lut, smem + kThreads * 256, comp_s, zz_s);
  int* const bufs = reinterpret_cast<int*>(smem) + (threadIdx.x & ~31) * 64;
  const int lane_id = threadIdx.x & 31;
  int* buf = bufs + lane_id * 64;
  int4* buf4 = reinterpret_cast<int4*>(buf);
  const int sw = threadIdx.x & 15;  // logical chunk c sits at c ^ sw
  for (int c = 0; c < 16; ++c) buf4[c ^ sw] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t g_end = static_cast<int64_t>(wr.n_lanes) * kWindows;
  if ((g & ~31ll) >= g_end) return;  // the whole warp is past the end
  int n = 0, lane = 0;
  int4 c0 = make_int4(0, 0, 0, 0);
  if (g < g_end) {
    lane = static_cast<int>(g >> kWindowBits);
    const int t = static_cast<int>(g & (kWindows - 1));
    c0 = wk.path[g];
    const int4 c1 = t + 1 < kWindows ? wk.path[g + 1] : wk.path[g_end + lane];
    n = c1.z - c0.z;
  }
  const Lane ln = lane_of(wr, lane);
  const bool whole = load_flag(wk.flags + 1) != 0;
  Run r = run_from(wr, comp_s, ln, St{ln.start + c0.x, c0.y & 0xff, c0.y >> 8});
  const int blk0 = n > 0 ? blk_start(wr, wk, lane) + c0.w : 0;
  bool shared_first = r.z > 0 || !whole;  // the block began before this window
  unsigned long long set = 0;             // cells of buf written
  auto cell = [&](int zz) { return buf + (((zz >> 2) ^ sw) << 2) + (zz & 3); };
  auto scatter = [&](int blk) {
    while (set) {
      const int zz = __ffsll(static_cast<long long>(set)) - 1;
      set &= set - 1;
      int* s = cell(zz);
      if (blk < ln.blk_limit) out[static_cast<int64_t>(blk) * 64 + zz] = *s;
      *s = 0;
    }
  };
  for (int i = 0; __any_sync(kFull, i < n); ++i) {
    bool store = false;
    int blk = 0;
    if (i < n) {
      const int z = r.z;
      blk = blk0 + r.blocks;
      uint32_t w32;
      const unsigned e = step(wr, tb, comp_s, ln, r, w32);
      int zc, v;
      if (symbol_value(e, z, w32, zc, v)) {
        const int zz = zz_s[zc];
        *cell(zz) = v;
        set |= 1ull << zz;
      }
      if (r.blocks != blk - blk0) {  // the symbol ended block blk
        if (shared_first) {
          scatter(blk);
          shared_first = !whole;
        } else {
          store = true;  // the warp stores it below and clears the row
          set = 0;
        }
      }
    }
    unsigned todo = __ballot_sync(kFull, store);
    if (todo) {
      __syncwarp();
      while (todo) {  // a finished block a step: 8 bytes a thread
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int b = __shfl_sync(kFull, blk, src);
        const int limit = __shfl_sync(kFull, ln.blk_limit, src);
        const int c = lane_id >> 1;
        int2* s = reinterpret_cast<int2*>(bufs + src * 64 + ((c ^ (src & 15)) << 2) +
                                          (lane_id & 1) * 2);
        if (b < limit)
          reinterpret_cast<int2*>(out + static_cast<int64_t>(b) * 64)[lane_id] = *s;
        *s = make_int2(0, 0);
      }
      __syncwarp();
    }
  }
  if (n > 0) scatter(blk0 + r.blocks);  // the block the window leaves unfinished
}

struct Seg {
  int s, f;
};

__device__ __forceinline__ Seg seg_join(Seg a, Seg b) {  // a before b
  return Seg{b.f ? b.s : a.s + b.s, a.f | b.f};
}

__device__ __forceinline__ Seg warp_inclusive(Seg v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o{__shfl_up_sync(kFull, v.s, d), __shfl_up_sync(kFull, v.f, d)};
    if (lane >= d) v = seg_join(o, v);
  }
  return v;
}

// Exclusive segmented scan over the threads of the block in thread order
// (blockDim.x a multiple of 32, at most 1024). Every thread calls it.
__device__ Seg block_exclusive(Seg v, Seg* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Seg inc = warp_inclusive(v);
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg w = lane < static_cast<int>(blockDim.x >> 5) ? sh[lane] : Seg{0, 0};
    sh[lane] = warp_inclusive(w);
  }
  __syncthreads();
  Seg ex{__shfl_up_sync(kFull, inc.s, 1), __shfl_up_sync(kFull, inc.f, 1)};
  if (lane == 0) ex = Seg{0, 0};
  const Seg res = warp ? seg_join(sh[warp - 1], ex) : ex;
  __syncthreads();  // sh is reused by the next call
  return res;
}

// K5's view of one tile of one image: kDcPerThread consecutive blocks a
// thread, their DC diffs loaded at once, each component's segmented sum,
// restarting where blk % ri_blk is the component's first MCU slot.
struct DcTile {
  int* dc;  // the image's first cell
  int lo, hi, ri;
  int v[kDcPerThread];
};

// The thread's blocks of the tile and their DC diffs: from the output's
// cells (a 256-byte stride), copied to `dcs` (a 4-byte stride), or (the
// second level) from `dcs`.
__device__ void dc_tile(int* out, const int* ri_blk, int nblk_img, int* dcs,
                        bool from_dcs, DcTile& d) {
  d.dc = out + static_cast<int64_t>(blockIdx.x) * nblk_img * 64;
  d.ri = max(ri_blk[blockIdx.x], 1);
  d.lo = min(static_cast<int>(blockIdx.y) * kDcTile +
                 static_cast<int>(threadIdx.x) * kDcPerThread, nblk_img);
  d.hi = min(d.lo + kDcPerThread, nblk_img);
  int* compact = dcs + static_cast<int64_t>(blockIdx.x) * nblk_img;
#pragma unroll
  for (int i = 0; i < kDcPerThread; ++i) {
    const int b = d.lo + i;
    if (from_dcs) {
      d.v[i] = b < d.hi ? compact[b] : 0;
    } else {
      d.v[i] = b < d.hi ? d.dc[static_cast<int64_t>(b) * 64] : 0;
      if (b < d.hi) compact[b] = d.v[i];
    }
  }
}

__device__ void dc_setup(const int* g_comp_of, int B, int* comp_s, int* first_s) {
  if (threadIdx.x == 0) {
    for (int c = 0; c < kMaxComp; ++c) first_s[c] = -1;
    for (int s = 0; s < B; ++s) {
      const int c = g_comp_of[s];
      comp_s[s] = c;
      if (c >= 0 && c < kMaxComp && first_s[c] < 0) first_s[c] = s;
    }
  }
  __syncthreads();
}

// Per component the tile's segmented sum (carry = nullptr), or the
// absolute DC written back after `carry` (the sum before the thread's
// first block).
__device__ void dc_walk(DcTile& d, int B, const int* comp_s, const int* first_s,
                        Seg loc[kMaxComp], int* carry) {
  if (!carry)
    for (int c = 0; c < kMaxComp; ++c) loc[c] = Seg{0, 0};
  int m = d.lo % B, r = d.lo % d.ri;
#pragma unroll
  for (int i = 0; i < kDcPerThread; ++i) {
    const int b = d.lo + i;
    const int c = comp_s[m];
    if (b < d.hi && c >= 0 && c < kMaxComp) {
      const bool reset = r == first_s[c];
      if (carry) {
        carry[c] = reset ? d.v[i] : carry[c] + d.v[i];
        d.dc[static_cast<int64_t>(b) * 64] = carry[c];
      } else {
        loc[c] = reset ? Seg{d.v[i], 1} : Seg{loc[c].s + d.v[i], loc[c].f};
      }
    }
    m = m + 1 == B ? 0 : m + 1;
    r = r + 1 == d.ri ? 0 : r + 1;
  }
}

// K5 runs an image a grid column (blockIdx.x) and a tile a grid row
// (blockIdx.y). First level: each tile's per-component aggregate.
__global__ void __launch_bounds__(kScanThreads) dc_tile_kernel(
    int* __restrict__ out, const int* __restrict__ g_comp_of,
    const int* __restrict__ ri_blk, int nblk_img, int B, Seg* __restrict__ agg,
    int* __restrict__ dcs) {
  __shared__ int comp_s[kMaxB];
  __shared__ int first_s[kMaxComp];
  __shared__ Seg sh[32];
  DcTile d;
  dc_tile(out, ri_blk, nblk_img, dcs, false, d);
  dc_setup(g_comp_of, B, comp_s, first_s);
  Seg loc[kMaxComp];
  dc_walk(d, B, comp_s, first_s, loc, nullptr);
  for (int c = 0; c < kMaxComp; ++c) {
    const Seg ex = block_exclusive(loc[c], sh);
    if (threadIdx.x == blockDim.x - 1)
      agg[(static_cast<int64_t>(blockIdx.x) * gridDim.y + blockIdx.y) * kMaxComp + c] =
          seg_join(ex, loc[c]);
  }
}

// K5, second level: the tiles before this one folded in order (a
// contiguous share a lane of warp 0, then a warp scan), then the tile's
// own scan, DC made absolute in place.
__global__ void __launch_bounds__(kScanThreads) dc_apply_kernel(
    int* __restrict__ out, const int* __restrict__ g_comp_of,
    const int* __restrict__ ri_blk, int nblk_img, int B, const Seg* __restrict__ agg,
    int* __restrict__ dcs) {
  __shared__ int comp_s[kMaxB];
  __shared__ int first_s[kMaxComp];
  __shared__ Seg sh[32];
  __shared__ Seg cin[kMaxComp];
  DcTile d;
  dc_tile(out, ri_blk, nblk_img, dcs, true, d);
  if (threadIdx.x < 32) {
    const Seg* a = agg + static_cast<int64_t>(blockIdx.x) * gridDim.y * kMaxComp;
    const int nt = blockIdx.y;
    const int per = (nt + 31) / 32;
    const int j0 = min(static_cast<int>(threadIdx.x) * per, nt);
    const int j1 = min(j0 + per, nt);
    for (int c = 0; c < kMaxComp; ++c) {
      Seg acc{0, 0};
      for (int j = j0; j < j1; ++j) acc = seg_join(acc, a[j * kMaxComp + c]);
      acc = warp_inclusive(acc);
      if (threadIdx.x == 31) cin[c] = acc;
    }
  }
  dc_setup(g_comp_of, B, comp_s, first_s);  // synchronises
  Seg loc[kMaxComp];
  dc_walk(d, B, comp_s, first_s, loc, nullptr);
  int carry[kMaxComp];
  for (int c = 0; c < kMaxComp; ++c)
    carry[c] = seg_join(cin[c], block_exclusive(loc[c], sh)).s;
  dc_walk(d, B, comp_s, first_s, loc, carry);
}

int set_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  return 0;
}

// Launch shapes: the tables in shared memory when they fit; the pass
// kernel's cooperative grid (a thread a lane, at most the resident
// blocks); the emission's 256-byte row a thread on top of the tables.
struct Shape {
  const void* pass;
  const void* emit;
  int grid;
  size_t smem, emit_smem;
  unsigned emit_blocks;
};

Shape shape_of(int n_uniq, int n_lanes) {
  Shape sh;
  const bool in_smem = table_smem(n_uniq) <= static_cast<size_t>(kSmemTableLimit);
  sh.pass = in_smem ? reinterpret_cast<const void*>(chunk_pass_kernel<true>)
                    : reinterpret_cast<const void*>(chunk_pass_kernel<false>);
  sh.emit = in_smem ? reinterpret_cast<const void*>(chunk_emit_kernel<true>)
                    : reinterpret_cast<const void*>(chunk_emit_kernel<false>);
  sh.smem = in_smem ? table_smem(n_uniq) : 0;
  sh.emit_smem = sh.smem + kThreads * 256;
  set_smem(sh.pass, sh.smem);
  int per_sm = 0, sms = 132, dev = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sh.pass, kThreads, sh.smem);
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (n_lanes + kThreads - 1) / kThreads;
  sh.grid = want < kMaxGrid ? want : kMaxGrid;
  if (sh.grid > per_sm * sms) sh.grid = per_sm * sms;
  sh.emit_blocks = static_cast<unsigned>(
      (static_cast<int64_t>(n_lanes) * kWindows + kThreads - 1) / kThreads);
  return sh;
}

}  // namespace

// work: int32, n_uniq*2048 + 4*(kWindows+1)*n_lanes + 12*n_lanes +
// max_passes + 2 + 2048, 16-byte aligned (no zeroing needed); out: (out_rows, 64) int32, the
// batch's blocks (no zeroing needed), DC left as diffs (K5 integrates
// it); info: 3 int32 (ok, passes run, overflow). comp2: comp_of packed 2
// bits a slot (read when B <= 16). Launches the table build, the
// cooperative pass kernel and the emission, on `stream`. Returns the
// first launch error, else cudaGetLastError().
extern "C" int picha_huffman_decode_chunked(
    const void* words, const void* lane_word_base, const void* lane_bits,
    const void* lane_pinned, const void* lane_seg_first,
    const void* lane_blk_base, const void* lane_blk_limit, const void* limit,
    const void* delta, const void* hv, int n_uniq, const void* lane_uid6,
    const void* comp_of, int comp2, int B, int n_lanes, int C, int steps,
    int max_passes, int nw, void* work, void* out,
    int64_t out_rows, void* info, void* stream) {
  const int W = C / 32 + 2;
  if (B < 1 || B > kMaxB || n_uniq < 1 || n_lanes < 1 || max_passes < 1 ||
      C < 32 || C % 32 != 0 || nw < W || out_rows < 0 ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Wire wr{static_cast<const uint32_t*>(words),
          static_cast<const int*>(lane_word_base),
          static_cast<const int*>(lane_bits),
          static_cast<const uint8_t*>(lane_pinned),
          static_cast<const int*>(lane_seg_first),
          static_cast<const int*>(lane_blk_base),
          static_cast<const int*>(lane_blk_limit),
          static_cast<const uint8_t*>(lane_uid6),
          static_cast<const int*>(limit),
          static_cast<const int*>(delta),
          static_cast<const int*>(hv),
          static_cast<const int*>(comp_of),
          n_uniq, B, n_lanes, C, W, steps, static_cast<unsigned>(comp2)};
  Work wk = carve(static_cast<int*>(work), n_lanes, max_passes, n_uniq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lut_build_kernel<<<n_uniq, 256, 0, st>>>(wr.limit, wr.delta, wr.hv, wk.lut);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape sh = shape_of(n_uniq, n_lanes);
  int rc = set_smem(sh.pass, sh.smem);
  if (!rc) rc = set_smem(sh.emit, sh.emit_smem);
  if (rc) return rc;
  if (sh.grid < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int* o = static_cast<int*>(out);
  int* inf = static_cast<int*>(info);
  void* args[] = {&wr, &wk, &max_passes, &o, &out_rows, &inf};
  err = cudaLaunchCooperativeKernel(sh.pass, dim3(sh.grid), dim3(kThreads), args,
                                    sh.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* eargs[] = {&wr, &wk, &o};
  err = cudaLaunchKernel(sh.emit, dim3(sh.emit_blocks), dim3(kThreads), eargs,
                         sh.emit_smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K4's builds and launch shapes at n_uniq table rows and n_lanes lanes:
// out[0..6] the pass kernel's registers, local bytes a thread, static
// and dynamic shared bytes, resident blocks an SM, threads a block and
// grid; out[7..13] the emission kernel's.
extern "C" int picha_huffman_decode_chunked_info(int n_uniq, int n_lanes, int* out) {
  const Shape sh = shape_of(n_uniq, n_lanes);
  const void* fns[2] = {sh.pass, sh.emit};
  const size_t smems[2] = {sh.smem, sh.emit_smem};
  const int grids[2] = {sh.grid, static_cast<int>(sh.emit_blocks)};
  for (int k = 0; k < 2; ++k) {
    const int rc = set_smem(fns[k], smems[k]);
    if (rc) return rc;
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, fns[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[k], kThreads, smems[k]);
    int* o = out + 7 * k;
    o[0] = fa.numRegs;
    o[1] = static_cast<int>(fa.localSizeBytes);
    o[2] = static_cast<int>(fa.sharedSizeBytes);
    o[3] = static_cast<int>(smems[k]);
    o[4] = per_sm;
    o[5] = kThreads;
    o[6] = grids[k];
  }
  return static_cast<int>(cudaGetLastError());
}

// out: (n_img, nblk_img, 64) int32 with DC diffs at [.., 0], integrated
// in place; comp_of: (B,) int32; ri_blk: (n_img,) int32; scratch: int32,
// 2 * 4 * n_img * ceil(nblk_img / 2048) (one aggregate per tile and
// component), then n_img * nblk_img (the DC diffs, packed). Two launches:
// tile aggregates (reading each DC once), then the tiles in place.
extern "C" int picha_dc_integrate(void* out, const void* comp_of,
                                  const void* ri_blk, int n_img, int nblk_img,
                                  int B, void* scratch, void* stream) {
  const int tiles = (nblk_img + kDcTile - 1) / kDcTile;
  if (B < 1 || B > kMaxB || n_img < 0 || nblk_img < 0 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_img > 0 && nblk_img > 0) {
    const dim3 grid(n_img, tiles);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Seg* agg = static_cast<Seg*>(scratch);
    int* dcs = static_cast<int*>(scratch) + 2 * kMaxComp * static_cast<int64_t>(tiles) * n_img;
    dc_tile_kernel<<<grid, kScanThreads, 0, st>>>(
        static_cast<int*>(out), static_cast<const int*>(comp_of),
        static_cast<const int*>(ri_blk), nblk_img, B, agg, dcs);
    dc_apply_kernel<<<grid, kScanThreads, 0, st>>>(
        static_cast<int*>(out), static_cast<const int*>(comp_of),
        static_cast<const int*>(ri_blk), nblk_img, B, agg, dcs);
  }
  return static_cast<int>(cudaGetLastError());
}
