// K1: baseline JPEG Huffman decode, one thread per restart segment.
//
// Replaces: picha_tpu/ops/jpeg_huffman_decode_tpu.py::build_decoder_core
// in single-pass mode (ScanBatch.single_pass: every lane is a whole
// restart segment whose entry state is exact), including the zigzag to
// natural permutation and the per-component DC segmented scan. The TPU
// graph decodes all lanes in lockstep, emits (slot, coef, value) rows
// and densifies them with one-hot matmuls because scatters serialise
// there; a GPU thread builds each block of its segment and stores it.
//
// What bounds it on an H100: each segment is a serial chain of dependent
// table lookups (bit window -> table entry -> next position), ~600
// symbols on the longest segment of the slice's 16 x 1080p restart-8
// batch, and only 16,320 lanes (a few warps an SM) to hide the chain's
// latency; and the output, the (N, mcus*B, 64) int32 blocks, 200 MB at
// 16 x 1080p and 3.2 GB at 256, the bytes of the bound. The first port
// (two dependent global word loads and 16 compares a symbol, arrays
// indexed at run time in 48 bytes of local memory) took 0.42 ms at 16
// images, twice its longest lane alone (~340 ns a symbol), after zeroing
// the whole output, and wrote each value as a 4-byte scattered store;
// 11 ms at 256. This design's lane alone takes ~250 ns a symbol: an
// iteration's instructions issue in order, one warp a scheduler at 16
// images (PERF.md §6).
//
// What the design does about it:
//  * the step of K4 (huffman_lut.cuh): one shared-memory load of a
//    2^10-entry table a symbol (global memory past kSmemTableLimit), the
//    tables built on the card by lut_build_kernel and copied in by
//    16-byte loads; the stream in registers, the next word loaded a word
//    ahead; the slot -> component map (B <= 16), the six table-row ids
//    and the DC predictors packed in registers, no array indexed at run
//    time; the words, the slot and the predictors move on by selects and
//    the value is stored by a predicated store, so a warp's lanes take no
//    branch apart but where a block ends;
//  * each block is built in the thread's 256-byte row of shared memory
//    (zigzag order, 16-byte chunks swizzled by thread) and stored whole,
//    zeros included, when the block ends, by the warp: a 256-byte row an
//    instruction, natural order read through the inverse zigzag (the
//    thread's own 16-byte stores were as fast at 16 images and 1.5x
//    slower at 256). Every cell of the output is written exactly once: a lane
//    also writes the blocks of its segment it never reached (zeros and
//    the running DC) and the rows between its segment's end and the next
//    lane's first block (the first lane also those before its own), as
//    ScanBatch lays the lanes out, in block order. Nothing is zeroed
//    first;
//  * the block size is planned from the card's occupancy at these
//    shared bytes (rows and tables): the widest block that leaves no
//    multiprocessor idle and keeps the most threads resident.
//
// Semantics held exactly to the reference:
//  * code length clen = min(1 + #(P >= limit[0..15]), 16) and symbol
//    index clip((P >> (16 - clen)) + delta[clen], 0, 255), the same
//    clamped lookup as `sym` (garbage bits never index out of range);
//  * a lane runs at most `steps` symbols and freezes at bit_end, so
//    reads past its own segment are inert; `ok` is cleared by any lane
//    that ends with pos < bit_end (step budget exhausted);
//  * emissions are masked at blk_limit and at zigzag position 64;
//  * DC diffs are integrated per component from 0 at the segment start,
//    and blocks of the segment the lane never reached carry the last
//    predictor (the reference's scan adds zero diffs there).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "huffman_lut.cuh"

namespace {

using picha::lut_build_kernel;
using picha::Run;
using picha::symbol_value;
using picha::table_smem;
using picha::Tabs;

constexpr int kMaxB = 64;                   // blocks per MCU handled here
constexpr int kPackedB = 16;                // slot -> component in a register
constexpr int kMaxThreads = 512;
constexpr int kWidths[] = {64, 128, 256, 512};  // the plan's block sizes
constexpr int kRowBytes = 256;              // a block's staged row
constexpr int kSmemTableLimit = 96 * 1024;  // tables in shared memory
constexpr unsigned kFull = 0xffffffffu;

// the wire's lane arrays and tables (ScanBatch.args() order)
struct Args {
  const uint32_t* words;
  const int* word_base;
  const int* bits;
  const int* blk_base;
  const int* blk_limit;
  const uint8_t* uid6;
  const int* limit;
  const int* delta;
  const int* hv;
  const int* comp_of;
  int n_uniq, B, n_lanes, steps, nw, rows;
  unsigned comp2;  // slot s -> component in bits 2s..2s+1 (B <= kPackedB)
};

// A row's cells sit in zigzag order, 16-byte chunks swizzled by the
// thread that builds it: zigzag position p of thread t's row at this index.
__device__ __forceinline__ int cell_at(int p, int sw) {
  return (((p >> 2) ^ sw) << 2) | (p & 3);
}

// Row blk of the output from the thread's shared row (`cells`, swizzle
// sw), in natural order through nat_s (natural index -> zigzag
// position); the row is cleared.
__device__ __forceinline__ void store_row(int* out, int blk, int* cells, int sw,
                                          const int* nat_s) {
  int4* dst = reinterpret_cast<int4*>(out + static_cast<int64_t>(blk) * 64);
#pragma unroll 4
  for (int c = 0; c < 16; ++c)
    dst[c] = make_int4(cells[cell_at(nat_s[4 * c], sw)], cells[cell_at(nat_s[4 * c + 1], sw)],
                       cells[cell_at(nat_s[4 * c + 2], sw)], cells[cell_at(nat_s[4 * c + 3], sw)]);
  int4* row = reinterpret_cast<int4*>(cells);
#pragma unroll
  for (int c = 0; c < 16; ++c) row[c] = make_int4(0, 0, 0, 0);
}

// Row blk of the output: zeros but its DC.
__device__ __forceinline__ void dc_row(int* out, int blk, int dc) {
  int4* dst = reinterpret_cast<int4*>(out + static_cast<int64_t>(blk) * 64);
  dst[0] = make_int4(dc, 0, 0, 0);
#pragma unroll
  for (int c = 1; c < 16; ++c) dst[c] = make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ int pick(int c, int p0, int p1, int p2, int p3) {
  return c == 0 ? p0 : c == 1 ? p1 : c == 2 ? p2 : p3;
}

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads) restart_decode_kernel(
    Args a, const unsigned* __restrict__ lut, int* __restrict__ out, int* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int comp_s[kMaxB];
  __shared__ int zz_s[64];
  __shared__ int nat_s[64];
  const Tabs tb = picha::load_tables<kSmem>(lut, a.limit, a.delta, a.hv, a.n_uniq, a.comp_of,
                                            a.B, smem + blockDim.x * kRowBytes, comp_s, zz_s);
  int* const cells = reinterpret_cast<int*>(smem) + threadIdx.x * 64;
  const int sw = threadIdx.x & 15;
#pragma unroll
  for (int c = 0; c < 16; ++c) reinterpret_cast<int4*>(cells)[c] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < 64; i += blockDim.x) nat_s[zz_s[i]] = i;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31) >= a.n_lanes) return;  // the whole warp is past the end
  const bool real = lane < a.n_lanes;

  int base = 0, bits = 0, blk_base = 0, seg_end = 0;
  unsigned long long uid = 0;  // the lane's 6 table-row ids, byte t = row t
  if (real) {
    base = a.word_base[lane];
    bits = a.bits[lane];
    blk_base = a.blk_base[lane];
    seg_end = min(max(a.blk_limit[lane], blk_base), a.rows);
    for (int t = 0; t < 6; ++t)
      uid |= static_cast<unsigned long long>(a.uid6[lane * 6 + t]) << (8 * t);
  }
  const auto word = [&](int i) { return i < a.nw ? __ldg(a.words + i) : 0u; };
  int comp = 0;
  const auto rows = [&](Run& x) {
    comp = a.B <= kPackedB ? static_cast<int>((a.comp2 >> (2 * x.slot)) & 3u) : comp_s[x.slot];
    x.dc = static_cast<int>((uid >> (16 * comp)) & 0xffu);
    x.ac = static_cast<int>((uid >> (16 * comp + 8)) & 0xffu);
  };
  Run r;
  r.pos = base * 32;
  r.slot = 0;
  r.z = 0;
  r.cnt = 0;
  r.blocks = 0;
  r.wl = base;
  r.w0 = word(base);
  r.w1 = word(base + 1);
  r.w2 = word(base + 2);
  rows(r);
  const int bit_end = r.pos + bits;
  int p0 = 0, p1 = 0, p2 = 0, p3 = 0;  // DC predictors by component
  int blk = blk_base;                  // the block being built
  int* const warp_rows = reinterpret_cast<int*>(smem) + (threadIdx.x & ~31) * 64;
  const int lid = threadIdx.x & 31;
  // the zigzag positions of the two natural cells this lane stores of a
  // row the warp stores
  const int q0 = nat_s[2 * lid], q1 = nat_s[2 * lid + 1];

  for (;;) {
    const bool live = r.cnt < a.steps && r.pos < bit_end;
    if (!__any_sync(kFull, live)) break;
    bool store = false;
    int done = 0;  // the block a symbol ended
    if (live) {
      const int z = r.z;
      uint32_t w32;
      const unsigned e = picha::step(tb, a.B, r, w32, word, rows);
      int zc, v;
      const bool emit = symbol_value(e, z, w32, zc, v) && blk < seg_end;
      // a DC never ends its block, so comp is its component: the value
      // becomes the running predictor (selects, no branch)
      const bool dc = emit && z == 0;
      const int pv = pick(comp, p0, p1, p2, p3) + v;
      v = z == 0 ? pv : v;
      p0 = dc && comp == 0 ? pv : p0;
      p1 = dc && comp == 1 ? pv : p1;
      p2 = dc && comp == 2 ? pv : p2;
      p3 = dc && comp == 3 ? pv : p3;
      if (emit) cells[cell_at(zc, sw)] = v;
      const bool ended = r.z == 0;  // the symbol ended block blk
      done = blk;
      blk += ended ? 1 : 0;
      store = ended && done < seg_end;  // (a row holds values only below seg_end)
    }
    unsigned todo = __ballot_sync(kFull, store);
    if (todo) {
      __syncwarp();
      while (todo) {  // a finished row an instruction: 8 bytes a thread
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int b = __shfl_sync(kFull, done, src);
        int* s = warp_rows + src * 64;
        const int i0 = cell_at(q0, src & 15), i1 = cell_at(q1, src & 15);
        reinterpret_cast<int2*>(out + static_cast<int64_t>(b) * 64)[lid] =
            make_int2(s[i0], s[i1]);
        s[i0] = 0;
        s[i1] = 0;
      }
      __syncwarp();
    }
  }
  if (!real) return;
  if (r.pos < bit_end) *ok = 0;  // step budget ran out: malformed stream

  // the block the decode stopped inside, then the blocks of the segment
  // it never reached: zeros and the running DC
  if (r.z > 0) {
    if (blk < seg_end) store_row(out, blk, cells, sw, nat_s);
    ++blk;
  }
  for (; blk < seg_end; ++blk) {
    const int s = (blk - blk_base) % a.B;
    const int c = a.B <= kPackedB ? static_cast<int>((a.comp2 >> (2 * s)) & 3u) : comp_s[s];
    dc_row(out, blk, pick(c, p0, p1, p2, p3));
  }
  // the rows no lane holds: before the first lane's segment, and from
  // this segment's end to the next lane's first block
  if (lane == 0)
    for (int b = 0; b < min(blk_base, a.rows); ++b) dc_row(out, b, 0);
  const int next = lane + 1 < a.n_lanes ? min(a.blk_base[lane + 1], a.rows) : a.rows;
  for (int b = seg_end; b < next; ++b) dc_row(out, b, 0);
}

// The launch: the tables in shared memory when they fit; of the block
// sizes kWidths, those whose grid leaves no multiprocessor idle, the one
// that keeps the most threads resident (the narrower on a tie); if none
// fills the card, the narrowest that launches.
struct Plan {
  const void* fn;
  int threads, blocks, per_sm;
  size_t smem;
  bool in_smem;
};

constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);

size_t smem_of(int threads, int n_uniq, bool in_smem) {
  return static_cast<size_t>(threads) * kRowBytes + (in_smem ? table_smem(n_uniq) : 0);
}

// The card's part of a plan: its multiprocessors and each width's
// resident blocks (0: the card refuses it). Asked once a device and
// table count; the kernel's shared-memory limit is set once, to the most
// any width and table count needs, so no launch lowers another's.
struct Card {
  int sms;
  int per_sm[kNumWidths];
};

cudaError_t card_of(const void* fn, int n_uniq, bool in_smem, Card* out) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, Card> cards;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const std::pair<int, int> key(dev, in_smem ? n_uniq : 0);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cards.find(key);
  if (it == cards.end()) {
    Card c{};
    int optin = 0;
    rc = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const size_t most = static_cast<size_t>(kMaxThreads) * kRowBytes +
                        (in_smem ? static_cast<size_t>(kSmemTableLimit) : 0);
    const size_t limit = std::min(most, static_cast<size_t>(optin));
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(limit));
    for (int k = 0; k < kNumWidths && rc == cudaSuccess; ++k) {
      const size_t smem = smem_of(kWidths[k], n_uniq, in_smem);
      if (smem <= limit)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm[k], fn, kWidths[k], smem);
    }
    if (rc != cudaSuccess) return rc;
    it = cards.emplace(key, c).first;
  }
  *out = it->second;
  return cudaSuccess;
}

cudaError_t plan_of(int n_uniq, int n_lanes, Plan* out) {
  Plan p{nullptr, 0, 0, 0, 0, false};
  p.in_smem = table_smem(n_uniq) <= static_cast<size_t>(kSmemTableLimit);
  p.fn = p.in_smem ? reinterpret_cast<const void*>(restart_decode_kernel<true>)
                   : reinterpret_cast<const void*>(restart_decode_kernel<false>);
  Card c;
  const cudaError_t rc = card_of(p.fn, n_uniq, p.in_smem, &c);
  if (rc != cudaSuccess) return rc;
  bool best_fills = false;
  int best_resident = 0;
  for (int k = 0; k < kNumWidths; ++k) {
    const int t = kWidths[k];
    if (c.per_sm[k] < 1) continue;
    const int blocks = (n_lanes + t - 1) / t;
    const bool fills = blocks >= c.sms;
    const int resident = c.per_sm[k] * t;
    const bool better = p.threads == 0 || (fills && !best_fills) ||
                        (fills && best_fills && resident > best_resident);
    if (better) {
      p.threads = t;
      p.blocks = blocks;
      p.per_sm = c.per_sm[k];
      p.smem = smem_of(t, n_uniq, p.in_smem);
      best_fills = fills;
      best_resident = resident;
    }
  }
  if (p.threads == 0) return cudaErrorLaunchOutOfResources;
  *out = p;
  return cudaSuccess;
}

}  // namespace

// lut: n_uniq * picha::kRowLut uint32, 16-byte aligned (no zeroing
// needed: built here);
// out: (rows, 64) int32, every cell written (no zeroing needed); ok: one
// int32 set to 1 by the caller. comp2: comp_of packed 2 bits a slot (read
// when B <= 16). Launches the table build and the decode on `stream`.
// Returns the first launch error, else cudaGetLastError().
extern "C" int picha_huffman_decode_restart(
    const void* words, const void* lane_word_base, const void* lane_bits,
    const void* lane_blk_base, const void* lane_blk_limit, const void* limit,
    const void* delta, const void* hv, int n_uniq, const void* lane_uid6,
    const void* comp_of, int comp2, int B, int n_lanes, int steps, int nw, void* lut,
    void* out, int rows, void* ok, void* stream) {
  if (B < 1 || B > kMaxB || n_uniq < 1 || n_lanes < 1 || nw < 0 || rows < 0 ||
      reinterpret_cast<uintptr_t>(lut) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const uint32_t*>(words),
         static_cast<const int*>(lane_word_base),
         static_cast<const int*>(lane_bits),
         static_cast<const int*>(lane_blk_base),
         static_cast<const int*>(lane_blk_limit),
         static_cast<const uint8_t*>(lane_uid6),
         static_cast<const int*>(limit),
         static_cast<const int*>(delta),
         static_cast<const int*>(hv),
         static_cast<const int*>(comp_of),
         n_uniq, B, n_lanes, steps, nw, rows, static_cast<unsigned>(comp2)};
  auto* lt = static_cast<unsigned*>(lut);
  lut_build_kernel<<<n_uniq, 256, 0, st>>>(a.limit, a.delta, a.hv, lt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  err = plan_of(n_uniq, n_lanes, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned* lc = lt;
  int* o = static_cast<int*>(out);
  int* okp = static_cast<int*>(ok);
  void* args[] = {&a, &lc, &o, &okp};
  err = cudaLaunchKernel(p.fn, dim3(p.blocks), dim3(p.threads), args, p.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K1's build and plan at n_uniq table rows and n_lanes lanes: out[0..8]
// registers, local bytes a thread, static and dynamic shared bytes a
// block, resident blocks a multiprocessor, threads a block, grid, tables
// in shared memory (0 / 1).
extern "C" int picha_huffman_decode_restart_info(int n_uniq, int n_lanes, int* out) {
  Plan p;
  cudaError_t err = plan_of(n_uniq, n_lanes, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, p.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = static_cast<int>(p.smem);
  out[4] = p.per_sm;
  out[5] = p.threads;
  out[6] = p.blocks;
  out[7] = p.in_smem ? 1 : 0;
  return static_cast<int>(cudaGetLastError());
}
