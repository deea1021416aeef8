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
// What bounds it on an H100: the decode is a serial chain of dependent
// loads per lane (bit window -> code length -> symbol -> value bits), so
// it is latency bound: ~10k lanes at 16 x 1080p are a few percent of the
// threads the card keeps resident, and a pass lasts as long as its
// longest lane (~C / 5 symbols). After the first two passes only the
// unsynchronised frontier of lanes has a new entry, yet every pass still
// costs a launch and its slowest live lane.
//
// What the design does about it:
//  * one thread per lane, the U unique table rows in shared memory (as
//    K1), the symbol decode shared with K1 (huffman_symbol.cuh);
//  * exact Jacobi with one launch per pass: exits are double-buffered by
//    pass parity, so pass p reads only pass p-1's exits of the previous
//    lane (propagating inside a pass would converge in fewer passes and
//    change `ok` at the max_passes bound);
//  * frontier: a lane whose new entry equals its previous entry copies
//    its stored exit instead of decoding (the reference's compaction in
//    meaning; identical exits);
//  * no host sync: all max_passes pass launches are enqueued at once;
//    each returns at its first instruction once the change flag of the
//    pass before last is clear (the fixpoint was reached);
//  * block starts are a hand-written single-block scan of the per-lane
//    block counts; the emission pass re-decodes each lane from its
//    converged entry straight into the zeroed output (no (steps, L)
//    emission buffers, no placement): lanes that share a boundary block
//    write disjoint cells. Writes are bounded by the exact block start
//    blk_start + nblk < blk_limit, so a segment's last chunk decoding the
//    1-bit padding writes nothing into the next image.
// Length-sorted lanes, a warp-cooperative decode and a CUDA graph or a
// persistent kernel for the pass loop are later work.
//
// Semantics held exactly to the reference (and to the plain twin
// picha_tpu_torch/ops/jpeg_huffman_decode.py::decode_scan_chunked_plain):
//  * a lane reads only the words of its window [word_base, word_base +
//    C/32 + 2); reads outside it give 0 bits, as the reference's window
//    gather does (an entry taken from an overflowed lane points before
//    the window);
//  * a pass decodes at most `steps` symbols per lane and stops at
//    bit_end; exit offset = pos - (word_base*32 + C), overflow = pos <
//    bit_end;
//  * passes run while an entry changed, at most max_passes; ok = the
//    last propagation changed nothing and no lane overflowed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_symbol.cuh"

namespace {

using picha::decode_symbol;
using picha::kRowInts;
using picha::kZigzag;
using picha::Symbol;

constexpr int kMaxB = 64;                   // blocks per MCU handled here
constexpr int kMaxComp = 4;
constexpr int kThreads = 64;                // per-lane launches
constexpr int kScanThreads = 1024;          // single-block scans
constexpr int kSmemTableLimit = 40 * 1024;  // + static smem stays < 48 KB
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
};

// carved from the caller's zeroed int32 workspace: 13 lane arrays, then
// max_passes change flags, then one overflow flag
struct Work {
  int* ent[3];     // the entry (off, slot, z) of each lane's last pass
  int* ex[2][3];   // exits by pass parity
  int* nblk;       // blocks the lane's last decode ended
  int* over;       // 1: its last decode stopped short of bit_end
  int* blk_start;  // first block the lane writes
  int* prev;       // exclusive prefix of nblk over all lanes
  int* chg;        // chg[p] = 1: propagating pass p's exits changed an entry
  int* flags;      // [0]: some lane's last decode overflowed
};

Work carve(int* w, int n_lanes, int max_passes) {
  Work k;
  for (int i = 0; i < 3; ++i, w += n_lanes) k.ent[i] = w;
  for (int p = 0; p < 2; ++p)
    for (int i = 0; i < 3; ++i, w += n_lanes) k.ex[p][i] = w;
  k.nblk = w;
  w += n_lanes;
  k.over = w;
  w += n_lanes;
  k.blk_start = w;
  w += n_lanes;
  k.prev = w;
  w += n_lanes;
  k.chg = w;
  k.flags = w + max_passes;
  return k;
}

struct Tables {
  const int* lim;
  const int* dlt;
  const int* hv;
};

// Loads comp_of (and the table rows, when they fit) into shared memory;
// the caller synchronises before use.
__device__ Tables load_tables(const Wire& wr, int* smem, int* comp_s,
                              int in_smem) {
  for (int i = threadIdx.x; i < wr.B; i += blockDim.x) comp_s[i] = wr.comp_of[i];
  if (!in_smem) return Tables{wr.limit, wr.delta, wr.hv};
  const int n = wr.n_uniq;
  for (int i = threadIdx.x; i < n * 16; i += blockDim.x) smem[i] = wr.limit[i];
  for (int i = threadIdx.x; i < n * 17; i += blockDim.x) smem[n * 16 + i] = wr.delta[i];
  for (int i = threadIdx.x; i < n * 256; i += blockDim.x) smem[n * 33 + i] = wr.hv[i];
  return Tables{smem, smem + n * 16, smem + n * 33};
}

struct LaneEnd {
  int pos, slot, z, nblk;
};

// Decodes one lane from entry (off, slot, z): at most `steps` symbols,
// stopping once pos reaches the lane's bit_end. With `out`, every value
// lands in natural order in block blk_start + (blocks ended so far)
// while that block is below the lane's blk_limit.
__device__ LaneEnd decode_lane(const Wire& wr, const Tables& tb,
                               const int* comp_s, int lane, int off, int slot,
                               int z, int* __restrict__ out, int blk_start) {
  const int base = wr.word_base[lane];
  int pos = base * 32 + off;
  const int bit_end = base * 32 + wr.bits[lane];
  const int blk_limit = wr.blk_limit[lane];
  int uid6[6];
  for (int t = 0; t < 6; ++t) uid6[t] = wr.uid6[lane * 6 + t];
  int nblk = 0;
  for (int i = 0; i < wr.steps && pos < bit_end; ++i) {
    // 32-bit window at pos; words outside the lane's window read as 0
    const int wl = pos >> 5;
    const int rel = wl - base;
    const uint32_t w0 = (rel >= 0 && rel < wr.W) ? wr.words[wl] : 0u;
    const uint32_t w1 = (rel + 1 >= 0 && rel + 1 < wr.W) ? wr.words[wl + 1] : 0u;
    const int b = pos & 31;
    const uint32_t w32 = b ? (w0 << b) | (w1 >> (32 - b)) : w0;
    const int u = uid6[comp_s[slot] * 2 + (z > 0 ? 1 : 0)];
    const Symbol s = decode_symbol(w32, z, tb.lim + u * 16, tb.dlt + u * 17,
                                   tb.hv + u * 256);
    if (out != nullptr && s.has_value) {
      const int blk = blk_start + nblk;
      if (blk < blk_limit) out[static_cast<int64_t>(blk) * 64 + kZigzag[s.z_coef]] = s.val;
    }
    pos += s.adv;
    if (s.z_new >= 64) {
      z = 0;
      slot = (slot + 1 == wr.B) ? 0 : slot + 1;
      ++nblk;
    } else {
      z = s.z_new;
    }
  }
  return LaneEnd{pos, slot, z, nblk};
}

// The entry pass p gives `lane`: the previous lane's exit of pass p-1,
// or (0, 0, 0) on the first pass and for segment-first (pinned) lanes.
__device__ void next_entry(const Wire& wr, const Work& wk, int lane, int p,
                           int e[3]) {
  e[0] = e[1] = e[2] = 0;
  if (p > 0 && lane > 0 && !wr.pinned[lane]) {
    const int par = (p - 1) & 1;
    for (int k = 0; k < 3; ++k) e[k] = wk.ex[par][k][lane - 1];
  }
}

// One Jacobi pass: propagation of pass p-1's exits, then the decode of
// every lane whose entry changed.
__global__ void chunk_pass_kernel(Wire wr, Work wk, int p, int in_smem) {
  // chg[p-2] clear: pass p-1 changed no entry, the fixpoint is reached
  if (p >= 2 && wk.chg[p - 2] == 0) return;
  extern __shared__ int smem[];
  __shared__ int comp_s[kMaxB];
  const Tables tb = load_tables(wr, smem, comp_s, in_smem);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= wr.n_lanes) return;
  const int cur = p & 1;
  int e[3];
  next_entry(wr, wk, lane, p, e);
  if (p > 0) {
    if (e[0] == wk.ent[0][lane] && e[1] == wk.ent[1][lane] && e[2] == wk.ent[2][lane]) {
      for (int k = 0; k < 3; ++k) wk.ex[cur][k][lane] = wk.ex[cur ^ 1][k][lane];
      return;  // same entry, same exit
    }
    wk.chg[p - 1] = 1;
  }
  for (int k = 0; k < 3; ++k) wk.ent[k][lane] = e[k];
  const LaneEnd x = decode_lane(wr, tb, comp_s, lane, e[0], e[1], e[2], nullptr, 0);
  const int start = wr.word_base[lane] * 32;
  wk.ex[cur][0][lane] = x.pos - (start + wr.C);
  wk.ex[cur][1][lane] = x.slot;
  wk.ex[cur][2][lane] = x.z;
  wk.nblk[lane] = x.nblk;
  wk.over[lane] = x.pos < start + wr.bits[lane] ? 1 : 0;
}

// After the last pass: collects overflow, and when every pass changed an
// entry, whether propagating the last pass's exits changes one more.
__global__ void chunk_settle_kernel(Wire wr, Work wk, int max_passes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= wr.n_lanes) return;
  if (wk.over[lane]) wk.flags[0] = 1;
  for (int j = 0; j + 1 < max_passes; ++j)
    if (wk.chg[j] == 0) return;  // converged within the budget
  int e[3];
  next_entry(wr, wk, lane, max_passes, e);
  if (e[0] != wk.ent[0][lane] || e[1] != wk.ent[1][lane] || e[2] != wk.ent[2][lane])
    wk.chg[max_passes - 1] = 1;
}

// segmented-sum scan element: s = sum since the last reset, f = a reset
// happened in the span
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

// One block: blk_start[i] = blk_base[i] + (blocks ended by the lanes of
// i's segment before i), and info = (ok, passes run, overflow).
__global__ void chunk_block_start_kernel(Wire wr, Work wk, int max_passes,
                                         int* __restrict__ info) {
  __shared__ Seg sh[32];
  const int L = wr.n_lanes;
  const int per = (L + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, L);
  const int hi = min(lo + per, L);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += wk.nblk[i];
  int acc = block_exclusive(Seg{sum, 0}, sh).s;
  for (int i = lo; i < hi; ++i) {
    wk.prev[i] = acc;
    acc += wk.nblk[i];
  }
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const int f = min(max(wr.seg_first[i], 0), L - 1);
    wk.blk_start[i] = wr.blk_base[i] + wk.prev[i] - wk.prev[f];
  }
  if (threadIdx.x == 0) {
    int passes = max_passes, converged = 0;
    for (int j = 0; j < max_passes; ++j) {
      if (wk.chg[j] == 0) {
        passes = j + 1;
        converged = 1;
        break;
      }
    }
    info[0] = converged && !wk.flags[0];
    info[1] = passes;
    info[2] = wk.flags[0];
  }
}

// Emission: every lane again from its converged entry, values straight
// into the zeroed output (DC still as diffs).
__global__ void chunk_emit_kernel(Wire wr, Work wk, int* __restrict__ out,
                                  int in_smem) {
  extern __shared__ int smem[];
  __shared__ int comp_s[kMaxB];
  const Tables tb = load_tables(wr, smem, comp_s, in_smem);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= wr.n_lanes) return;
  decode_lane(wr, tb, comp_s, lane, wk.ent[0][lane], wk.ent[1][lane],
              wk.ent[2][lane], out, wk.blk_start[lane]);
}

// K5: one block per image. Per component, a segmented inclusive sum of
// the DC diffs over the image's blocks in scan order, restarting where
// blk % ri_blk is the component's first MCU slot.
__global__ void dc_integrate_kernel(int* __restrict__ out,
                                    const int* __restrict__ g_comp_of,
                                    const int* __restrict__ ri_blk,
                                    int nblk_img, int B) {
  __shared__ int comp_s[kMaxB];
  __shared__ int first_s[kMaxComp];
  __shared__ Seg sh[32];
  if (threadIdx.x == 0) {
    for (int c = 0; c < kMaxComp; ++c) first_s[c] = -1;
    for (int s = 0; s < B; ++s) {
      const int c = g_comp_of[s];
      comp_s[s] = c;
      if (c >= 0 && c < kMaxComp && first_s[c] < 0) first_s[c] = s;
    }
  }
  __syncthreads();
  int* dc = out + static_cast<int64_t>(blockIdx.x) * nblk_img * 64;
  const int ri = max(ri_blk[blockIdx.x], 1);
  const int per = (nblk_img + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, nblk_img);
  const int hi = min(lo + per, nblk_img);
  Seg loc[kMaxComp];
  for (int c = 0; c < kMaxComp; ++c) loc[c] = Seg{0, 0};
  for (int b = lo; b < hi; ++b) {
    const int c = comp_s[b % B];
    if (c < 0 || c >= kMaxComp) continue;
    const int d = dc[static_cast<int64_t>(b) * 64];
    loc[c] = (b % ri == first_s[c]) ? Seg{d, 1} : Seg{loc[c].s + d, loc[c].f};
  }
  int carry[kMaxComp];
  for (int c = 0; c < kMaxComp; ++c) carry[c] = block_exclusive(loc[c], sh).s;
  for (int b = lo; b < hi; ++b) {
    const int c = comp_s[b % B];
    if (c < 0 || c >= kMaxComp) continue;
    int64_t cell = static_cast<int64_t>(b) * 64;
    carry[c] = (b % ri == first_s[c]) ? dc[cell] : carry[c] + dc[cell];
    dc[cell] = carry[c];
  }
}

}  // namespace

// work: zeroed int32, 13 * n_lanes + max_passes + 1; out: zeroed
// (n_blk_total, 64) int32, DC left as diffs (K5 integrates it); info:
// 3 int32 (ok, passes run, overflow). Launches max_passes pass kernels,
// then settle, block starts and emission, all on `stream`. Returns the
// first launch error, else cudaGetLastError().
extern "C" int picha_huffman_decode_chunked(
    const void* words, const void* lane_word_base, const void* lane_bits,
    const void* lane_pinned, const void* lane_seg_first,
    const void* lane_blk_base, const void* lane_blk_limit, const void* limit,
    const void* delta, const void* hv, int n_uniq, const void* lane_uid6,
    const void* comp_of, int B, int n_lanes, int C, int steps,
    int max_passes, int nw, void* work, void* out, void* info,
    void* stream) {
  const int W = C / 32 + 2;
  if (B < 1 || B > kMaxB || n_uniq < 1 || n_lanes < 1 || max_passes < 1 ||
      C < 32 || C % 32 != 0 || nw < W)
    return static_cast<int>(cudaErrorInvalidValue);
  const Wire wr{static_cast<const uint32_t*>(words),
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
                n_uniq, B, n_lanes, C, W, steps};
  const Work wk = carve(static_cast<int*>(work), n_lanes, max_passes);
  const size_t table_bytes = static_cast<size_t>(n_uniq) * kRowInts * sizeof(int);
  const int in_smem = table_bytes <= static_cast<size_t>(kSmemTableLimit) ? 1 : 0;
  const size_t smem = in_smem ? table_bytes : 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int p = 0; p < max_passes; ++p) {
    chunk_pass_kernel<<<blocks, kThreads, smem, st>>>(wr, wk, p, in_smem);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chunk_settle_kernel<<<blocks, kThreads, 0, st>>>(wr, wk, max_passes);
  chunk_block_start_kernel<<<1, kScanThreads, 0, st>>>(wr, wk, max_passes,
                                                       static_cast<int*>(info));
  chunk_emit_kernel<<<blocks, kThreads, smem, st>>>(wr, wk, static_cast<int*>(out),
                                                    in_smem);
  return static_cast<int>(cudaGetLastError());
}

// out: (n_img, nblk_img, 64) int32 with DC diffs at [.., 0], integrated
// in place; comp_of: (B,) int32; ri_blk: (n_img,) int32.
extern "C" int picha_dc_integrate(void* out, const void* comp_of,
                                  const void* ri_blk, int n_img, int nblk_img,
                                  int B, void* stream) {
  if (B < 1 || B > kMaxB || n_img < 0 || nblk_img < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_img > 0 && nblk_img > 0) {
    dc_integrate_kernel<<<n_img, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), static_cast<const int*>(comp_of),
        static_cast<const int*>(ri_blk), nblk_img, B);
  }
  return static_cast<int>(cudaGetLastError());
}
