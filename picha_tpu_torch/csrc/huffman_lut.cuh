// The two-level lookup of a baseline Huffman symbol and the decode step
// that K1 (huffman_decode_restart.cu) and K4 (huffman_decode_chunked.cu)
// both take. Each symbol is one load of a 2^10-entry table of its first
// bits, one table per unique table row, built on the card from the wire's
// rows; the longer codes of a prefix go through a second 64-entry table
// of the next 6 bits (up to 16 such prefixes a row) and, past that, the
// exact 16-compare rule of huffman_symbol.cuh. Every entry is the exact
// rule's symbol for every stream whose bits it covers, so the decode is
// bit for bit the reference's `sym` step and the plain twin
// picha_tpu_torch/ops/jpeg_huffman_decode.py::_symbol.
#pragma once

#include <stdint.h>

#include "huffman_symbol.cuh"

namespace picha {
namespace {  // internal linkage: each .cu has its own copy

constexpr int kLutBits = 10;                // first bits a table entry
constexpr int kLutSize = 1 << kLutBits;
constexpr int kSubBits = 6;                 // the next bits, long codes
constexpr int kSubTables = 16;              // long-code prefixes a row
constexpr int kSubSize = kSubTables << kSubBits;
constexpr int kRowLut = kLutSize + kSubSize;  // entries a row
constexpr unsigned kFullMask = 0xffffffffu;

// A symbol as a table entry: bits 0-4 the bits it takes (code + value),
// 5-9 the code length, 10-16 the coefficient-index step it makes in an
// AC position (run + 1; 16 for ZRL; 64 for EOB, which ends the block),
// 24-31 the symbol byte. Never 0 in bits 0-4 (a code is >= 1 bit). An
// entry with bits 0-4 zero sends the lookup on: to sub-table i (bit 5
// set, i in bits 6-9) of the next kSubBits bits, or (0) to the exact
// rule.
__device__ __forceinline__ unsigned pack_entry(int clen, int sym) {
  const int size = sym & 15, run = sym >> 4;
  const int zadd = size ? run + 1 : (run == 15 ? 16 : 64);
  return static_cast<unsigned>(clen + size) | (static_cast<unsigned>(clen) << 5) |
         (static_cast<unsigned>(zadd) << 10) | (static_cast<unsigned>(sym) << 24);
}

// The exact rule's symbol at the 16-bit window P as a table entry.
__device__ __forceinline__ unsigned exact_entry(int P, const int* lim,
                                                const int* dlt, const int* hv) {
  int clen;
  const int sym = table_symbol(static_cast<uint32_t>(P) << 16, lim, dlt, hv, clen);
  return pack_entry(clen, sym & 255);
}

// One block per unique table row: entry q of the first kLutBits bits is
// the symbol wherever the exact rule gives every 16-bit P with these
// first bits the same length <= kLutBits (#(P >= lim[k]) is monotone in
// P, so the ends of the range decide); the first kSubTables other
// prefixes, in order, get a sub-table of the exact rule at each of the
// next kSubBits bits; the rest 0.
__global__ void lut_build_kernel(const int* __restrict__ limit,
                                 const int* __restrict__ delta,
                                 const int* __restrict__ hv,
                                 unsigned* __restrict__ lut) {
  __shared__ int red[32];
  const int u = blockIdx.x;
  const int* lim = limit + u * 16;
  const int* dlt = delta + u * 17;
  const int* h = hv + u * 256;
  unsigned* row = lut + static_cast<size_t>(u) * kRowLut;
  int before = 0;  // long prefixes in the chunks before
  for (int q0 = 0; q0 < kLutSize; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    const int lo = q << (16 - kLutBits);
    const int hi = lo | ((1 << (16 - kLutBits)) - 1);
    int c_lo = 0, c_hi = 0;
    for (int k = 0; k < 16; ++k) {
      c_lo += lo >= lim[k] ? 1 : 0;
      c_hi += hi >= lim[k] ? 1 : 0;
    }
    const int clen = min(1 + c_lo, 16);
    const int idx = min(max((lo >> (16 - clen)) + dlt[clen], 0), 255);
    const int sym = h[idx];
    const bool fast = q < kLutSize && c_lo == c_hi && clen <= kLutBits &&
                      sym >= 0 && sym < 256;
    const bool longp = q < kLutSize && !fast;
    // rank of this long prefix among the row's long prefixes
    const unsigned bal = __ballot_sync(kFullMask, longp);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = __popc(bal);
    __syncthreads();
    int rank = before + __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += red[w];
    int total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += red[w];
    __syncthreads();
    before += total;
    if (q < kLutSize) {
      unsigned e = 0;
      if (fast) {
        e = pack_entry(clen, sym);
      } else if (rank < kSubTables) {
        e = (1u << 5) | (static_cast<unsigned>(rank) << 6);
        for (int j = 0; j < (1 << kSubBits); ++j)
          row[kLutSize + (rank << kSubBits) + j] = exact_entry(lo | j, lim, dlt, h);
      }
      row[q] = e;
    }
  }
}

struct Tabs {
  const unsigned* lut;  // n_uniq rows of kRowLut entries
  const int* lim;
  const int* dlt;
  const int* hv;
};

// Shared bytes of the lookup tables and table rows of n_uniq rows.
inline size_t table_smem(int n_uniq) {
  return static_cast<size_t>(n_uniq) * (kRowLut + kRowInts) * sizeof(int);
}

// The table entry of the 32 stream bits w32 under table row u.
__device__ __forceinline__ unsigned lookup(const Tabs& tb, int u, uint32_t w32) {
  const unsigned* row = tb.lut + u * kRowLut;
  unsigned e = row[w32 >> (32 - kLutBits)];
  if ((e & 31u) == 0) {
    if (e) {
      e = row[kLutSize + (((e >> 6) & 15u) << kSubBits) +
              ((w32 >> (32 - kLutBits - kSubBits)) & ((1u << kSubBits) - 1u))];
    } else {
      e = exact_entry(static_cast<int>(w32 >> 16), tb.lim + u * 16, tb.dlt + u * 17,
                      tb.hv + u * 256);
    }
  }
  return e;
}

// Loads comp_of (B slots), the zigzag order and (kSmem) the lookup tables
// and table rows of n rows into shared memory at `smem`; the caller
// synchronises. With the tables' address space fixed at compile time,
// their loads are shared-memory loads with 32-bit addresses, not generic
// ones. lut and smem are 16-byte aligned: the copy takes 16-byte loads,
// four in flight a thread (a narrow block copies ~37 KB).
template <bool kSmem>
__device__ __forceinline__ Tabs load_tables(const unsigned* lut, const int* limit,
                                            const int* delta, const int* hv, int n,
                                            const int* comp_of, int B, unsigned char* smem,
                                            int* comp_s, int* zz_s) {
  for (int i = threadIdx.x; i < B; i += blockDim.x) comp_s[i] = comp_of[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz_s[i] = kZigzag[i];
  if (!kSmem) return Tabs{lut, limit, delta, hv};
  unsigned* lut_s = reinterpret_cast<unsigned*>(smem);
  int* rows = reinterpret_cast<int*>(lut_s + n * kRowLut);
  const uint4* src = reinterpret_cast<const uint4*>(lut);
  uint4* dst = reinterpret_cast<uint4*>(lut_s);
#pragma unroll 4
  for (int i = threadIdx.x; i < n * (kRowLut / 4); i += blockDim.x) dst[i] = src[i];
#pragma unroll 4
  for (int i = threadIdx.x; i < n * 16; i += blockDim.x) rows[i] = limit[i];
#pragma unroll 4
  for (int i = threadIdx.x; i < n * 17; i += blockDim.x) rows[n * 16 + i] = delta[i];
#pragma unroll 4
  for (int i = threadIdx.x; i < n * 256; i += blockDim.x) rows[n * 33 + i] = hv[i];
  return Tabs{lut_s, rows, rows + n * 16, rows + n * 33};
}

// A decode in registers: its state, the symbols and blocks so far, the
// table rows of the current block's component (dc, ac) and the stream
// words wl, wl + 1 and wl + 2 around pos.
struct Run {
  int pos, slot, z, cnt, blocks, wl, dc, ac;
  uint32_t w0, w1, w2;
};

// One symbol: returns its table entry (the caller reads the value from
// w32 when it needs it) and moves r past it. word(i): stream word i;
// rows(r): sets r.dc, r.ac for r.slot. B: slots an MCU. No branch that a
// warp's lanes take apart: the words and the slot move on by selects, the
// next word's load is predicated, and rows(r) runs every symbol (the same
// rows while the block goes on).
template <class Word, class Rows>
__device__ __forceinline__ unsigned step(const Tabs& tb, int B, Run& r, uint32_t& w32,
                                         const Word& word, const Rows& rows) {
  w32 = __funnelshift_l(r.w1, r.w0, r.pos);  // the 32 bits from pos
  const unsigned e = lookup(tb, r.z ? r.ac : r.dc, w32);
  r.pos += static_cast<int>(e & 31u);
  ++r.cnt;
  const int zn = r.z ? r.z + static_cast<int>((e >> 10) & 127u) : 1;
  const bool on = (r.pos >> 5) != r.wl;  // at most one word on (a symbol < 32 bits)
  r.wl += on ? 1 : 0;
  r.w0 = on ? r.w1 : r.w0;
  r.w1 = on ? r.w2 : r.w1;
  if (on) r.w2 = word(r.wl + 2);
  const bool end = zn >= 64;
  r.z = end ? 0 : zn;
  r.slot = end ? (r.slot + 1 == B ? 0 : r.slot + 1) : r.slot;
  r.blocks += end ? 1 : 0;
  rows(r);
  return e;
}

// The value a symbol carries: (has, zigzag position, value).
__device__ __forceinline__ bool symbol_value(unsigned e, int z, uint32_t w32,
                                             int& zc, int& v) {
  const int clen = static_cast<int>((e >> 5) & 31u);
  const int sym = static_cast<int>(e >> 24);
  const int size = sym & 15;
  zc = z ? z + (sym >> 4) : 0;
  v = 0;
  if (size) {
    v = static_cast<int>((w32 << clen) >> (32 - size));
    if (v < (1 << (size - 1))) v += 1 - (1 << size);
  }
  return (z == 0 || size) && zc < 64;
}

}  // namespace
}  // namespace picha
