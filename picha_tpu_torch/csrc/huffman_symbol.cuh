// One baseline Huffman symbol, as the reference's lockstep `sym` step
// (picha_tpu/ops/jpeg_huffman_decode_tpu.py::build_decoder_core) decodes
// it. K1 (huffman_decode_restart.cu) decodes with it; K4
// (huffman_decode_chunked.cu) looks most codes up in tables of their
// first bits and takes the exact rule, `table_symbol`, for the rest. The
// plain twin is
// picha_tpu_torch/ops/jpeg_huffman_decode.py::_symbol.
#pragma once

#include <stdint.h>

namespace picha {
namespace {  // internal linkage: each .cu has its own copy

// zigzag position -> natural-order index
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kRowInts = 16 + 17 + 256;  // limit | delta | hv per table row

struct Symbol {
  int adv;         // bits consumed: code length + value bits
  int val;         // signed value (0 when the size is 0)
  int z_coef;      // zigzag position of the value (0 for a DC)
  int z_new;       // coefficient index after the symbol; >= 64 ends the block
  bool has_value;  // a DC, or an AC of nonzero size, inside the block
};

// The exact table rule: lim/dlt/hv the table row (16 exclusive
// left-aligned bounds, 17 valptr - mincode, 256 symbols). The code
// length is min(1 + #(P >= lim[k]), 16) for the top 16 bits P of w32,
// and the symbol index is clamped to 0..255, so any bit pattern decodes
// to something in range. Returns the symbol byte, the length in clen.
__device__ __forceinline__ int table_symbol(uint32_t w32, const int* lim,
                                            const int* dlt, const int* hv,
                                            int& clen) {
  const int P = static_cast<int>(w32 >> 16);
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) cnt += (P >= lim[k]) ? 1 : 0;
  clen = min(1 + cnt, 16);
  int idx = (P >> (16 - clen)) + dlt[clen];
  idx = min(max(idx, 0), 255);
  return hv[idx];
}

// w32: the 32 stream bits from the symbol's first bit, MSB first. z: the
// coefficient index before it (0 = DC). lim/dlt/hv: the table row.
__device__ __forceinline__ Symbol decode_symbol(uint32_t w32, int z,
                                                const int* lim,
                                                const int* dlt,
                                                const int* hv) {
  int clen;
  const int sym = table_symbol(w32, lim, dlt, hv, clen);
  const int run = z > 0 ? (sym >> 4) : 0;
  const int size = sym & 15;
  Symbol s;
  s.val = 0;
  if (size > 0) {
    s.val = static_cast<int>((w32 << clen) >> (32 - size));
    if (s.val < (1 << (size - 1))) s.val = s.val - (1 << size) + 1;
  }
  const bool is_dc = z == 0;
  const bool is_eob = !is_dc && size == 0 && run != 15;
  const bool is_zrl = !is_dc && size == 0 && run == 15;
  s.z_coef = is_dc ? 0 : z + run;
  s.z_new = is_dc ? 1 : (is_eob ? 64 : (is_zrl ? z + 16 : z + run + 1));
  s.has_value = (is_dc || size > 0) && s.z_coef < 64;
  s.adv = clen + size;
  return s;
}

}  // namespace
}  // namespace picha
