// One baseline Huffman symbol, as the reference's lockstep `sym` step
// (picha_tpu/ops/jpeg_huffman_decode_tpu.py::build_decoder_core) decodes
// it: the exact 16-compare table rule. K1 (huffman_decode_restart.cu) and
// K4 (huffman_decode_chunked.cu) look most codes up in tables of their
// first bits (huffman_lut.cuh), built from this rule, and take it
// directly for the rest. The plain twin is
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

}  // namespace
}  // namespace picha
