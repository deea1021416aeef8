// K1: baseline JPEG Huffman decode, one thread per restart segment.
//
// Replaces: picha_tpu/ops/jpeg_huffman_decode_tpu.py::build_decoder_core
// in single-pass mode (ScanBatch.single_pass: every lane is a whole
// restart segment whose entry state is exact), including the zigzag to
// natural permutation and the per-component DC segmented scan. The TPU
// graph decodes all lanes in lockstep, emits (slot, coef, value) rows
// and densifies them with one-hot matmuls because scatters serialise
// there; a GPU thread writes each coefficient straight to its cell.
//
// What bounds it on an H100: the decode is a serial chain of dependent
// table lookups per segment (bit window -> code length -> symbol ->
// value bits), so it is latency bound, not bandwidth bound: ~16k lanes
// are ~1/4 of the threads the card can keep resident, and threads of a
// warp finish at different times (segment lengths differ). The design
// keeps every lookup on chip: the U unique table rows (limit, delta,
// hv: U*289 ints) sit in shared memory when they fit (40 KB), else they
// are read from global memory (L1/L2 resident); the 64-bit bit window
// reads two big-endian words per symbol. Making it fast (warp-
// cooperative decode, length-sorted lanes) is later work.
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

#include "huffman_symbol.cuh"

namespace {

using picha::decode_symbol;
using picha::kRowInts;
using picha::kZigzag;
using picha::Symbol;

constexpr int kMaxB = 64;                // blocks per MCU handled here
constexpr int kMaxComp = 4;
constexpr int kThreads = 64;
constexpr int kSmemTableLimit = 40 * 1024;  // + static smem stays < 48 KB

__global__ void huffman_decode_restart_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ lane_word_base,
    const int* __restrict__ lane_bits, const int* __restrict__ lane_blk_base,
    const int* __restrict__ lane_blk_limit, const int* __restrict__ g_limit,
    const int* __restrict__ g_delta, const int* __restrict__ g_hv, int n_uniq,
    const uint8_t* __restrict__ lane_uid6, const int* __restrict__ g_comp_of,
    int B, int n_lanes, int steps, int tables_in_smem, int* __restrict__ out,
    int* __restrict__ ok) {
  extern __shared__ int smem[];
  __shared__ int comp_of[kMaxB];
  const int* lim_t = g_limit;
  const int* dlt_t = g_delta;
  const int* hv_t = g_hv;
  if (tables_in_smem) {
    int* s_lim = smem;
    int* s_dlt = smem + n_uniq * 16;
    int* s_hv = smem + n_uniq * 33;
    for (int i = threadIdx.x; i < n_uniq * 16; i += blockDim.x) s_lim[i] = g_limit[i];
    for (int i = threadIdx.x; i < n_uniq * 17; i += blockDim.x) s_dlt[i] = g_delta[i];
    for (int i = threadIdx.x; i < n_uniq * 256; i += blockDim.x) s_hv[i] = g_hv[i];
    lim_t = s_lim;
    dlt_t = s_dlt;
    hv_t = s_hv;
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) comp_of[i] = g_comp_of[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;

  int pos = lane_word_base[lane] * 32;
  const int bit_end = pos + lane_bits[lane];
  const int blk_base = lane_blk_base[lane];
  const int blk_limit = lane_blk_limit[lane];
  int uid6[6];
  for (int t = 0; t < 6; ++t) uid6[t] = lane_uid6[lane * 6 + t];
  int pred[kMaxComp] = {0, 0, 0, 0};
  int slot = 0, z = 0, nblk = 0;

  for (int i = 0; i < steps && pos < bit_end; ++i) {
    // 32-bit window at pos from two big-endian words
    const int wl = pos >> 5;
    const int b = pos & 31;
    const uint32_t w0 = words[wl];
    const uint32_t w32 = b ? (w0 << b) | (words[wl + 1] >> (32 - b)) : w0;
    const int comp = comp_of[slot];
    const int u = uid6[comp * 2 + (z > 0 ? 1 : 0)];
    const Symbol s = decode_symbol(w32, z, lim_t + u * 16, dlt_t + u * 17,
                                   hv_t + u * 256);
    const int blk = blk_base + nblk;
    if (s.has_value && blk < blk_limit) {
      int* cell = out + static_cast<int64_t>(blk) * 64;
      if (z == 0) {
        pred[comp] += s.val;
        cell[0] = pred[comp];
      } else {
        cell[kZigzag[s.z_coef]] = s.val;
      }
    }
    pos += s.adv;
    if (s.z_new >= 64) {
      z = 0;
      slot = (slot + 1 == B) ? 0 : slot + 1;
      ++nblk;
    } else {
      z = s.z_new;
    }
  }
  if (pos < bit_end) *ok = 0;  // step budget ran out: malformed stream

  // blocks of this segment never reached keep the running DC
  const int seg_nblk = blk_limit - blk_base;
  for (int k = nblk + (z > 0 ? 1 : 0); k < seg_nblk; ++k) {
    const int c = comp_of[k % B];
    if (pred[c] != 0) out[static_cast<int64_t>(blk_base + k) * 64] = pred[c];
  }
}

}  // namespace

// out: zeroed (n_blk_total, 64) int32; ok: one int32 set to 1 by the
// caller. Returns cudaGetLastError() after the launch.
extern "C" int picha_huffman_decode_restart(
    const void* words, const void* lane_word_base, const void* lane_bits,
    const void* lane_blk_base, const void* lane_blk_limit, const void* limit,
    const void* delta, const void* hv, int n_uniq, const void* lane_uid6,
    const void* comp_of, int B, int n_lanes, int steps, void* out, void* ok,
    void* stream) {
  if (B < 1 || B > kMaxB || n_uniq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t table_bytes = static_cast<size_t>(n_uniq) * kRowInts * sizeof(int);
  const int in_smem = table_bytes <= static_cast<size_t>(kSmemTableLimit) ? 1 : 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  if (blocks > 0) {
    huffman_decode_restart_kernel<<<blocks, kThreads, in_smem ? table_bytes : 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int*>(lane_word_base),
        static_cast<const int*>(lane_bits), static_cast<const int*>(lane_blk_base),
        static_cast<const int*>(lane_blk_limit), static_cast<const int*>(limit),
        static_cast<const int*>(delta), static_cast<const int*>(hv), n_uniq,
        static_cast<const uint8_t*>(lane_uid6), static_cast<const int*>(comp_of), B,
        n_lanes, steps, in_smem, static_cast<int*>(out), static_cast<int*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
