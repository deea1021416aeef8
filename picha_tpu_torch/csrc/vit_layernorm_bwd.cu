// K21: the backward of the ViT's LayerNorm (K17): dx, dscale and dbias.
//
// Replaces: the VJP that JAX derives from picha_tpu/models/vit.py::_ln
// (:145-152) inside jax.grad(loss_fn); XLA fuses it into the backward
// graph. With p = x - mu, r = sqrt(var + 1e-6), g = dy * scale (all f32):
//   dscale = sum over rows of (p / r) * dy,   dbias = sum over rows of dy,
//   dvar   = -(sum_k (g_k * r^-2) * p_k) * (0.5 / r) / d,
//   dx     = bf16((g / r + dvar * 2p) + (-(sum_k g_k / r) - sum_k dvar * 2p_k) / d),
// in that order of operations (JAX's derivative of the forward lines). It
// runs 2 x depth + 1 times per train step (25 at ViT-S/16).
//
// What bounds it on an H100: memory traffic. At the step's shape (256
// images x 196 tokens, d = 384) it reads x and dy (77 MB of bf16) and
// writes dx (38.5 MB): 0.0345 ms at HBM peak, against ~35 instructions an
// element, which at the card's issue rate take about as long: so the
// bytes must stream while the rows compute, and an element may cost no
// more than that. The design (the tuned path, even d <= 1024):
//   - ln_bwd_rows, one warp a row, the row's bf16 pairs spread over the
//     lanes (pair p on lane p % 32) as K17 holds them: mu and r
//     recomputed with K17's arithmetic (two passes, IEEE square root), so
//     they are the forward's own; the row sums by warp shuffles in a
//     fixed tree; dx rounded once to bf16. No FMA contraction
//     (__fmul_rn, __fadd_rn). Every true division is `div_by`
//     (resnet_norm.cuh), bit for bit __fdiv_rn: the two an element by the
//     row's r, with r's reciprocal refined once a row, and the four by d
//     with d's refined once a block.
//   - Each warp streams its rows through its own ring of kStages slots
//     in shared memory (cp.async, 16 bytes where rows and bases allow,
//     else 4): the next kStages - 1 rows' x and dy are in flight while a
//     row computes, and no registers hold them.
//   - The grid is planned from the card's occupancy (`plan`): as many
//     blocks as the multiprocessors hold at once, each taking one run of
//     consecutive rows (its warps interleaved over it), so every block
//     does the same work in one wave. A lane sums its columns' dscale and
//     dbias terms over its warp's rows in registers; the warps' sums meet
//     in shared memory in warp order and the block writes one partial a
//     column.
//   - ln_bwd_columns sums the blocks' partials of 32 columns a block: 32
//     groups of threads each add every 32nd partial in block order, then
//     one warp adds the 32 group sums in group order. No atomics: two
//     runs give the same bits.
// Widths outside the tuned envelope (odd, or past 1024) take a simpler
// path chosen by shape, with the same arithmetic: ln_bwd_row_any, one
// block of 256 threads a row, x and dy re-read from memory for each of
// its five passes (mu, r, the variance path's sum with -g / r, -dvar 2p,
// dx), the block's sums by warp shuffles and then the warps in order; it
// keeps each row's mu and r for ln_bwd_cols_any, one thread a column
// summing (p / r) dy and dy over a block's 256 rows in order into the same
// per-block partials, which ln_bwd_columns then sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "resnet_norm.cuh"

namespace {

using picha_norm::cp_async;
using picha_norm::cp_commit;
using picha_norm::cp_wait;
using picha_norm::div_by;
using picha_norm::rcp_refined;

constexpr int kWarps = 8;
constexpr int kStages = 4;           // rows in a warp's ring (kStages - 1 in flight)
constexpr int kRowsPerBlock = 256;   // rows a block of the any-width path sums
constexpr int kMaxPairs = 16;        // bf16 pairs a lane holds: d <= 1024
constexpr int kColTile = 32;         // columns a block of ln_bwd_columns sums
constexpr int kColGroups = 32;       // its groups of partials

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bytes of one row of one tensor in the ring (16-byte slots)
__host__ __device__ inline int ring_row_bytes(int d) { return (2 * d + 15) / 16 * 16; }

// dynamic shared bytes of ln_bwd_rows: the scale, then the warps' rings
inline size_t rows_smem(int d) {
  return static_cast<size_t>((4 * d + 15) / 16 * 16) +
         static_cast<size_t>(kWarps) * kStages * 2 * ring_row_bytes(d);
}

// NP: pairs a lane holds (pairs <= 32 * NP). Block b takes rows [b * per,
// min((b + 1) * per, rows)); warp w the rows w, w + kWarps, ... of them.
template <int NP>
__global__ void __launch_bounds__(kWarps * 32) ln_bwd_rows(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const __nv_bfloat16* __restrict__ dy, int64_t rows, int64_t per, int pairs, float d,
    int vec16, __nv_bfloat162* __restrict__ dx, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dd = 2 * pairs, rb = ring_row_bytes(dd);
  float* sc = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (4 * dd + 15) / 16 * 16;
  for (int c = threadIdx.x; c < dd; c += blockDim.x) sc[c] = scale[c];
  const float y1d = rcp_refined(d);

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t r1 = r0 + per < rows ? r0 + per : rows;
  const int count = r1 - r0 > warp ? static_cast<int>((r1 - r0 - warp + kWarps - 1) / kWarps) : 0;
  unsigned char* mine = ring + static_cast<size_t>(warp) * kStages * 2 * rb;
  const int chunks = vec16 ? dd / 8 : pairs;   // 16- or 4-byte copies a row

  // row j of this warp's into slot s (an empty group past the last row)
  auto issue = [&](int j, int s) {
    if (j < count) {
      const int64_t row = r0 + warp + static_cast<int64_t>(j) * kWarps;
      const unsigned char* gx = reinterpret_cast<const unsigned char*>(x + row * dd);
      const unsigned char* gg = reinterpret_cast<const unsigned char*>(dy + row * dd);
      unsigned char* sx = mine + static_cast<size_t>(s) * 2 * rb;
      if (vec16) {
        for (int c = lane; c < chunks; c += 32) {
          cp_async<16>(sx + 16 * c, gx + 16 * c);
          cp_async<16>(sx + rb + 16 * c, gg + 16 * c);
        }
      } else {
        for (int c = lane; c < chunks; c += 32) {
          cp_async<4>(sx + 4 * c, gx + 4 * c);
          cp_async<4>(sx + rb + 4 * c, gg + 4 * c);
        }
      }
    }
    cp_commit();
  };

  float2 ps[NP], pb[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) ps[i] = pb[i] = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s, s);
  __syncthreads();   // the scale

#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    __syncwarp();    // every lane is done with the slot issue() refills
    issue(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_wait<kStages - 1>();
    __syncwarp();    // every lane's copies of row j are in
    const uint32_t* wx = reinterpret_cast<const uint32_t*>(mine + (j % kStages) * 2 * rb);
    const uint32_t* wg = reinterpret_cast<const uint32_t*>(mine + (j % kStages) * 2 * rb + rb);
    const int64_t row = r0 + warp + static_cast<int64_t>(j) * kWarps;
    float2 v[NP], z[NP];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs) {
        const uint32_t a = wx[p], b = wg[p];
        v[i] = make_float2(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u));
        z[i] = make_float2(__uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
        s = __fadd_rn(__fadd_rn(s, v[i].x), v[i].y);
      }
    }
    const float mu = div_by(warp_sum(s), d, y1d);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (lane + 32 * i < pairs) {
        v[i].x = __fsub_rn(v[i].x, mu);
        v[i].y = __fsub_rn(v[i].y, mu);
        q = __fadd_rn(__fadd_rn(q, __fmul_rn(v[i].x, v[i].x)), __fmul_rn(v[i].y, v[i].y));
      }
    }
    const float r = __fsqrt_rn(__fadd_rn(div_by(warp_sum(q), d, y1d), 1e-6f));
    const float y1r = rcp_refined(r);
    const float u = __fdiv_rn(1.0f, __fmul_rn(r, r));
    // the sum through the variance, and the column sums
    float a = 0.0f, bq = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs) {
        const float2 c = reinterpret_cast<const float2*>(sc)[p];
        const float gx = __fmul_rn(z[i].x, c.x), gy = __fmul_rn(z[i].y, c.y);
        a = __fadd_rn(__fadd_rn(a, __fmul_rn(__fmul_rn(gx, u), v[i].x)),
                      __fmul_rn(__fmul_rn(gy, u), v[i].y));
        ps[i].x = __fadd_rn(ps[i].x, __fmul_rn(div_by(v[i].x, r, y1r), z[i].x));
        ps[i].y = __fadd_rn(ps[i].y, __fmul_rn(div_by(v[i].y, r, y1r), z[i].y));
        pb[i].x = __fadd_rn(pb[i].x, z[i].x);
        pb[i].y = __fadd_rn(pb[i].y, z[i].y);
        z[i].x = div_by(gx, r, y1r);   // z now holds g / r
        z[i].y = div_by(gy, r, y1r);
        bq = __fadd_rn(__fadd_rn(bq, -z[i].x), -z[i].y);
      }
    }
    const float dvar = div_by(__fmul_rn(-warp_sum(a), div_by(0.5f, r, y1r)), d, y1d);
    float by = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (lane + 32 * i < pairs) {
        v[i].x = __fmul_rn(dvar, __fmul_rn(2.0f, v[i].x));   // v now holds dvar * 2p
        v[i].y = __fmul_rn(dvar, __fmul_rn(2.0f, v[i].y));
        by = __fadd_rn(__fadd_rn(by, -v[i].x), -v[i].y);
      }
    }
    const float dmu = div_by(__fadd_rn(warp_sum(bq), warp_sum(by)), d, y1d);
    __nv_bfloat162* orow = dx + row * pairs;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs)
        orow[p] = __floats2bfloat162_rn(__fadd_rn(__fadd_rn(z[i].x, v[i].x), dmu),
                                        __fadd_rn(__fadd_rn(z[i].y, v[i].y), dmu));
    }
  }

  // the block's partial column sums, the warps in order, through the rings
  cp_wait<0>();
  __syncthreads();
  float* wsum = reinterpret_cast<float*>(ring);   // kWarps x 2 x dd
  float* own = wsum + static_cast<int64_t>(warp) * 2 * dd;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    if (p < pairs) {
      own[2 * p] = ps[i].x;
      own[2 * p + 1] = ps[i].y;
      own[dd + 2 * p] = pb[i].x;
      own[dd + 2 * p + 1] = pb[i].y;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * dd; c += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, wsum[w * 2 * dd + c]);
    partial[static_cast<int64_t>(blockIdx.x) * 2 * dd + c] = acc;
  }
}

// out[c] = the sum of partial[b][c] over the blocks b, c < cols: thread
// (group g, column c) adds the partials g, g + kColGroups, ... in order,
// then a warp adds the groups' sums in group order
__global__ void __launch_bounds__(kColTile * kColGroups) ln_bwd_columns(
    const float* __restrict__ partial, int nblk, int cols, float* __restrict__ out) {
  __shared__ float red[kColGroups][kColTile + 1];
  const int lane = threadIdx.x % kColTile, g = threadIdx.x / kColTile;
  const int c = blockIdx.x * kColTile + lane;
  float acc = 0.0f;
  if (c < cols) {
    for (int b = g; b < nblk; b += kColGroups)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * cols + c]);
  }
  red[g][lane] = acc;
  __syncthreads();
  if (g == 0 && c < cols) {
    float t = red[0][lane];
    for (int k = 1; k < kColGroups; ++k) t = __fadd_rn(t, red[k][lane]);
    out[c] = t;
  }
}

// The tuned path's launch plan for (rows, d): out[0..7] = pairs a lane
// (NP), rows a block (per), blocks (nblk), blocks a multiprocessor,
// multiprocessors, dynamic shared bytes, registers, local bytes. The
// card's part (the shared-memory limit set, occupancy, build) is asked
// once a device and width.
template <int NP>
int plan(int64_t rows, int d, int* out) {
  struct Card {
    int sms, occ, regs, local;
  };
  static std::mutex mu;
  static std::map<std::pair<int, int>, Card> cards;
  const size_t bytes = rows_smem(d);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Card c;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cards.find({dev, d});
    if (it == cards.end()) {
      int sms = 0, occ = 0;
      cudaFuncAttributes fa;
      // the limit of the build's widest row, so no width lowers another's
      rc = cudaFuncSetAttribute(ln_bwd_rows<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(rows_smem(64 * NP)));
      if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ln_bwd_rows<NP>, kWarps * 32,
                                                           bytes);
      if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&fa, ln_bwd_rows<NP>);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      it = cards.emplace(std::make_pair(dev, d),
                         Card{sms, occ, fa.numRegs, static_cast<int>(fa.localSizeBytes)})
               .first;
    }
    c = it->second;
  }
  // one wave of equal runs of rows, at least a row a warp
  int64_t want = static_cast<int64_t>(c.sms) * c.occ;
  const int64_t most = (rows + kWarps - 1) / kWarps;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const int64_t per = (rows + want - 1) / want;
  const int64_t nblk = (rows + per - 1) / per;
  out[0] = NP;
  out[1] = static_cast<int>(per);
  out[2] = static_cast<int>(nblk);
  out[3] = c.occ;
  out[4] = c.sms;
  out[5] = static_cast<int>(bytes);
  out[6] = c.regs;
  out[7] = c.local;
  return 0;
}

int plan_for(int64_t rows, int d, int* out) {
  const int np = (d / 2 + 31) / 32;
  if (np <= 2) return plan<2>(rows, d, out);
  if (np <= 4) return plan<4>(rows, d, out);
  if (np <= 6) return plan<6>(rows, d, out);
  if (np <= 8) return plan<8>(rows, d, out);
  if (np <= 12) return plan<12>(rows, d, out);
  return plan<16>(rows, d, out);
}

template <int NP>
int launch_rows(const void* x, const void* scale, const void* dy, int64_t rows, int d, void* dx,
                void* partial, const int* pl, int vec16, cudaStream_t st) {
  ln_bwd_rows<NP><<<static_cast<unsigned>(pl[2]), kWarps * 32, static_cast<size_t>(pl[5]), st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(dy), rows, pl[1], d / 2, static_cast<float>(d), vec16,
      static_cast<__nv_bfloat162*>(dx), static_cast<float*>(partial));
  return static_cast<int>(cudaGetLastError());
}

bool tuned(int d) { return (d & 1) == 0 && d <= 2 * 32 * kMaxPairs; }

// a sum across the block, the warps' sums in warp order; every thread
// gets it (red: kWarps floats of shared memory)
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red[w]);
  __syncthreads();
  return t;
}

// any width: one block a row -> dx, and the row's (mu, r) into stats
__global__ void __launch_bounds__(kWarps * 32) ln_bwd_row_any(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const __nv_bfloat16* __restrict__ dy, int d, __nv_bfloat16* __restrict__ dx,
    float2* __restrict__ stats) {
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * d;
  const __nv_bfloat16* gr = dy + row * d;
  const float df = static_cast<float>(d);
  float s = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) s = __fadd_rn(s, __bfloat162float(xr[j]));
  const float mu = __fdiv_rn(block_sum(s, red), df);
  float q = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = __fsub_rn(__bfloat162float(xr[j]), mu);
    q = __fadd_rn(q, __fmul_rn(v, v));
  }
  const float r = __fsqrt_rn(__fadd_rn(__fdiv_rn(block_sum(q, red), df), 1e-6f));
  const float u = __fdiv_rn(1.0f, __fmul_rn(r, r));
  float a = 0.0f, bq = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float p = __fsub_rn(__bfloat162float(xr[j]), mu);
    const float g = __fmul_rn(__bfloat162float(gr[j]), scale[j]);
    a = __fadd_rn(a, __fmul_rn(__fmul_rn(g, u), p));
    bq = __fadd_rn(bq, -__fdiv_rn(g, r));
  }
  const float dvar = __fdiv_rn(__fmul_rn(-block_sum(a, red), __fdiv_rn(0.5f, r)), df);
  const float bqs = block_sum(bq, red);
  float by = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float p = __fsub_rn(__bfloat162float(xr[j]), mu);
    by = __fadd_rn(by, -__fmul_rn(dvar, __fmul_rn(2.0f, p)));
  }
  const float dmu = __fdiv_rn(__fadd_rn(bqs, block_sum(by, red)), df);
  __nv_bfloat16* orow = dx + row * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float p = __fsub_rn(__bfloat162float(xr[j]), mu);
    const float g = __fmul_rn(__bfloat162float(gr[j]), scale[j]);
    orow[j] = __float2bfloat16_rn(
        __fadd_rn(__fadd_rn(__fdiv_rn(g, r), __fmul_rn(dvar, __fmul_rn(2.0f, p))), dmu));
  }
  if (threadIdx.x == 0) stats[row] = make_float2(mu, r);
}

// any width: partial[b][0][c] = the sum of (p / r) dy over block b's rows
// in order, partial[b][1][c] = the sum of dy; one thread a column
__global__ void __launch_bounds__(256) ln_bwd_cols_any(const __nv_bfloat16* __restrict__ x,
                                                       const __nv_bfloat16* __restrict__ dy,
                                                       const float2* __restrict__ stats,
                                                       int64_t rows, int d,
                                                       float* __restrict__ partial) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock;
  const int64_t r1 = r0 + kRowsPerBlock < rows ? r0 + kRowsPerBlock : rows;
  float ps = 0.0f, pb = 0.0f;
  for (int64_t row = r0; row < r1; ++row) {
    const float2 st = stats[row];
    const float z = __bfloat162float(dy[row * d + c]);
    const float p = __fsub_rn(__bfloat162float(x[row * d + c]), st.x);
    ps = __fadd_rn(ps, __fmul_rn(__fdiv_rn(p, st.y), z));
    pb = __fadd_rn(pb, z);
  }
  float* out = partial + static_cast<int64_t>(blockIdx.y) * 2 * d;
  out[c] = ps;
  out[d + c] = pb;
}

// blocks of the columns kernel for 2d columns
unsigned col_blocks(int d) { return static_cast<unsigned>((2 * d + kColTile - 1) / kColTile); }

}  // namespace

// The plan of a call at (rows, d), for the wrapper's scratch and for
// kernel_info: out[0] = 1 for the tuned path (0: the block-a-row one),
// out[1..8] the tuned plan (`plan`; for the block-a-row path: 0, 256,
// ceil(rows / 256), then the row kernel's build), out[9..10] the columns
// kernel's blocks and threads. Returns a CUDA error code.
extern "C" int picha_vit_layernorm_bwd_info(int64_t rows, int d, int* out) {
  if (rows < 1 || d < 1 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  out[9] = static_cast<int>(col_blocks(d));
  out[10] = kColTile * kColGroups;
  if (tuned(d)) {
    out[0] = 1;
    return plan_for(rows, d, out + 1);
  }
  out[0] = 0;
  cudaFuncAttributes fa;
  int occ = 0;
  cudaError_t rc = cudaFuncGetAttributes(&fa, ln_bwd_row_any);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ln_bwd_row_any, kWarps * 32, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t nblk = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  out[1] = 0;
  out[2] = kRowsPerBlock;
  out[3] = static_cast<int>(nblk);
  out[4] = occ;
  out[5] = 0;
  out[6] = 0;
  out[7] = fa.numRegs;
  out[8] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

// x, dy, dx: (rows, d) bf16 (dx may not alias x or dy); scale: (d,) float32;
// d >= 1 (the tuned kernel for even d <= 1024, 4-byte aligned rows;
// otherwise the block-a-row path, which needs stats: (rows, 2) float32
// scratch); partial: float32 scratch of `partial_floats`, at least
// 2 d x the plan's blocks (picha_vit_layernorm_bwd_info's out[3]); dsb:
// (2, d) float32 out, dscale then dbias. Returns cudaGetLastError().
extern "C" int picha_vit_layernorm_bwd(const void* x, const void* scale, const void* dy,
                                       int64_t rows, int d, void* dx, void* partial,
                                       int64_t partial_floats, void* dsb, void* stats,
                                       void* stream) {
  if (rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    const cudaError_t rc = cudaMemsetAsync(dsb, 0, static_cast<size_t>(2) * d * sizeof(float), st);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  int pl[11];
  int rc = picha_vit_layernorm_bwd_info(rows, d, pl);
  if (rc != 0) return rc;
  const int nblk = pl[3];
  if (static_cast<int64_t>(nblk) * 2 * d > partial_floats) return static_cast<int>(cudaErrorInvalidValue);
  if (!tuned(d)) {
    if (stats == nullptr || nblk > 65535 || rows > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    ln_bwd_row_any<<<static_cast<unsigned>(rows), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const __nv_bfloat16*>(dy), d, static_cast<__nv_bfloat16*>(dx),
        static_cast<float2*>(stats));
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    ln_bwd_cols_any<<<dim3((d + 255) / 256, static_cast<unsigned>(nblk)), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<const float2*>(stats), rows, d, static_cast<float*>(partial));
    rc = static_cast<int>(cudaGetLastError());
  } else {
    const int vec16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    const int* tp = pl + 1;
    switch (tp[0]) {
      case 2: rc = launch_rows<2>(x, scale, dy, rows, d, dx, partial, tp, vec16, st); break;
      case 4: rc = launch_rows<4>(x, scale, dy, rows, d, dx, partial, tp, vec16, st); break;
      case 6: rc = launch_rows<6>(x, scale, dy, rows, d, dx, partial, tp, vec16, st); break;
      case 8: rc = launch_rows<8>(x, scale, dy, rows, d, dx, partial, tp, vec16, st); break;
      case 12: rc = launch_rows<12>(x, scale, dy, rows, d, dx, partial, tp, vec16, st); break;
      default: rc = launch_rows<16>(x, scale, dy, rows, d, dx, partial, tp, vec16, st); break;
    }
  }
  if (rc != 0) return rc;
  ln_bwd_columns<<<col_blocks(d), kColTile * kColGroups, 0, st>>>(
      static_cast<const float*>(partial), nblk, 2 * d, static_cast<float*>(dsb));
  return static_cast<int>(cudaGetLastError());
}
