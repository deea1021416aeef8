// K17: the LayerNorm of the ViT blocks (bf16 rows in, bf16 rows out).
//
// Replaces: picha_tpu/models/vit.py::_ln (:145-152), which XLA fuses into
// the forward graph: x -> f32, mu = mean(x), var = mean((x - mu)^2),
// (x - mu) / sqrt(var + 1e-6), * scale + bias (f32 parameters), -> bf16.
// It runs 2 x depth + 1 times per forward (25 at ViT-S/16).
//
// What bounds it on an H100: memory traffic. At the forward's shape
// (256 images x 196 tokens, d = 384) it reads 38.5 MB of bf16 and writes
// 38.5 MB: 0.023 ms at HBM peak, against ~12 instructions an element,
// which at the card's issue rate take about as long: so the bytes must
// stream while the rows compute. The design (the tuned path, even
// d <= 1024), K21's (vit_layernorm_bwd.cu) for the forward:
//   - ln_fwd_rows, one warp a row, the row's bf16 pairs spread over the
//     lanes (pair p = lane + 32 i in the lane's slot i). The arithmetic
//     keeps the reference's rounding order: a two-pass mean and
//     variance, each lane's partial sums over its pairs in slot order
//     (x, then y), the lanes' sums by the xor-shuffle tree, true
//     divisions, an IEEE square root, * scale + bias without FMA
//     contraction (__fmul_rn, __fadd_rn), one rounding to bf16 at the end
//     (__floats2bfloat162_rn). K21 recomputes mu and r with exactly this
//     order, so the backward sees the forward's own statistics. Only the
//     order of the two sums differs from the plain version
//     (picha_tpu_torch/ops/layernorm.py::layer_norm_plain).
//   - Every division is `div_by` (resnet_norm.cuh), bit for bit
//     __fdiv_rn: the two an element by the row's den, with den's
//     reciprocal refined once a row, and the two a row by d, with d's
//     refined once a block.
//   - Each warp streams its rows through its own ring of kStages slots in
//     shared memory (cp.async, 16 bytes where d % 8 == 0 and x's base is
//     16-byte aligned, else 4): the next kStages - 1 rows are in flight
//     while a row computes, and no registers hold them.
//   - scale and bias sit in registers: a lane loads its columns' values
//     once for all of its warp's rows.
//   - The grid is planned from the card's occupancy (`plan`): as many
//     blocks as the multiprocessors hold at once, each taking one run of
//     consecutive rows (its warps interleaved over it), so the blocks
//     finish in one wave. Stores are a bf16 pair a lane (128 bytes a
//     warp instruction).
//
// Widths outside the tuned envelope (odd, or past 1024) take a second,
// simpler kernel chosen by shape: one block of 256 threads a row, single
// bf16 loads, x read again from memory (L1 / L2) for each pass, the same
// two-pass order and true divisions, the sums across the block by warp
// shuffles and then the 8 warps' sums in warp order.
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

constexpr int kWarps = 8;       // warps a block
constexpr int kStages = 4;      // rows in a warp's ring (kStages - 1 in flight)
constexpr int kMaxPairs = 16;   // bf16 pairs a lane holds: d <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bytes of one row in the ring (16-byte slots)
__host__ __device__ inline int ring_row_bytes(int d) { return (2 * d + 15) / 16 * 16; }

// dynamic shared bytes of ln_fwd_rows: the warps' rings
inline size_t rows_smem(int d) {
  return static_cast<size_t>(kWarps) * kStages * ring_row_bytes(d);
}

// NP: pairs a lane holds (pairs <= 32 * NP). Block b takes rows [b * per,
// min((b + 1) * per, rows)); warp w the rows w, w + kWarps, ... of them.
template <int NP>
__global__ void __launch_bounds__(kWarps * 32) ln_fwd_rows(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, int64_t rows, int64_t per, int pairs, float d, int vec16,
    __nv_bfloat162* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dd = 2 * pairs, rb = ring_row_bytes(dd);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t r1 = r0 + per < rows ? r0 + per : rows;
  const int count = r1 - r0 > warp ? static_cast<int>((r1 - r0 - warp + kWarps - 1) / kWarps) : 0;
  unsigned char* mine = smem + static_cast<size_t>(warp) * kStages * rb;
  const int chunks = vec16 ? dd / 8 : pairs;   // 16- or 4-byte copies a row

  // row j of this warp's into slot s (an empty group past the last row)
  auto issue = [&](int j, int s) {
    if (j < count) {
      const int64_t row = r0 + warp + static_cast<int64_t>(j) * kWarps;
      const unsigned char* gx = reinterpret_cast<const unsigned char*>(x + row * dd);
      unsigned char* sx = mine + static_cast<size_t>(s) * rb;
      if (vec16) {
        for (int c = lane; c < chunks; c += 32) cp_async<16>(sx + 16 * c, gx + 16 * c);
      } else {
        for (int c = lane; c < chunks; c += 32) cp_async<4>(sx + 4 * c, gx + 4 * c);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s, s);

  // the lane's columns of scale and bias, once for all its rows
  float2 sc[NP], bi[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    sc[i] = bi[i] = make_float2(0.0f, 0.0f);
    if (p < pairs) {
      sc[i] = make_float2(scale[2 * p], scale[2 * p + 1]);
      bi[i] = make_float2(bias[2 * p], bias[2 * p + 1]);
    }
  }
  const float y1d = rcp_refined(d);

#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    __syncwarp();    // every lane is done with the slot issue() refills
    issue(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_wait<kStages - 1>();
    __syncwarp();    // every lane's copies of row j are in
    const uint32_t* wx = reinterpret_cast<const uint32_t*>(mine + (j % kStages) * rb);
    const int64_t row = r0 + warp + static_cast<int64_t>(j) * kWarps;
    float2 v[NP];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs) {
        const uint32_t a = wx[p];
        v[i] = make_float2(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u));
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
    const float den = __fsqrt_rn(__fadd_rn(div_by(warp_sum(q), d, y1d), 1e-6f));
    const float y1 = rcp_refined(den);
    __nv_bfloat162* orow = out + row * pairs;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs) {
        const float a0 = __fadd_rn(__fmul_rn(div_by(v[i].x, den, y1), sc[i].x), bi[i].x);
        const float a1 = __fadd_rn(__fmul_rn(div_by(v[i].y, den, y1), sc[i].y), bi[i].y);
        orow[p] = __floats2bfloat162_rn(a0, a1);
      }
    }
  }
  cp_wait<0>();
}

// The tuned path's launch plan for (rows, d): out[0..7] = pairs a lane
// (NP), rows a block (per), blocks, blocks a multiprocessor,
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
      rc = cudaFuncSetAttribute(ln_fwd_rows<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(rows_smem(64 * NP)));
      if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ln_fwd_rows<NP>, kWarps * 32,
                                                           bytes);
      if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&fa, ln_fwd_rows<NP>);
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
int launch_rows(const void* x, const void* scale, const void* bias, int64_t rows, int d,
                void* out, const int* pl, int vec16, cudaStream_t st) {
  ln_fwd_rows<NP><<<static_cast<unsigned>(pl[2]), kWarps * 32, static_cast<size_t>(pl[5]), st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), rows, pl[1], d / 2, static_cast<float>(d), vec16,
      static_cast<__nv_bfloat162*>(out));
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

// any width: one block a row, x re-read for each pass
__global__ void __launch_bounds__(kWarps * 32) vit_layernorm_rows(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, int d, __nv_bfloat16* __restrict__ out) {
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * d;
  const float df = static_cast<float>(d);
  float s = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) s = __fadd_rn(s, __bfloat162float(xr[j]));
  const float mu = __fdiv_rn(block_sum(s, red), df);
  float q = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = __fsub_rn(__bfloat162float(xr[j]), mu);
    q = __fadd_rn(q, __fmul_rn(v, v));
  }
  const float den = __fsqrt_rn(__fadd_rn(__fdiv_rn(block_sum(q, red), df), 1e-6f));
  __nv_bfloat16* orow = out + row * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = __fsub_rn(__bfloat162float(xr[j]), mu);
    orow[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(__fdiv_rn(v, den), scale[j]), bias[j]));
  }
}

}  // namespace

// The plan of a call at (rows, d), for kernel_info: out[0] = 1 for the
// tuned path (0: the block-a-row one), out[1..8] the tuned plan (`plan`;
// for the block-a-row path: 0, 1, rows, then its blocks a
// multiprocessor, multiprocessors, 0 dynamic shared bytes, registers and
// local bytes). Returns a CUDA error code.
extern "C" int picha_vit_layernorm_info(int64_t rows, int d, int* out) {
  if (rows < 1 || d < 1 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (tuned(d)) {
    out[0] = 1;
    return plan_for(rows, d, out + 1);
  }
  out[0] = 0;
  cudaFuncAttributes fa;
  int occ = 0, sms = 0, dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&fa, vit_layernorm_rows);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, vit_layernorm_rows, kWarps * 32, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[1] = 0;
  out[2] = 1;
  out[3] = static_cast<int>(rows);
  out[4] = occ;
  out[5] = sms;
  out[6] = 0;
  out[7] = fa.numRegs;
  out[8] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

// x, out: (rows, d) bf16 (out may not alias x); scale, bias: (d,) float32;
// d >= 1 (the tuned kernel for even d <= 1024, 4-byte aligned rows; the
// block-a-row kernel otherwise). Returns cudaGetLastError().
extern "C" int picha_vit_layernorm(const void* x, const void* scale, const void* bias,
                                   int64_t rows, int d, void* out, void* stream) {
  if (rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tuned(d)) {
    vit_layernorm_rows<<<static_cast<unsigned>(rows), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), d, static_cast<__nv_bfloat16*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  int pl[8];
  int rc = plan_for(rows, d, pl);
  if (rc != 0) return rc;
  const int vec16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (pl[0]) {
    case 2: return launch_rows<2>(x, scale, bias, rows, d, out, pl, vec16, st);
    case 4: return launch_rows<4>(x, scale, bias, rows, d, out, pl, vec16, st);
    case 6: return launch_rows<6>(x, scale, bias, rows, d, out, pl, vec16, st);
    case 8: return launch_rows<8>(x, scale, bias, rows, d, out, pl, vec16, st);
    case 12: return launch_rows<12>(x, scale, bias, rows, d, out, pl, vec16, st);
    default: return launch_rows<16>(x, scale, bias, rows, d, out, pl, vec16, st);
  }
}
