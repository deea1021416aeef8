// K27-K30: the restores of the host-coefficient uploads of
// JpegBatchPipeline (upload="sparse" | "int8" | "gap8" | "gap4"): the
// uploaded wire of one component -> its dense (N, bh, bw, 64) int32
// quantised coefficients, the tensor split_planes hands the staged IDCT
// (K6) and the fused product on the scan path.
//
// Replaces (picha_tpu/pipeline/jpeg_batch.py):
//   K27 densify (_jit_batch_graph.densify, :244-256): per image k sorted
//       int32 indices and int16 values (padding (m - 1, 0)) scatter-added
//       into zeros;
//   K28 int8_restore (:274-282): the int8 body widened, plus a batch-flat
//       sorted int16 correction list (padding (N m - 1, 0));
//   K29 gap8_restore (:258-272): per image the running sum of u8 gaps - 1
//       (clamped at 0) indexes i8 values, plus the corrections;
//   K30 gap4_restore_flat (:119-142): a nibble primary stream (gap << 4 |
//       code; code 7 adds zero, 15 escapes), its escapes' values in a gap8
//       side stream with its own gap chain, plus the corrections.
// Each runs once per component of a batch (3 times for 4:2:0 colour).
//
// What bounds them on an H100: memory traffic. At the slice's batch (16
// 1920x1088 4:2:0 sources, q85) they read a few MB of wire and write the
// dense planes, 16 x 3.13 M int32 = 200 MB: ~0.06 ms at HBM peak. The
// design: the output is cleared with one memset, then
//   - K29 / K30, one block of 1024 threads per image (a row of the wire):
//     the row is walked in tiles of 8192 entries, each thread summing 8
//     consecutive gaps, a block-wide inclusive scan of the thread sums
//     written here (warp shuffles, then the 32 warp totals) plus the
//     carry of the earlier tiles gives every entry its index. The primary
//     stream writes each nonzero cell once (a plain store): of the
//     entries at one index (zero-valued gap extensions, the tail pin,
//     padding) only the first stores, and a later nonzero one, which a
//     well-formed wire does not hold, is added after a barrier;
//   - K30's side stream is walked the same way after the primary and adds
//     its values with integer atomicAdd into the cells already written;
//   - K27: one thread per entry (no prefix sum: the entries carry their
//     index), first-of-index entries storing, the others added after;
//   - K28: one thread per cell widens the int8 body (every cell written
//     once, no memset);
//   - then a second launch adds the corrections (K28-K30) and K27's
//     repeated indices with integer atomicAdd, one thread an entry.
// Integer sums are exact in any order, so the result is bit for bit the
// plain version's (picha_tpu_torch/ops/coef_restore.py) and the
// reference's scatter-adds. The reference's sorted-scatter hints (a TPU
// workaround) are not carried over: no kernel relies on sorted input. An
// index outside its image (or batch) is dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;                      // entries a thread takes per tile
constexpr int kTile = kThreads * kItems;

// inclusive scan of v over the block; *total = the block's sum. warp_tot:
// 32 ints of shared memory
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_tot[warp - 1] : 0);
  *total = warp_tot[nw - 1];
  __syncthreads();
  return out;
}

// walk one image's gap stream of k entries: gap_of(j) and val_of(j) give
// entry j's gap and value; the entry lands at idx = max(running sum - 1,
// 0). kAdd: every nonzero value is added atomically (K30's side stream);
// else the first entry at an index stores its nonzero value and a later
// nonzero one at the same index is added after a barrier.
template <bool kAdd, typename G, typename V>
__device__ __forceinline__ void walk(int64_t k, int64_t m, int* out, G gap_of, V val_of) {
  __shared__ int warp_tot[32];
  int64_t carry = 0;
  for (int64_t base = 0; base < k; base += kTile) {
    const int64_t j0 = base + static_cast<int64_t>(threadIdx.x) * kItems;
    int g[kItems], s = 0;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      g[it] = j0 + it < k ? gap_of(j0 + it) : 0;
      s += g[it];
    }
    int total = 0;
    const int incl = block_scan(s, warp_tot, &total);
    int64_t run = carry + incl - s;                 // the sum before entry j0
    int64_t prev = j0 > 0 ? (run - 1 > 0 ? run - 1 : 0) : -1;
    int64_t later[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      later[it] = -1;
      run += g[it];
      const int64_t idx = run - 1 > 0 ? run - 1 : 0;
      if (j0 + it < k) {
        const int v = val_of(j0 + it);
        if (v != 0 && idx < m) {
          if (kAdd)
            atomicAdd(out + idx, v);
          else if (idx != prev)
            out[idx] = v;
          else
            later[it] = idx;
        }
      }
      prev = idx;
    }
    if (!kAdd) {
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kItems; ++it)
        if (later[it] >= 0) atomicAdd(out + later[it], val_of(j0 + it));
    }
    carry += total;
  }
}

// K29: one block per image
__global__ void __launch_bounds__(kThreads) gap8_restore(const uint8_t* __restrict__ g,
                                                         const int8_t* __restrict__ v, int64_t k,
                                                         int64_t m, int* __restrict__ out) {
  const int64_t img = blockIdx.x;
  const uint8_t* gi = g + img * k;
  const int8_t* vi = v + img * k;
  walk<false>(k, m, out + img * m, [&](int64_t j) { return static_cast<int>(gi[j]); },
              [&](int64_t j) { return static_cast<int>(vi[j]); });
}

// K30: one block per image, the primary stream, then the side stream
__global__ void __launch_bounds__(kThreads) gap4_restore(const uint8_t* __restrict__ prim,
                                                         const uint8_t* __restrict__ sg,
                                                         const int8_t* __restrict__ sv,
                                                         int64_t k1, int64_t k2, int64_t m,
                                                         int* __restrict__ out) {
  const int64_t img = blockIdx.x;
  const uint8_t* p = prim + img * k1;
  int* o = out + img * m;
  walk<false>(k1, m, o, [&](int64_t j) { return static_cast<int>(p[j] >> 4); },
              [&](int64_t j) {
                const int nib = p[j] & 15;
                return nib == 15 ? 0 : nib - 7;
              });
  __syncthreads();
  const uint8_t* gs = sg + img * k2;
  const int8_t* vs = sv + img * k2;
  walk<true>(k2, m, o, [&](int64_t j) { return static_cast<int>(gs[j]); },
             [&](int64_t j) { return static_cast<int>(vs[j]); });
}

// K27: one thread an entry; the first entry at an index of its row stores
__global__ void __launch_bounds__(256) densify_first(const int* __restrict__ idx,
                                                     const int16_t* __restrict__ val,
                                                     int64_t rows, int64_t k, int64_t m,
                                                     int* __restrict__ out) {
  const int64_t total = rows * k;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / k, j = e - r * k;
    const int i = idx[e], v = val[e];
    if (v != 0 && i >= 0 && i < m && (j == 0 || idx[e - 1] != i)) out[r * m + i] = v;
  }
}

// K27's second launch: the entries at an index of their row after its first
__global__ void __launch_bounds__(256) densify_later(const int* __restrict__ idx,
                                                     const int16_t* __restrict__ val,
                                                     int64_t rows, int64_t k, int64_t m,
                                                     int* __restrict__ out) {
  const int64_t total = rows * k;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / k, j = e - r * k;
    const int i = idx[e], v = val[e];
    if (v != 0 && i >= 0 && i < m && j > 0 && idx[e - 1] == i) atomicAdd(out + r * m + i, v);
  }
}

// K28: the int8 body widened, every cell once
__global__ void __launch_bounds__(256) widen(const int8_t* __restrict__ c8, int64_t cells,
                                             int* __restrict__ out) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < cells;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[e] = c8[e];
}

// K28-K30's second launch: the batch-flat corrections
__global__ void __launch_bounds__(256) corrections(const int* __restrict__ ci,
                                                   const int16_t* __restrict__ cv, int64_t kc,
                                                   int64_t cells, int* __restrict__ out) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < kc;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int i = ci[e], v = cv[e];
    if (v != 0 && i >= 0 && i < cells) atomicAdd(out + i, v);
  }
}

int grid_for(int64_t items) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (items + 255) / 256, cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

int clear(void* out, int64_t cells, cudaStream_t st) {
  return static_cast<int>(cudaMemsetAsync(out, 0, static_cast<size_t>(cells) * sizeof(int), st));
}

int add_corrections(const void* ci, const void* cv, int64_t kc, int64_t cells, void* out,
                    cudaStream_t st) {
  if (kc == 0) return static_cast<int>(cudaGetLastError());
  corrections<<<grid_for(kc), 256, 0, st>>>(static_cast<const int*>(ci),
                                            static_cast<const int16_t*>(cv), kc, cells,
                                            static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool sizes_ok(int64_t n, int64_t m) {
  return n >= 0 && n <= 0x7fffffffLL && m >= 1 && n * m <= 0x7fffffffLL;
}

}  // namespace

// K27. idx: (n, k) int32, val: (n, k) int16; out: (n, m) int32. Returns
// cudaGetLastError().
extern "C" int picha_coef_densify(const void* idx, const void* val, int64_t n, int64_t k,
                                  int64_t m, void* out, void* stream) {
  if (!sizes_ok(n, m) || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = clear(out, n * m, st);
  if (rc != 0 || n * k == 0) return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
  const auto* i = static_cast<const int*>(idx);
  const auto* v = static_cast<const int16_t*>(val);
  densify_first<<<grid_for(n * k), 256, 0, st>>>(i, v, n, k, m, static_cast<int*>(out));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  densify_later<<<grid_for(n * k), 256, 0, st>>>(i, v, n, k, m, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K28. c8: (cells,) int8; ci: (kc,) int32 batch-flat, cv: (kc,) int16;
// out: (cells,) int32. Returns cudaGetLastError().
extern "C" int picha_coef_int8_restore(const void* c8, int64_t cells, const void* ci,
                                       const void* cv, int64_t kc, void* out, void* stream) {
  if (!sizes_ok(cells, 1) || kc < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cells == 0) return static_cast<int>(cudaGetLastError());
  widen<<<grid_for(cells), 256, 0, st>>>(static_cast<const int8_t*>(c8), cells,
                                         static_cast<int*>(out));
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return add_corrections(ci, cv, kc, cells, out, st);
}

// K29. g: (n, k) uint8, v: (n, k) int8; ci, cv: (kc,) batch-flat
// corrections; out: (n, m) int32. Returns cudaGetLastError().
extern "C" int picha_coef_gap8_restore(const void* g, const void* v, int64_t n, int64_t k,
                                       int64_t m, const void* ci, const void* cv, int64_t kc,
                                       void* out, void* stream) {
  if (!sizes_ok(n, m) || k < 0 || kc < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = clear(out, n * m, st);
  if (rc != 0 || n == 0) return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
  gap8_restore<<<static_cast<unsigned>(n), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(g), static_cast<const int8_t*>(v), k, m, static_cast<int*>(out));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return add_corrections(ci, cv, kc, n * m, out, st);
}

// K30. prim: (n, k1) uint8; sg: (n, k2) uint8, sv: (n, k2) int8; ci, cv:
// (kc,) batch-flat corrections; out: (n, m) int32. Returns
// cudaGetLastError().
extern "C" int picha_coef_gap4_restore(const void* prim, const void* sg, const void* sv,
                                       int64_t n, int64_t k1, int64_t k2, int64_t m,
                                       const void* ci, const void* cv, int64_t kc, void* out,
                                       void* stream) {
  if (!sizes_ok(n, m) || k1 < 0 || k2 < 0 || kc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = clear(out, n * m, st);
  if (rc != 0 || n == 0) return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
  gap4_restore<<<static_cast<unsigned>(n), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(prim), static_cast<const uint8_t*>(sg),
      static_cast<const int8_t*>(sv), k1, k2, m, static_cast<int*>(out));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return add_corrections(ci, cv, kc, n * m, out, st);
}
