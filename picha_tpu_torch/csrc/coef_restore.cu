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
// designs:
//   - K29 and K30, the whole batch in tiles of kTileEntries entries, no
//     memset, one code for both wires (templates over how an entry gives
//     its gap and value: gap4's primary byte b gap b >> 4 and value
//     (b & 15) - 7, 0 at the escape 15; gap8's pair g[j], v[j]). Three
//     launches: *_tile_sums sums every tile's gaps (K30: primary and side
//     stream) in one grid of (tile, image) blocks, 8 entries a thread by
//     one 8-byte load; *_write gives each primary tile its base (the sum
//     of its image's earlier tiles), its entries their indices by a block
//     scan, and writes the cells the tile owns, zeros included, once:
//     indices within an image never decrease, so tile t owns [its first
//     entry's index, the next tile's first index) (tile 0 from cell 0,
//     the last tile up to m), staged kStagedCells at a time in shared
//     memory where the tile's values are summed, then stored by 16-byte
//     stores. A tile's entries at the next tile's first index (a run of
//     equal indices across the boundary) are summed into one spill a
//     tile; then *_adds adds K30's side stream (its tiles indexed the
//     same way; K29 has none), the spills and the corrections with
//     integer atomicAdd into the written cells;
//   - K27 on the same tiled code with a third entry reading: the entry
//     carries its int32 index, so there is no tile-sums launch. Two
//     launches: densify_write (tile t owns [its first entry's index, the
//     next tile's first index), clamped to [0, m), writes every owned
//     cell once by the staged 16-byte stores, no memset; the equal-index
//     run at the next tile's first index, such as the padding run at
//     m - 1 across many tiles, goes to the tile's spill), then
//     densify_adds adds the spills. The ownership needs indices that
//     never decrease within a row (the reference's sorted scatter, the
//     packers' np.flatnonzero order): each thread checks its entries and
//     the next thread's first, the tile's last thread the next tile's
//     first, and a decrease traps, so the call ends with a CUDA error
//     and never gives a plane;
//   - K28: one thread per cell widens the int8 body (every cell written
//     once, no memset), then a second launch adds the corrections with
//     integer atomicAdd, one thread an entry.
// Integer sums are exact in any order, so the result is bit for bit the
// plain version's (picha_tpu_torch/ops/coef_restore.py) and the
// reference's scatter-adds. An index outside its image (or batch) is
// dropped. The grids of the grid-stride launches come from the card's
// occupancy; a failed query is an error.
#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int kItems = 8;                      // entries a thread takes per tile
constexpr int kTileThreads = 256;
constexpr int kTileEntries = kTileThreads * kItems;   // entries a tile
constexpr int kStagedCells = 8192;             // cells a block stages at once

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

// the entries j0 .. j0 + 7 of a row of k bytes (0 past k): one 8-byte load
// where they lie whole and aligned
__device__ __forceinline__ void load8(const uint8_t* row, int64_t k, int64_t j0,
                                      uint8_t (&b)[kItems]) {
  const uint8_t* p = row + j0;
  if (j0 + kItems <= k && reinterpret_cast<uintptr_t>(p) % 8 == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] = static_cast<uint8_t>(w.x >> (8 * i));
      b[4 + i] = static_cast<uint8_t>(w.y >> (8 * i));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) b[i] = j0 + i < k ? p[i] : 0;
  }
}

// How a primary entry gives its gap and its value: K30's byte g (gap
// g >> 4, value (g & 15) - 7, 0 at the escape 15: that value is in the
// side stream) or K29's pair (g, v).
template <bool kGap8>
struct Entry {
  static __device__ __forceinline__ int gap(uint8_t g) { return kGap8 ? g : g >> 4; }
  static __device__ __forceinline__ int value(uint8_t g, uint8_t v) {
    if (kGap8) return static_cast<int8_t>(v);
    const int nib = g & 15;
    return nib != 15 ? nib - 7 : 0;
  }
};

// the block's sum of v, in every thread (red: 32 int64 of shared memory)
__device__ __forceinline__ int64_t block_sum64(int64_t v, int64_t* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t t = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();
  return t;
}

// the sum of an image's tile sums before tile t
__device__ __forceinline__ int64_t tile_base(const int* sums, int t, int64_t* red) {
  int64_t b = 0;
  for (int i = threadIdx.x; i < t; i += blockDim.x) b += sums[i];
  return block_sum64(b, red);
}

// index of an entry at running sum `run`
__device__ __forceinline__ int64_t index_at(int64_t run) { return run - 1 > 0 ? run - 1 : 0; }

// block (x, image): x < tp sums primary tile x's gaps into psum[image][x],
// else side tile x - tp's into ssum[image][x - tp] (K30 only: K29 has
// ts = 0)
template <bool kGap8>
__device__ __forceinline__ void tile_sums(const uint8_t* __restrict__ prim,
                                          const uint8_t* __restrict__ sg, int64_t k1,
                                          int64_t k2, int tp, int ts, int* __restrict__ psum,
                                          int* __restrict__ ssum) {
  __shared__ int64_t red[32];
  const int64_t img = blockIdx.y;
  const bool side = static_cast<int>(blockIdx.x) >= tp;
  const int t = side ? blockIdx.x - tp : blockIdx.x;
  const int64_t k = side ? k2 : k1;
  const int64_t j0 = static_cast<int64_t>(t) * kTileEntries + threadIdx.x * kItems;
  uint8_t b[kItems];
  load8((side ? sg : prim) + img * k, k, j0, b);
  int s = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) s += side ? b[i] : Entry<kGap8>::gap(b[i]);
  const int64_t total = block_sum64(s, red);
  if (threadIdx.x == 0) (side ? ssum + img * ts : psum + img * tp)[t] = static_cast<int>(total);
}

// The cells [lo, hi) of a plane o of m cells from a tile's entries (idx,
// val; 0 values add nothing), staged kStagedCells at a time in buf where
// the values are summed, each cell stored once (16-byte stores where vec);
// then the entries at hi (the next tile's first index) summed into the
// tile's spill: *spill_val at *spill_cell = cell0 + hi (-1: none). Idx:
// int64_t for K29's and K30's running sums, int for K27's read indices
template <typename Idx>
__device__ __forceinline__ void write_owned(int* __restrict__ o, int64_t m, int64_t lo,
                                            int64_t hi, const Idx (&idx)[kItems],
                                            const int (&val)[kItems], int vec, int* buf,
                                            int64_t* red, int64_t* spill_cell,
                                            int* spill_val, int64_t cell0) {
  for (int64_t c0 = lo; c0 < hi; c0 += kStagedCells) {
    const int64_t c1 = c0 + kStagedCells < hi ? c0 + kStagedCells : hi;
    const int64_t cb = c0 & ~static_cast<int64_t>(3);   // buf[0] is cell cb
    const int quads = static_cast<int>((c1 - cb + 3) / 4);
    for (int q = threadIdx.x; q < quads; q += blockDim.x)
      reinterpret_cast<int4*>(buf)[q] = make_int4(0, 0, 0, 0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (val[i] != 0 && idx[i] >= c0 && idx[i] < c1) atomicAdd(buf + (idx[i] - cb), val[i]);
    __syncthreads();
    // [a, e): the cells of whole 16-byte words, stored by words
    int64_t a = vec ? (c0 + 3) & ~static_cast<int64_t>(3) : c1;
    int64_t e = vec ? c1 & ~static_cast<int64_t>(3) : c1;
    if (a >= e) a = e = c1;
    for (int64_t c = c0 + threadIdx.x; c < a; c += blockDim.x) o[c] = buf[c - cb];
    for (int64_t q = threadIdx.x; q < (e - a) / 4; q += blockDim.x)
      *reinterpret_cast<int4*>(o + a + 4 * q) =
          reinterpret_cast<const int4*>(buf)[(a - cb) / 4 + q];
    for (int64_t c = e + threadIdx.x; c < c1; c += blockDim.x) o[c] = buf[c - cb];
    __syncthreads();
  }

  // the entries past the owned cells lie at hi, the next tile's first cell
  int64_t sp = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (idx[i] >= hi && idx[i] < m) sp += val[i];
  sp = block_sum64(sp, red);
  if (threadIdx.x == 0) {
    *spill_cell = hi < m ? cell0 + hi : -1;
    *spill_val = static_cast<int>(sp);
  }
}

// block (t, image): primary tile t writes the cells it owns (see the file's
// doc) and its spill: spill_val[image][t] summed at cell spill_cell (-1:
// none). vals: K29's values (null for K30). vec: out and m allow 16-byte
// stores
template <bool kGap8>
__device__ __forceinline__ void tile_write(const uint8_t* __restrict__ prim,
                                           const int8_t* __restrict__ vals, int64_t k1,
                                           int64_t m, int tp, const int* __restrict__ psum,
                                           int vec, int* __restrict__ out,
                                           int64_t* __restrict__ spill_cell,
                                           int* __restrict__ spill_val) {
  __shared__ __align__(16) int buf[kStagedCells + 4];
  __shared__ int warp_tot[32];
  __shared__ int64_t red[32];
  using E = Entry<kGap8>;
  const int64_t img = blockIdx.y;
  const int t = blockIdx.x;
  const uint8_t* row = prim + img * k1;
  int* o = out + img * m;
  const int64_t first = static_cast<int64_t>(t) * kTileEntries;
  const int64_t base = tile_base(psum + img * tp, t, red);

  uint8_t b[kItems], bv[kItems] = {};
  const int64_t j0 = first + threadIdx.x * kItems;
  load8(row, k1, j0, b);
  if (kGap8) load8(reinterpret_cast<const uint8_t*>(vals) + img * k1, k1, j0, bv);
  int s = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) s += E::gap(b[i]);
  int total = 0;
  const int incl = block_scan(s, warp_tot, &total);
  int64_t idx[kItems];
  int val[kItems];
  int64_t run = base + incl - s;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run += E::gap(b[i]);
    idx[i] = index_at(run);
    val[i] = j0 + i < k1 ? E::value(b[i], bv[i]) : 0;
  }
  // the owned cells [lo, hi)
  int64_t lo = 0, hi = m;
  if (t > 0) lo = index_at(base + E::gap(row[first]));
  if (t + 1 < tp) hi = index_at(base + total + E::gap(row[first + kTileEntries]));
  lo = lo < m ? lo : m;
  hi = hi < m ? hi : m;
  write_owned(o, m, lo, hi, idx, val, vec, buf, red, spill_cell + img * tp + t,
              spill_val + img * tp + t, img * m);
}

// blocks [0, n * ts): side tile (b % ts) of image b / ts adds its values
// (K30 only); the others add the spills and the corrections, a thread an
// entry
__device__ __forceinline__ void tile_adds(
    const uint8_t* __restrict__ sg, const int8_t* __restrict__ sv, int64_t k2, int64_t m,
    int64_t n, int ts, const int* __restrict__ ssum, const int64_t* __restrict__ spill_cell,
    const int* __restrict__ spill_val, int64_t nsp, const int* __restrict__ ci,
    const int16_t* __restrict__ cv, int64_t kc, int* __restrict__ out) {
  __shared__ int warp_tot[32];
  __shared__ int64_t red[32];
  const int64_t side_blocks = n * ts;
  if (static_cast<int64_t>(blockIdx.x) < side_blocks) {
    const int64_t img = blockIdx.x / ts;
    const int t = static_cast<int>(blockIdx.x % ts);
    const int64_t base = tile_base(ssum + img * ts, t, red);
    const int64_t j0 = static_cast<int64_t>(t) * kTileEntries + threadIdx.x * kItems;
    uint8_t g[kItems], v[kItems];
    load8(sg + img * k2, k2, j0, g);
    load8(reinterpret_cast<const uint8_t*>(sv) + img * k2, k2, j0, v);
    int s = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) s += g[i];
    int total = 0;
    int64_t run = base + block_scan(s, warp_tot, &total) - s;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      run += g[i];
      const int64_t idx = index_at(run);
      const int val = static_cast<int8_t>(v[i]);
      if (val != 0 && idx < m) atomicAdd(out + img * m + idx, val);
    }
    return;
  }
  const int64_t cells = n * m;
  for (int64_t e = (blockIdx.x - side_blocks) * blockDim.x + threadIdx.x; e < nsp + kc;
       e += (gridDim.x - side_blocks) * blockDim.x) {
    if (e < nsp) {
      if (spill_val[e] != 0 && spill_cell[e] >= 0) atomicAdd(out + spill_cell[e], spill_val[e]);
    } else {
      const int i = ci[e - nsp], v = cv[e - nsp];
      if (v != 0 && i >= 0 && i < cells) atomicAdd(out + i, v);
    }
  }
}

// The kernels, by name: K30 gap4_*, K29 gap8_*
__global__ void __launch_bounds__(kTileThreads) gap4_tile_sums(
    const uint8_t* __restrict__ prim, const uint8_t* __restrict__ sg, int64_t k1, int64_t k2,
    int tp, int ts, int* __restrict__ psum, int* __restrict__ ssum) {
  tile_sums<false>(prim, sg, k1, k2, tp, ts, psum, ssum);
}

__global__ void __launch_bounds__(kTileThreads) gap4_write(
    const uint8_t* __restrict__ prim, int64_t k1, int64_t m, int tp, const int* __restrict__ psum,
    int vec, int* __restrict__ out, int64_t* __restrict__ spill_cell,
    int* __restrict__ spill_val) {
  tile_write<false>(prim, nullptr, k1, m, tp, psum, vec, out, spill_cell, spill_val);
}

__global__ void __launch_bounds__(kTileThreads) gap4_adds(
    const uint8_t* __restrict__ sg, const int8_t* __restrict__ sv, int64_t k2, int64_t m,
    int64_t n, int ts, const int* __restrict__ ssum, const int64_t* __restrict__ spill_cell,
    const int* __restrict__ spill_val, int64_t nsp, const int* __restrict__ ci,
    const int16_t* __restrict__ cv, int64_t kc, int* __restrict__ out) {
  tile_adds(sg, sv, k2, m, n, ts, ssum, spill_cell, spill_val, nsp, ci, cv, kc, out);
}

__global__ void __launch_bounds__(kTileThreads) gap8_tile_sums(const uint8_t* __restrict__ g,
                                                              int64_t k, int tp,
                                                              int* __restrict__ psum) {
  tile_sums<true>(g, nullptr, k, 0, tp, 0, psum, nullptr);
}

__global__ void __launch_bounds__(kTileThreads) gap8_write(
    const uint8_t* __restrict__ g, const int8_t* __restrict__ v, int64_t k, int64_t m, int tp,
    const int* __restrict__ psum, int vec, int* __restrict__ out,
    int64_t* __restrict__ spill_cell, int* __restrict__ spill_val) {
  tile_write<true>(g, v, k, m, tp, psum, vec, out, spill_cell, spill_val);
}

__global__ void __launch_bounds__(kTileThreads) gap8_adds(
    int64_t m, int64_t n, const int64_t* __restrict__ spill_cell,
    const int* __restrict__ spill_val, int64_t nsp, const int* __restrict__ ci,
    const int16_t* __restrict__ cv, int64_t kc, int* __restrict__ out) {
  tile_adds(nullptr, nullptr, 0, m, n, 0, nullptr, spill_cell, spill_val, nsp, ci, cv, kc, out);
}

int tiles_of(int64_t k) {
  return static_cast<int>(k > 0 ? (k + kTileEntries - 1) / kTileEntries : 0);
}

// K27's entries j0 .. j0 + 7 of a row of k and the index of entry j0 + 8
// (ix[8]; the order check's neighbour): 16-byte loads where they lie whole
// and aligned. Entries past k read index 0 and value 0.
__device__ __forceinline__ void load_sparse(const int* __restrict__ idx,
                                            const int16_t* __restrict__ val, int64_t k,
                                            int64_t j0, int (&ix)[kItems + 1],
                                            int16_t (&v)[kItems]) {
  const int* pi = idx + j0;
  const int16_t* pv = val + j0;
  if (j0 + kItems <= k && reinterpret_cast<uintptr_t>(pi) % 16 == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(pi));
    const int4 b = __ldg(reinterpret_cast<const int4*>(pi) + 1);
    ix[0] = a.x, ix[1] = a.y, ix[2] = a.z, ix[3] = a.w;
    ix[4] = b.x, ix[5] = b.y, ix[6] = b.z, ix[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) ix[i] = j0 + i < k ? __ldg(pi + i) : 0;
  }
  ix[kItems] = j0 + kItems < k ? __ldg(pi + kItems) : 0;
  if (j0 + kItems <= k && reinterpret_cast<uintptr_t>(pv) % 16 == 0) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(pv));
    const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = static_cast<int16_t>(words[i] & 0xffff);
      v[2 * i + 1] = static_cast<int16_t>(static_cast<uint32_t>(words[i]) >> 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = j0 + i < k ? __ldg(pv + i) : 0;
  }
}

// an entry's index clamped to the plane's cells [0, m]
__device__ __forceinline__ int64_t clamp_cell(int i, int64_t m) {
  return i < 0 ? 0 : (i < m ? i : m);
}

// K27, block (t, image): tile t of the row's sorted (index, value) entries
// writes the cells it owns and its spill (see the file's doc); a decrease
// of the index within the row traps
__global__ void __launch_bounds__(kTileThreads) densify_write(
    const int* __restrict__ idx, const int16_t* __restrict__ val, int64_t k, int64_t m, int tp,
    int vec, int* __restrict__ out, int64_t* __restrict__ spill_cell,
    int* __restrict__ spill_val) {
  __shared__ __align__(16) int buf[kStagedCells + 4];
  __shared__ int64_t red[32];
  const int64_t img = blockIdx.y;
  const int t = blockIdx.x;
  const int* row = idx + img * k;
  const int64_t first = static_cast<int64_t>(t) * kTileEntries;
  const int64_t j0 = first + threadIdx.x * kItems;
  int ix[kItems + 1];
  int16_t v[kItems];
  load_sparse(row, val + img * k, k, j0, ix, v);
  bool down = false;
#pragma unroll
  for (int i = 0; i < kItems; ++i) down |= j0 + i + 1 < k && ix[i + 1] < ix[i];
  if (down) __trap();
  int cell[kItems], value[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    cell[i] = ix[i];
    value[i] = j0 + i < k && ix[i] >= 0 && ix[i] < m ? v[i] : 0;
  }
  const int64_t lo = t > 0 ? clamp_cell(__ldg(row + first), m) : 0;
  const int64_t hi = t + 1 < tp ? clamp_cell(__ldg(row + first + kTileEntries), m) : m;
  write_owned(out + img * m, m, lo, hi, cell, value, vec, buf, red,
              spill_cell + img * tp + t, spill_val + img * tp + t, img * m);
}

// K27's second launch: the spills
__global__ void __launch_bounds__(kTileThreads) densify_adds(
    int64_t m, int64_t n, const int64_t* __restrict__ spill_cell,
    const int* __restrict__ spill_val, int64_t nsp, int* __restrict__ out) {
  tile_adds(nullptr, nullptr, 0, m, n, 0, nullptr, spill_cell, spill_val, nsp, nullptr, nullptr,
            0, out);
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

// *grid: the blocks of 256 threads a grid-stride launch of `kernel` over
// `items` takes: one a 256 items, at most the blocks the card holds at
// once (its SMs times the kernel's blocks an SM, asked once a kernel and
// device). Returns a CUDA error code: a failed query is an error.
int grid_for(const void* kernel, int64_t items, unsigned* grid) {
  int per_sm = 0, sms = 0;
  const int rc = picha::occupancy(kernel, 256, &per_sm, &sms);
  if (rc != 0) return rc;
  const int64_t blocks = (items + 255) / 256, cap = static_cast<int64_t>(sms) * per_sm;
  *grid = static_cast<unsigned>(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
  return 0;
}

int add_corrections(const void* ci, const void* cv, int64_t kc, int64_t cells, void* out,
                    cudaStream_t st) {
  if (kc == 0) return static_cast<int>(cudaGetLastError());
  unsigned grid = 0;
  const int rc = grid_for(reinterpret_cast<const void*>(corrections), kc, &grid);
  if (rc != 0) return rc;
  corrections<<<grid, 256, 0, st>>>(static_cast<const int*>(ci), static_cast<const int16_t*>(cv),
                                    kc, cells, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool sizes_ok(int64_t n, int64_t m) {
  return n >= 0 && n <= 0x7fffffffLL && m >= 1 && n * m <= 0x7fffffffLL;
}

}  // namespace

// K28. c8: (cells,) int8; ci: (kc,) int32 batch-flat, cv: (kc,) int16;
// out: (cells,) int32. Returns cudaGetLastError().
extern "C" int picha_coef_int8_restore(const void* c8, int64_t cells, const void* ci,
                                       const void* cv, int64_t kc, void* out, void* stream) {
  if (!sizes_ok(cells, 1) || kc < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cells == 0) return static_cast<int>(cudaGetLastError());
  unsigned grid = 0;
  int rc = grid_for(reinterpret_cast<const void*>(widen), cells, &grid);
  if (rc != 0) return rc;
  widen<<<grid, 256, 0, st>>>(static_cast<const int8_t*>(c8), cells, static_cast<int*>(out));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return add_corrections(ci, cv, kc, cells, out, st);
}

// K27's, K29's and K30's scratch for (n, k1, k2): the spill cells
// (int64), then the primary tiles' sums (unused by K27), the spills'
// values and the side tiles' sums (int32)
static int64_t tile_scratch_bytes(int64_t n, int tp, int ts) {
  return n * tp * 8 + n * tp * 4 * 2 + n * ts * 4;
}

// The tiles and builds of K30's, K29's and K27's kernels: out[0] entries
// a tile, out[1] cells a block stages at once, then for gap4_tile_sums,
// gap4_write, gap4_adds, gap8_tile_sums, gap8_write, gap8_adds,
// densify_write and densify_adds: registers, local bytes, shared bytes,
// threads, blocks a multiprocessor (out[2..41]). Returns a CUDA error
// code.
extern "C" int picha_coef_tiles_info(int* out) {
  out[0] = kTileEntries;
  out[1] = kStagedCells;
  const void* kernels[8] = {
      reinterpret_cast<const void*>(gap4_tile_sums), reinterpret_cast<const void*>(gap4_write),
      reinterpret_cast<const void*>(gap4_adds),      reinterpret_cast<const void*>(gap8_tile_sums),
      reinterpret_cast<const void*>(gap8_write),     reinterpret_cast<const void*>(gap8_adds),
      reinterpret_cast<const void*>(densify_write),  reinterpret_cast<const void*>(densify_adds)};
  for (int i = 0; i < 8; ++i) {
    cudaFuncAttributes fa;
    int blocks = 0, sms = 0;
    const cudaError_t rc = cudaFuncGetAttributes(&fa, kernels[i]);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const int orc = picha::occupancy(kernels[i], kTileThreads, &blocks, &sms);
    if (orc != 0) return orc;
    int* o = out + 2 + 5 * i;
    o[0] = fa.numRegs;
    o[1] = static_cast<int>(fa.localSizeBytes);
    o[2] = static_cast<int>(fa.sharedSizeBytes);
    o[3] = kTileThreads;
    o[4] = blocks;
  }
  return 0;
}

// The checks K27, K29 and K30 share: sizes, tiles a grid row, the scratch.
static bool tiles_ok(int64_t n, int64_t k1, int64_t k2, int64_t m, int64_t kc, int tp, int ts,
                     const void* scratch, int64_t scratch_bytes) {
  return sizes_ok(n, m) && k1 >= 0 && k2 >= 0 && kc >= 0 && n <= 65535 &&
         (k1 + kTileEntries - 1) / kTileEntries <= 0x7fffffffLL / 2 &&
         (k2 + kTileEntries - 1) / kTileEntries <= 0x7fffffffLL / 2 &&
         scratch_bytes >= tile_scratch_bytes(n, tp, ts) &&
         reinterpret_cast<uintptr_t>(scratch) % 8 == 0;
}

// K29. g: (n, k) uint8, v: (n, k) int8; ci, cv: (kc,) batch-flat
// corrections; out: (n, m) int32, every cell written; scratch: at least
// tile_scratch_bytes(n, tiles of k (at least 1), 0) bytes, 8-byte
// aligned. Returns cudaGetLastError().
extern "C" int picha_coef_gap8_restore(const void* g, const void* v, int64_t n, int64_t k,
                                       int64_t m, const void* ci, const void* cv, int64_t kc,
                                       void* out, void* scratch, int64_t scratch_bytes,
                                       void* stream) {
  const int tp = k > 0 && k < (int64_t{1} << 40) ? tiles_of(k) : 1;
  if (!tiles_ok(n, k, 0, m, kc, tp, 0, scratch, scratch_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* spill_cell = static_cast<int64_t*>(scratch);
  auto* psum = reinterpret_cast<int*>(spill_cell + n * tp);
  int* spill_val = psum + n * tp;
  const auto* gb = static_cast<const uint8_t*>(g);
  const int vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned ny = static_cast<unsigned>(n);
  gap8_tile_sums<<<dim3(static_cast<unsigned>(tp), ny), kTileThreads, 0, st>>>(gb, k, tp, psum);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  gap8_write<<<dim3(static_cast<unsigned>(tp), ny), kTileThreads, 0, st>>>(
      gb, static_cast<const int8_t*>(v), k, m, tp, psum, vec, static_cast<int*>(out), spill_cell,
      spill_val);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int64_t nsp = n * tp;
  unsigned grid = 0;
  rc = grid_for(reinterpret_cast<const void*>(gap8_adds), nsp + kc, &grid);
  if (rc != 0) return rc;
  gap8_adds<<<grid, kTileThreads, 0, st>>>(m, n, spill_cell, spill_val, nsp,
                                           static_cast<const int*>(ci),
                                           static_cast<const int16_t*>(cv), kc,
                                           static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K27. idx: (n, k) int32, val: (n, k) int16, each row's indices never
// decreasing (a decrease traps); out: (n, m) int32, every cell written;
// scratch as K29's for (n, k). Returns cudaGetLastError().
extern "C" int picha_coef_densify(const void* idx, const void* val, int64_t n, int64_t k,
                                  int64_t m, void* out, void* scratch, int64_t scratch_bytes,
                                  void* stream) {
  const int tp = k > 0 && k < (int64_t{1} << 40) ? tiles_of(k) : 1;
  if (!tiles_ok(n, k, 0, m, 0, tp, 0, scratch, scratch_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* spill_cell = static_cast<int64_t*>(scratch);
  int* spill_val = reinterpret_cast<int*>(spill_cell + n * tp) + n * tp;
  const int vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t nsp = n * tp;
  unsigned grid = 0;
  int rc = grid_for(reinterpret_cast<const void*>(densify_adds), nsp, &grid);
  if (rc != 0) return rc;
  densify_write<<<dim3(static_cast<unsigned>(tp), static_cast<unsigned>(n)), kTileThreads, 0,
                  st>>>(static_cast<const int*>(idx), static_cast<const int16_t*>(val), k, m, tp,
                        vec, static_cast<int*>(out), spill_cell, spill_val);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  densify_adds<<<grid, kTileThreads, 0, st>>>(m, n, spill_cell, spill_val, nsp,
                                              static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K30. prim: (n, k1) uint8; sg: (n, k2) uint8, sv: (n, k2) int8; ci, cv:
// (kc,) batch-flat corrections; out: (n, m) int32, every cell written;
// scratch: at least tile_scratch_bytes(n, tiles of k1 (at least 1), tiles
// of k2) bytes, 8-byte aligned. Returns cudaGetLastError().
extern "C" int picha_coef_gap4_restore(const void* prim, const void* sg, const void* sv,
                                       int64_t n, int64_t k1, int64_t k2, int64_t m,
                                       const void* ci, const void* cv, int64_t kc, void* out,
                                       void* scratch, int64_t scratch_bytes, void* stream) {
  const bool small = k1 < (int64_t{1} << 40) && k2 < (int64_t{1} << 40);
  const int tp = k1 > 0 && small ? tiles_of(k1) : 1, ts = small ? tiles_of(k2) : 0;
  if (!small || !tiles_ok(n, k1, k2, m, kc, tp, ts, scratch, scratch_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* spill_cell = static_cast<int64_t*>(scratch);
  auto* psum = reinterpret_cast<int*>(spill_cell + n * tp);
  int* spill_val = psum + n * tp;
  int* ssum = spill_val + n * tp;
  const auto* p = static_cast<const uint8_t*>(prim);
  const auto* g = static_cast<const uint8_t*>(sg);
  const int vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned ny = static_cast<unsigned>(n);
  gap4_tile_sums<<<dim3(static_cast<unsigned>(tp + ts), ny), kTileThreads, 0, st>>>(
      p, g, k1, k2, tp, ts, psum, ssum);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  gap4_write<<<dim3(static_cast<unsigned>(tp), ny), kTileThreads, 0, st>>>(
      p, k1, m, tp, psum, vec, static_cast<int*>(out), spill_cell, spill_val);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int64_t side_blocks = n * ts, nsp = n * tp;
  unsigned grid = 0;
  rc = grid_for(reinterpret_cast<const void*>(gap4_adds), nsp + kc, &grid);
  if (rc != 0) return rc;
  gap4_adds<<<static_cast<unsigned>(side_blocks + grid), kTileThreads, 0, st>>>(
      g, static_cast<const int8_t*>(sv), k2, m, n, ts, ssum, spill_cell, spill_val, nsp,
      static_cast<const int*>(ci), static_cast<const int16_t*>(cv), kc, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
