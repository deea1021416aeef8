// Tensor-core building blocks of K18 (vit_attention.cu) and K22
// (vit_attention_bwd.cu): cp.async staging of a head's rows into shared
// memory, ldmatrix fragment loads and the bf16 mma.sync.m16n8k16 with f32
// accumulators.
//
// A head tile is SP rows (S rounded up to 16) of D bf16 values, stored
// without padding; the 16-byte chunks of a row are XOR-swizzled with the
// row (chunk ^ (row & 7), or chunk ^ ((row >> 1) & 3) where a row is 64
// bytes), so that the 8 row addresses of one ldmatrix phase land in 8
// different 16-byte bank groups.
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16): in a lane, g = lane / 4 and
// c = lane % 4. An accumulator tile (16 x 8 f32) holds (g, 2c), (g, 2c+1),
// (g+8, 2c), (g+8, 2c+1); an A tile (16 x 16 bf16) holds the pairs
// (g, 2c..), (g+8, 2c..), (g, 2c+8..), (g+8, 2c+8..); a B tile (16 x 8)
// the pairs (k 2c.., n g), (k 2c+8.., n g). Two accumulator tiles side by
// side are therefore, rounded to bf16 and packed, the A tile of a product
// whose depth is their 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kMaxSeq = 256;

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
template <int D>
__device__ __forceinline__ uint32_t off(int row, int chunk) {
  const int swz = D == 32 ? (row >> 1) & 3 : row & 7;
  return static_cast<uint32_t>(row * (D * 2) + ((chunk ^ swz) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows [0, SP) of a head into a swizzled tile: row r < S from src + r *
// stride (bf16 elements), zeros past S. 16-byte cp.async copies; the
// caller commits, waits and synchronises.
template <int D>
__device__ __forceinline__ void stage(uint32_t tile, const __nv_bfloat16* src, int64_t stride,
                                      int S, int SP) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < SP * kChunks; i += blockDim.x) {
    const int r = i / kChunks, ch = i - r * kChunks;
    const __nv_bfloat16* g = src + (r < S ? r * stride + ch * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tile + off<D>(r, ch)),
                 "l"(g), "r"(r < S ? 16 : 0));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the A tile of rows r0 .. r0+15, columns k0 .. k0+15 of a row-major tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t tile, int r0, int k0, int lane,
                                       uint32_t (&a)[4]) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(tile + off<D>(r0 + r + 8 * (i & 1), (k0 >> 3) + (i >> 1)), a);
}

// the B tiles of two products of depth k0 .. k0+15, the first for columns
// n0 .. n0+7, the second for n0+8 .. n0+15, out of a tile whose rows are
// the columns (B = tile^T): b[0], b[1] and b[2], b[3]
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t tile, int n0, int k0, int lane,
                                          uint32_t (&b)[4]) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(tile + off<D>(n0 + r + 8 * (i >> 1), (k0 >> 3) + (i & 1)), b);
}

// the same out of a tile whose rows are the depth (B = tile), transposed
// by ldmatrix
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t tile, int k0, int n0, int lane,
                                          uint32_t (&b)[4]) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4_t(tile + off<D>(k0 + r + 8 * (i & 1), (n0 >> 3) + (i >> 1)), b);
}

// c += a . b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s += a . b for one 16-deep step of a score (or dP) product: the step
// taken from a zero accumulator and added with round-to-nearest (the first
// as it is), as the tensor cores truncate where they add into an
// accumulator. K18 and K22 take every score this way, so that the
// backward's max, l and p are the forward's.
__device__ __forceinline__ void mma_step_rn(float (&s)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1, bool first) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(p, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = first ? p[e] : __fadd_rn(s[e], p[e]);
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two accumulator tiles (columns 0-7 and 8-15) as the A tile of depth 16
__device__ __forceinline__ void as_a(const float (&t)[2][4], uint32_t (&a)[4]) {
  a[0] = pack_bf2(t[0][0], t[0][1]);
  a[1] = pack_bf2(t[0][2], t[0][3]);
  a[2] = pack_bf2(t[1][0], t[1][1]);
  a[3] = pack_bf2(t[1][2], t[1][3]);
}

// an f32 tile split into two bf16 A tiles, hi = bf16(v), lo = bf16(v - hi):
// hi + lo is v within 2^-17 |v| (v - hi is exact in f32)
__device__ __forceinline__ void as_a_split(const float (&t)[2][4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  float h[2][4], l[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[j][e] = round_bf16(t[j][e]);
      l[j][e] = __fsub_rn(t[j][e], h[j][e]);
    }
  as_a(h, hi);
  as_a(l, lo);
}

// the column of accumulator element e of tile j, within its 16 columns
__device__ __forceinline__ int col_of(int lane, int j, int e) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// a row's sum out of its four lanes' float64 sums, rounded once to f32: the
// terms are f32, so the float64 sum is all but exact and its rounding does
// not depend on the order the lanes took them in (K22's l and c)
__device__ __forceinline__ float quad_sum(double v) {
  v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return __double2float_rn(v);
}

// RN(a / b), given rb = RN(1 / b): q0 = RN(a rb) is within 1 ulp of a / b,
// the residual a - q0 b is exact in one FMA, and RN(q0 + r rb) is the
// correctly rounded quotient (Markstein's theorem) wherever it is a normal
// number; a zero a gives 0. Three operations where __fdiv_rn takes a dozen
// and a branch; no branch, so that an unrolled tile loop stays one block
// the compiler can schedule.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q0 = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q0, b, a), rb, q0);
}

// the f32 dot of rows ra of A and rb of B (swizzled tiles), d = 0, 1, ...
// in order, one FMA each: the order of the plain version's f32 product;
// out of line, as few values need it
template <int D>
__device__ __noinline__ float seq_dot(uint32_t A, int ra, uint32_t B, int rb) {
  float acc = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    __nv_bfloat162 ha, hb;
    *reinterpret_cast<uint32_t*>(&ha) = lds32(A + off<D>(ra, d >> 3) + (d & 7) * 2);
    *reinterpret_cast<uint32_t*>(&hb) = lds32(B + off<D>(rb, d >> 3) + (d & 7) * 2);
    const float2 fa = __bfloat1622float2(ha), fb = __bfloat1622float2(hb);
    acc = __fmaf_rn(fa.x, fb.x, acc);
    acc = __fmaf_rn(fa.y, fb.y, acc);
  }
  return acc;
}

// whether f, a tensor-core sum of terms whose magnitudes sum to a, might
// round to another bf16 value than the same sum taken in order: it lies
// within 64 f32 ulps, or within 2^-20 a, of a bf16 rounding midpoint. The
// two sums' rounding errors, grown as a random walk, stay near sqrt(D)
// 2^-24 a (2^-21 a at D = 64); the worst-case bound, D 2^-24 a, flags
// several times as many values and cost K22 a quarter of its time.
// chip_smoke.py compares K22 with its plain version on every call of the
// dense train step at six seeds, where a value this missed would stand
// out by many ulps of its row
__device__ __forceinline__ bool ambiguous(float f, float a) {
  const uint32_t u = __float_as_uint(f);
  const int low = static_cast<int>(u & 0xffffu) - 0x8000;
  const float mid = __uint_as_float((u & 0xffff0000u) | 0x8000u);
  return (low < 64 && low > -64) || fabsf(__fsub_rn(f, mid)) <= a * 0x1p-20f;
}

// shared memory a block may take (227 KB)
constexpr size_t kSmemMax = 232448;

// the persistent grid: resident blocks a multiprocessor times the
// multiprocessors of the current device, at most one block per (image,
// head)
template <typename K>
inline int grid_of(K kernel, int threads, size_t smem, int64_t items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = static_cast<int64_t>(per_sm) * sms;
  *grid = static_cast<int>(items < want ? items : want);
  return 0;
}

// the launch's shape checks, shared by K18 and K22
inline bool takes(int n, int s, int h) {
  return n >= 0 && s >= 1 && s <= kMaxSeq && h >= 1 && static_cast<int64_t>(n) * h <= 0x7fffffffLL;
}

// a kernel's dynamic shared memory and carveout, set before each launch
template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

// out[0..4] = registers a thread, local (spill) bytes a thread, dynamic
// shared bytes, threads and resident blocks a multiprocessor
template <typename K>
int info(K kernel, int threads, size_t bytes, int* out) {
  cudaError_t rc = prepare(kernel, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaFuncAttributes a;
  rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(bytes);
  out[3] = threads;
  out[4] = blocks;
  return static_cast<int>(rc);
}

}  // namespace attn
