// The tiled instantiations of K18 and K22 (vit_attention_tiled.cu,
// vit_attention_bwd_tiled.cu): the shapes past the tuned kernels' envelope
// (more than 256 tokens, or a head width outside K18's 32 / 64 / 128 and
// K22's 32 / 64), chosen by shape in picha_vit_attention and
// picha_vit_attention_bwd.
//
// A block owns 128 rows of one (image, head), a warp 16 of them, and walks
// the other side's rows in chunks of at most 256 staged into shared memory.
// A head row of width D <= 128 is stored as DP = D rounded up to 16 bf16
// values, zero-padded (exact zeros add nothing to a dot), plus 16 bytes of
// row padding: the row stride is then 4 mod 8 words, so the 8 row
// addresses of an ldmatrix phase land in 8 different 16-byte bank groups.
// Rows are staged with single bf16 loads: a head of odd width starts at
// any 2-byte boundary. The arithmetic is the tuned kernels' (the
// tensor-core pieces of vit_attention_mma.cuh), so where both take a
// shape they give the same bits.
#pragma once

#include "vit_attention_mma.cuh"

// host entry points of the tiled kernels (cudaGetLastError() or an error)
int attn_tiled_forward(const void* qkv, int n, int s, int h, int d, float scale, void* out,
                       cudaStream_t st);
int attn_tiled_backward(const void* qkv, const void* dout, int n, int s, int h, int d,
                        float scale, void* dqkv, void* stats, cudaStream_t st);
int attn_tiled_forward_info(int d, int* out);
int attn_tiled_backward_info(int d, int* out);

namespace tiled {

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;   // a block's own rows (queries, or keys)
constexpr int kChunk = 256;          // the other side's rows staged at a time
constexpr int kMaxD = 128;

__host__ __device__ constexpr int stride_of(int dp) { return dp * 2 + 16; }

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// bytes of dynamic shared memory: two tiles of kRows and two of kChunk rows
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return static_cast<size_t>(2 * kRows + 2 * kChunk) * stride_of(dp);
}

template <int DP>
__device__ __forceinline__ uint32_t at(uint32_t tile, int row, int chunk) {
  return tile + row * stride_of(DP) + (chunk << 4);
}

// rows [0, rows) of a tile: row r < valid from src + r * src_stride (bf16
// elements), its first D columns; zeros in the columns D .. DP-1 and in
// the rows past `valid`. The caller synchronises.
template <int DP>
__device__ __forceinline__ void stage(uint8_t* tile, const __nv_bfloat16* src, int64_t src_stride,
                                      int valid, int rows, int D) {
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
  for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
    const int r = i / DP, c = i - r * DP;
    const uint16_t v = r < valid && c < D ? s16[r * src_stride + c] : static_cast<uint16_t>(0);
    *reinterpret_cast<uint16_t*>(tile + r * stride_of(DP) + c * 2) = v;
  }
}

// the A tile of rows r0 .. r0+15, columns k0 .. k0+15
template <int DP>
__device__ __forceinline__ void load_a(uint32_t tile, int r0, int k0, int lane, uint32_t (&a)[4]) {
  const int i = lane >> 3, r = lane & 7;
  attn::ldsm_x4(at<DP>(tile, r0 + r + 8 * (i & 1), (k0 >> 3) + (i >> 1)), a);
}

// the B tiles of depth k0 .. k0+15 for columns n0 .. n0+7 and n0+8 .. n0+15
// out of a tile whose rows are the columns (B = tile^T)
template <int DP>
__device__ __forceinline__ void load_b_nk(uint32_t tile, int n0, int k0, int lane,
                                          uint32_t (&b)[4]) {
  const int i = lane >> 3, r = lane & 7;
  attn::ldsm_x4(at<DP>(tile, n0 + r + 8 * (i >> 1), (k0 >> 3) + (i & 1)), b);
}

// the same out of a tile whose rows are the depth (B = tile)
template <int DP>
__device__ __forceinline__ void load_b_kn(uint32_t tile, int k0, int n0, int lane,
                                          uint32_t (&b)[4]) {
  const int i = lane >> 3, r = lane & 7;
  attn::ldsm_x4_t(at<DP>(tile, k0 + r + 8 * (i & 1), (n0 >> 3) + (i >> 1)), b);
}

// s = A[r0 .. r0+15] . X[16 t .. 16 t + 15]^T as K18 sums the scores (each
// 16-deep step from a zero accumulator, the steps added with
// round-to-nearest); A's fragments loaded as they are needed
template <int DP>
__device__ __forceinline__ void dots(uint32_t A, int r0, uint32_t X, int t, int lane,
                                     float (&s)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], b[4];
    load_a<DP>(A, r0, 16 * kk, lane, a);
    load_b_nk<DP>(X, 16 * t, 16 * kk, lane, b);
    attn::mma_step_rn(s[0], a, b[0], b[1], kk == 0);
    attn::mma_step_rn(s[1], a, b[2], b[3], kk == 0);
  }
}

// s = |A| . |X|^T, the sum of the terms' magnitudes
template <int DP>
__device__ __forceinline__ void dots_abs(uint32_t A, int r0, uint32_t X, int t, int lane,
                                         float (&s)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], b[4];
    load_a<DP>(A, r0, 16 * kk, lane, a);
    load_b_nk<DP>(X, 16 * t, 16 * kk, lane, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] &= 0x7fff7fffu;
      b[i] &= 0x7fff7fffu;
    }
    attn::mma(s[0], a, b[0], b[1]);
    attn::mma(s[1], a, b[2], b[3]);
  }
}

// acc[t] += a . M[rows k0 .. k0+15, columns 8 t ..]
template <int DP>
__device__ __forceinline__ void times(const uint32_t (&a)[4], uint32_t m, int k0, int lane,
                                      float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int t = 0; t < DP / 16; ++t) {
    uint32_t b[4];
    load_b_kn<DP>(m, k0, 16 * t, lane, b);
    attn::mma(acc[2 * t], a, b[0], b[1]);
    attn::mma(acc[2 * t + 1], a, b[2], b[3]);
  }
}

// acc += dS . M, dS given as its two bf16 terms (hi, lo) into one
// accumulator
template <int DP>
__device__ __forceinline__ void ds_times(const float (&ds)[2][4], uint32_t m, int k0, int lane,
                                         float (&acc)[DP / 8][4]) {
  uint32_t hi[4], lo[4];
  attn::as_a_split(ds, hi, lo);
#pragma unroll
  for (int t = 0; t < DP / 16; ++t) {
    uint32_t b[4];
    load_b_kn<DP>(m, k0, 16 * t, lane, b);
    attn::mma(acc[2 * t], hi, b[0], b[1]);
    attn::mma(acc[2 * t], lo, b[0], b[1]);
    attn::mma(acc[2 * t + 1], hi, b[2], b[3]);
    attn::mma(acc[2 * t + 1], lo, b[2], b[3]);
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int t = 0; t < DP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
}

// rows r0 + g and r0 + g + 8 (below `rows`) of acc, rounded to bf16, at
// dst + row * stride + column for the columns below D
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4], __nv_bfloat16* dst,
                                           int64_t stride, int r0, int rows, int D, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + (lane >> 2) + 8 * half;
    if (row >= rows) continue;
    __nv_bfloat16* p = dst + row * stride;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int col = 8 * t + 2 * (lane & 3);
      if (col < D) p[col] = __float2bfloat16_rn(acc[t][2 * half]);
      if (col + 1 < D) p[col + 1] = __float2bfloat16_rn(acc[t][2 * half + 1]);
    }
  }
}

// the f32 dot of rows ra of A and rb of B over the D real columns, d = 0,
// 1, ... in order, one FMA each (attn::seq_dot's order); out of line, as
// few values need it
template <int DP>
__device__ __noinline__ float seq_dot(uint32_t A, int ra, uint32_t B, int rb, int D) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) {
    uint16_t ha, hb;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(ha) : "r"(A + ra * stride_of(DP) + 2 * d));
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(hb) : "r"(B + rb * stride_of(DP) + 2 * d));
    acc = __fmaf_rn(__bfloat162float(__ushort_as_bfloat16(ha)),
                    __bfloat162float(__ushort_as_bfloat16(hb)), acc);
  }
  return acc;
}

// an f32 dP tile (rows r0 + g (+ 8) of A, rows 16 t + col of B; ab: its
// terms' magnitudes) rounded to bf16, its ambiguous values summed again in
// order first (K22's settling, per tile)
template <int DP>
__device__ __forceinline__ void resum_round(uint32_t A, int r0, uint32_t B, int t, int D,
                                            int lane, const float (&ab)[2][4],
                                            float (&dp)[2][4]) {
  uint32_t amb = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    amb |= static_cast<uint32_t>(attn::ambiguous(dp[k >> 2][k & 3], ab[k >> 2][k & 3])) << k;
  if (__any_sync(0xffffffffu, amb)) {
#pragma unroll 1
    for (int k = 0; k < 8; ++k)
      if (amb >> k & 1u)
        dp[k >> 2][k & 3] = seq_dot<DP>(A, r0 + (lane >> 2) + 8 * ((k & 3) >> 1), B,
                                        16 * t + attn::col_of(lane, k >> 2, k & 3), D);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) dp[k >> 2][k & 3] = attn::round_bf16(dp[k >> 2][k & 3]);
}

// (n, h, block) of a block index: `blocks` blocks of kRows rows a head
__device__ __forceinline__ void item_of(int64_t item, int H, int blocks, int64_t& n, int& h,
                                        int& b) {
  b = static_cast<int>(item % blocks);
  const int64_t nh = item / blocks;
  h = static_cast<int>(nh % H);
  n = nh / H;
}

}  // namespace tiled

// The wide kernels (head widths past tiled::kMaxD): the tiled kernels'
// passes and rounding points with every operand fragment loaded from
// global memory. A block owns kRows rows of one (image, head) and one
// window of kOut output columns; each block recomputes the scores (and
// dP) over all D, so the work grows with the number of windows: a
// correct, slow path for the rare configurations that need it.
namespace wide {

constexpr int kOut = 128;   // output columns a block owns

// a bf16 matrix in global memory: row r < rows at p + r * stride, columns
// below cols; zeros elsewhere (the mma's padding)
struct Mat {
  const uint16_t* p;
  int64_t stride;
  int rows, cols;
};

__device__ __forceinline__ uint32_t elem(const Mat& m, int r, int c) {
  return r < m.rows && c < m.cols ? static_cast<uint32_t>(__ldg(m.p + r * m.stride + c)) : 0u;
}

// elements (r, c) and (r, c + 1), packed low / high as a fragment register
__device__ __forceinline__ uint32_t pair_row(const Mat& m, int r, int c) {
  return elem(m, r, c) | (elem(m, r, c + 1) << 16);
}

// elements (r, c) and (r + 1, c)
__device__ __forceinline__ uint32_t pair_col(const Mat& m, int r, int c) {
  return elem(m, r, c) | (elem(m, r + 1, c) << 16);
}

// the A tile of rows r0 .. r0+15, columns k0 .. k0+15 (ldmatrix's layout,
// vit_attention_mma.cuh)
__device__ __forceinline__ void load_a(const Mat& m, int r0, int k0, int lane, uint32_t (&a)[4]) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  a[0] = pair_row(m, r0 + g, k0 + c);
  a[1] = pair_row(m, r0 + g + 8, k0 + c);
  a[2] = pair_row(m, r0 + g, k0 + c + 8);
  a[3] = pair_row(m, r0 + g + 8, k0 + c + 8);
}

// B = m^T: depth k0 .. k0+15, columns n0 .. n0+7 (b[0], b[1]) and n0+8 ..
// n0+15 (b[2], b[3])
__device__ __forceinline__ void load_b_nk(const Mat& m, int n0, int k0, int lane,
                                          uint32_t (&b)[4]) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  b[0] = pair_row(m, n0 + g, k0 + c);
  b[1] = pair_row(m, n0 + g, k0 + c + 8);
  b[2] = pair_row(m, n0 + g + 8, k0 + c);
  b[3] = pair_row(m, n0 + g + 8, k0 + c + 8);
}

// B = m: depth (rows) k0 .. k0+15, columns n0 .. n0+15
__device__ __forceinline__ void load_b_kn(const Mat& m, int k0, int n0, int lane,
                                          uint32_t (&b)[4]) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  b[0] = pair_col(m, k0 + c, n0 + g);
  b[1] = pair_col(m, k0 + c + 8, n0 + g);
  b[2] = pair_col(m, k0 + c, n0 + g + 8);
  b[3] = pair_col(m, k0 + c + 8, n0 + g + 8);
}

// s = A[r0 ..] . X[16 t ..]^T over the D = A.cols columns, each 16-deep
// step from a zero accumulator added with round-to-nearest (the tiled
// kernels' dots, over as many steps as D takes)
__device__ __forceinline__ void dots(const Mat& A, int r0, const Mat& X, int t, int lane,
                                     float (&s)[2][4]) {
  const int steps = (A.cols + 15) / 16;
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t a[4], b[4];
    load_a(A, r0, 16 * kk, lane, a);
    load_b_nk(X, 16 * t, 16 * kk, lane, b);
    attn::mma_step_rn(s[0], a, b[0], b[1], kk == 0);
    attn::mma_step_rn(s[1], a, b[2], b[3], kk == 0);
  }
}

// s = |A| . |X|^T
__device__ __forceinline__ void dots_abs(const Mat& A, int r0, const Mat& X, int t, int lane,
                                         float (&s)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  const int steps = (A.cols + 15) / 16;
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t a[4], b[4];
    load_a(A, r0, 16 * kk, lane, a);
    load_b_nk(X, 16 * t, 16 * kk, lane, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] &= 0x7fff7fffu;
      b[i] &= 0x7fff7fffu;
    }
    attn::mma(s[0], a, b[0], b[1]);
    attn::mma(s[1], a, b[2], b[3]);
  }
}

// acc[t] += a . M[rows k0 .. k0+15, window columns 8 t ..]
__device__ __forceinline__ void times(const uint32_t (&a)[4], const Mat& m, int k0, int lane,
                                      float (&acc)[kOut / 8][4]) {
#pragma unroll
  for (int t = 0; t < kOut / 16; ++t) {
    uint32_t b[4];
    load_b_kn(m, k0, 16 * t, lane, b);
    attn::mma(acc[2 * t], a, b[0], b[1]);
    attn::mma(acc[2 * t + 1], a, b[2], b[3]);
  }
}

// acc += dS . M, dS as its two bf16 terms (hi, lo)
__device__ __forceinline__ void ds_times(const float (&ds)[2][4], const Mat& m, int k0, int lane,
                                         float (&acc)[kOut / 8][4]) {
  uint32_t hi[4], lo[4];
  attn::as_a_split(ds, hi, lo);
#pragma unroll
  for (int t = 0; t < kOut / 16; ++t) {
    uint32_t b[4];
    load_b_kn(m, k0, 16 * t, lane, b);
    attn::mma(acc[2 * t], hi, b[0], b[1]);
    attn::mma(acc[2 * t], lo, b[0], b[1]);
    attn::mma(acc[2 * t + 1], hi, b[2], b[3]);
    attn::mma(acc[2 * t + 1], lo, b[2], b[3]);
  }
}

// the f32 dot of rows ra of A and rb of B over their columns, in order,
// one FMA each (the tiled kernels' seq_dot)
static __device__ __noinline__ float seq_dot(Mat A, int ra, Mat B, int rb) {
  float acc = 0.0f;
  for (int d = 0; d < A.cols; ++d)
    acc = __fmaf_rn(__bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(elem(A, ra, d)))),
                    __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(elem(B, rb, d)))),
                    acc);
  return acc;
}

// the tiled kernels' resum_round: dP rounded to bf16, its ambiguous values
// summed again in order first
__device__ __forceinline__ void resum_round(const Mat& A, int r0, const Mat& B, int t, int lane,
                                            const float (&ab)[2][4], float (&dp)[2][4]) {
  uint32_t amb = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    amb |= static_cast<uint32_t>(attn::ambiguous(dp[k >> 2][k & 3], ab[k >> 2][k & 3])) << k;
  if (__any_sync(0xffffffffu, amb)) {
#pragma unroll 1
    for (int k = 0; k < 8; ++k)
      if (amb >> k & 1u)
        dp[k >> 2][k & 3] = seq_dot(A, r0 + (lane >> 2) + 8 * ((k & 3) >> 1), B,
                                    16 * t + attn::col_of(lane, k >> 2, k & 3));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) dp[k >> 2][k & 3] = attn::round_bf16(dp[k >> 2][k & 3]);
}

__device__ __forceinline__ void zero(float (&acc)[kOut / 8][4]) {
#pragma unroll
  for (int t = 0; t < kOut / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
}

// rows r0 + g (+ 8) below `rows` of the window's accumulators, rounded to
// bf16, at dst + row * stride + column for the columns below `cols`
__device__ __forceinline__ void store_rows(const float (&acc)[kOut / 8][4], __nv_bfloat16* dst,
                                           int64_t stride, int r0, int rows, int cols, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + (lane >> 2) + 8 * half;
    if (row >= rows) continue;
    __nv_bfloat16* p = dst + row * stride;
#pragma unroll
    for (int t = 0; t < kOut / 8; ++t) {
      const int col = 8 * t + 2 * (lane & 3);
      if (col < cols) p[col] = __float2bfloat16_rn(acc[t][2 * half]);
      if (col + 1 < cols) p[col + 1] = __float2bfloat16_rn(acc[t][2 * half + 1]);
    }
  }
}

// a head's rows from `row0`, `rows` of them, columns [c0, D)
__device__ __forceinline__ Mat mat(const __nv_bfloat16* base, int64_t stride, int row0, int rows,
                                   int c0, int D) {
  return Mat{reinterpret_cast<const uint16_t*>(base) + row0 * stride + c0, stride, rows, D - c0};
}

// (n, h, row block, window) of a block index
__device__ __forceinline__ void item_of(int64_t item, int H, int blocks, int windows, int64_t& n,
                                        int& h, int& b, int& w) {
  w = static_cast<int>(item % windows);
  tiled::item_of(item / windows, H, blocks, n, h, b);
}

}  // namespace wide
