// The tiled instantiations of K18 and K22 (vit_attention_tiled.cu,
// vit_attention_bwd_tiled.cu): the shapes past the tuned kernels' envelope
// (more than 256 tokens, or a head width outside K18's 32 / 64 / 128 and
// K22's 32 / 64), chosen by shape in picha_vit_attention and
// picha_vit_attention_bwd.
//
// The layout, chosen for the H100 (227 KB of shared memory and 64 K
// registers a multiprocessor):
//   - a block of 4 warps owns 64 rows of one (image, head), a warp 16 of
//     them: at 576 tokens a head is 9 full blocks, none half empty, and
//     two or three blocks share a multiprocessor;
//   - the other side's rows stream through shared memory in chunks of 64
//     (kChunk), double-buffered: the copy of the next chunk runs while
//     the warps multiply the current one. Every pass of a kernel walks the
//     same ring, so a kernel's steps are one sequence of (pass, chunk);
//   - a head row of width D <= 128 is stored as DP = D rounded up to 16
//     bf16 values, zero-padded (exact zeros add nothing to a dot), plus
//     16 bytes of row padding: the row stride is then 4 mod 8 words, so
//     the 8 row addresses of an ldmatrix phase land in 8 different 16-byte
//     bank groups;
//   - rows are copied with 16-byte cp.async where D is a multiple of 8
//     and the tensors are 16-byte aligned (heads of 40, 64, 80, 128), the
//     chunks past D and the rows past S filled with zeros by the copy
//     itself; other widths (43) are copied element by element inside the
//     same kernel, a warp a row, with no overlap;
//   - the A fragments of a warp's own rows that every pass reuses (q) are
//     loaded once into registers (DP / 16 x 4 of them);
//   - the work is instructions a score, not bytes (the reference's
//     rounding order keeps three score products in K18 and five in K22),
//     so a chunk whose rows are all below S takes a build of its tile
//     loop without the per-score mask, and the launch bounds ask for as
//     many blocks as shared memory allows up to D = 64 (four, or three
//     on K22's key side), trading a few spilled bytes for the warps that
//     hide the products' latency.
// The arithmetic is the tuned kernels' (the tensor-core pieces of
// vit_attention_mma.cuh), so where both take a shape they give the same
// bits.
#pragma once

#include "vit_attention_mma.cuh"

// host entry points of the tiled kernels (cudaGetLastError() or an error)
int attn_tiled_forward(const void* qkv, int n, int s, int h, int d, float scale, void* out,
                       cudaStream_t st);
int attn_tiled_backward(const void* qkv, const void* dout, int n, int s, int h, int d,
                        float scale, void* dqkv, void* stats, void* dp, cudaStream_t st);
int attn_tiled_forward_info(int d, int* out);
int attn_tiled_backward_info(int d, int* out);

namespace tiled {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // a block's own rows (queries, or keys)
constexpr int kChunk = 64;           // the other side's rows a staged chunk holds
constexpr int kMaxD = 128;
constexpr int kFixCap = 288;         // a warp's list of dP values to sum again

__host__ __device__ constexpr int stride_of(int dp) { return dp * 2 + 16; }

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// bytes of one staged tile (kChunk = kRows rows)
__host__ __device__ constexpr int tile_bytes(int dp) { return kChunk * stride_of(dp); }

__host__ __device__ constexpr int chunks(int s) { return (s + kChunk - 1) / kChunk; }

template <int DP>
__device__ __forceinline__ uint32_t at(uint32_t tile, int row, int chunk) {
  return tile + row * stride_of(DP) + (chunk << 4);
}

// rows [0, kChunk) of a tile: row r < valid from src + r * src_stride
// (bf16 elements), its first D columns; zeros in the columns D .. DP-1 and
// in the rows past `valid`. vec: 16-byte cp.async copies (D % 8 == 0, src
// 16-byte aligned), which the caller commits and waits for; else element
// copies. The caller synchronises.
template <int DP>
__device__ __forceinline__ void stage(uint8_t* tile, const __nv_bfloat16* src, int64_t src_stride,
                                      int valid, int D, bool vec) {
  constexpr int ST = stride_of(DP);
  if (vec) {
    constexpr int kC = DP / 8;   // 16-byte chunks a row
    const uint32_t t = attn::smem_addr(tile);
    for (int i = threadIdx.x; i < kChunk * kC; i += blockDim.x) {
      const int r = i / kC, c = i - r * kC;
      const bool in = r < valid && 8 * c < D;
      const __nv_bfloat16* g = src + (in ? r * src_stride + 8 * c : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(t + r * ST + 16 * c),
                   "l"(g), "r"(in ? 16 : 0));
    }
  } else {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    for (int r = threadIdx.x >> 5; r < kChunk; r += blockDim.x >> 5)
      for (int c = threadIdx.x & 31; c < DP; c += 32) {
        const uint16_t v = r < valid && c < D ? s16[r * src_stride + c] : static_cast<uint16_t>(0);
        *reinterpret_cast<uint16_t*>(tile + r * ST + 2 * c) = v;
      }
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

// A operands of rows r0 .. r0+15 of a staged tile: held in registers
// (RegA, loaded once by init) or read from shared memory at every use
// (SmemA)
template <int DP>
struct RegA {
  uint32_t f[DP / 16][4];
  __device__ __forceinline__ void init(uint32_t tile, int r0, int lane) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) load_a<DP>(tile, r0, 16 * kk, lane, f[kk]);
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
  }
};

template <int DP>
struct SmemA {
  uint32_t tile;
  int r0, lane;
  __device__ __forceinline__ void init(uint32_t t, int r, int l) {
    tile = t;
    r0 = r;
    lane = l;
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
    load_a<DP>(tile, r0, 16 * kk, lane, a);
  }
};

// s[i] = A . X[16 (t0 + i) .. + 15]^T for NT key tiles, as K18 sums the
// scores: each 16-deep step from a zero accumulator, the steps added with
// round-to-nearest (a tile's bits do not depend on NT; with NT > 1 the
// tiles' steps interleave, so that their products are in flight together)
template <int DP, int NT, typename AS>
__device__ __forceinline__ void dots(const AS& A, uint32_t X, int t0, int lane,
                                     float (&s)[NT][2][4]) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    A.get(kk, a);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint32_t b[4];
      load_b_nk<DP>(X, 16 * (t0 + i), 16 * kk, lane, b);
      attn::mma_step_rn(s[i][0], a, b[0], b[1], kk == 0);
      attn::mma_step_rn(s[i][1], a, b[2], b[3], kk == 0);
    }
  }
}

// dp[i] = A . X^T as `dots` sums it, and ab[i] = |A| . |X|^T, the sum of
// its terms' magnitudes, from one load of each fragment
template <int DP, int NT, typename AS>
__device__ __forceinline__ void dots_abs(const AS& A, uint32_t X, int t0, int lane,
                                         float (&dp)[NT][2][4], float (&ab)[NT][2][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ab[i][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], aa[4];
    A.get(kk, a);
#pragma unroll
    for (int e = 0; e < 4; ++e) aa[e] = a[e] & 0x7fff7fffu;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint32_t b[4];
      load_b_nk<DP>(X, 16 * (t0 + i), 16 * kk, lane, b);
      attn::mma_step_rn(dp[i][0], a, b[0], b[1], kk == 0);
      attn::mma_step_rn(dp[i][1], a, b[2], b[3], kk == 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] &= 0x7fff7fffu;
      attn::mma(ab[i][0], aa, b[0], b[1]);
      attn::mma(ab[i][1], aa, b[2], b[3]);
    }
  }
}

// s *= scale, elementwise (the scores' rounding point after the dot)
template <int NT>
__device__ __forceinline__ void scaled(float (&s)[NT][2][4], float scale) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = __fmul_rn(s[i][j][e], scale);
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
// 1, ... in order, one FMA each (attn::seq_dot's order); 16-byte loads,
// unrolled, so that the chain of D dependent FMAs is the only wait; out
// of line, as few values need it
template <int DP>
__device__ __noinline__ float seq_dot(uint32_t A, int ra, uint32_t B, int rb, int D) {
  const uint32_t pa = A + ra * stride_of(DP), pb = B + rb * stride_of(DP);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    if (8 * c >= D) break;
    uint32_t a[4], b[4];
    asm("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(pa + 16 * c));
    asm("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
        : "r"(pb + 16 * c));
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (8 * c + e < D) {
        const uint32_t wa = a[e >> 1] >> (16 * (e & 1)), wb = b[e >> 1] >> (16 * (e & 1));
        acc = __fmaf_rn(__bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(wa))),
                        __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(wb))), acc);
      }
  }
  return acc;
}

// (n, h, block) of a block index: `blocks` blocks a head
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

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;   // a block's own rows
constexpr int kOut = 128;            // output columns a block owns

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

// dP rounded to bf16, its ambiguous values summed again in order first
// (attn::ambiguous; one value at a time, per tile)
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
