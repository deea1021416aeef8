// K6: dequantisation + 8x8 inverse DCT of one JPEG component, straight
// to its cropped uint8 sample plane.
//
// Replaces: picha_tpu/ops/jpeg_tpu.py::dequant_idct_plane (the first
// stage of build_decode_stage). The TPU graph multiplies the blocks by
// the quantisation table, runs the (64, 64) Kronecker IDCT as one large
// matmul on the MXU, reshapes blocks to raster, adds 128, rounds half
// to even (jnp.round), clips to [0, 255] and crops to the component's
// (dh, dw) plane, materialising the f32 samples in HBM between steps.
//
// The arithmetic, fixed since the first port: sample p of a block is
// the k-ordered chain acc = fmaf(f[k], kron[k][p], acc) from acc = 0
// over the 64 dequantised coefficients f[k] = float(coef) * float(q),
// then rintf(acc + 128) (half to even) clipped to [0, 255]. A sample may
// differ from the plain version's matmul by one where its value lies
// within f32 rounding of a .5 tie.
//
// What bounds it on an H100: a JPEG block at q85 holds a few nonzero
// coefficients (the 1080p corpus: 13 of 64 in luma blocks, 3 in chroma).
// fmaf(0, k, acc) is acc, so the chain over the nonzero coefficients
// alone gives the same bits as the whole chain (at most the sign of a
// zero acc differs, which neither a later product nor + 128 sees), and so
// does a chain over any superset of them. With the zeros skipped the
// work is reading the int coefficients (4 bytes a sample for int32) and
// writing one byte a sample: bytes, not the FP32 pipe (64 FMAs a sample
// dense). In this kernel the products still dominate (each a 4-byte
// shared-memory load of the Kronecker matrix unless a loaded value
// serves several blocks): without them a luma plane of 16 1080p images
// takes 0.077 of its 0.17 ms on an H100, and int16 coefficients are no
// faster than int32.
//
// The design: a persistent grid of 256-thread CTAs walks tiles of 32
// blocks along one block row. Each tile's raw coefficients arrive by
// 16-byte cp.async into a ring of kStages tile buffers. A tile is
// dequantised into shared memory (transposed so that a coefficient's
// values in four blocks are one float4) with a ballot a half block giving
// each block's 64-bit nonzero mask. Then a warp takes four blocks: it
// walks the union of their masks in k order, each thread owning two
// samples of each block, each step one broadcast float4 of the four
// blocks' coefficients and one float2 of the Kronecker row, eight FMAs
// into eight accumulators. The 8 x 256 output bytes are staged in shared
// memory and stored a row a warp, 8 bytes a thread where aligned. Tile
// indices are 32-bit, one division a tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBlk = 32;                     // 8x8 blocks a tile
constexpr int kWarpBlk = 4;                      // blocks a warp computes
constexpr int kStages = 2;                       // tile buffers (cp.async ring)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned to_byte(float acc) {
  return static_cast<unsigned>(fminf(fmaxf(rintf(acc + 128.0f), 0.0f), 255.0f));
}

struct Geom {
  int bh, bw, dh, dw, tiles_per_row, n_tiles;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) idct_plane_kernel(
    const T* __restrict__ coefs, const int* __restrict__ qtab,
    const float* __restrict__ kron, Geom g, uint8_t* __restrict__ out) {
  constexpr int kTileBytes = kTileBlk * 64 * static_cast<int>(sizeof(T));
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  auto raw = reinterpret_cast<unsigned char (*)[kTileBytes]>(smem);
  auto kron_s = reinterpret_cast<float (*)[64]>(smem + kStages * kTileBytes);
  // f[w][k][j]: coefficient k of block kWarpBlk * w + j, dequantised
  __shared__ __align__(16) float f[kWarps][64][kWarpBlk];
  __shared__ unsigned mask[kTileBlk][2];
  __shared__ __align__(16) uint8_t pix[8][kTileBlk * 8];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int i = t; i < 64 * 64 / 4; i += kThreads)
    reinterpret_cast<float4*>(&kron_s[0][0])[i] = reinterpret_cast<const float4*>(kron)[i];

  auto issue = [&](int tile, int slot) {
    if (tile < g.n_tiles) {
      const int row = tile / g.tiles_per_row;
      const int bx0 = (tile - row * g.tiles_per_row) * kTileBlk;
      const int nb = min(kTileBlk, g.bw - bx0);
      const int chunks = nb * 64 * static_cast<int>(sizeof(T)) / 16;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          coefs + (static_cast<int64_t>(row) * g.bw + bx0) * 64);
      for (int c = t; c < chunks; c += kThreads)
        cp_async16(raw[slot] + c * 16, src + c * 16);
    }
    cp_commit();
  };

  const int step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(blockIdx.x + s * step, s);
  int it = 0;
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += step, ++it) {
    issue(tile + (kStages - 1) * step, (it + kStages - 1) % kStages);
    cp_wait<kStages - 1>();
    __syncthreads();
    const int row = tile / g.tiles_per_row;
    const int bx0 = (tile - row * g.tiles_per_row) * kTileBlk;
    const int nb = min(kTileBlk, g.bw - bx0);
    const int img = row / g.bh;
    const int by = row - img * g.bh;
    // dequantise; each warp's ballot is half a block's nonzero mask
    const T* rs = reinterpret_cast<const T*>(raw[it % kStages]);
    const int* qt = qtab + img * 64;
#pragma unroll
    for (int i = 0; i < kTileBlk * 64 / kThreads; ++i) {
      const int e = i * kThreads + t;
      const int b = e >> 6, k = e & 63;
      float v = 0.0f;
      if (b < nb) v = static_cast<float>(rs[e]) * static_cast<float>(__ldg(qt + k));
      f[b / kWarpBlk][k][b % kWarpBlk] = v;
      const unsigned m = __ballot_sync(kFull, v != 0.0f);
      if (lane == 0) mask[b][k >> 5] = m;
    }
    __syncthreads();
    const int b0 = warp * kWarpBlk;
    if (b0 < nb) {
      unsigned lo = 0, hi = 0;  // the union of the warp's blocks' masks
#pragma unroll
      for (int j = 0; j < kWarpBlk; ++j) {
        lo |= mask[b0 + j][0];
        hi |= mask[b0 + j][1];
      }
      float acc[kWarpBlk][2];
#pragma unroll
      for (int j = 0; j < kWarpBlk; ++j) acc[j][0] = acc[j][1] = 0.0f;
      // the coefficients nonzero in any of the four, in k order: the
      // first 32, then the rest
      for (int k0 = 0; k0 < 64; k0 += 32) {
        for (unsigned m = k0 ? hi : lo; m; m &= m - 1) {
          const int k = k0 + __ffs(m) - 1;
          const float4 v = *reinterpret_cast<const float4*>(f[warp][k]);
          const float2 kk = reinterpret_cast<const float2*>(kron_s[k])[lane];
          acc[0][0] = fmaf(v.x, kk.x, acc[0][0]);
          acc[0][1] = fmaf(v.x, kk.y, acc[0][1]);
          acc[1][0] = fmaf(v.y, kk.x, acc[1][0]);
          acc[1][1] = fmaf(v.y, kk.y, acc[1][1]);
          acc[2][0] = fmaf(v.z, kk.x, acc[2][0]);
          acc[2][1] = fmaf(v.z, kk.y, acc[2][1]);
          acc[3][0] = fmaf(v.w, kk.x, acc[3][0]);
          acc[3][1] = fmaf(v.w, kk.y, acc[3][1]);
        }
      }
      // samples 2 lane, 2 lane + 1: row lane >> 2, columns 2 (lane & 3)
#pragma unroll
      for (int j = 0; j < kWarpBlk; ++j) {
        const unsigned px = to_byte(acc[j][0]) | (to_byte(acc[j][1]) << 8);
        *reinterpret_cast<uint16_t*>(&pix[lane >> 2][(b0 + j) * 8 + (lane & 3) * 2]) =
            static_cast<uint16_t>(px);
      }
    }
    __syncthreads();
    // a warp a sample row: 8 bytes a thread
    const int y = by * 8 + warp;
    const int x0 = bx0 * 8;
    const int width = min(nb * 8, g.dw - x0);
    const int c = lane * 8;
    if (y < g.dh && c < width) {
      uint8_t* dst = out + (static_cast<int64_t>(img) * g.dh + y) * g.dw + x0 + c;
      if (c + 8 <= width && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(&pix[warp][c]);
      } else {
        for (int k = 0; k < 8 && c + k < width; ++k) dst[k] = pix[warp][c + k];
      }
    }
  }
  cp_wait<0>();
}

// Dynamic shared bytes: the tile ring and the Kronecker matrix.
template <typename T>
constexpr size_t dyn_smem() {
  return static_cast<size_t>(kStages) * kTileBlk * 64 * sizeof(T) + 64 * 64 * sizeof(float);
}

template <typename T>
int resident_ctas() {
  cudaFuncSetAttribute(idct_plane_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dyn_smem<T>()));
  int per_sm = 0, sms = 132, dev = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, idct_plane_kernel<T>,
                                                kThreads, dyn_smem<T>());
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm * sms;
}

template <typename T>
int launch(const void* coefs, const void* qtab, const void* kron, const Geom& g,
           void* out, cudaStream_t s) {
  int grid = resident_ctas<T>();
  if (grid > g.n_tiles) grid = g.n_tiles;
  if (grid < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  idct_plane_kernel<T><<<grid, kThreads, dyn_smem<T>(), s>>>(
      static_cast<const T*>(coefs), static_cast<const int*>(qtab),
      static_cast<const float*>(kron), g, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coefs: (N, bh, bw, 64) int16 (elem_bytes 2) or int32 (elem_bytes 4),
// natural coefficient order, 16-byte aligned; qtab: (N, 64) int32, one
// table per image; kron: the (64, 64) float32 Kronecker IDCT
// (picha_tpu.ops.jpeg_tpu._idct_kron, pixel = coef @ kron); out: (N, dh,
// dw) uint8 with dh <= 8 bh, dw <= 8 bw. Returns cudaGetLastError().
extern "C" int picha_idct_plane(const void* coefs, int elem_bytes, const void* qtab,
                                const void* kron, int n_img, int bh, int bw, int dh,
                                int dw, void* out, void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || dh > 8 * bh || dw > 8 * bw ||
      (reinterpret_cast<uintptr_t>(coefs) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_img <= 0 || bh <= 0 || bw <= 0 || dh <= 0 || dw <= 0)
    return static_cast<int>(cudaGetLastError());
  const int tiles_per_row = (bw + kTileBlk - 1) / kTileBlk;
  const int64_t n_tiles = static_cast<int64_t>(n_img) * bh * tiles_per_row;
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{bh, bw, dh, dw, tiles_per_row, static_cast<int>(n_tiles)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2 ? launch<int16_t>(coefs, qtab, kron, g, out, s)
                         : launch<int32_t>(coefs, qtab, kron, g, out, s);
}

// K6's build for elem_bytes 2 or 4: out[0..6] = registers, local bytes a
// thread, static shared bytes, resident blocks an SM, threads a block,
// tile buffers in flight, dynamic shared bytes.
extern "C" int picha_idct_plane_info(int elem_bytes, int* out) {
  cudaFuncAttributes fa;
  const bool narrow = elem_bytes == 2;
  const void* fn = narrow ? reinterpret_cast<const void*>(idct_plane_kernel<int16_t>)
                          : reinterpret_cast<const void*>(idct_plane_kernel<int32_t>);
  const int per_sm = (narrow ? resident_ctas<int16_t>() : resident_ctas<int32_t>());
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = per_sm / sms;
  out[4] = kThreads;
  out[5] = kStages;
  out[6] = static_cast<int>(narrow ? dyn_smem<int16_t>() : dyn_smem<int32_t>());
  return static_cast<int>(cudaGetLastError());
}
