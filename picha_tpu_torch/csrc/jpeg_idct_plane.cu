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
// What bounds it on an H100: 64 multiply-adds per output sample (3.2 G
// FMA for 16 x 1080p 4:2:0) against ~4 B read and 1 B written per
// sample, so the FP32 pipe, not memory. A dot product that read both
// operands from shared memory would instead be bound by shared-memory
// loads (two per FMA). The design: each thread owns one sample position
// p of the 8x8 block and keeps column p of the Kronecker matrix in 64
// registers for the whole launch; a CUDA block stages the dequantised
// coefficients of 16 blocks in shared memory (coalesced loads, one
// table row per image) and every thread then runs 64 sequential FMAs
// per block, reading the coefficients as float4 broadcasts (one shared
// load per 4 FMAs). Rounding is rintf (half to even, exact ties of
// flat blocks included), then clip and a byte store inside the crop.
// The sum runs in k order with FMA, so a sample may differ from the
// plain version's matmul by one where its value lies within f32
// rounding of a .5 tie.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 64;     // 64-thread groups per CUDA block
constexpr int kPerGroup = 4;               // 8x8 blocks per 64-thread group
constexpr int kTile = kGroups * kPerGroup; // 8x8 blocks per iteration

template <typename T>
__global__ void __launch_bounds__(kThreads) idct_plane_kernel(
    const T* __restrict__ coefs, const int* __restrict__ qtab,
    const float* __restrict__ kron, int n_img, int bh, int bw, int dh, int dw,
    uint8_t* __restrict__ out) {
  __shared__ __align__(16) float f[kTile][64];
  const int t = threadIdx.x;
  const int p = t & 63;                 // sample position (row p>>3, col p&7)
  const int group = t >> 6;
  float kc[64];                         // kron[:, p]
#pragma unroll
  for (int k = 0; k < 64; ++k) kc[k] = kron[k * 64 + p];

  const int per_img = bh * bw;
  const int64_t total = static_cast<int64_t>(n_img) * per_img;
  const int64_t tiles = (total + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t first = tile * kTile;
    // load kTile blocks of 64 coefficients: element e of the tile
#pragma unroll
    for (int i = 0; i < kTile * 64 / kThreads; ++i) {
      const int e = i * kThreads + t;
      const int64_t blk = first + (e >> 6);
      float v = 0.0f;
      if (blk < total) {
        const int k = e & 63;
        const int img = static_cast<int>(blk / per_img);
        v = static_cast<float>(coefs[blk * 64 + k]) *
            static_cast<float>(qtab[img * 64 + k]);
      }
      f[e >> 6][e & 63] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerGroup; ++j) {
      const int b = group * kPerGroup + j;
      const int64_t blk = first + b;
      if (blk < total) {
        const float4* fb = reinterpret_cast<const float4*>(f[b]);
        float acc = 0.0f;
#pragma unroll
        for (int k4 = 0; k4 < 16; ++k4) {
          const float4 v = fb[k4];
          acc = fmaf(v.x, kc[4 * k4 + 0], acc);
          acc = fmaf(v.y, kc[4 * k4 + 1], acc);
          acc = fmaf(v.z, kc[4 * k4 + 2], acc);
          acc = fmaf(v.w, kc[4 * k4 + 3], acc);
        }
        const int img = static_cast<int>(blk / per_img);
        const int rel = static_cast<int>(blk - static_cast<int64_t>(img) * per_img);
        const int y = (rel / bw) * 8 + (p >> 3);
        const int x = (rel % bw) * 8 + (p & 7);
        if (y < dh && x < dw) {
          const float s = fminf(fmaxf(rintf(acc + 128.0f), 0.0f), 255.0f);
          out[(static_cast<int64_t>(img) * dh + y) * dw + x] = static_cast<uint8_t>(s);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// coefs: (N, bh, bw, 64) int16 (elem_bytes 2) or int32 (elem_bytes 4),
// natural coefficient order; qtab: (N, 64) int32, one table per image;
// kron: the (64, 64) float32 Kronecker IDCT
// (picha_tpu.ops.jpeg_tpu._idct_kron, pixel = coef @ kron); out: (N, dh,
// dw) uint8 with dh <= 8 bh, dw <= 8 bw. Returns cudaGetLastError().
extern "C" int picha_idct_plane(const void* coefs, int elem_bytes, const void* qtab,
                                const void* kron, int n_img, int bh, int bw, int dh,
                                int dw, void* out, void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || dh > 8 * bh || dw > 8 * bw)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_img) * bh * bw;
  if (total <= 0 || dh <= 0 || dw <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + kTile - 1) / kTile;
  const int64_t cap = static_cast<int64_t>(sms) * 8;  // kron column loaded once per block
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* q = static_cast<const int*>(qtab);
  const float* kr = static_cast<const float*>(kron);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (elem_bytes == 2)
    idct_plane_kernel<int16_t><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const int16_t*>(coefs), q, kr, n_img, bh, bw, dh, dw, o);
  else
    idct_plane_kernel<int32_t><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(coefs), q, kr, n_img, bh, bw, dh, dw, o);
  return static_cast<int>(cudaGetLastError());
}
