// K2: JPEG encoder front — u8 pack, RGB->YCbCr, 2x2 chroma downsample,
// 8x8 block edge padding, forward DCT and quantisation.
//
// Replaces: picha_tpu/ops/jpeg_tpu.py::_jit_encode (rgb_to_ycbcr,
// box_downsample_2x2, plane_to_blocks, fdct_quant) together with the
// u8 pack of picha_tpu/pipeline/jpeg_batch.py (floor(clip(v+0.5))).
// The TPU graph materialises the packed image, the three full-size
// planes, the padded block tensors and runs the 64x64 Kronecker fDCT
// as one large matmul on the MXU.
//
// What bounds it on an H100: one read of the float image (12 B/px at
// 3 channels) and one write of the int16 coefficients (~3 B/px at
// 4:2:0) — memory traffic — plus 64 MACs per coefficient. The design
// keeps every intermediate on chip: each 64-thread group owns one
// output 8x8 block of one component, forms its 64 samples straight
// from the float image (pack, jccolor fixed point in int32 with
// arithmetic >>16, chroma 2x2 average (+2)>>2 with edge clamping, edge
// replication into partial blocks), stages them in shared memory, and
// each thread computes one coefficient as a 64-term f32 dot product
// with a Kronecker row. The 64x64 matrix is held transposed in shared
// memory, loaded once per (persistent, grid-strided) CUDA block, so the
// 64 threads read 64 consecutive words per step: no bank conflicts,
// where a __constant__ copy would serialise the 32 distinct addresses
// of a warp. Quantisation is rintf(f / q): round half to even like
// jnp.round / torch.round. A wgmma fDCT is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;                 // 8x8 blocks per CUDA block
constexpr int kThreads = 64 * kGroups;

// libjpeg jccolor.c fixed point: FIX(x) = int(x * 65536 + 0.5)
constexpr int kFix0299 = 19595, kFix0587 = 38470, kFix0114 = 7471;
constexpr int kFix016874 = 11059, kFix033126 = 21709, kFix05 = 32768;
constexpr int kFix041869 = 27439, kFix008131 = 5329;
constexpr int kOneHalf = 32768;

__device__ __forceinline__ int pack(float v) {
  return static_cast<int>(floorf(fminf(fmaxf(v + 0.5f, 0.0f), 255.0f)));
}

struct Rgb { int r, g, b; };

__device__ __forceinline__ Rgb load_rgb(const float* px) {
  return {pack(px[0]), pack(px[1]), pack(px[2])};
}

__device__ __forceinline__ int luma(Rgb p) {
  return (kFix0299 * p.r + kFix0587 * p.g + kFix0114 * p.b + kOneHalf) >> 16;
}

__device__ __forceinline__ int chroma(Rgb p, int which) {
  const int bias = (128 << 16) + kOneHalf - 1;
  if (which == 1)
    return (-kFix016874 * p.r - kFix033126 * p.g + kFix05 * p.b + bias) >> 16;
  return (kFix05 * p.r - kFix041869 * p.g - kFix008131 * p.b + bias) >> 16;
}

__global__ void __launch_bounds__(kThreads) jpeg_encode_front_kernel(
    const float* __restrict__ img, int n_img, int h, int w, int c,
    const int* __restrict__ qluma, const int* __restrict__ qchroma,
    const float* __restrict__ kron, int16_t* __restrict__ out_y,
    int16_t* __restrict__ out_cb, int16_t* __restrict__ out_cr, int ybh, int ybw,
    int cbh, int cbw) {
  __shared__ float kron_t[64 * 64];         // kron_t[p*64 + k] = kron[k][p]
  __shared__ float samples[kGroups][64];
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads)
    kron_t[(i & 63) * 64 + (i >> 6)] = kron[i];
  __syncthreads();

  const int group = threadIdx.x >> 6;
  const int t = threadIdx.x & 63;
  const int r = t >> 3, col = t & 7;
  const int ny = n_img * ybh * ybw;
  const int nc = (c == 3) ? n_img * cbh * cbw : 0;
  const int total = ny + 2 * nc;
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;  // 4:2:0 chroma planes

  for (int base = blockIdx.x * kGroups; base < total; base += gridDim.x * kGroups) {
    const int item = base + group;
    const bool live = item < total;
    int comp = 0, rel = item;
    if (live && item >= ny) {
      comp = 1 + (item - ny) / nc;
      rel = (item - ny) % nc;
    }
    const int bh = comp ? cbh : ybh, bw = comp ? cbw : ybw;
    const int n = rel / (bh * bw);
    const int by = (rel / bw) % bh, bx = rel % bw;
    if (live) {
      const float* im = img + static_cast<int64_t>(n) * h * w * c;
      int s;
      if (comp == 0) {
        const int y = min(by * 8 + r, h - 1), x = min(bx * 8 + col, w - 1);
        const float* px = im + (static_cast<int64_t>(y) * w + x) * c;
        s = (c == 1) ? pack(px[0]) : luma(load_rgb(px));
      } else {
        const int cy = min(by * 8 + r, ch - 1), cx = min(bx * 8 + col, cw - 1);
        int sum = 0;
        for (int dy = 0; dy < 2; ++dy) {
          const int y = min(2 * cy + dy, h - 1);
          for (int dx = 0; dx < 2; ++dx) {
            const int x = min(2 * cx + dx, w - 1);
            sum += chroma(load_rgb(im + (static_cast<int64_t>(y) * w + x) * c), comp);
          }
        }
        s = (sum + 2) >> 2;
      }
      samples[group][t] = static_cast<float>(s) - 128.0f;
    }
    __syncthreads();
    if (live) {
      float f = 0.0f;
      const float* sm = samples[group];
#pragma unroll 8
      for (int p = 0; p < 64; ++p) f += sm[p] * kron_t[p * 64 + t];
      const float q = static_cast<float>(comp ? qchroma[t] : qluma[t]);
      int16_t* out = comp == 0 ? out_y : (comp == 1 ? out_cb : out_cr);
      out[static_cast<int64_t>(rel) * 64 + t] = static_cast<int16_t>(rintf(f / q));
    }
    __syncthreads();
  }
}

}  // namespace

// img: (N, H, W, C) float32, C in {1, 3} (colour encodes 4:2:0);
// qluma/qchroma: (64,) int32 natural order; kron: the (64, 64) float32
// Kronecker DCT (picha_tpu.ops.jpeg_tpu._idct_kron); outputs (N, bh, bw,
// 64) int16. out_cb/out_cr are unused for C == 1. Returns
// cudaGetLastError().
extern "C" int picha_jpeg_encode_front(
    const void* img, int n_img, int h, int w, int c, const void* qluma,
    const void* qchroma, const void* kron, void* out_y, void* out_cb, void* out_cr,
    int ybh, int ybw, int cbh, int cbw, void* stream) {
  if ((c != 1 && c != 3) || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_img) * ybh * ybw +
                        (c == 3 ? 2LL * n_img * cbh * cbw : 0);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + kGroups - 1) / kGroups;
  const int64_t cap = static_cast<int64_t>(sms) * 8;  // persistent-ish grid
  if (blocks > cap) blocks = cap;
  jpeg_encode_front_kernel<<<static_cast<int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), n_img, h, w, c,
      static_cast<const int*>(qluma), static_cast<const int*>(qchroma),
      static_cast<const float*>(kron), static_cast<int16_t*>(out_y),
      static_cast<int16_t*>(out_cb), static_cast<int16_t*>(out_cr), ybh, ybw, cbh, cbw);
  return static_cast<int>(cudaGetLastError());
}
