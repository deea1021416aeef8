// K7: chroma upsampling and colour transform of the staged JPEG decode:
// per-component uint8 sample planes -> interleaved (N, H, W, C) uint8.
//
// Replaces: picha_tpu/ops/jpeg_tpu.py::upsample_to (with
// fancy_upsample_h / fancy_upsample_v / fancy_upsample_h2v2 and the
// libjpeg-turbo h1v2 branch), ycbcr_to_rgb_int, cmyk_fold_to_rgb,
// ycck_to_cmyk and the per-component assembly of build_decode_stage.
// The TPU graph builds every upsampled plane as an int32 tensor
// (concatenates for the edge neighbours, stacks and reshapes for the
// interleave), then stacks the colour channels: several full-size int32
// intermediates in HBM.
//
// What bounds it on an H100: memory traffic, about 1.5 B read and 3 B
// written per output pixel at 4:2:0 with a handful of integer ops.
// The design: one thread per output pixel computes every component's
// upsampled sample directly from at most 2x2 source samples (the four
// neighbours of the triangle filter; neighbouring threads share them
// through L1/L2), applies the colour transform in int32 fixed point,
// and writes its C bytes, so nothing but the uint8 planes and the
// output touches HBM. Integer semantics are the reference's exactly:
// libjpeg's fancy biases (h2v2: +8/+7 then >>4; h2v1 and turbo's h1v2:
// +1/+2 then >>2), edge replication at the cropped plane's edge,
// int_upsample replication for other integer ratios, jdcolor.c's
// 16-bit fixed point with arithmetic right shifts (a floor for negative
// sums, as >> on signed int is in CUDA), and the CMYK fold's floor
// division of non-negative products.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// colour modes (picha_tpu_torch/ops/jpeg.py GREY..CMYK)
constexpr int kGrey = 0, kYcbcr = 1, kRgb = 2, kYcck = 3, kCmyk = 4;

// jdcolor.c fixed point: FIX(x) = int(x * 65536 + 0.5)
constexpr int kFix1402 = 91881, kFix1772 = 116130;
constexpr int kFix034414 = 22554, kFix071414 = 46802;
constexpr int kOneHalf = 32768;

struct Plane {
  const uint8_t* p;
  int h, w, fx, fy;  // cropped plane size; upsampling ratio to the luma grid
};

struct Planes {
  Plane c[4];
};

__device__ __forceinline__ int at(const Plane& P, int64_t base, int r, int c) {
  return P.p[base + static_cast<int64_t>(r) * P.w + c];
}

// The component's sample at luma-grid position (y, x) of image img.
__device__ __forceinline__ int upsampled(const Plane& P, int img, int y, int x) {
  const int64_t base = static_cast<int64_t>(img) * P.h * P.w;
  if (P.fx == 1 && P.fy == 1) return at(P, base, y, x);
  if (P.fx == 2 && P.fy == 2) {
    const int i = y >> 1, j = x >> 1;
    const int ri = (y & 1) ? min(i + 1, P.h - 1) : max(i - 1, 0);
    const int jn = (x & 1) ? min(j + 1, P.w - 1) : max(j - 1, 0);
    const int c0 = 3 * at(P, base, i, j) + at(P, base, ri, j);    // column sums
    const int c1 = 3 * at(P, base, i, jn) + at(P, base, ri, jn);
    return (x & 1) ? (3 * c0 + c1 + 7) >> 4 : (3 * c0 + c1 + 8) >> 4;
  }
  if (P.fx == 2 && P.fy == 1) {
    const int j = x >> 1;
    const int jn = (x & 1) ? min(j + 1, P.w - 1) : max(j - 1, 0);
    const int s = 3 * at(P, base, y, j) + at(P, base, y, jn);
    return (x & 1) ? (s + 2) >> 2 : (s + 1) >> 2;
  }
  if (P.fx == 1 && P.fy == 2) {
    const int i = y >> 1;
    const int ri = (y & 1) ? min(i + 1, P.h - 1) : max(i - 1, 0);
    const int s = 3 * at(P, base, i, x) + at(P, base, ri, x);
    return (y & 1) ? (s + 2) >> 2 : (s + 1) >> 2;
  }
  return at(P, base, y / P.fy, x / P.fx);
}

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

__device__ __forceinline__ void ycc_to_rgb(int y, int cb, int cr, int* rgb) {
  const int cbs = cb - 128, crs = cr - 128;
  rgb[0] = clip255(y + ((kFix1402 * crs + kOneHalf) >> 16));
  rgb[1] = clip255(y + ((-kFix034414 * cbs - kFix071414 * crs + kOneHalf) >> 16));
  rgb[2] = clip255(y + ((kFix1772 * cbs + kOneHalf) >> 16));
}

__global__ void __launch_bounds__(256) upsample_color_kernel(
    Planes pl, int n_img, int h, int w, int mode, int c, uint8_t* __restrict__ out) {
  const int64_t total = static_cast<int64_t>(n_img) * h * w;
  for (int64_t pix = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       pix < total; pix += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int img = static_cast<int>(pix / (static_cast<int64_t>(h) * w));
    const int rem = static_cast<int>(pix - static_cast<int64_t>(img) * h * w);
    const int y = rem / w, x = rem % w;
    uint8_t* o = out + pix * c;
    if (mode == kGrey) {
      const uint8_t g = static_cast<uint8_t>(upsampled(pl.c[0], img, y, x));
      for (int k = 0; k < c; ++k) o[k] = g;
      continue;
    }
    int s[4];
    const int used = (mode == kYcck || mode == kCmyk) ? 4 : 3;
    for (int k = 0; k < used; ++k) s[k] = upsampled(pl.c[k], img, y, x);
    int rgb[3];
    if (mode == kYcbcr || mode == kYcck) {
      ycc_to_rgb(s[0], s[1], s[2], rgb);
    } else {
      rgb[0] = s[0];
      rgb[1] = s[1];
      rgb[2] = s[2];
    }
    if (mode == kYcck)
      for (int k = 0; k < 3; ++k) rgb[k] = 255 - rgb[k];
    if (mode == kYcck || mode == kCmyk)
      for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] * s[3] / 255;  // non-negative: a floor
    for (int k = 0; k < 3; ++k) o[k] = static_cast<uint8_t>(rgb[k]);
  }
}

}  // namespace

// p0..p3: per-component uint8 planes (N, h_i, w_i), each cropped as
// dequant_idct_plane writes it, with (fx_i, fy_i) its integer upsampling
// ratio to the luma grid; components the mode does not use repeat a
// used one. out: (N, h, w, c) uint8, c = 3, or 1 for grey. Returns
// cudaGetLastError().
extern "C" int picha_upsample_color(
    const void* p0, const void* p1, const void* p2, const void* p3, int h0, int w0,
    int fx0, int fy0, int h1, int w1, int fx1, int fy1, int h2, int w2, int fx2,
    int fy2, int h3, int w3, int fx3, int fy3, int n_img, int h, int w, int mode,
    int c, void* out, void* stream) {
  Planes pl;
  const void* ps[4] = {p0, p1, p2, p3};
  const int dims[4][4] = {{h0, w0, fx0, fy0}, {h1, w1, fx1, fy1},
                          {h2, w2, fx2, fy2}, {h3, w3, fx3, fy3}};
  for (int k = 0; k < 4; ++k) {
    pl.c[k] = {static_cast<const uint8_t*>(ps[k]), dims[k][0], dims[k][1],
               dims[k][2], dims[k][3]};
    if (dims[k][0] < 1 || dims[k][1] < 1 || dims[k][2] < 1 || dims[k][3] < 1 ||
        static_cast<int64_t>(dims[k][0]) * dims[k][3] < h ||
        static_cast<int64_t>(dims[k][1]) * dims[k][2] < w)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode < kGrey || mode > kCmyk || (c != 1 && c != 3) || (mode != kGrey && c != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_img) * h * w;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + 255) / 256;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  upsample_color_kernel<<<static_cast<int>(blocks), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pl, n_img, h, w, mode, c, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
