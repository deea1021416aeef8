// K10: the clip after the resize and the composed per-image augment chain
// of the training ingest (brightness -> contrast -> saturation -> cutout),
// in two launches.
//
// Replaces: picha_tpu/pipeline/training.py::_jit_crop_resize_normalize's
// clip (:70) and picha_tpu/pipeline/augment.py::augment (:105-115) with
// brightness, contrast, saturation and cutout (:42-89), which XLA fuses
// into the ingest graph.
//
// What bounds it on an H100: memory traffic. The batch (256 x 224 x 224 x
// 3 float32, 154 MB) is read twice when contrast is on (once for the
// per-image mean, once for the chain) and written once: about 460 MB,
// 0.14 ms at HBM peak; the arithmetic is ~30 flops per pixel. The design:
//   (a) augment_grey_sum: one block per image; each thread sums
//       grey(clip(clip(x) * f_b)) over a fixed stride of the image's
//       pixels, then a shared-memory tree adds the threads' sums in a fixed
//       order. No float atomics, so a run repeats bit for bit. Skipped when
//       contrast is off.
//   (b) augment_apply: one thread per pixel (its 3 channels, since
//       saturation needs the pixel's grey), the whole chain in registers.
// Products and sums are separately rounded (__fmul_rn / __fadd_rn /
// __fsub_rn, no FMA contraction), in the order of the plain twin
// (picha_tpu_torch/pipeline/augment.py::augment_fused_plain); only the
// mean's summation order differs from it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrightness = 1, kContrast = 2, kSaturation = 4, kCutout = 8;
constexpr int kSumThreads = 512;

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

__device__ __forceinline__ float grey_of(float r, float g, float b, float l0, float l1,
                                         float l2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, l0), __fmul_rn(g, l1)), __fmul_rn(b, l2));
}

__global__ void __launch_bounds__(kSumThreads) augment_grey_sum(
    const float* __restrict__ x, int64_t hw, const float* __restrict__ fb, int flags,
    float l0, float l1, float l2, float* __restrict__ sums) {
  __shared__ float part[kSumThreads];
  const int64_t n = blockIdx.x;
  const float* img = x + n * hw * 3;
  const float f = (flags & kBrightness) ? fb[n] : 1.0f;
  float acc = 0.0f;
  for (int64_t p = threadIdx.x; p < hw; p += kSumThreads) {
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      v[ch] = clip01(img[p * 3 + ch]);
      if (flags & kBrightness) v[ch] = clip01(__fmul_rn(v[ch], f));
    }
    acc = __fadd_rn(acc, grey_of(v[0], v[1], v[2], l0, l1, l2));
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[n] = part[0];
}

__global__ void __launch_bounds__(256) augment_apply(
    const float* __restrict__ x, int64_t total, int h, int w, const float* __restrict__ fb,
    const float* __restrict__ fc, const float* __restrict__ fs,
    const float* __restrict__ sums, const int* __restrict__ ty, const int* __restrict__ tx,
    int cut, float fill, int flags, float l0, float l1, float l2, float* __restrict__ out) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; p < total;
       p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t n = p / hw;
    const int64_t rem = p - n * hw;
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[ch] = clip01(x[p * 3 + ch]);
    if (flags & kBrightness) {
      const float f = fb[n];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) v[ch] = clip01(__fmul_rn(v[ch], f));
    }
    if (flags & kContrast) {
      const float m = __fdiv_rn(sums[n], static_cast<float>(hw));
      const float f = fc[n];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[ch] = clip01(__fadd_rn(__fmul_rn(__fsub_rn(v[ch], m), f), m));
    }
    if (flags & kSaturation) {
      const float g = grey_of(v[0], v[1], v[2], l0, l1, l2);
      const float f = fs[n];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[ch] = clip01(__fadd_rn(g, __fmul_rn(__fsub_rn(v[ch], g), f)));
    }
    if (flags & kCutout) {
      const int y = static_cast<int>(rem / w), xx = static_cast<int>(rem % w);
      const int dy = y - ty[n], dx = xx - tx[n];
      if (dy >= 0 && dy < cut && dx >= 0 && dx < cut) v[0] = v[1] = v[2] = fill;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[p * 3 + ch] = v[ch];
  }
}

}  // namespace

// x, out: (n, h, w, 3) float32 (out may not alias x); fb, fc, fs: (n,)
// float32 factors (read only when their flag is set); sums: (n,) float32
// scratch; ty, tx: (n,) int32 cutout corners; flags: 1 brightness, 2
// contrast, 4 saturation, 8 cutout. Returns cudaGetLastError().
extern "C" int picha_augment(const void* x, int n, int h, int w, const void* fb,
                             const void* fc, const void* fs, void* sums, const void* ty,
                             const void* tx, int cut, float fill, int flags, float l0, float l1,
                             float l2, void* out, void* stream) {
  if (n < 0 || h < 1 || w < 1 || flags < 0 || flags > 15 || cut < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n) * h * w;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  if (flags & kContrast) {
    augment_grey_sum<<<n, kSumThreads, 0, st>>>(xi, static_cast<int64_t>(h) * w,
                                                 static_cast<const float*>(fb), flags, l0, l1,
                                                 l2, static_cast<float*>(sums));
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + 255) / 256;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  augment_apply<<<static_cast<int>(blocks), 256, 0, st>>>(
      xi, total, h, w, static_cast<const float*>(fb), static_cast<const float*>(fc),
      static_cast<const float*>(fs), static_cast<const float*>(sums),
      static_cast<const int*>(ty), static_cast<const int*>(tx), cut, fill, flags, l0, l1, l2,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
