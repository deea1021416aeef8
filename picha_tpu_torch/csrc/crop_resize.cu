// K9: per-image crop, horizontal flip and the width pass of the resize,
// fused, for the training ingest.
//
// Replaces: picha_tpu/pipeline/training.py::_jit_crop_resize_normalize
// (:64-70), which takes a dynamic_slice of each decoded frame at its
// (y, x) offset, flips it under a lax.cond, unpacks it as v * f32(1/255)
// and then runs resize_f32's width einsum over the whole crop row.
//
// What bounds it on an H100: memory traffic. Each output element reads k
// (about 4 on the main path: 192 -> 224, cubic) uint8 inputs of its crop
// row, mostly from L1/L2 since neighbouring outputs share them, and
// writes 4 B; at 256 x 1080p -> crop 192 -> 224 that is the 28 MB of the
// crops read and 132 MB of f32 written. The design: one thread per output
// element (image n, crop row r, output column o, channel c), consecutive
// threads on consecutive channels and columns. Column j of output o's
// window is crop column cc = starts[o] + j, read from source column
// xs[n] + (crop - 1 - cc) when the image is flipped, else xs[n] + cc, at
// source row ys[n] + r: the flip is read inside the tap loop, so the taps
// run in the same j order as K8 on the flipped crop. Offsets are clamped
// into the frame. The sum is K8's: v * in_scale first, then separately
// rounded products and sums (__fmul_rn / __fadd_rn, no FMA contraction),
// so K9 equals its plain twin (crop_flip_resize_w_plain: the flipped crop
// gathered, then resize_axis_windowed_plain) and K8 on the flipped crop
// bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Idx (the output index) is int when the output has < 2^30 elements (32-bit
// division is several times cheaper than 64-bit), else int64_t; the
// source offset is always 64-bit (256 full 1080p frames are 1.6 GB).
template <typename Idx>
__global__ void __launch_bounds__(256) crop_flip_resize_w_kernel(
    const uint8_t* __restrict__ rgb, int h, int w, int c,
    const int* __restrict__ xs, const int* __restrict__ ys,
    const uint8_t* __restrict__ flip, int crop, const int* __restrict__ starts,
    const float* __restrict__ taps, int dst, int k, float in_scale, Idx total,
    float* __restrict__ out) {
  for (Idx e = blockIdx.x * static_cast<Idx>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<Idx>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(e % c);
    Idx rest = e / c;
    const int o = static_cast<int>(rest % dst);
    rest /= dst;
    const int r = static_cast<int>(rest % crop);
    const int64_t n = rest / crop;
    const int x0 = min(max(xs[n], 0), w - crop);
    const int y0 = min(max(ys[n], 0), h - crop);
    const bool fl = flip[n] != 0;
    const uint8_t* row = rgb + ((n * h + y0 + r) * static_cast<int64_t>(w)) * c + ch;
    const float* wt = taps + static_cast<int64_t>(o) * k;
    const int s = starts[o];
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const int cc = s + j;
      const int col = fl ? x0 + (crop - 1 - cc) : x0 + cc;
      const float v = __fmul_rn(static_cast<float>(row[static_cast<int64_t>(col) * c]),
                                in_scale);
      acc = __fadd_rn(acc, __fmul_rn(wt[j], v));
    }
    out[e] = acc;
  }
}

}  // namespace

// rgb: (n, h, w, c) uint8; xs, ys: (n,) int32 crop corners (clamped to
// [0, w - crop] and [0, h - crop]); flip: (n,) uint8 (0 or 1); starts:
// (dst,) int32 with 0 <= starts[o] <= crop - k; taps: (dst, k) float32;
// out: (n, crop, dst, c) float32. Returns cudaGetLastError().
extern "C" int picha_crop_flip_resize_w(const void* rgb, int n, int h, int w, int c,
                                        const void* xs, const void* ys, const void* flip,
                                        int crop, const void* starts, const void* taps,
                                        int dst, int k, float in_scale, void* out,
                                        void* stream) {
  if (n < 0 || c < 1 || crop < 1 || crop > h || crop > w || k < 1 || k > crop || dst < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n) * crop * dst * c;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + 255) / 256;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(rgb);
  const int* x = static_cast<const int*>(xs);
  const int* y = static_cast<const int*>(ys);
  const uint8_t* f = static_cast<const uint8_t*>(flip);
  const int* so = static_cast<const int*>(starts);
  const float* tp = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  if (total < (int64_t{1} << 30))
    crop_flip_resize_w_kernel<int><<<static_cast<int>(blocks), 256, 0, st>>>(
        src, h, w, c, x, y, f, crop, so, tp, dst, k, in_scale, static_cast<int>(total), o);
  else
    crop_flip_resize_w_kernel<int64_t><<<static_cast<int>(blocks), 256, 0, st>>>(
        src, h, w, c, x, y, f, crop, so, tp, dst, k, in_scale, total, o);
  return static_cast<int>(cudaGetLastError());
}
