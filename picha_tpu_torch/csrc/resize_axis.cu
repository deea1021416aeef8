// K8: one axis of the separable resize, as a per-output tap window.
//
// Replaces: picha_tpu/ops/resize.py::_apply_axis and resize_f32 (the
// horizontal pass, then the vertical one). The TPU graph runs each axis
// as a dense (dst, src) einsum at a source <= 512, and above it as the
// banded plan: a gather of T tiles of in_len source rows and a batched
// (tile, in_len) einsum, for the MXU's sake. For 1920 -> 960 that is 131
// multiply-adds per output where 5 taps are nonzero.
//
// What bounds it on an H100: memory traffic. Per output element it
// reads k (5 on the main path) inputs, mostly from L1/L2 since
// neighbouring outputs share them, and writes 4 B; the width pass of 16
// x 1080p reads 100 MB of uint8 and writes 200 MB of f32, the height
// pass reads those 200 MB and writes 100 MB. The design: the tensor is
// viewed as (outer, L, inner) with the resized axis in the middle
// (width pass: outer = N*H, inner = C; height pass: outer = N, inner =
// W*C), and one thread per output element walks its window
// starts[o] .. starts[o]+k-1 with the taps (zero-padded to k, the
// reference's resize_windows), so consecutive threads read consecutive
// inputs. The input is uint8 or f32 and is unpacked on load as
// v * in_scale (the pipeline's f32(1/255), before any tap, as the
// reference unpacks before resizing); the sum runs in window order
// with separately rounded products and sums (__fmul_rn / __fadd_rn,
// so nvcc cannot contract them into FMAs), and the result is scaled by
// out_scale (255 when the encoder front follows). The plain twin
// (resize_axis_windowed_plain) does the same operations in the same
// order, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Idx is int when input and output have < 2^30 elements each (32-bit
// index division is several times cheaper than 64-bit; the margin keeps
// the grid stride from overflowing), else int64_t.
template <typename T, typename Idx>
__global__ void __launch_bounds__(256) resize_axis_kernel(
    const T* __restrict__ x, Idx outer, int src, int dst, Idx inner,
    const int* __restrict__ starts, const float* __restrict__ taps, int k,
    float in_scale, float out_scale, float* __restrict__ out) {
  const Idx total = outer * dst * inner;
  for (Idx e = blockIdx.x * static_cast<Idx>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<Idx>(gridDim.x) * blockDim.x) {
    const Idx in_i = e % inner;
    const Idx rest = e / inner;
    const int o = static_cast<int>(rest % dst);
    const Idx a = rest / dst;
    const T* row = x + (static_cast<int64_t>(a) * src + starts[o]) * inner + in_i;
    const float* w = taps + static_cast<int64_t>(o) * k;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float v = __fmul_rn(static_cast<float>(row[static_cast<int64_t>(j) * inner]),
                                in_scale);
      acc = __fadd_rn(acc, __fmul_rn(w[j], v));
    }
    out[e] = __fmul_rn(acc, out_scale);
  }
}

template <typename T>
void launch(const void* x, int64_t outer, int src, int dst, int64_t inner,
            const int* starts, const float* taps, int k, float in_scale,
            float out_scale, float* out, int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (outer * dst * inner < (int64_t{1} << 30) && outer * src * inner < (int64_t{1} << 30))
    resize_axis_kernel<T, int><<<blocks, 256, 0, s>>>(
        xt, static_cast<int>(outer), src, dst, static_cast<int>(inner), starts, taps, k,
        in_scale, out_scale, out);
  else
    resize_axis_kernel<T, int64_t><<<blocks, 256, 0, s>>>(
        xt, outer, src, dst, inner, starts, taps, k, in_scale, out_scale, out);
}

}  // namespace

// x: (outer, src, inner) uint8 (elem_bytes 1) or float32 (elem_bytes 4);
// starts: (dst,) int32 with 0 <= starts[o] <= src - k; taps: (dst, k)
// float32; out: (outer, dst, inner) float32,
// out = out_scale * sum_j taps[o, j] * (x[starts[o] + j] * in_scale).
// Returns cudaGetLastError().
extern "C" int picha_resize_axis(const void* x, int elem_bytes, int64_t outer, int src,
                                 int dst, int64_t inner, const void* starts,
                                 const void* taps, int k, float in_scale,
                                 float out_scale, void* out, void* stream) {
  if ((elem_bytes != 1 && elem_bytes != 4) || k < 1 || k > src)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = outer * dst * inner;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + 255) / 256;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const float* tp = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  if (elem_bytes == 1)
    launch<uint8_t>(x, outer, src, dst, inner, st, tp, k, in_scale, out_scale, o,
                    static_cast<int>(blocks), s);
  else
    launch<float>(x, outer, src, dst, inner, st, tp, k, in_scale, out_scale, o,
                  static_cast<int>(blocks), s);
  return static_cast<int>(cudaGetLastError());
}
