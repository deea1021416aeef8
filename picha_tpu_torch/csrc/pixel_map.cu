// K11: unpack, crop window, channel map and pack of (N, H, W, C) pixels.
//
// Replaces: picha_tpu/pixels.py::junpack_f32 and jpack (:112-124) and
// picha_tpu/ops/colorconvert.py::map_channels (:66-118), as the
// reference composes them in ops/colorconvert.py::_jit_convert
// (unpack -> map -> pack), ops/resize.py::_jit_resize (unpack, then the
// resize, then pack) and pipeline/image_batch.py::_jit_transform
// (unpack -> crop -> resize -> map -> pack, or clip with normalize).
// XLA fuses each of those chains into one elementwise loop; here one
// kernel takes each end: the head (unpack + crop, f32 out) before the
// resize, the tail (map + pack, or clip) after it, or the whole chain
// in one launch where there is no resize.
//
// What bounds it on an H100: memory traffic, a few bytes read and
// written per pixel and ~10 flops. The design is one thread per output
// pixel in a grid-stride loop, reading its sc source channels and
// writing its dc destination channels, so neighbouring threads touch
// neighbouring pixels. The numerics are the reference's, bit for bit:
// integer input is unpacked by an IEEE division (__fdiv_rn(v, MAX)),
// not by a reciprocal multiply (they differ on 126 of the 256 uint8
// values); the luma t0*wr + t1*wg + t2*wb and the pack v*MAX + 0.5 are
// rounded at every product and sum (__fmul_rn / __fadd_rn, so nvcc
// cannot contract them into FMAs); the clamp is min(max(v, 0), MAX),
// then floor. The plain versions (picha_tpu_torch/pixels.py unpack_f32,
// pack_f32; ops/colorconvert.py map_channels) do the same operations in
// the same order. NaN input (possible only for float input) is clamped
// by fmaxf/fminf where the reference would carry it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum OutMode { PACK = 0, RAW = 1, CLIP = 2 };

__device__ __forceinline__ float unpack(uint8_t v) {
  return __fdiv_rn(static_cast<float>(v), 255.0f);
}
__device__ __forceinline__ float unpack(uint16_t v) {
  return __fdiv_rn(static_cast<float>(v), 65535.0f);
}
__device__ __forceinline__ float unpack(float v) { return v; }

template <typename T>
struct MaxOf;
template <>
struct MaxOf<uint8_t> {
  static constexpr float value = 255.0f;
};
template <>
struct MaxOf<uint16_t> {
  static constexpr float value = 65535.0f;
};

template <typename Tout, int MODE>
__device__ __forceinline__ Tout store(float v) {
  if constexpr (MODE == RAW) {
    return v;
  } else if constexpr (MODE == CLIP) {
    return fminf(fmaxf(v, 0.0f), 1.0f);
  } else {
    constexpr float m = MaxOf<Tout>::value;
    const float s = fminf(fmaxf(__fadd_rn(__fmul_rn(v, m), 0.5f), 0.0f), m);
    return static_cast<Tout>(floorf(s));
  }
}

__device__ __forceinline__ float luma(const float* t, float wr, float wg, float wb) {
  return __fadd_rn(__fadd_rn(__fmul_rn(t[0], wr), __fmul_rn(t[1], wg)), __fmul_rn(t[2], wb));
}

// The reference's channel table (colorconvert.py:87-118): grey
// replicated, luma from rgb, alpha kept or synthesised as 1.0, greya ->
// rgb as [g, g, g] (its deliberate deviation).
__device__ __forceinline__ void map_channels(const float* t, int sc, int dc, float wr,
                                             float wg, float wb, float* o) {
  if (sc == dc) {
    for (int c = 0; c < dc; ++c) o[c] = t[c];
    return;
  }
  if (sc <= 2) {  // grey or greya source
    const float a = sc == 2 ? t[1] : 1.0f;
    if (dc <= 2) {  // 1 -> 2 (alpha 1), 2 -> 1
      o[0] = t[0];
      if (dc == 2) o[1] = a;
    } else {  // -> rgb, rgba
      o[0] = o[1] = o[2] = t[0];
      if (dc == 4) o[3] = a;
    }
    return;
  }
  // rgb or rgba source
  const float a = sc == 4 ? t[3] : 1.0f;
  if (dc <= 2) {
    o[0] = luma(t, wr, wg, wb);
    if (dc == 2) o[1] = a;
  } else {  // 3 -> 4, 4 -> 3
    o[0] = t[0];
    o[1] = t[1];
    o[2] = t[2];
    if (dc == 4) o[3] = a;
  }
}

// Idx is int when input and output have < 2^30 elements each, else
// int64_t (as K8).
template <typename Tin, typename Tout, int MODE, typename Idx>
__global__ void __launch_bounds__(256) pixel_map_kernel(
    const Tin* __restrict__ x, Idx total, int h, int w, int sc, int y0, int x0, int oh,
    int ow, int dc, float wr, float wg, float wb, Tout* __restrict__ out) {
  for (Idx p = blockIdx.x * static_cast<Idx>(blockDim.x) + threadIdx.x; p < total;
       p += static_cast<Idx>(gridDim.x) * blockDim.x) {
    const Idx ox = p % ow;
    const Idx rest = p / ow;
    const Idx oy = rest % oh;
    const Idx img = rest / oh;
    const Tin* src = x + ((img * h + (y0 + oy)) * w + (x0 + ox)) * sc;
    float t[4], o[4];
    for (int c = 0; c < sc; ++c) t[c] = unpack(src[c]);
    map_channels(t, sc, dc, wr, wg, wb, o);
    Tout* dst = out + p * dc;
    for (int c = 0; c < dc; ++c) dst[c] = store<Tout, MODE>(o[c]);
  }
}

struct Args {
  const void* x;
  int64_t n;
  int h, w, sc, y0, x0, oh, ow, dc;
  float wr, wg, wb;
  void* out;
  int blocks;
  cudaStream_t s;
};

template <typename Tin, typename Tout, int MODE>
void launch(const Args& a) {
  const int64_t total = a.n * a.oh * a.ow;
  const Tin* x = static_cast<const Tin*>(a.x);
  Tout* out = static_cast<Tout*>(a.out);
  if (total * a.dc < (int64_t{1} << 30) &&
      a.n * a.h * a.w * a.sc < (int64_t{1} << 30))
    pixel_map_kernel<Tin, Tout, MODE, int><<<a.blocks, 256, 0, a.s>>>(
        x, static_cast<int>(total), a.h, a.w, a.sc, a.y0, a.x0, a.oh, a.ow, a.dc, a.wr,
        a.wg, a.wb, out);
  else
    pixel_map_kernel<Tin, Tout, MODE, int64_t><<<a.blocks, 256, 0, a.s>>>(
        x, total, a.h, a.w, a.sc, a.y0, a.x0, a.oh, a.ow, a.dc, a.wr, a.wg, a.wb, out);
}

template <typename Tin>
void launch_out(const Args& a, int out_kind) {
  switch (out_kind) {
    case 0: launch<Tin, uint8_t, PACK>(a); break;
    case 1: launch<Tin, uint16_t, PACK>(a); break;
    case 2: launch<Tin, float, RAW>(a); break;
    default: launch<Tin, float, CLIP>(a); break;
  }
}

}  // namespace

// x: (n, h, w, sc) of in_kind 0 uint8, 1 uint16, 2 float32; the window
// rows y0 .. y0+oh-1, columns x0 .. x0+ow-1 of every image; out: (n, oh,
// ow, dc) of out_kind 0 uint8 (pack), 1 uint16 (pack), 2 float32 (as
// mapped), 3 float32 clipped to [0, 1]. sc, dc in 1..4; wr, wg, wb the
// luma weights. Returns cudaGetLastError().
extern "C" int picha_pixel_map(const void* x, int in_kind, int64_t n, int h, int w, int sc,
                               int y0, int x0, int oh, int ow, int dc, int out_kind,
                               float wr, float wg, float wb, void* out, void* stream) {
  if (in_kind < 0 || in_kind > 2 || out_kind < 0 || out_kind > 3 || sc < 1 || sc > 4 ||
      dc < 1 || dc > 4 || y0 < 0 || x0 < 0 || oh < 1 || ow < 1 || y0 + oh > h ||
      x0 + ow > w || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n * oh * ow;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + 255) / 256;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  const Args a{x, n, h, w, sc, y0, x0, oh, ow, dc, wr, wg, wb, out,
               static_cast<int>(blocks), static_cast<cudaStream_t>(stream)};
  switch (in_kind) {
    case 0: launch_out<uint8_t>(a, out_kind); break;
    case 1: launch_out<uint16_t>(a, out_kind); break;
    default: launch_out<float>(a, out_kind); break;
  }
  return static_cast<int>(cudaGetLastError());
}
