// K10: the clip after the resize and the composed per-image augment chain
// of the training ingest (brightness -> contrast -> saturation -> cutout).
//
// Replaces: picha_tpu/pipeline/training.py::_jit_crop_resize_normalize's
// clip (:70) and picha_tpu/pipeline/augment.py::augment (:105-115) with
// brightness, contrast, saturation and cutout (:42-89) and contrast's
// per-image grey mean (:48-51), which XLA fuses into the ingest graph.
//
// What bounds it on an H100: memory traffic. The batch (256 x 224 x 224 x
// 3 float32, 154 MB) read once and written once is 308 MB, 0.092 ms at
// 3.35 TB/s; the arithmetic is ~30 flops a pixel. Contrast needs each
// image's grey mean before any of its pixels is written. The design:
//   - the mean (contrast on): a block an image, thread t of 512 adding
//     grey(clip(clip(x) * f_b)) of pixels t, t + 512, ... in order, then a
//     halving tree in shared memory (the first design's sum, kept for its
//     bits: a batch with other bits moves the MoE ViT's near-tie routes
//     downstream, past chip_smoke's bound on the forward's logits); no
//     float atomics, so a run repeats bit for bit;
//   - the chain: CTAs of 2,048 pixels of one image (many waves, no tail),
//     a thread four pixels (three 16-byte words) loaded and stored as
//     float4s, the edge pixels of a CTA's range one by one, each thread
//     stepping its pixel's row and column with no division.
// Tried and set aside (PERF.md section 6): one launch reading each image
// once, a thread-block cluster an image staging its shares in shared
// memory and summing them in another order through distributed shared
// memory: 0.153 ms at the ingest's shape on an H100 80GB HBM3 (700 W)
// against this design's 0.169, but other bits; that order rebuilt over
// distributed shared memory took 1.0 ms.
// Products and sums are separately rounded (__fmul_rn / __fadd_rn /
// __fsub_rn, no FMA contraction), in the order of the plain version
// (picha_tpu_torch/pipeline/augment.py::augment_fused_plain), the mean as
// __fdiv_rn(sum, hw); only the mean's summation order differs from it, and
// pipeline/augment.py::augment_sum_lanes models that order bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>



namespace {

constexpr int kBrightness = 1, kContrast = 2, kSaturation = 4, kCutout = 8;
constexpr int kThreads = 512;
constexpr int kSumThreads = 512;
constexpr int kStreamPixels = 4 * kThreads;    // pixels a chain CTA

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

struct Chain {
  float fb, fc, fs, m, l0, l1, l2, fill;
  int ty, tx, cut, flags;

  __device__ __forceinline__ float grey(const float (&v)[3]) const {
    return __fadd_rn(__fadd_rn(__fmul_rn(v[0], l0), __fmul_rn(v[1], l1)), __fmul_rn(v[2], l2));
  }
  // clip, then brightness: what the contrast mean sums
  __device__ __forceinline__ void head(float (&v)[3]) const {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      v[ch] = clip01(v[ch]);
      if (flags & kBrightness) v[ch] = clip01(__fmul_rn(v[ch], fb));
    }
  }
  // the whole chain on a pixel at (y, x)
  __device__ __forceinline__ void apply(float (&v)[3], int y, int x) const {
    head(v);
    if (flags & kContrast) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[ch] = clip01(__fadd_rn(__fmul_rn(__fsub_rn(v[ch], m), fc), m));
    }
    if (flags & kSaturation) {
      const float g = grey(v);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[ch] = clip01(__fadd_rn(g, __fmul_rn(__fsub_rn(v[ch], g), fs)));
    }
    if (flags & kCutout) {
      const int dy = y - ty, dx = x - tx;
      if (dy >= 0 && dy < cut && dx >= 0 && dx < cut) v[0] = v[1] = v[2] = fill;
    }
  }
};

struct Args {
  const float *x, *fb, *fc, *fs, *sums;
  const int *ty, *tx;
  int n, hw, w, cut, flags;
  float fill, l0, l1, l2;
  float* out;

  __device__ __forceinline__ Chain chain(int img) const {
    Chain c;
    c.fb = (flags & kBrightness) ? fb[img] : 1.0f;
    c.fc = (flags & kContrast) ? fc[img] : 1.0f;
    c.fs = (flags & kSaturation) ? fs[img] : 1.0f;
    c.ty = (flags & kCutout) ? ty[img] : 0;
    c.tx = (flags & kCutout) ? tx[img] : 0;
    c.l0 = l0;
    c.l1 = l1;
    c.l2 = l2;
    c.fill = fill;
    c.cut = cut;
    c.flags = flags;
    c.m = (flags & kContrast) ? __fdiv_rn(sums[img], static_cast<float>(hw)) : 0.0f;
    return c;
  }
};

// Each image's sum of grey(clip(clip(x) * f_b)) (augment_sum_lanes' order)
__global__ void __launch_bounds__(kSumThreads) augment_grey_sum(Args a, float* __restrict__ sums) {
  __shared__ float part[kSumThreads];
  const int img = blockIdx.x;
  const float* x = a.x + 3 * static_cast<int64_t>(img) * a.hw;
  const Chain c = a.chain(img);
  float acc = 0.0f;
  for (int p = threadIdx.x; p < a.hw; p += kSumThreads) {
    float v[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
    c.head(v);
    acc = __fadd_rn(acc, c.grey(v));
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[img] = part[0];
}

// The chain over pixels [p0, p1) of image img (flat indices over the
// batch): its whole quads (flat pixels 4q .. 4q + 3, 48 bytes at a 16-byte
// boundary) a thread at a time as float4s, the row and column stepped by
// 4 * kThreads pixels with no division; the pixels around the quads alone.
// Grid (CTAs an image, n).
__global__ void __launch_bounds__(kThreads) augment_apply(Args a) {
  const int img = blockIdx.y;
  const int64_t base = static_cast<int64_t>(img) * a.hw;
  const int64_t p0 = base + static_cast<int64_t>(a.hw) * blockIdx.x / gridDim.x;
  const int64_t p1 = base + static_cast<int64_t>(a.hw) * (blockIdx.x + 1) / gridDim.x;
  const Chain c = a.chain(img);
  const int w = a.w;
  auto one = [&](int64_t p) {  // a flat pixel, alone
    const int ip = static_cast<int>(p - base);
    float v[3] = {a.x[3 * p], a.x[3 * p + 1], a.x[3 * p + 2]};
    c.apply(v, ip / w, ip - (ip / w) * w);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) a.out[3 * p + ch] = v[ch];
  };
  const int64_t q0 = (p0 + 3) / 4, q1 = p1 / 4;
  if (q1 <= q0) {
    for (int64_t p = p0 + threadIdx.x; p < p1; p += kThreads) one(p);
    return;
  }
  const int head = static_cast<int>(4 * q0 - p0), tail = static_cast<int>(p1 - 4 * q1);
  for (int i = threadIdx.x; i < head + tail; i += kThreads)
    one(i < head ? p0 + i : 4 * q1 + (i - head));
  int64_t q = q0 + threadIdx.x;
  if (q >= q1) return;
  const int ip = static_cast<int>(4 * q - base);
  int y = ip / w, xx = ip - y * w;
  const int sy = 4 * kThreads / w, sx = 4 * kThreads - sy * w;
  for (; q < q1; q += kThreads) {
    const float4* s4 = reinterpret_cast<const float4*>(a.x) + 3 * q;
    float f[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 wv = __ldg(s4 + k);
      f[4 * k] = wv.x;
      f[4 * k + 1] = wv.y;
      f[4 * k + 2] = wv.z;
      f[4 * k + 3] = wv.w;
    }
    int py = y, px = xx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k > 0) {
        ++px;
        while (px >= w) {
          px -= w;
          ++py;
        }
      }
      float v[3] = {f[3 * k], f[3 * k + 1], f[3 * k + 2]};
      c.apply(v, py, px);
      f[3 * k] = v[0];
      f[3 * k + 1] = v[1];
      f[3 * k + 2] = v[2];
    }
    float4* o4 = reinterpret_cast<float4*>(a.out) + 3 * q;
    __stcs(o4, make_float4(f[0], f[1], f[2], f[3]));
    __stcs(o4 + 1, make_float4(f[4], f[5], f[6], f[7]));
    __stcs(o4 + 2, make_float4(f[8], f[9], f[10], f[11]));
    y += sy;
    xx += sx;
    while (xx >= w) {
      xx -= w;
      ++y;
    }
  }
}

// CTAs an image for the chain
inline int apply_ctas(int hw) { return (hw + kStreamPixels - 1) / kStreamPixels; }

// a kernel's build: registers, local bytes, shared bytes, threads,
// resident blocks an SM, to out[0..4]
cudaError_t build_of(const void* kernel, int threads, int* out) {
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (rc != cudaSuccess) return rc;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = threads;
  out[4] = blocks;
  return cudaSuccess;
}

}  // namespace

// x, out: (n, h, w, 3) float32, 16-byte aligned (out may not alias x); fb,
// fc, fs: (n,) float32 factors (read only when their flag is set); sums:
// (n,) float32 scratch; ty, tx: (n,) int32 cutout corners; flags: 1
// brightness, 2 contrast, 4 saturation, 8 cutout. Returns
// cudaGetLastError().
extern "C" int picha_augment(const void* x, int n, int h, int w, const void* fb, const void* fc,
                             const void* fs, void* sums, const void* ty, const void* tx, int cut,
                             float fill, int flags, float l0, float l1, float l2, void* out,
                             void* stream) {
  if (n < 0 || h < 1 || w < 1 || flags < 0 || flags > 15 || cut < 0 ||
      static_cast<int64_t>(h) * w > 0x7fffffff / 12 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const float*>(x), static_cast<const float*>(fb),
               static_cast<const float*>(fc), static_cast<const float*>(fs),
               static_cast<const float*>(sums), static_cast<const int*>(ty),
               static_cast<const int*>(tx), n, h * w, w, cut, flags, fill, l0, l1, l2,
               static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kContrast) {
    augment_grey_sum<<<n, kSumThreads, 0, st>>>(a, static_cast<float*>(sums));
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  augment_apply<<<dim3(apply_ctas(h * w), n), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The plan and build for images of h x w: out[0..1] CTAs an image for the
// chain, its threads; out[2..6] the chain kernel's registers, local
// bytes, shared bytes, threads, blocks an SM; out[7..11] the sum kernel's.
extern "C" int picha_augment_info(int h, int w, int* out) {
  if (h < 1 || w < 1 || static_cast<int64_t>(h) * w > 0x7fffffff / 12)
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = apply_ctas(h * w);
  out[1] = kThreads;
  cudaError_t rc = build_of(reinterpret_cast<const void*>(augment_apply), kThreads,
                                    out + 2);
  if (rc == cudaSuccess)
    rc = build_of(reinterpret_cast<const void*>(augment_grey_sum), kSumThreads, out + 7);
  return static_cast<int>(rc);
}
