// K26: the backward of the ResNet's instance norm + scale + ReLU (K25):
// dx and dscale.
//
// Replaces: the VJP that JAX derives from picha_tpu/models/resnet.py::_norm
// (:100-106) and the jax.nn.relu after it (:129, :131) inside
// jax.value_and_grad(loss_fn) (:161); XLA fuses it into the backward
// graph. Per (image, channel), with p = x - mu, r = sigma (K25's), the
// rounding points of the jaxpr:
//   g      = f32(y > 0 ? dy : 0)          (the mask is on the bf16 output)
//   dscale = sum over (N, H, W) of (p / r) * g
//   gs     = g * scale,  dvar = -(sum_hw (gs * (1 / (r * r))) * p) * (0.5 / r)
//   dx     = bf16((gs / r + (dvar / hw) * 2p) + (sum_hw(-gs / r) + sum_hw(-(dvar / hw) * 2p)) / hw)
// It runs twice per block: 12 times a train step of ResNetConfig().
//
// What bounds it on an H100: memory traffic. It must read x, y and dy
// and write dx, 8 bytes an element: 17.7 GB a step at N = 256, 5.3 ms at
// HBM peak, against ~25 flops an element. The design, simple first: two
// passes over x, y and dy (14 bytes an element, 1.75x the bound's):
//   - pass 1, blocks as K25's (a 256-pixel run of a plane, an image, 64
//     channels; lanes across the channels as bf16 pairs, 8 warps striding
//     over the run): each lane sums, in f32 over its 32 pixels, the
//     terms of the variance path, -gs / r, p, and dscale's (p / r) * g;
//     the 8 warps meet in shared memory in warp order in float64, one
//     float64 partial per (run, term, channel);
//   - one thread per (image, channel) sums the runs in order in float64,
//     rounds each sum once to f32 and forms dvar / hw and the mean's
//     cotangent / hw with true divisions. The sum of -(dvar / hw) * 2p
//     over the plane is taken as -(dvar / hw) * 2 * sum(p): the same value
//     up to the rounding of its terms, which any order of the sum moves
//     as much;
//   - pass 2 writes dx, rounded once to bf16;
//   - dscale: one thread per channel sums the per-(image, channel)
//     partials over the images in order.
// No atomics: two runs give the same bits. No FMA contraction (__fmul_rn,
// __fadd_rn, __fdiv_rn).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRun = 256;
constexpr int kPairsPerGroup = 32;
constexpr int kTerms = 4;   // a: variance path, b: -gs / r, d: p, q: dscale

__device__ __forceinline__ float masked(__nv_bfloat16 y, __nv_bfloat16 dy) {
  return __bfloat162float(y) > 0.0f ? __bfloat162float(dy) : 0.0f;
}

__global__ void __launch_bounds__(kWarps * 32) bwd_partial(
    const __nv_bfloat162* __restrict__ x, const __nv_bfloat162* __restrict__ y,
    const __nv_bfloat162* __restrict__ dy, const float2* __restrict__ scale,
    const float2* __restrict__ mu, const float2* __restrict__ sigma, int64_t hw, int pairs,
    int runs, double* __restrict__ partial) {
  __shared__ double2 acc[kWarps][kTerms][kPairsPerGroup];
  const int run = blockIdx.x, img = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.z * kPairsPerGroup + lane;
  float2 sa = make_float2(0.0f, 0.0f), sb = sa, sd = sa, sq = sa;
  if (p < pairs) {
    const float2 m = mu[static_cast<int64_t>(img) * pairs + p];
    const float2 r = sigma[static_cast<int64_t>(img) * pairs + p];
    const float2 sc = scale[p];
    const float2 u = make_float2(__fdiv_rn(1.0f, __fmul_rn(r.x, r.x)),
                                 __fdiv_rn(1.0f, __fmul_rn(r.y, r.y)));
    const int64_t px0 = static_cast<int64_t>(run) * kRun;
    const int64_t px1 = px0 + kRun < hw ? px0 + kRun : hw;
    const int64_t off = static_cast<int64_t>(img) * hw * pairs + p;
#pragma unroll 2
    for (int64_t px = px0 + warp; px < px1; px += kWarps) {
      const int64_t i = off + px * pairs;
      const float2 xv = __bfloat1622float2(x[i]);
      const __nv_bfloat162 yv = y[i], gv = dy[i];
      const float gx = masked(yv.x, gv.x), gy = masked(yv.y, gv.y);
      const float px_ = __fsub_rn(xv.x, m.x), py_ = __fsub_rn(xv.y, m.y);
      sq.x = __fadd_rn(sq.x, __fmul_rn(__fdiv_rn(px_, r.x), gx));
      sq.y = __fadd_rn(sq.y, __fmul_rn(__fdiv_rn(py_, r.y), gy));
      const float gsx = __fmul_rn(gx, sc.x), gsy = __fmul_rn(gy, sc.y);
      sa.x = __fadd_rn(sa.x, __fmul_rn(__fmul_rn(gsx, u.x), px_));
      sa.y = __fadd_rn(sa.y, __fmul_rn(__fmul_rn(gsy, u.y), py_));
      sb.x = __fadd_rn(sb.x, -__fdiv_rn(gsx, r.x));
      sb.y = __fadd_rn(sb.y, -__fdiv_rn(gsy, r.y));
      sd.x = __fadd_rn(sd.x, px_);
      sd.y = __fadd_rn(sd.y, py_);
    }
  }
  acc[warp][0][lane] = make_double2(sa.x, sa.y);
  acc[warp][1][lane] = make_double2(sb.x, sb.y);
  acc[warp][2][lane] = make_double2(sd.x, sd.y);
  acc[warp][3][lane] = make_double2(sq.x, sq.y);
  __syncthreads();
  // warps 0-3 each combine one term over the 8 warps, in warp order
  if (warp < kTerms && p < pairs) {
    double2 t = acc[0][warp][lane];
    for (int w = 1; w < kWarps; ++w) {
      t.x = __dadd_rn(t.x, acc[w][warp][lane].x);
      t.y = __dadd_rn(t.y, acc[w][warp][lane].y);
    }
    double* out =
        partial + ((static_cast<int64_t>(img) * runs + run) * kTerms + warp) * (2 * pairs) + 2 * p;
    out[0] = t.x;
    out[1] = t.y;
  }
}

// one thread per (image, channel): plane[img][0][ch] = dvar / hw,
// plane[img][1][ch] = the mean's cotangent / hw, plane[img][2][ch] = the
// image's dscale partial
__global__ void __launch_bounds__(256) bwd_plane(const double* __restrict__ partial,
                                                 const float* __restrict__ sigma, int runs, int n,
                                                 int c, float hw, double* __restrict__ plane) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(n) * c) return;
  const int64_t img = idx / c, ch = idx % c;
  double t[kTerms] = {0.0, 0.0, 0.0, 0.0};
  for (int r = 0; r < runs; ++r) {
    const double* src = partial + ((img * runs + r) * kTerms) * c + ch;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) t[k] = __dadd_rn(t[k], src[static_cast<int64_t>(k) * c]);
  }
  const float r = sigma[idx];
  const float dvar = __fmul_rn(-__double2float_rn(t[0]), __fdiv_rn(0.5f, r));
  const float dvar_hw = __fdiv_rn(dvar, hw);
  const float by = -__fmul_rn(dvar_hw, __fmul_rn(2.0f, __double2float_rn(t[2])));
  const float dmu = __fdiv_rn(__fadd_rn(__double2float_rn(t[1]), by), hw);
  double* out = plane + img * 3 * c + ch;
  out[0] = dvar_hw;
  out[c] = dmu;
  out[2 * c] = t[3];
}

__global__ void __launch_bounds__(kWarps * 32) bwd_dx(
    const __nv_bfloat162* __restrict__ x, const __nv_bfloat162* __restrict__ y,
    const __nv_bfloat162* __restrict__ dy, const float2* __restrict__ scale,
    const float2* __restrict__ mu, const float2* __restrict__ sigma,
    const double* __restrict__ plane, int64_t hw, int pairs, __nv_bfloat162* __restrict__ dx) {
  const int run = blockIdx.x, img = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.z * kPairsPerGroup + lane;
  if (p >= pairs) return;
  const int c = 2 * pairs;
  const float2 m = mu[static_cast<int64_t>(img) * pairs + p];
  const float2 r = sigma[static_cast<int64_t>(img) * pairs + p];
  const float2 sc = scale[p];
  const double* pl = plane + static_cast<int64_t>(img) * 3 * c + 2 * p;
  const float2 dv = make_float2(static_cast<float>(pl[0]), static_cast<float>(pl[1]));
  const float2 dm = make_float2(static_cast<float>(pl[c]), static_cast<float>(pl[c + 1]));
  const int64_t px0 = static_cast<int64_t>(run) * kRun;
  const int64_t px1 = px0 + kRun < hw ? px0 + kRun : hw;
  const int64_t off = static_cast<int64_t>(img) * hw * pairs + p;
#pragma unroll 2
  for (int64_t px = px0 + warp; px < px1; px += kWarps) {
    const int64_t i = off + px * pairs;
    const float2 xv = __bfloat1622float2(x[i]);
    const __nv_bfloat162 yv = y[i], gv = dy[i];
    const float gx = masked(yv.x, gv.x), gy = masked(yv.y, gv.y);
    const float px_ = __fsub_rn(xv.x, m.x), py_ = __fsub_rn(xv.y, m.y);
    const float grx = __fdiv_rn(__fmul_rn(gx, sc.x), r.x);
    const float gry = __fdiv_rn(__fmul_rn(gy, sc.y), r.y);
    const float bvx = __fmul_rn(dv.x, __fmul_rn(2.0f, px_));
    const float bvy = __fmul_rn(dv.y, __fmul_rn(2.0f, py_));
    dx[i] = __floats2bfloat162_rn(__fadd_rn(__fadd_rn(grx, bvx), dm.x),
                                  __fadd_rn(__fadd_rn(gry, bvy), dm.y));
  }
}

// one thread per channel: dscale[ch] = the images' partials in order
__global__ void __launch_bounds__(256) bwd_dscale(const double* __restrict__ plane, int n, int c,
                                                  float* __restrict__ dscale) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  double t = 0.0;
  for (int img = 0; img < n; ++img)
    t = __dadd_rn(t, plane[(static_cast<int64_t>(img) * 3 + 2) * c + ch]);
  dscale[ch] = __double2float_rn(t);
}

}  // namespace

// x, y, dy, dx: (n, hw, c) bf16 (dx may not alias them); scale: (c,)
// float32; mu, sigma: (n, c) float32 (K25's); c even; dscale: (c,) float32
// out; partial: (n, ceil(hw / 256), 4, c) and plane: (n, 3, c) float64
// scratch. Returns cudaGetLastError().
extern "C" int picha_resnet_norm_bwd(const void* x, const void* y, const void* dy,
                                     const void* scale, const void* mu, const void* sigma, int n,
                                     int64_t hw, int c, void* dx, void* dscale, void* partial,
                                     void* plane, void* stream) {
  if (n < 0 || n > 65535 || hw < 1 || c < 2 || (c & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    const cudaError_t rc = cudaMemsetAsync(dscale, 0, static_cast<size_t>(c) * sizeof(float), st);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  const int64_t runs = (hw + kRun - 1) / kRun;
  const int pairs = c / 2;
  const int groups = (pairs + kPairsPerGroup - 1) / kPairsPerGroup;
  if (runs > 0x7fffffffLL || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(runs), n, groups);
  const int64_t planes = static_cast<int64_t>(n) * c;
  const auto* xs = static_cast<const __nv_bfloat162*>(x);
  const auto* ys = static_cast<const __nv_bfloat162*>(y);
  const auto* gs = static_cast<const __nv_bfloat162*>(dy);
  const auto* sc = static_cast<const float2*>(scale);
  const auto* m2 = static_cast<const float2*>(mu);
  const auto* r2 = static_cast<const float2*>(sigma);
  double* part = static_cast<double*>(partial);
  double* pl = static_cast<double*>(plane);
  bwd_partial<<<grid, kWarps * 32, 0, st>>>(xs, ys, gs, sc, m2, r2, hw, pairs,
                                            static_cast<int>(runs), part);
  bwd_plane<<<static_cast<unsigned>((planes + 255) / 256), 256, 0, st>>>(
      part, static_cast<const float*>(sigma), static_cast<int>(runs), n, c,
      static_cast<float>(hw), pl);
  bwd_dx<<<grid, kWarps * 32, 0, st>>>(xs, ys, gs, sc, m2, r2, pl, hw, pairs,
                                       static_cast<__nv_bfloat162*>(dx));
  bwd_dscale<<<(c + 255) / 256, 256, 0, st>>>(pl, n, c, static_cast<float*>(dscale));
  return static_cast<int>(cudaGetLastError());
}
