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
// __fadd_rn, __fdiv_rn). An odd channel count takes the same kernels
// instantiated for one channel a lane (W = 1) in place of a bf16 pair
// (W = 2), each channel's sums in the same order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRun = 256;
constexpr int kLanes = 32;
constexpr int kTerms = 4;   // a: variance path, b: -gs / r, d: p, q: dscale

__device__ __forceinline__ float masked(__nv_bfloat16 y, __nv_bfloat16 dy) {
  return __bfloat162float(y) > 0.0f ? __bfloat162float(dy) : 0.0f;
}

// W channels at p -> raw bf16 values
template <int W>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, __nv_bfloat16 (&v)[W]) {
  if constexpr (W == 2) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = h.x;
    v[1] = h.y;
  } else {
    v[0] = *p;
  }
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32) bwd_partial(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ dy, const float* __restrict__ scale,
    const float* __restrict__ mu, const float* __restrict__ sigma, int64_t hw, int c, int runs,
    double* __restrict__ partial) {
  __shared__ double acc[kWarps][kTerms][kLanes * W];
  const int run = blockIdx.x, img = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch0 = (blockIdx.z * kLanes + lane) * W;
  float sa[W], sb[W], sd[W], sq[W];
#pragma unroll
  for (int k = 0; k < W; ++k) sa[k] = sb[k] = sd[k] = sq[k] = 0.0f;
  if (ch0 < c) {
    float m[W], r[W], sc[W], u[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      m[k] = mu[static_cast<int64_t>(img) * c + ch0 + k];
      r[k] = sigma[static_cast<int64_t>(img) * c + ch0 + k];
      sc[k] = scale[ch0 + k];
      u[k] = __fdiv_rn(1.0f, __fmul_rn(r[k], r[k]));
    }
    const int64_t px0 = static_cast<int64_t>(run) * kRun;
    const int64_t px1 = px0 + kRun < hw ? px0 + kRun : hw;
    const int64_t off = static_cast<int64_t>(img) * hw * c + ch0;
#pragma unroll 2
    for (int64_t px = px0 + warp; px < px1; px += kWarps) {
      const int64_t i = off + px * c;
      __nv_bfloat16 xv[W], yv[W], gv[W];
      load_raw<W>(x + i, xv);
      load_raw<W>(y + i, yv);
      load_raw<W>(dy + i, gv);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float g = masked(yv[k], gv[k]);
        const float p = __fsub_rn(__bfloat162float(xv[k]), m[k]);
        sq[k] = __fadd_rn(sq[k], __fmul_rn(__fdiv_rn(p, r[k]), g));
        const float gs = __fmul_rn(g, sc[k]);
        sa[k] = __fadd_rn(sa[k], __fmul_rn(__fmul_rn(gs, u[k]), p));
        sb[k] = __fadd_rn(sb[k], -__fdiv_rn(gs, r[k]));
        sd[k] = __fadd_rn(sd[k], p);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    acc[warp][0][lane * W + k] = sa[k];
    acc[warp][1][lane * W + k] = sb[k];
    acc[warp][2][lane * W + k] = sd[k];
    acc[warp][3][lane * W + k] = sq[k];
  }
  __syncthreads();
  // warps 0-3 each combine one term over the 8 warps, in warp order
  if (warp < kTerms && ch0 < c) {
    double* out = partial + ((static_cast<int64_t>(img) * runs + run) * kTerms + warp) * c + ch0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      double t = acc[0][warp][lane * W + k];
      for (int w = 1; w < kWarps; ++w) t = __dadd_rn(t, acc[w][warp][lane * W + k]);
      out[k] = t;
    }
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

template <int W>
__global__ void __launch_bounds__(kWarps * 32) bwd_dx(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ dy, const float* __restrict__ scale,
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const double* __restrict__ plane, int64_t hw, int c, __nv_bfloat16* __restrict__ dx) {
  const int run = blockIdx.x, img = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch0 = (blockIdx.z * kLanes + lane) * W;
  if (ch0 >= c) return;
  float m[W], r[W], sc[W], dv[W], dm[W];
  const double* pl = plane + static_cast<int64_t>(img) * 3 * c + ch0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    m[k] = mu[static_cast<int64_t>(img) * c + ch0 + k];
    r[k] = sigma[static_cast<int64_t>(img) * c + ch0 + k];
    sc[k] = scale[ch0 + k];
    dv[k] = static_cast<float>(pl[k]);
    dm[k] = static_cast<float>(pl[c + k]);
  }
  const int64_t px0 = static_cast<int64_t>(run) * kRun;
  const int64_t px1 = px0 + kRun < hw ? px0 + kRun : hw;
  const int64_t off = static_cast<int64_t>(img) * hw * c + ch0;
#pragma unroll 2
  for (int64_t px = px0 + warp; px < px1; px += kWarps) {
    const int64_t i = off + px * c;
    __nv_bfloat16 xv[W], yv[W], gv[W];
    load_raw<W>(x + i, xv);
    load_raw<W>(y + i, yv);
    load_raw<W>(dy + i, gv);
    float o[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float g = masked(yv[k], gv[k]);
      const float p = __fsub_rn(__bfloat162float(xv[k]), m[k]);
      const float gr = __fdiv_rn(__fmul_rn(g, sc[k]), r[k]);
      const float bv = __fmul_rn(dv[k], __fmul_rn(2.0f, p));
      o[k] = __fadd_rn(__fadd_rn(gr, bv), dm[k]);
    }
    if constexpr (W == 2)
      *reinterpret_cast<__nv_bfloat162*>(dx + i) = __floats2bfloat162_rn(o[0], o[1]);
    else
      dx[i] = __float2bfloat16_rn(o[0]);
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

template <int W>
void launch(const __nv_bfloat16* xs, const __nv_bfloat16* ys, const __nv_bfloat16* gs,
            const float* sc, const float* m, const float* r, int n, int64_t hw, int c,
            int64_t runs, int groups, __nv_bfloat16* dx, float* dscale, double* part, double* pl,
            cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(runs), n, groups);
  const int64_t planes = static_cast<int64_t>(n) * c;
  bwd_partial<W><<<grid, kWarps * 32, 0, st>>>(xs, ys, gs, sc, m, r, hw, c,
                                               static_cast<int>(runs), part);
  bwd_plane<<<static_cast<unsigned>((planes + 255) / 256), 256, 0, st>>>(
      part, r, static_cast<int>(runs), n, c, static_cast<float>(hw), pl);
  bwd_dx<W><<<grid, kWarps * 32, 0, st>>>(xs, ys, gs, sc, m, r, pl, hw, c, dx);
  bwd_dscale<<<(c + 255) / 256, 256, 0, st>>>(pl, n, c, dscale);
}

}  // namespace

// x, y, dy, dx: (n, hw, c) bf16 (dx may not alias them; 4-byte aligned
// where c is even); scale: (c,) float32; mu, sigma: (n, c) float32 (K25's);
// c >= 1; dscale: (c,) float32 out; partial: (n, ceil(hw / 256), 4, c) and
// plane: (n, 3, c) float64 scratch. Returns cudaGetLastError().
extern "C" int picha_resnet_norm_bwd(const void* x, const void* y, const void* dy,
                                     const void* scale, const void* mu, const void* sigma, int n,
                                     int64_t hw, int c, void* dx, void* dscale, void* partial,
                                     void* plane, void* stream) {
  if (n < 0 || n > 65535 || hw < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    const cudaError_t rc = cudaMemsetAsync(dscale, 0, static_cast<size_t>(c) * sizeof(float), st);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  const int64_t runs = (hw + kRun - 1) / kRun;
  const int w = (c & 1) ? 1 : 2;
  const int groups = (c / w + kLanes - 1) / kLanes;
  if (runs > 0x7fffffffLL || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = static_cast<const __nv_bfloat16*>(x);
  const auto* ys = static_cast<const __nv_bfloat16*>(y);
  const auto* gs = static_cast<const __nv_bfloat16*>(dy);
  const auto* sc = static_cast<const float*>(scale);
  const auto* m = static_cast<const float*>(mu);
  const auto* r = static_cast<const float*>(sigma);
  auto* dxs = static_cast<__nv_bfloat16*>(dx);
  auto* ds = static_cast<float*>(dscale);
  double* part = static_cast<double*>(partial);
  double* pl = static_cast<double*>(plane);
  if (w == 2)
    launch<2>(xs, ys, gs, sc, m, r, n, hw, c, runs, groups, dxs, ds, part, pl, st);
  else
    launch<1>(xs, ys, gs, sc, m, r, n, hw, c, runs, groups, dxs, ds, part, pl, st);
  return static_cast<int>(cudaGetLastError());
}
