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
// The ReLU's mask is recomputed from x, not read from y: y is K25's output
// for the same x, mu, sigma and scale (the autograd Function saves them
// together), and y > 0 exactly where bf16(((x - mu) / sigma) * scale) > 0
// in K25's rounding order (`masked_dy`: a sign test where |x - mu| is past
// a bound that keeps the product away from bf16's zero, that expression
// itself below it). So the kernel needs x and dy and writes dx: 6 bytes an
// element, where reading y made it 8.
//
// What bounds it on an H100: memory traffic. The bound's bytes at 6 bytes
// an element are 13.3 GB a step at N = 256, 3.96 ms at HBM peak (5.28 ms
// at 8 bytes, with y), against ~25 flops an element. The design reads x
// and dy twice and writes dx once, 10 bytes an element (1.67x the
// bound's; the previous design read x, y and dy twice, 14 bytes), in
// three launches, the two passes streaming their pixels through a
// shared-memory ring (resnet_norm.cuh), with 16-byte vectors where
// c % 8 == 0:
//   - pass 1 (`bwd_plane`), one thread-block cluster of up to 8 CTAs per
//     (image, channel group) plane as K25's statistics: each thread sums,
//     for its V channels, p, g and g * p in f32 over chunks of kChunk
//     pixels, then in float64; the block's rows meet in a fixed order, the
//     cluster's CTAs in rank order through distributed shared memory.
//     Rank 0 forms the plane's terms from those three sums, each rounded
//     once to f32: sum_hw (gs * u) * p = scale * u * sum(g p),
//     sum_hw(-gs / r) = -scale * sum(g) / r, sum_hw(-(dvar / hw) * 2p) =
//     -(dvar / hw) * 2 * sum(p), and the image's dscale term sum(g p) / r:
//     the same values up to the rounding of each term, which any order of
//     the sums moves as much. dvar / hw and the mean's cotangent / hw are
//     true divisions;
//   - pass 2 (`bwd_dx`) writes dx, rounded once to bf16 (__fmul_rn,
//     __fadd_rn and a true division, `div_by`: bit for bit __fdiv_rn;
//     no FMA contraction);
//   - dscale (`bwd_dscale`): one thread per channel sums the images'
//     terms in order in float64.
// No atomics: two runs give the same bits. Pass 2 is the costliest in
// instructions an element; with the mask's branch-free sign test, the
// division refined once a channel (with __fdiv_rn the stem's call took
// 3.49 ms against 2.92) and 4 blocks a multiprocessor, both passes run at
// ~85 % of the card's bandwidth (H100 80GB HBM3, 700 W; PERF.md):
// what remains over the bound is the second read of x and dy.
#include "resnet_norm.cuh"

namespace {

using namespace picha_norm;

constexpr int kThreads = 256;
constexpr int kDxIters = 16;   // pixel rows a thread of bwd_dx takes
// bwd_dx takes 4 channels a thread (8-byte vectors) where the others take
// 8, and 64 registers, so that 4 blocks fit a multiprocessor: it carries
// 9 per-channel constants, and at 8 channels and 3 blocks the stem's call
// took 4.23 ms against 2.92 (PERF.md)
constexpr int kDxWide = 4;
constexpr int kDxMinBlocks = 4;

// The bound at and past which masked_dy takes the sign test: there
// |(p / r) * scale| >= 2^-109 after both roundings, so bf16 of it is not
// zero and its sign is sign(p) * sign(scale). NaN (never the sign test)
// where scale is 0 or NaN, or the bound is not finite.
__device__ __forceinline__ float open_bound(float r, float sc) {
  const double a = fabs(static_cast<double>(sc));
  if (!(a > 0.0)) return __int_as_float(0x7fffffff);
  const double t = static_cast<double>(r) * fmax(0x1p-99, 0x1p-109 / a);
  const float tf = __double2float_ru(t);
  return tf <= 3.402823466e38f ? tf : __int_as_float(0x7fffffff);
}

// bf16(((p / r) * scale)) > 0 in K25's rounding order, off the main path
__device__ __noinline__ bool relu_open_exact(float p, const float* r, const float* sc) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fdiv_rn(p, *r), *sc))) > 0.0f;
}

// A channel's constants for the ReLU's mask: |p|'s bits take the sign test
// where |p| - lo <= span (unsigned), from the bound up to infinity, not NaN;
// none where the bound is NaN; and scale's sign bit
struct MaskC {
  uint32_t lo, span, sign;
};

__device__ __forceinline__ MaskC mask_c(float r, float sc) {
  const float b = open_bound(r, sc);
  const uint32_t lo = b == b ? __float_as_uint(b) : 0xffffffffu;
  return {lo, b == b ? 0x7f800000u - lo : 0u, __float_as_uint(sc) & 0x80000000u};
}

// g[k] = dy[k] where K25's output is > 0 at p[k] = x - mu, else +0: past
// the bound by the sign of p * scale (branch-free), below it (rare, one
// branch a pixel) by K25's own expression
template <int V>
__device__ __forceinline__ void masked_dy(const float (&p)[V], const float (&dy)[V],
                                          const MaskC (&mc)[V], const float* sigma,
                                          const float* scale, float (&g)[V]) {
  uint32_t slow = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const uint32_t pb = __float_as_uint(p[k]);
    slow |= ((pb & 0x7fffffffu) - mc[k].lo > mc[k].span ? 1u : 0u) << k;
    const uint32_t shut = static_cast<uint32_t>(static_cast<int32_t>(pb ^ mc[k].sign) >> 31);
    g[k] = __uint_as_float(__float_as_uint(dy[k]) & ~shut);
  }
  if (slow) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if ((slow >> k) & 1u)
        g[k] = relu_open_exact(p[k], sigma + k, scale + k) ? dy[k] : 0.0f;
  }
}

// dx of V channels of one pixel, from the plane's dvar / hw and dmu / hw
template <int V>
__device__ __forceinline__ void dx_px(const float (&xv)[V], const float (&gv)[V],
                                      const float (&m)[V], const float (&r)[V],
                                      const float (&y1)[V], const float (&sc)[V],
                                      const MaskC (&mc)[V], const float (&dv)[V],
                                      const float (&dm)[V], const float* sigma,
                                      const float* scale, __nv_bfloat16* dxp) {
  float p[V], g[V];
#pragma unroll
  for (int k = 0; k < V; ++k) p[k] = __fsub_rn(xv[k], m[k]);
  masked_dy<V>(p, gv, mc, sigma, scale, g);
  __nv_bfloat16 o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float gr = div_by(__fmul_rn(g[k], sc[k]), r[k], y1[k]);
    const float bv = __fmul_rn(dv[k], __fmul_rn(2.0f, p[k]));
    o[k] = __float2bfloat16_rn(__fadd_rn(__fadd_rn(gr, bv), dm[k]));
  }
  store_bf<V>(dxp, o);
}

// The plane's dvar / hw, dmu / hw (f32) and dscale term (float64) from
// the sums of p, g and g * p
__device__ __forceinline__ void finish_plane(const double (&t)[3], float r, float sc, int64_t hw,
                                             double* out, int c) {
  const float hwf = static_cast<float>(hw);
  const float u = __fdiv_rn(1.0f, __fmul_rn(r, r));
  const float a = __double2float_rn(__dmul_rn(__dmul_rn(static_cast<double>(u),
                                                        static_cast<double>(sc)), t[2]));
  const float dvar = __fmul_rn(-a, __fdiv_rn(0.5f, r));
  const float dvar_hw = __fdiv_rn(dvar, hwf);
  const float b = __double2float_rn(
      __ddiv_rn(-__dmul_rn(static_cast<double>(sc), t[1]), static_cast<double>(r)));
  const float by = -__fmul_rn(dvar_hw, __fmul_rn(2.0f, __double2float_rn(t[0])));
  out[0] = dvar_hw;
  out[c] = __fdiv_rn(__fadd_rn(b, by), hwf);
  out[2 * c] = __ddiv_rn(t[2], static_cast<double>(r));
}

// pass 1 (see the header): plane[img][0][ch] = dvar / hw, [1] = dmu / hw,
// [2] = the image's dscale term
template <int V>
__global__ void __launch_bounds__(kThreads, 2) bwd_plane(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const float* __restrict__ scale, const float* __restrict__ mu,
    const float* __restrict__ sigma, int64_t hw, int c, int tp, double* __restrict__ plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);   // red_bytes<3, kThreads>(tp, V)
  unsigned char* ring = smem + red_bytes<3, kThreads>(tp, V);
  __shared__ double part[3 * kMaxCg];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.y;
  const Lane l = lane_of<V, kThreads>(tp, blockIdx.z);
  double s[3][V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[0][k] = s[1][k] = s[2][k] = 0.0;
  if (l.ch0 < c) {
    const int64_t i0 = static_cast<int64_t>(img) * c + l.ch0;
    float m[V];
    MaskC mc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = mu[i0 + k];
      mc[k] = mask_c(sigma[i0 + k], scale[l.ch0 + k]);
    }
    int64_t px0, px1;
    share_of(hw, rank, static_cast<int>(cluster.num_blocks()), px0, px1);
    const int count = pixels_of(px0, px1, l.row, l.rows);
    const int64_t off = (static_cast<int64_t>(img) * hw + px0 + l.row) * c + l.ch0;
    const __nv_bfloat16* src[2] = {x + off, dy + off};
    float a[3][V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[0][k] = a[1][k] = a[2][k] = 0.0f;
    stream_pixels<V, kThreads, 2>(src, static_cast<int64_t>(l.rows) * c, count, ring,
                                  [&](int i, auto& v) {
      float p[V], g[V];
#pragma unroll
      for (int k = 0; k < V; ++k) p[k] = __fsub_rn(v[0][k], m[k]);
      masked_dy<V>(p, v[1], mc, sigma + i0, scale + l.ch0, g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[0][k] = __fadd_rn(a[0][k], p[k]);
        a[1][k] = __fadd_rn(a[1][k], g[k]);
        a[2][k] = __fmaf_rn(g[k], p[k], a[2][k]);
      }
      if ((i & (kChunk - 1)) == kChunk - 1 || i + 1 == count) {
#pragma unroll
        for (int k = 0; k < V; ++k)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            s[j][k] = __dadd_rn(s[j][k], static_cast<double>(a[j][k]));
            a[j][k] = 0.0f;
          }
      }
    });
  }
  block_sum<3, V, kThreads>(s, tp, red, part);
  cluster.sync();
  if (rank == 0) {
    for (int slot = threadIdx.x; slot < tp * V; slot += kThreads) {
      const int ch = blockIdx.z * tp * V + slot;
      if (ch >= c) continue;
      double t[3];
      cluster_sum<3>(cluster, part, slot, t);
      finish_plane(t, sigma[static_cast<int64_t>(img) * c + ch], scale[ch], hw,
                   plane + static_cast<int64_t>(img) * 3 * c + ch, c);
    }
  }
  cluster.sync();   // no CTA leaves while rank 0 reads its partials
}

// pass 2: dx over a run of pixel rows
template <int V>
__global__ void __launch_bounds__(kThreads, kDxMinBlocks) bwd_dx(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const float* __restrict__ scale, const float* __restrict__ mu,
    const float* __restrict__ sigma, const double* __restrict__ plane, int64_t hw, int c, int tp,
    __nv_bfloat16* __restrict__ dx) {
  extern __shared__ __align__(16) unsigned char ring[];
  const Lane l = lane_of<V, kThreads>(tp, blockIdx.z);
  if (l.ch0 >= c) return;
  const int img = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(img) * c + l.ch0;
  float m[V], r[V], y1[V], sc[V], dv[V], dm[V];
  MaskC mc[V];
  const double* pl = plane + static_cast<int64_t>(img) * 3 * c + l.ch0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = mu[i0 + k];
    r[k] = sigma[i0 + k];
    y1[k] = rcp_refined(r[k]);
    sc[k] = scale[l.ch0 + k];
    mc[k] = mask_c(r[k], sc[k]);
    dv[k] = static_cast<float>(pl[k]);
    dm[k] = static_cast<float>(pl[c + k]);
  }
  const int64_t run = static_cast<int64_t>(l.rows) * kDxIters;
  const int64_t px0 = static_cast<int64_t>(blockIdx.x) * run;
  const int64_t px1 = px0 + run < hw ? px0 + run : hw;
  const int64_t off = (static_cast<int64_t>(img) * hw + px0 + l.row) * c + l.ch0;
  const int64_t step = static_cast<int64_t>(l.rows) * c;
  const __nv_bfloat16* src[2] = {x + off, dy + off};
  __nv_bfloat16* dst = dx + off;
  stream_pixels<V, kThreads, 2>(src, step, pixels_of(px0, px1, l.row, l.rows), ring,
                                [&](int i, auto& v) {
    dx_px<V>(v[0], v[1], m, r, y1, sc, mc, dv, dm, sigma + i0, scale + l.ch0, dst + i * step);
  });
}

// one thread per channel: dscale[ch] = the images' terms in order
__global__ void __launch_bounds__(256) bwd_dscale(const double* __restrict__ plane, int n, int c,
                                                  float* __restrict__ dscale) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  double t = 0.0;
  for (int img = 0; img < n; ++img)
    t = __dadd_rn(t, plane[(static_cast<int64_t>(img) * 3 + 2) * c + ch]);
  dscale[ch] = __double2float_rn(t);
}

// How a call at (hw, c) is cut (see K25's)
struct Plan {
  int tp, groups, cl, dx_tp, dx_groups;
  size_t plane_smem, dx_smem;
};

template <int V>
constexpr int dx_width() {
  return V == 8 ? kDxWide : V;
}

template <int V>
Plan plan_for(int64_t hw, int c) {
  Plan pl;
  pl.tp = threads_per_pixel(c, V);
  pl.groups = (c + pl.tp * V - 1) / (pl.tp * V);
  pl.cl = cluster_size(hw, kThreads / pl.tp);
  pl.plane_smem = red_bytes<3, kThreads>(pl.tp, V) + ring_bytes<V, kThreads, 2>();
  pl.dx_smem = ring_bytes<dx_width<V>(), kThreads, 2>();
  pl.dx_tp = threads_per_pixel(c, dx_width<V>());
  pl.dx_groups = (c + pl.dx_tp * dx_width<V>() - 1) / (pl.dx_tp * dx_width<V>());
  return pl;
}

template <int V>
cudaError_t launch(const __nv_bfloat16* xs, const __nv_bfloat16* gs, const float* sc,
                   const float* m, const float* r, int n, int64_t hw, int c, __nv_bfloat16* dx,
                   float* dscale, double* plane, cudaStream_t st) {
  const Plan pl = plan_for<V>(hw, c);
  const int64_t run = static_cast<int64_t>(kThreads / pl.dx_tp) * kDxIters;
  const int64_t runs = (hw + run - 1) / run;
  if (pl.groups > 65535 || runs > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t rc = launch_clusters(bwd_plane<V>, pl.cl, n, pl.groups, kThreads, pl.plane_smem,
                                   st, xs, gs, sc, m, r, hw, c, pl.tp, plane);
  constexpr int W = dx_width<V>();
  if (rc == cudaSuccess) rc = allow_smem(bwd_dx<W>, pl.dx_smem);
  if (rc != cudaSuccess) return rc;
  bwd_dx<W><<<dim3(static_cast<unsigned>(runs), n, pl.dx_groups), kThreads, pl.dx_smem, st>>>(
      xs, gs, sc, m, r, plane, hw, c, pl.dx_tp, dx);
  bwd_dscale<<<(c + 255) / 256, 256, 0, st>>>(plane, n, c, dscale);
  return cudaGetLastError();
}

// out[0..4]: V, tp, channel groups, CTAs a cluster, launches; out[5..9]
// bwd_plane's build, out[10..14] bwd_dx's (build_of)
template <int V>
cudaError_t info(int64_t hw, int c, int* out) {
  const Plan pl = plan_for<V>(hw, c);
  const int head[5] = {V, pl.tp, pl.groups, pl.cl, 3};
  for (int i = 0; i < 5; ++i) out[i] = head[i];
  cudaError_t rc = allow_smem(bwd_plane<V>, pl.plane_smem);
  if (rc == cudaSuccess) rc = allow_smem(bwd_dx<dx_width<V>()>, pl.dx_smem);
  if (rc == cudaSuccess)
    rc = build_of(reinterpret_cast<const void*>(bwd_plane<V>), kThreads, pl.plane_smem, out + 5);
  if (rc == cudaSuccess)
    rc = build_of(reinterpret_cast<const void*>(bwd_dx<dx_width<V>()>), kThreads, pl.dx_smem,
                  out + 10);
  return rc;
}

}  // namespace

// x, dy, dx: (n, hw, c) bf16 (dx may not alias them); scale: (c,) float32;
// mu, sigma: (n, c) float32, K25's for this x (the ReLU's mask is K25's
// output recomputed from them, see the header); c >= 1; dscale: (c,)
// float32 out; plane: (n, 3, c) float64 scratch. Three launches (pass 1,
// dx, dscale). Returns cudaGetLastError() or the launch's error.
extern "C" int picha_resnet_norm_bwd(const void* x, const void* dy, const void* scale,
                                     const void* mu, const void* sigma, int n, int64_t hw, int c,
                                     void* dx, void* dscale, void* plane, void* stream) {
  if (n < 0 || n > 65535 || hw < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    const cudaError_t rc = cudaMemsetAsync(dscale, 0, static_cast<size_t>(c) * sizeof(float), st);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  const auto* xs = static_cast<const __nv_bfloat16*>(x);
  const auto* gs = static_cast<const __nv_bfloat16*>(dy);
  const auto* sc = static_cast<const float*>(scale);
  const auto* m = static_cast<const float*>(mu);
  const auto* r = static_cast<const float*>(sigma);
  auto* dxs = static_cast<__nv_bfloat16*>(dx);
  auto* ds = static_cast<float*>(dscale);
  double* pl = static_cast<double*>(plane);
  const void* ptrs[3] = {x, dy, dx};
  const int v = vec_width(c, ptrs, 3);
  const cudaError_t rc = v == 8   ? launch<8>(xs, gs, sc, m, r, n, hw, c, dxs, ds, pl, st)
                         : v == 2 ? launch<2>(xs, gs, sc, m, r, n, hw, c, dxs, ds, pl, st)
                                  : launch<1>(xs, gs, sc, m, r, n, hw, c, dxs, ds, pl, st);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// K26's plan and builds for a call at (hw, c) of vector width v (8, 2 or
// 1; see `info`): 15 ints to out. Launches nothing.
extern "C" int picha_resnet_norm_bwd_info(int64_t hw, int c, int v, int* out) {
  if (hw < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = v == 8 ? info<8>(hw, c, out) : v == 2 ? info<2>(hw, c, out)
                                                               : info<1>(hw, c, out);
  return static_cast<int>(rc);
}
