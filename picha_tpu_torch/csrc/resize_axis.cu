// K8: the separable resize with per-output tap windows: both axes in one
// launch (resize_2d), or one axis a launch (resize_rows, resize_cols).
//
// Replaces: picha_tpu/ops/resize.py::resize_f32 (:330: the horizontal
// pass, then the vertical one) and _apply_axis (:296). The TPU graph runs
// each axis as a dense (dst, src) einsum at a source <= 512, and above it
// as the banded plan: a gather of T tiles of in_len source rows and a
// batched (tile, in_len) einsum, for the MXU's sake. For 1920 -> 960 that
// is 131 multiply-adds per output where 7 taps are nonzero.
//
// The arithmetic, in every kernel here: out = out_scale * sum_j taps[o,
// j] * v[starts[o] + j] with v = x * in_scale (the pipeline's f32(1/255)
// for uint8, 1 for f32) taken before any tap, the sum in window order
// with separately rounded products and sums (__fmul_rn / __fadd_rn, so
// nvcc cannot contract them into FMAs), starting from 0. Two axes are
// the width pass (in_scale, then out_scale 1) and the height pass on its
// f32 result (in_scale 1, then out_scale). The plain twin
// (ops/resize.py::resize_axis_windowed_plain, applied once an axis) does
// the same operations in the same order, so every route agrees with it
// bit for bit. No atomics.
//
// What bounds it on an H100: memory traffic. The staged transcode's
// resize (16 x 1088 x 1920 x 3 uint8 -> 544 x 960 f32) must read the
// 100 MB input and write the 100 MB output: 0.060 ms at HBM peak. Two
// passes through HBM also write and read the width pass's 200 MB f32
// intermediate (0.180 ms). The designs:
//   - resize_2d (both axes, one launch): a block owns a tile of ty output
//     rows x tx output columns of one image. It takes its source rows'
//     and columns' spans from the min and max of its tile's starts (no
//     monotone windows assumed) and puts every source row of the tile in
//     flight at once: the 16-byte words that cover each row's column span
//     go to shared memory by cp.async, in two commit groups, so the width
//     pass of the first half of the rows runs while the second lands, and
//     a uint8 tile keeps ~18 KB in flight. (Staging 4 rows at a time left
//     the first design waiting on memory, 0.36 ms at the transcode's
//     shape; 4 commit groups 0.23, 8 0.25; persistent blocks that
//     double-buffer the next tile's rows 0.20, at 64 registers; PERF.md
//     §6.) The width pass reads the raw input from shared memory (v *
//     in_scale per tap) into the tile's f32 intermediate in shared
//     memory; the height pass reads it back with float4 loads and stores
//     the tile with 16-byte stores where aligned. The intermediate never
//     reaches HBM. The tile (ty, and the smem it needs) is planned on the
//     host from the windows and the card's shared memory and occupancy
//     (ops/resize.py::resize_plan), so it holds every tile's spans; a
//     block whose spans pass it (a plan of other windows) traps.
//   - resize_rows (one axis, inner = C <= 4: the width pass): a block
//     takes a tile of outputs of kRows consecutive rows, stages the
//     rows' spans the same way and the tile's taps in shared memory, and
//     stores 128 bytes a warp. Where the spans do not fit shared memory,
//     the plan stages nothing and the kernel reads global memory.
//   - resize_cols (one axis, inner = W*C contiguous: the height pass): a
//     thread owns 4 consecutive inner elements (float4 / uchar4 loads and
//     float4 stores where aligned) and walks a chunk of outputs, the
//     chunk's starts and taps staged in shared memory.
// No kernel divides per element by a runtime size: grids are 2-D, and
// the channel count is a template parameter. resize_2d's windows of 5
// taps (the defaults' 2x downscale: cubic at filterScale 0.7) take a
// build whose tap loops are unrolled 5 times, with the width taps in
// registers; other windows take the build whose loops are unrolled by 4
// (PERF.md §6 times both at the windows that run them).
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

#include "resnet_norm.cuh"

namespace {

using picha_norm::cp_async;
using picha_norm::cp_commit;
using picha_norm::cp_wait;

constexpr int kThreads = 256;
constexpr int kRows = 4;           // rows a block of resize_rows takes
constexpr int kTapSmem = 12288;    // bytes of taps + starts resize_cols stages

// v * s as f32, v one element
__device__ __forceinline__ float unpack(uint8_t v, float s) {
  return __fmul_rn(static_cast<float>(v), s);
}

__device__ __forceinline__ float unpack(float v, float s) { return __fmul_rn(v, s); }

// 4 consecutive elements at p (a word of 4 elements, aligned) * s as f32
__device__ __forceinline__ float4 quad_f32(const uint8_t* p, float s) {
  const uchar4 u = *reinterpret_cast<const uchar4*>(p);
  return make_float4(unpack(u.x, s), unpack(u.y, s), unpack(u.z, s), unpack(u.w, s));
}

__device__ __forceinline__ float4 quad_f32(const float* p, float s) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(unpack(u.x, s), unpack(u.y, s), unpack(u.z, s), unpack(u.w, s));
}

// Copies the 16-byte words that cover cnt elements from g to dst (16-byte
// aligned) with cp.async: a word that holds an element of the tensor
// lies inside its allocation, whose base and size the allocator rounds
// to 512 bytes. Element i lands at element shift + i of dst; returns
// shift. Threads `t` of `nt` share the words.
template <typename T>
__device__ __forceinline__ int stage_raw(const T* g, int cnt, unsigned char* dst, int t, int nt) {
  const int sb = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const unsigned char* g0 = reinterpret_cast<const unsigned char*>(g) - sb;
  const int nc = (sb + cnt * static_cast<int>(sizeof(T)) + 15) >> 4;
  for (int i = t; i < nc; i += nt) cp_async<16>(dst + 16 * i, g0 + 16 * i);
  return sb / static_cast<int>(sizeof(T));
}

// The tap sum of one output: sum_j w[j] * (v[j * step] * s), in j order;
// v the raw input (uint8 or f32; s = 1 for f32, an exact product). KM > 0: k <= KM, the loop unrolled KM times and predicated on k
// (w may then sit in registers); else a loop unrolled by 4.
template <int KM, typename T>
__device__ __forceinline__ float tap_sum(const float* w, const T* v, int k, int step, float s) {
  float acc = 0.0f;
  if constexpr (KM > 0) {
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < k) acc = __fadd_rn(acc, __fmul_rn(w[j], unpack(v[j * step], s)));
  } else {
#pragma unroll 4
    for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, __fmul_rn(w[j], unpack(v[j * step], s)));
  }
  return acc;
}

// The same straight from global memory (v unpacked as x * s)
template <typename T>
__device__ __forceinline__ float tap_sum_global(const float* w, const T* x, int k, int64_t step,
                                                float s) {
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, __fmul_rn(__ldg(w + j), unpack(x[j * step], s)));
  return acc;
}

// lo = min, hi = max of starts[0..n) over a warp (every lane gets them)
__device__ __forceinline__ void warp_span(const int* starts, int n, int lane, int& lo, int& hi) {
  int a = 0x7fffffff, b = 0;
  for (int o = lane; o < n; o += 32) {
    const int s = __ldg(starts + o);
    a = min(a, s);
    b = max(b, s);
  }
  lo = __reduce_min_sync(0xffffffffu, a);
  hi = __reduce_max_sync(0xffffffffu, b);
}

// Stores 4 consecutive outputs at p (16 bytes if vec, else those of the
// first `valid`).
__device__ __forceinline__ void store4(float* p, const float (&r)[4], int valid, bool vec) {
  if (vec && valid >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < valid) p[q] = r[q];
  }
}

// ---- resize_2d ------------------------------------------------------------
// The crop mode's per-image source: x holds (n, h, w, C) frames, and image
// n's src_h x src_w source is the crop at (xs[n], ys[n]) (clamped into the
// frame, as lax.dynamic_slice clamps), mirrored left-right where flip[n].
struct Crop {
  const int* xs;
  const int* ys;
  const uint8_t* flip;
  int h, w;
};

// grid: x = image * col_tiles + column tile, y = row tile. Dynamic smem:
// mid (rows_max x tx*C f32), the staged source rows (rows_max x
// span_chunks 16-byte words of raw input), the tile's width taps (tx x
// kw) and height taps (ty x kh), its relative starts (tx + ty ints) and
// the staged rows' element shifts (rows_max ints). KM > 0: kw, kh <= KM
// (the tap loops unrolled, a thread's width taps in registers). kCrop:
// the source is a crop of a frame (`Crop`): a tile stages frame rows y0 +
// its row span and the frame columns its column span maps to (mirrored,
// x0 + crop - 1 - hi ... x0 + crop - 1 - lo), by the same covering words
// at any byte offset, and reads a mirrored row backwards, so the taps
// still run in window order over crop columns.
template <typename T, int C, int KM, bool kCrop>
__global__ void __launch_bounds__(kThreads) resize_2d(
    const T* __restrict__ x, int src_h, int src_w, int dst_h, int dst_w,
    const int* __restrict__ sw, const float* __restrict__ tw, int kw,
    const int* __restrict__ sh, const float* __restrict__ th, int kh, float in_scale,
    float out_scale, float* __restrict__ out, int tx, int ty, int col_tiles, int rows_max,
    int span_chunks, int vec_out, Crop crop) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int span[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n = blockIdx.x / col_tiles;
  int fh = src_h, fw = src_w, x0 = 0, y0 = 0;
  bool fl = false;
  if constexpr (kCrop) {
    fh = crop.h;
    fw = crop.w;
    x0 = min(max(__ldg(crop.xs + n), 0), fw - src_w);
    y0 = min(max(__ldg(crop.ys + n), 0), fh - src_h);
    fl = crop.flip[n] != 0;
  }
  const int ox0 = (blockIdx.x - static_cast<int>(n) * col_tiles) * tx;
  const int oy0 = blockIdx.y * ty;
  const int nx = min(tx, dst_w - ox0), ny = min(ty, dst_h - oy0);
  const int txc = tx * C, nxc = nx * C;
  if (warp < 2) {
    int lo, hi;
    if (warp == 0)
      warp_span(sw + ox0, nx, lane, lo, hi);
    else
      warp_span(sh + oy0, ny, lane, lo, hi);
    if (lane == 0) {
      span[2 * warp] = lo;
      span[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
  const int xlo = span[0], ylo = span[2];
  const int xspan = span[1] + kw - xlo;        // source columns of a staged row
  const int xcnt = xspan * C;                  // its elements
  const int rows = span[3] + kh - ylo;         // source rows of the tile
  const T* img = x + n * fh * fw * C + (static_cast<int64_t>(y0) * fw +
                                        (fl ? x0 + src_w - xlo - xspan : x0 + xlo)) * C;
  float* oimg = out + n * dst_h * dst_w * C;

  // The plan holds every tile's spans (it is made from these starts):
  // spans past it mean a plan of other windows, and the launch stops.
  if (rows > rows_max || 15 + xcnt * static_cast<int>(sizeof(T)) > 16 * span_chunks) __trap();

  const int rb = span_chunks * 16;
  float* mid = sm;
  unsigned char* raw = reinterpret_cast<unsigned char*>(mid + static_cast<size_t>(rows_max) * txc);
  float* wxs = reinterpret_cast<float*>(raw + static_cast<size_t>(rows_max) * rb);
  float* wys = wxs + tx * kw;
  int* sxs = reinterpret_cast<int*>(wys + ty * kh);
  int* sys = sxs + tx;
  int* shs = sys + ty;

  // Every source row of the tile in flight at once, in two commit groups
  // of consecutive rows (warp w copies rows w, w + 8, ... of a group), so
  // the first group's width pass runs while the second lands.
  const int per = (rows + 1) / 2;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r1 = min(rows, (p + 1) * per);
    for (int r = p * per + warp; r < r1; r += kThreads / 32) {
      const int sft = stage_raw(img + static_cast<int64_t>(ylo + r) * fw * C, xcnt,
                                raw + static_cast<size_t>(r) * rb, lane, 32);
      if (lane == 0) shs[r] = sft;
    }
    cp_commit();
  }
  for (int i = tid; i < nx * kw; i += kThreads) wxs[i] = __ldg(tw + static_cast<int64_t>(ox0) * kw + i);
  for (int i = tid; i < ny * kh; i += kThreads) wys[i] = __ldg(th + static_cast<int64_t>(oy0) * kh + i);
  for (int i = tid; i < nx; i += kThreads) {
    const int rel = __ldg(sw + ox0 + i) - xlo;
    sxs[i] = (fl ? xspan - 1 - rel : rel) * C;   // a mirrored row: its tap 0, read backwards
  }
  for (int i = tid; i < ny; i += kThreads) sys[i] = __ldg(sh + oy0 + i) - ylo;

  // the width pass: thread t < nx * C computes column t of each row
  const int ox = tid / C, c = tid - (tid / C) * C;
  const int step = fl ? -C : C;
  float wr[KM > 0 ? KM : 1];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p == 0)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    if (tid < nxc) {
      if constexpr (KM > 0) {
        if (p == 0) {
#pragma unroll
          for (int j = 0; j < KM; ++j) wr[j] = j < kw ? wxs[ox * kw + j] : 0.0f;
        }
      }
      const int base = sxs[ox] + c;
      const int r1 = min(rows, (p + 1) * per);
#pragma unroll 2
      for (int r = p * per; r < r1; ++r) {
        const T* v = reinterpret_cast<const T*>(raw + static_cast<size_t>(r) * rb) + shs[r] + base;
        mid[static_cast<size_t>(r) * txc + tid] =
            KM > 0 ? tap_sum<KM>(wr, v, kw, step, in_scale)
                   : tap_sum<0>(wxs + ox * kw, v, kw, step, in_scale);
      }
    }
  }
  __syncthreads();

  // the height pass: thread (row group rg, quad q) takes the tile's
  // columns 4q .. 4q + 3 of output rows rg, rg + rgs, ...
  const int nq = txc / 4, rgs = kThreads / nq;
  const int q = tid % nq, rg = tid / nq;
  if (rg >= rgs) return;
  const bool vec = vec_out != 0;
  for (int oy = rg; oy < ny; oy += rgs) {
    const float* m = mid + static_cast<size_t>(sys[oy]) * txc + 4 * q;
    const float* w = wys + oy * kh;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    auto tap = [&](int j) {
      const float4 v = *reinterpret_cast<const float4*>(m + static_cast<size_t>(j) * txc);
      const float wj = w[j];
      acc[0] = __fadd_rn(acc[0], __fmul_rn(wj, v.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(wj, v.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(wj, v.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(wj, v.w));
    };
    if constexpr (KM > 0) {
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < kh) tap(j);
    } else {
#pragma unroll 4
      for (int j = 0; j < kh; ++j) tap(j);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fmul_rn(acc[i], out_scale);
    store4(oimg + (static_cast<int64_t>(oy0 + oy) * dst_w + ox0) * C + 4 * q, acc, nxc - 4 * q,
           vec);
  }
}

// ---- resize_rows ----------------------------------------------------------
// One axis with inner = C <= 4. grid: x = a run of kRows outer rows, y =
// a tile of `tile` outputs. Dynamic smem (span_chunks > 0): kRows staged
// spans (span_chunks 16-byte words of raw input each), then the tile's
// taps (tile x k) and relative starts (tile ints). The kRows spans are
// in flight at once; thread t then computes the tile's elements t, t +
// kThreads, ... of each row (neighbouring threads read neighbouring
// staged values: at most 2-way bank conflicts at a 2x downscale) and
// stores them 128 bytes a warp.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) resize_rows(
    const T* __restrict__ x, int64_t outer, int src, int dst, const int* __restrict__ starts,
    const float* __restrict__ taps, int k, float in_scale, float out_scale,
    float* __restrict__ out, int tile, int span_chunks) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int span[2];
  __shared__ int shs[kRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t a0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int nr = static_cast<int>(min(static_cast<int64_t>(kRows), outer - a0));
  const int o0 = blockIdx.y * tile;
  const int no = min(tile, dst - o0), ne = no * C;
  int xcnt = 0;
  if (span_chunks > 0) {
    if (tid < 32) {
      int lo, hi;
      warp_span(starts + o0, no, tid, lo, hi);
      if (tid == 0) {
        span[0] = lo;
        span[1] = hi;
      }
    }
    __syncthreads();
    xcnt = (span[1] + k - span[0]) * C;
  }
  // a span past the plan (made from these starts) means a plan of other
  // windows: the launch stops
  if (span_chunks > 0 && 15 + xcnt * static_cast<int>(sizeof(T)) > 16 * span_chunks) __trap();
  if (span_chunks == 0) {
    // unstaged (the plan's choice): source and taps from global memory
    for (int r = 0; r < nr; ++r) {
      const T* row = x + (a0 + r) * src * C;
      float* orow = out + ((a0 + r) * dst + o0) * C;
      for (int e = tid; e < ne; e += kThreads) {
        const int o = e / C, c = e - o * C;
        orow[e] = __fmul_rn(tap_sum_global(taps + static_cast<int64_t>(o0 + o) * k,
                                           row + __ldg(starts + o0 + o) * C + c, k, C, in_scale),
                            out_scale);
      }
    }
    return;
  }
  const int lo = span[0], rb = span_chunks * 16;
  unsigned char* raw = reinterpret_cast<unsigned char*>(sm);
  float* ws = reinterpret_cast<float*>(raw + static_cast<size_t>(kRows) * rb);
  int* ss = reinterpret_cast<int*>(ws + tile * k);
  // warps w and w + kRows copy row w of the run
  constexpr int kParts2 = kThreads / 32 / kRows;
  const int r = warp % kRows;
  if (r < nr) {
    const int sft = stage_raw(x + ((a0 + r) * src + lo) * C, xcnt, raw + static_cast<size_t>(r) * rb,
                              lane + 32 * (warp / kRows), 32 * kParts2);
    if (warp < kRows && lane == 0) shs[r] = sft;
  }
  cp_commit();
  for (int i = tid; i < no * k; i += kThreads) ws[i] = __ldg(taps + static_cast<int64_t>(o0) * k + i);
  for (int i = tid; i < no; i += kThreads) ss[i] = (__ldg(starts + o0 + i) - lo) * C;
  cp_wait<0>();
  __syncthreads();
  for (int q = 0; q < nr; ++q) {
    const T* v = reinterpret_cast<const T*>(raw + static_cast<size_t>(q) * rb) + shs[q];
    float* orow = out + ((a0 + q) * dst + o0) * C;
    for (int e = tid; e < ne; e += kThreads) {
      const int o = e / C, c = e - o * C;
      orow[e] = __fmul_rn(tap_sum<0>(ws + o * k, v + ss[o] + c, k, C, in_scale), out_scale);
    }
  }
}

// ---- resize_cols ----------------------------------------------------------
// One axis with the inner elements contiguous. grid: x = outer *
// chunks + chunk of blockDim * V inner elements, y = chunk of `to`
// outputs. Dynamic smem (stage): the chunk's taps (to x k), then its
// starts (to ints).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) resize_cols(
    const T* __restrict__ x, int src, int dst, int64_t inner, int chunks,
    const int* __restrict__ starts, const float* __restrict__ taps, int k, float in_scale,
    float out_scale, float* __restrict__ out, int to, int stage) {
  extern __shared__ __align__(16) float sm[];
  const int64_t a = blockIdx.x / chunks;
  const int chunk = blockIdx.x - static_cast<int>(a) * chunks;
  const int o0 = blockIdx.y * to;
  const int no = min(to, dst - o0);
  const float* w = taps + static_cast<int64_t>(o0) * k;
  const int* st = starts + o0;
  if (stage) {
    float* ws = sm;
    int* ss = reinterpret_cast<int*>(sm + to * k);
    for (int i = threadIdx.x; i < no * k; i += blockDim.x) ws[i] = __ldg(w + i);
    for (int i = threadIdx.x; i < no; i += blockDim.x) ss[i] = __ldg(st + i);
    __syncthreads();
    w = ws;
    st = ss;
  }
  const int64_t i0 = (static_cast<int64_t>(chunk) * blockDim.x + threadIdx.x) * V;
  if (i0 >= inner) return;
  const T* xb = x + a * src * inner + i0;
  float* ob = out + (a * dst + o0) * inner + i0;
  for (int o = 0; o < no; ++o) {
    const T* xr = xb + static_cast<int64_t>(st[o]) * inner;
    const float* wo = w + o * k;
    if constexpr (V == 4) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < k; ++j) {
        const float4 v = quad_f32(xr + static_cast<int64_t>(j) * inner, in_scale);
        const float wj = wo[j];
        acc[0] = __fadd_rn(acc[0], __fmul_rn(wj, v.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(wj, v.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(wj, v.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(wj, v.w));
      }
      *reinterpret_cast<float4*>(ob + static_cast<int64_t>(o) * inner) =
          make_float4(__fmul_rn(acc[0], out_scale), __fmul_rn(acc[1], out_scale),
                      __fmul_rn(acc[2], out_scale), __fmul_rn(acc[3], out_scale));
    } else {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(wo[j], unpack(xr[static_cast<int64_t>(j) * inner],
                                                     in_scale)));
      ob[static_cast<int64_t>(o) * inner] = __fmul_rn(acc, out_scale);
    }
  }
}

// Lets `fn` take up to the card's opt-in shared memory a block (less its
// static shared memory) as dynamic shared memory, once a device.
int allow_smem(const void* fn) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0, most = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, dev})) return 0;
  cudaFuncAttributes fa;
  rc = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&fa, fn);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              most - static_cast<int>(fa.sharedSizeBytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  done.insert({fn, dev});
  return 0;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// A call's arguments, for the launches below
struct Args2d {
  const void* x;
  int64_t n;
  int src_h, src_w, dst_h, dst_w;
  const int *sw, *sh;
  const float *tw, *th;
  int kw, kh;
  float in_scale, out_scale;
  float* out;
  int tx, ty, rows_max, span_chunks;
  size_t smem;
  Crop crop;   // kCrop builds only
};

struct ArgsAxis {
  const void* x;
  int64_t outer;
  int src, dst;
  int64_t inner;
  const int* starts;
  const float* taps;
  int k;
  float in_scale, out_scale;
  float* out;
  int tile, span_chunks;
};

// the unrolled tap loops' bound for windows of k taps (0: a loop unrolled
// by 4): 5, the defaults' 2x downscale (cubic at filterScale 0.7), exact
constexpr int km_of(int k) { return k == 5 ? 5 : 0; }

template <typename T, int C, int KM, bool kCrop>
int launch_2d(const Args2d& a, cudaStream_t st) {
  const int col_tiles = (a.dst_w + a.tx - 1) / a.tx;
  const int row_tiles = (a.dst_h + a.ty - 1) / a.ty;
  if (a.n * col_tiles > 0x7fffffffLL || row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem(reinterpret_cast<const void*>(resize_2d<T, C, KM, kCrop>));
  if (rc != 0) return rc;
  const int vec_out = reinterpret_cast<uintptr_t>(a.out) % 16 == 0 && (a.dst_w * C) % 4 == 0;
  resize_2d<T, C, KM, kCrop><<<dim3(static_cast<unsigned>(a.n * col_tiles), row_tiles), kThreads,
                               a.smem, st>>>(
      static_cast<const T*>(a.x), a.src_h, a.src_w, a.dst_h, a.dst_w, a.sw, a.tw, a.kw, a.sh, a.th,
      a.kh, a.in_scale, a.out_scale, a.out, a.tx, a.ty, col_tiles, a.rows_max, a.span_chunks,
      vec_out, a.crop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_rows(const ArgsAxis& a, cudaStream_t st) {
  const int tiles = (a.dst + a.tile - 1) / a.tile;
  const int64_t runs = (a.outer + kRows - 1) / kRows;
  if (runs > 0x7fffffffLL || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (a.span_chunks > 0) {
    smem = static_cast<size_t>(kRows) * a.span_chunks * 16 +
           static_cast<size_t>(a.tile) * (a.k + 1) * 4;
    const int rc = allow_smem(reinterpret_cast<const void*>(resize_rows<T, C>));
    if (rc != 0) return rc;
  }
  resize_rows<T, C><<<dim3(static_cast<unsigned>(runs), tiles), kThreads, smem, st>>>(
      static_cast<const T*>(a.x), a.outer, a.src, a.dst, a.starts, a.taps, a.k, a.in_scale,
      a.out_scale, a.out, a.tile, a.span_chunks);
  return static_cast<int>(cudaGetLastError());
}

// resize_cols's launch: V = 4 where inner % 4 == 0 and both bases are
// aligned to a word of 4 elements; blockDim the inner lanes rounded to
// a warp, at most kThreads; `to` outputs a block, halved down to 1 while
// the grid holds fewer than 8 blocks a multiprocessor.
template <typename T, int V>
int launch_cols(const ArgsAxis& a, cudaStream_t st) {
  const int64_t lanes = a.inner / V + (a.inner % V != 0);
  const int threads = static_cast<int>(lanes >= kThreads ? kThreads : (lanes + 31) / 32 * 32);
  const int chunks = static_cast<int>((lanes + threads - 1) / threads);
  int to = 8;
  const int64_t want = static_cast<int64_t>(sm_count()) * 8;
  while (to > 1 && a.outer * chunks * ((a.dst + to - 1) / to) < want) to /= 2;
  const size_t bytes = static_cast<size_t>(to) * (a.k + 1) * 4;
  const int stage = bytes <= static_cast<size_t>(kTapSmem);
  const int64_t gx = a.outer * chunks;
  const int gy = (a.dst + to - 1) / to;
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  resize_cols<T, V><<<dim3(static_cast<unsigned>(gx), gy), threads, stage ? bytes : 0, st>>>(
      static_cast<const T*>(a.x), a.src, a.dst, a.inner, chunks, a.starts, a.taps, a.k,
      a.in_scale, a.out_scale, a.out, to, stage);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int axis_typed(const ArgsAxis& a, cudaStream_t st) {
  switch (a.inner) {
    case 1: return launch_rows<T, 1>(a, st);
    case 2: return launch_rows<T, 2>(a, st);
    case 3: return launch_rows<T, 3>(a, st);
    case 4: return launch_rows<T, 4>(a, st);
    default: {
      const bool v4 = a.inner % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a.x) % (4 * sizeof(T)) == 0 &&
                      reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
      return v4 ? launch_cols<T, 4>(a, st) : launch_cols<T, 1>(a, st);
    }
  }
}

template <typename T, int C, bool kCrop>
int two_d_k(const Args2d& a, cudaStream_t st) {
  return km_of(a.kw > a.kh ? a.kw : a.kh) == 5 ? launch_2d<T, C, 5, kCrop>(a, st)
                                               : launch_2d<T, C, 0, kCrop>(a, st);
}

template <typename T, bool kCrop = false>
int two_d_typed(int c, const Args2d& a, cudaStream_t st) {
  switch (c) {
    case 1: return two_d_k<T, 1, kCrop>(a, st);
    case 2: return two_d_k<T, 2, kCrop>(a, st);
    case 3: return two_d_k<T, 3, kCrop>(a, st);
    case 4: return two_d_k<T, 4, kCrop>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int C, bool kCrop>
const void* two_d_fn(int k) {
  return km_of(k) == 5 ? reinterpret_cast<const void*>(resize_2d<T, C, 5, kCrop>)
                       : reinterpret_cast<const void*>(resize_2d<T, C, 0, kCrop>);
}

// the build that serves kernel `which` (0 resize_2d, 1 resize_rows, 2
// resize_cols at V = 4, 3 resize_2d's crop mode, uint8 only) for element
// type T, channels C and k taps
template <typename T, int C>
const void* kernel_c(int which, int k) {
  if (which == 1) return reinterpret_cast<const void*>(resize_rows<T, C>);
  if (which == 2) return reinterpret_cast<const void*>(resize_cols<T, 4>);
  if constexpr (sizeof(T) == 1)
    if (which == 3) return two_d_fn<T, C, true>(k);
  return two_d_fn<T, C, false>(k);
}

template <typename T>
const void* kernel_t(int which, int c, int k) {
  switch (c) {
    case 1: return kernel_c<T, 1>(which, k);
    case 2: return kernel_c<T, 2>(which, k);
    case 4: return kernel_c<T, 4>(which, k);
    default: return kernel_c<T, 3>(which, k);
  }
}

}  // namespace

// The card's part of the plans and a build: out[0..6] = registers, local
// bytes, blocks a multiprocessor at kThreads threads and `smem` dynamic
// shared bytes (0 if it does not fit), multiprocessors, the opt-in shared
// bytes a block, shared bytes a multiprocessor, shared bytes the runtime
// reserves a block; of the build of kernel `which` (0 resize_2d, 1
// resize_rows, 2 resize_cols at V = 4, 3 resize_2d's crop mode at eb 1)
// for element bytes eb, c channels
// and windows of k taps. Returns a CUDA error code.
extern "C" int picha_resize_info(int which, int eb, int c, int k, int smem, int* out) {
  if (which < 0 || which > 3 || (eb != 1 && eb != 4) || (which == 3 && eb != 1) || smem < 0 ||
      k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = eb == 1 ? kernel_t<uint8_t>(which, c, k) : kernel_t<float>(which, c, k);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int r = allow_smem(fn);
  if (r != 0) return r;
  cudaFuncAttributes fa;
  int occ = 0, sms = 0, optin = 0, per_sm = 0, reserved = 0;
  rc = cudaFuncGetAttributes(&fa, fn);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (smem + static_cast<int>(fa.sharedSizeBytes) <= optin) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = occ;
  out[3] = sms;
  out[4] = optin;
  out[5] = per_sm;
  out[6] = reserved;
  return 0;
}

// One axis. x: (outer, src, inner) uint8 (elem_bytes 1) or float32
// (elem_bytes 4); starts: (dst,) int32 with 0 <= starts[o] <= src - k;
// taps: (dst, k) float32; out: (outer, dst, inner) float32,
// out = out_scale * sum_j taps[o, j] * (x[starts[o] + j] * in_scale).
// inner <= 4 takes resize_rows, with `tile` outputs a block (a multiple
// of 4) and span_chunks 16-byte words of staged span a row (0:
// unstaged); a larger inner takes resize_cols (tile and span_chunks
// unused). Returns cudaGetLastError().
extern "C" int picha_resize_axis(const void* x, int elem_bytes, int64_t outer, int src, int dst,
                                 int64_t inner, const void* starts, const void* taps, int k,
                                 float in_scale, float out_scale, void* out, int tile,
                                 int span_chunks, void* stream) {
  if ((elem_bytes != 1 && elem_bytes != 4) || k < 1 || k > src || outer < 0 || dst < 0 ||
      inner < 1 || (inner <= 4 && (tile < 4 || tile % 4 != 0 || span_chunks < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (outer == 0 || dst == 0) return static_cast<int>(cudaGetLastError());
  const ArgsAxis a{x, outer, src, dst, inner, static_cast<const int*>(starts),
                   static_cast<const float*>(taps), k, in_scale, out_scale,
                   static_cast<float*>(out), tile, span_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 1 ? axis_typed<uint8_t>(a, s) : axis_typed<float>(a, s);
}

namespace {

// resize_2d's arguments, checked: the tile's shared memory against `smem`
int check_2d(int c, int src_h, int src_w, int dst_h, int dst_w, int kw, int kh, int tx, int ty,
             int rows_max, int span_chunks, int smem) {
  if (c < 1 || c > 4 || kw < 1 || kw > src_w || kh < 1 || kh > src_h || dst_h < 0 || dst_w < 0 ||
      tx < 1 || ty < 1 || (tx * c) % 4 != 0 || tx * c > kThreads || rows_max < kh ||
      span_chunks < 1 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = static_cast<size_t>(rows_max) * span_chunks * 16 +
                      (static_cast<size_t>(rows_max) * tx * c + static_cast<size_t>(tx) * kw +
                       static_cast<size_t>(ty) * kh + tx + ty + rows_max) *
                          4;
  return static_cast<size_t>(smem) < need ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// Both axes in one launch. x: (n, src_h, src_w, c) uint8 or float32, c
// 1-4; (sw, tw, kw) the width windows, (sh, th, kh) the height windows
// (as picha_resize_axis takes them); out: (n, dst_h, dst_w, c) float32 =
// the height pass (in_scale 1, out_scale) of the width pass (in_scale,
// out_scale 1). The tile: tx output columns (tx * c a multiple of 4, at
// most kThreads), ty output rows; rows_max source rows of span_chunks
// 16-byte words each staged, `smem` dynamic shared bytes in all (the
// plan's, ops/resize.py::resize_plan). Returns cudaGetLastError().
extern "C" int picha_resize_2d(const void* x, int elem_bytes, int64_t n, int src_h, int src_w,
                               int c, int dst_h, int dst_w, const void* sw, const void* tw, int kw,
                               const void* sh, const void* th, int kh, float in_scale,
                               float out_scale, void* out, int tx, int ty, int rows_max,
                               int span_chunks, int smem, void* stream) {
  if ((elem_bytes != 1 && elem_bytes != 4) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc =
      check_2d(c, src_h, src_w, dst_h, dst_w, kw, kh, tx, ty, rows_max, span_chunks, smem);
  if (rc != 0) return rc;
  if (n == 0 || dst_h == 0 || dst_w == 0) return static_cast<int>(cudaGetLastError());
  const Args2d a{x, n, src_h, src_w, dst_h, dst_w, static_cast<const int*>(sw),
                 static_cast<const int*>(sh), static_cast<const float*>(tw),
                 static_cast<const float*>(th), kw, kh, in_scale, out_scale,
                 static_cast<float*>(out), tx, ty, rows_max, span_chunks,
                 static_cast<size_t>(smem), Crop{}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 1 ? two_d_typed<uint8_t>(c, a, s) : two_d_typed<float>(c, a, s);
}

// K9: the training ingest's crop, flip and both resize passes in one
// launch (resize_2d's crop mode). rgb: (n, h, w, c) uint8 frames, c 1-4;
// xs, ys: (n,) int32 crop corners (clamped to [0, w - crop] and [0, h -
// crop]); flip: (n,) uint8 (0 or 1); the windows resize a crop x crop
// source as picha_resize_2d's do; out: (n, dst_h, dst_w, c) float32 =
// the height pass (in_scale 1, out_scale 1) of the width pass (in_scale)
// of the flipped crop, bit for bit the per-axis route (K9's width pass,
// then resize_cols). The tile as picha_resize_2d's, planned for the
// crop's windows. Returns cudaGetLastError().
extern "C" int picha_crop_flip_resize(const void* rgb, int n, int h, int w, int c, const void* xs,
                                      const void* ys, const void* flip, int crop, int dst_h,
                                      int dst_w, const void* sw, const void* tw, int kw,
                                      const void* sh, const void* th, int kh, float in_scale,
                                      void* out, int tx, int ty, int rows_max, int span_chunks,
                                      int smem, void* stream) {
  if (n < 0 || crop < 1 || crop > h || crop > w) return static_cast<int>(cudaErrorInvalidValue);
  const int rc =
      check_2d(c, crop, crop, dst_h, dst_w, kw, kh, tx, ty, rows_max, span_chunks, smem);
  if (rc != 0) return rc;
  if (n == 0 || dst_h == 0 || dst_w == 0) return static_cast<int>(cudaGetLastError());
  const Args2d a{rgb, n, crop, crop, dst_h, dst_w, static_cast<const int*>(sw),
                 static_cast<const int*>(sh), static_cast<const float*>(tw),
                 static_cast<const float*>(th), kw, kh, in_scale, 1.0f,
                 static_cast<float*>(out), tx, ty, rows_max, span_chunks,
                 static_cast<size_t>(smem),
                 Crop{static_cast<const int*>(xs), static_cast<const int*>(ys),
                      static_cast<const uint8_t*>(flip), h, w}};
  return two_d_typed<uint8_t, true>(c, a, static_cast<cudaStream_t>(stream));
}
