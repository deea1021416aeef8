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
// What bounds it on an H100: memory traffic, 4.5 B a pixel at 4:2:0
// (1 B of luma, 0.5 B of chroma in, 3 B out), if the integer work a
// pixel stays near the 40 instructions that rate leaves. A thread a
// pixel with an index division, per-pixel clamps and byte stores took
// ~300 (7.8x the bound at 256 x 1080p).
//
// The design: the common signatures are compiled in (`tiled_kernel`,
// a template on the chroma ratio and the mode): YCbCr h2v2 (4:2:0),
// h2v1 (4:2:2), h1v1 (4:4:4), and grey to 1 or 3 channels. A warp
// owns a 512-pixel segment of a band of rows, a thread 16 pixels of
// it: no division, the grid is (segment, band of rows, image). The
// thread loads its 16 luma bytes and 8 (h2) or 16 (h1) bytes of each
// chroma row as aligned 16-byte words (byte_stream.cuh), takes the
// neighbour columns from the lanes beside it by shuffle, and at h2v2
// keeps the three chroma rows of the triangle filter in registers as it
// walks down its band, so each chroma row is loaded once. The column
// sums 3 * c0 + c_neighbour serve both output columns of a chroma
// column, as libjpeg's h2v2 does. The interleaved output goes through
// a shared-memory row and is stored by the whole warp in 16-byte
// words at any alignment of the output row. Every other signature
// (h1v2, other integer ratios, RGB, CMYK, YCCK) takes `generic_kernel`,
// a thread a pixel on a 2-D grid.
//
// Integer semantics are the reference's exactly: libjpeg's fancy
// biases (h2v2: +8/+7 then >>4; h2v1 and turbo's h1v2: +1/+2 then
// >>2), edge replication at the cropped plane's edge, int_upsample
// replication for other integer ratios, jdcolor.c's 16-bit fixed point
// with arithmetic right shifts (a floor for negative sums, as >> on
// signed int is in CUDA), and the CMYK fold's floor division of
// non-negative products.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "byte_stream.cuh"

namespace {

// colour modes (picha_tpu_torch/ops/jpeg.py GREY..CMYK)
constexpr int kGrey = 0, kYcbcr = 1, kRgb = 2, kYcck = 3, kCmyk = 4;

// jdcolor.c fixed point: FIX(x) = int(x * 65536 + 0.5)
constexpr int kFix1402 = 91881, kFix1772 = 116130;
constexpr int kFix034414 = 22554, kFix071414 = 46802;
constexpr int kOneHalf = 32768;

// the builds (ops/jpeg.py K7_BUILDS)
enum Build { kH2v2 = 0, kH2v1, kH1v1, kGreyBuild, kGreyRgb, kGeneric, kBuilds };

constexpr int kWarps = 4;            // warps a block of the tiled builds
constexpr int kPix = 16;             // output pixels a thread, along a row
constexpr int kSpan = 32 * kPix;     // a warp's row segment, in pixels

struct Plane {
  const uint8_t* p;
  int h, w, fx, fy;  // cropped plane size; upsampling ratio to the luma grid
};

struct Planes {
  Plane c[4];
};

// max(min(v, 255), 0): one DPX instruction on sm_90
__device__ __forceinline__ int clip255(int v) { return __vimin_s32_relu(v, 255); }

__device__ __forceinline__ void ycc_to_rgb(int y, int cb, int cr, int* rgb) {
  const int cbs = cb - 128, crs = cr - 128;
  rgb[0] = clip255(y + ((kFix1402 * crs + kOneHalf) >> 16));
  rgb[1] = clip255(y + ((-kFix034414 * cbs - kFix071414 * crs + kOneHalf) >> 16));
  rgb[2] = clip255(y + ((kFix1772 * cbs + kOneHalf) >> 16));
}

// -- the generic build: a thread a pixel --------------------------------------

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

// block (32, 8), grid (ceil(w / 32), ceil(h / 8), images)
__global__ void __launch_bounds__(256) generic_kernel(
    Planes pl, int n_img, int h, int w, int mode, int c, uint8_t* __restrict__ out) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * 8 + threadIdx.y;
  if (x >= w || y >= h) return;
  for (int img = blockIdx.z; img < n_img; img += gridDim.z) {
    uint8_t* o = out + ((static_cast<int64_t>(img) * h + y) * w + x) * c;
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

// -- the tiled builds ------------------------------------------------------------

// Chroma columns j0 - 1 .. j0 + 8 of one row of a plane wc wide, the
// plane's edge column replicated past it: lo / hi hold j0 .. j0 + 7, ln
// and rn the neighbours (from the lanes beside, or loaded at the warp's
// two ends). Every lane of the warp calls it.
struct Strip {
  uint32_t lo, hi;
  int ln, rn;
};

__device__ __forceinline__ Strip load_strip(const uint8_t* row, int wc, int j0, int lane) {
  const int valid = wc - j0;
  uint32_t c[3];
  load_bytes<8>(row + j0, min(valid, 8), c);
  uint64_t v = c[0] | (static_cast<uint64_t>(c[1]) << 32);
  if (valid > 0 && valid < 8) {  // the plane's last column, replicated
    const uint64_t last = (v >> (8 * (valid - 1))) & 0xff;
    const uint64_t keep = (1ull << (8 * valid)) - 1;
    v = (v & keep) | (last * 0x0101010101010101ull & ~keep);
  }
  Strip s;
  s.lo = static_cast<uint32_t>(v);
  s.hi = static_cast<uint32_t>(v >> 32);
  const int own0 = s.lo & 0xff, own7 = s.hi >> 24;
  int prev7 = __shfl_up_sync(0xffffffffu, own7, 1);
  int next0 = __shfl_down_sync(0xffffffffu, own0, 1);
  if (lane == 0 && j0 > 0 && j0 <= wc) prev7 = row[j0 - 1];
  if (lane == 31 && j0 + 8 < wc) next0 = row[j0 + 8];
  s.ln = j0 == 0 ? own0 : prev7;
  s.rn = j0 + 8 < wc ? next0 : own7;
  return s;
}

// window byte t of a strip: 0 is column j0 - 1, 1..8 are j0..j0+7, 9 is
// j0 + 8 (t is a constant once the loops are unrolled)
__device__ __forceinline__ int strip_at(const Strip& s, int t) {
  if (t == 0) return s.ln;
  if (t == 9) return s.rn;
  return t <= 4 ? (s.lo >> (8 * (t - 1))) & 0xff : (s.hi >> (8 * (t - 5))) & 0xff;
}

// n bytes from shared s (16-aligned, readable 32 bytes past n) to
// global g at any alignment, by the whole warp: the aligned 16-byte
// words of g are assembled from the two shared words that hold them.
__device__ __forceinline__ void store_row(const uint8_t* s, uint8_t* g, int n, int lane) {
  const int d = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  uint8_t* g0 = g - d;
  const int words = (d + n + 15) >> 4;
  const int e = 16 - d;  // the word's first byte in the pair (A, B) of shared words
  for (int k = lane; k < words; k += 32) {
    const uint4 b = *reinterpret_cast<const uint4*>(s + 16 * k);
    uint32_t v[4] = {b.x, b.y, b.z, b.w};
    if (d != 0) {
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (k > 0) a = *reinterpret_cast<const uint4*>(s + 16 * (k - 1));
      uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const bool two = e & 8, one = e & 4;
#pragma unroll
      for (int i = 0; i + 2 < 8; ++i) u[i] = two ? u[i + 2] : u[i];
#pragma unroll
      for (int i = 0; i + 1 < 8; ++i) u[i] = one ? u[i + 1] : u[i];
      const unsigned sh = (e & 3) * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(u[i], u[i + 1], sh);
    }
    const int o = 16 * k - d;  // the word's first byte in the row
    if (o >= 0 && o + 16 <= n) {
      *reinterpret_cast<uint4*>(g0 + 16 * k) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (o + i >= 0 && o + i < n) g0[16 * k + i] = static_cast<uint8_t>(v[i >> 2] >> (8 * (i & 3)));
    }
  }
}

// four byte values (each < 256) -> one little-endian word, three PRMTs
__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  const uint32_t lo = __byte_perm(b0, b1, 0x5140), hi = __byte_perm(b2, b3, 0x5140);
  return __byte_perm(lo, hi, 0x5410);
}

// One output row segment of this thread: luma yc (16 bytes), chroma
// samples cb / cr of its 16 pixels already upsampled -> the thread's
// bytes of the shared row.
template <bool GREY, int C>
__device__ __forceinline__ void emit(const uint32_t (&yc)[5], const int (&cb)[kPix],
                                     const int (&cr)[kPix], uint8_t* stage, int lane) {
  int v[kPix * C];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int y = (yc[p >> 2] >> (8 * (p & 3))) & 0xff;
    if (GREY) {
#pragma unroll
      for (int k = 0; k < C; ++k) v[p * C + k] = y;
    } else {
      ycc_to_rgb(y, cb[p], cr[p], v + p * C);
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(stage + lane * kPix * C);
#pragma unroll
  for (int k = 0; k < kPix * C / 16; ++k) {
    const int* q = v + 16 * k;
    dst[k] = make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                        pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
  }
}

// h2 horizontal triangle from column sums (or samples at v1) cs[0..9]
// of the strip window: output pixel p of the thread's 16
template <int FY>
__device__ __forceinline__ int h2(const int (&cs)[10], int p) {
  const int t = 1 + (p >> 1);
  if (FY == 2)
    return (p & 1) ? (3 * cs[t] + cs[t + 1] + 7) >> 4 : (3 * cs[t] + cs[t - 1] + 8) >> 4;
  return (p & 1) ? (3 * cs[t] + cs[t + 1] + 2) >> 2 : (3 * cs[t] + cs[t - 1] + 1) >> 2;
}

// block kWarps warps, grid (ceil(w / kSpan), ceil(units / (kWarps * band)),
// images). A unit is a chroma row (2 output rows) at FY 2, an output row
// otherwise; warp w of block (bx, by) takes units [u0, u0 + band) of the
// segment bx: u0 = (by * kWarps + w) * band.
template <int FX, int FY, bool GREY, int C>
__global__ void __launch_bounds__(kWarps * 32) tiled_kernel(
    Planes pl, int n_img, int h, int w, int band, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t stage_all[kWarps][kSpan * C + 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* stage = stage_all[warp];
  const int seg_x = blockIdx.x * kSpan;
  const int seg_n = min(kSpan, w - seg_x) * C;  // bytes of the row segment
  const int x0 = seg_x + lane * kPix;            // this thread's first pixel
  const int y_valid = min(w - x0, kPix);
  const int j0 = x0 / FX;                        // its first chroma column
  const int units = FY == 2 ? (h + 1) >> 1 : h;
  const int u0 = (blockIdx.y * kWarps + warp) * band;
  const int u1 = min(u0 + band, units);
  if (u0 >= units) return;  // warp-uniform; no block barrier below
  const Plane& Y = pl.c[0];
  const Plane& B = pl.c[1];
  const Plane& R = pl.c[2];

  for (int img = blockIdx.z; img < n_img; img += gridDim.z) {
    const uint8_t* yp = Y.p + static_cast<int64_t>(img) * Y.h * Y.w;
    const uint8_t* bp = GREY ? nullptr : B.p + static_cast<int64_t>(img) * B.h * B.w;
    const uint8_t* rp = GREY ? nullptr : R.p + static_cast<int64_t>(img) * R.h * R.w;
    uint8_t* op = out + static_cast<int64_t>(img) * h * w * C;
    int cb[kPix], cr[kPix];

    auto row_out = [&](int y, const uint32_t (&yc)[5]) {
      emit<GREY, C>(yc, cb, cr, stage, lane);
      __syncwarp();
      store_row(stage, op + (static_cast<int64_t>(y) * w + seg_x) * C, seg_n, lane);
      __syncwarp();
    };
    auto luma = [&](int y, uint32_t (&yc)[5]) {
      load_bytes<16>(yp + static_cast<int64_t>(y) * Y.w + x0, y_valid, yc);
    };

    if (GREY || FX == 1) {
      // grey, or h1v1: every sample at its own position
      for (int u = u0; u < u1; ++u) {
        uint32_t yc[5];
        luma(u, yc);
        if (!GREY) {
          uint32_t bc[5], rc[5];
          load_bytes<16>(bp + static_cast<int64_t>(u) * B.w + x0, y_valid, bc);
          load_bytes<16>(rp + static_cast<int64_t>(u) * R.w + x0, y_valid, rc);
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            cb[p] = (bc[p >> 2] >> (8 * (p & 3))) & 0xff;
            cr[p] = (rc[p >> 2] >> (8 * (p & 3))) & 0xff;
          }
        }
        row_out(u, yc);
      }
    } else if (FY == 1) {
      // h2v1: each output row from its own chroma row
      for (int u = u0; u < u1; ++u) {
        const Strip sb = load_strip(bp + static_cast<int64_t>(u) * B.w, B.w, j0, lane);
        const Strip sr = load_strip(rp + static_cast<int64_t>(u) * R.w, R.w, j0, lane);
        int wb[10], wr[10];
#pragma unroll
        for (int t = 0; t < 10; ++t) {
          wb[t] = strip_at(sb, t);
          wr[t] = strip_at(sr, t);
        }
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          cb[p] = h2<1>(wb, p);
          cr[p] = h2<1>(wr, p);
        }
        uint32_t yc[5];
        luma(u, yc);
        row_out(u, yc);
      }
    } else {
      // h2v2: chroma rows u - 1, u, u + 1 (clamped) in registers, down
      // the band; output rows 2u (with row u - 1) and 2u + 1 (with u + 1)
      auto strips = [&](int i, Strip& sb, Strip& sr) {
        sb = load_strip(bp + static_cast<int64_t>(i) * B.w, B.w, j0, lane);
        sr = load_strip(rp + static_cast<int64_t>(i) * R.w, R.w, j0, lane);
      };
      Strip pb, pr, cbs, crs;
      strips(max(u0 - 1, 0), pb, pr);
      strips(min(u0, B.h - 1), cbs, crs);
      for (int u = u0; u < u1; ++u) {
        Strip nb, nr;
        strips(min(u + 1, B.h - 1), nb, nr);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int y = 2 * u + half;
          if (y >= h) break;
          const Strip& ob = half ? nb : pb;
          const Strip& orr = half ? nr : pr;
          int sb[10], sr[10];
#pragma unroll
          for (int t = 0; t < 10; ++t) {
            sb[t] = 3 * strip_at(cbs, t) + strip_at(ob, t);
            sr[t] = 3 * strip_at(crs, t) + strip_at(orr, t);
          }
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            cb[p] = h2<2>(sb, p);
            cr[p] = h2<2>(sr, p);
          }
          uint32_t yc[5];
          luma(y, yc);
          row_out(y, yc);
        }
        pb = cbs;
        pr = crs;
        cbs = nb;
        crs = nr;
      }
    }
  }
}

// the build a call launches
int pick_build(const int (&f)[4][2], int mode, int c) {
  const bool y11 = f[0][0] == 1 && f[0][1] == 1;
  if (mode == kYcbcr && c == 3 && y11 && f[1][0] == f[2][0] && f[1][1] == f[2][1]) {
    if (f[1][0] == 2 && f[1][1] == 2) return kH2v2;
    if (f[1][0] == 2 && f[1][1] == 1) return kH2v1;
    if (f[1][0] == 1 && f[1][1] == 1) return kH1v1;
  }
  if (mode == kGrey && y11) return c == 1 ? kGreyBuild : kGreyRgb;
  return kGeneric;
}

const void* build_fn(int build) {
  switch (build) {
    case kH2v2: return reinterpret_cast<const void*>(tiled_kernel<2, 2, false, 3>);
    case kH2v1: return reinterpret_cast<const void*>(tiled_kernel<2, 1, false, 3>);
    case kH1v1: return reinterpret_cast<const void*>(tiled_kernel<1, 1, false, 3>);
    case kGreyBuild: return reinterpret_cast<const void*>(tiled_kernel<1, 1, true, 1>);
    case kGreyRgb: return reinterpret_cast<const void*>(tiled_kernel<1, 1, true, 3>);
    default: return reinterpret_cast<const void*>(generic_kernel);
  }
}

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// p0..p3: per-component uint8 planes (N, h_i, w_i), each cropped as
// dequant_idct_plane writes it (any byte alignment), with (fx_i, fy_i)
// its integer upsampling ratio to the luma grid; components the mode
// does not use repeat a used one. out: (N, h, w, c) uint8, c = 3, or 1
// for grey. Returns cudaGetLastError().
extern "C" int picha_upsample_color(
    const void* p0, const void* p1, const void* p2, const void* p3, int h0, int w0,
    int fx0, int fy0, int h1, int w1, int fx1, int fy1, int h2, int w2, int fx2,
    int fy2, int h3, int w3, int fx3, int fy3, int n_img, int h, int w, int mode,
    int c, void* out, void* stream) {
  Planes pl;
  const void* ps[4] = {p0, p1, p2, p3};
  const int dims[4][4] = {{h0, w0, fx0, fy0}, {h1, w1, fx1, fy1},
                          {h2, w2, fx2, fy2}, {h3, w3, fx3, fy3}};
  int f[4][2];
  for (int k = 0; k < 4; ++k) {
    pl.c[k] = {static_cast<const uint8_t*>(ps[k]), dims[k][0], dims[k][1],
               dims[k][2], dims[k][3]};
    f[k][0] = dims[k][2];
    f[k][1] = dims[k][3];
    if (dims[k][0] < 1 || dims[k][1] < 1 || dims[k][2] < 1 || dims[k][3] < 1 ||
        static_cast<int64_t>(dims[k][0]) * dims[k][3] < h ||
        static_cast<int64_t>(dims[k][1]) * dims[k][2] < w)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode < kGrey || mode > kCmyk || (c != 1 && c != 3) || (mode != kGrey && c != 3) ||
      h > 65535 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_img <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  const unsigned nz = static_cast<unsigned>(std::min(n_img, 65535));
  const int build = pick_build(f, mode, c);
  if (build == kGeneric) {
    generic_kernel<<<dim3((w + 31) / 32, (h + 7) / 8, nz), dim3(32, 8), 0, st>>>(
        pl, n_img, h, w, mode, c, o);
    return static_cast<int>(cudaGetLastError());
  }
  // bands of 8 units a warp, halved while the grid is under 16 blocks an SM
  const int units = build == kH2v2 ? (h + 1) / 2 : h;
  const int gx = (w + kSpan - 1) / kSpan;
  int band = 8;
  auto gy = [&](int b) { return (units + kWarps * b - 1) / (kWarps * b); };
  while (band > 1 && static_cast<int64_t>(gx) * gy(band) * nz < 16LL * sm_count()) band /= 2;
  const dim3 grid(gx, gy(band), nz);
  switch (build) {
    case kH2v2: tiled_kernel<2, 2, false, 3><<<grid, kWarps * 32, 0, st>>>(pl, n_img, h, w, band, o); break;
    case kH2v1: tiled_kernel<2, 1, false, 3><<<grid, kWarps * 32, 0, st>>>(pl, n_img, h, w, band, o); break;
    case kH1v1: tiled_kernel<1, 1, false, 3><<<grid, kWarps * 32, 0, st>>>(pl, n_img, h, w, band, o); break;
    case kGreyBuild: tiled_kernel<1, 1, true, 1><<<grid, kWarps * 32, 0, st>>>(pl, n_img, h, w, band, o); break;
    default: tiled_kernel<1, 1, true, 3><<<grid, kWarps * 32, 0, st>>>(pl, n_img, h, w, band, o); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The build picha_upsample_color launches for these ratios, mode and
// channel count (ops/jpeg.py K7_BUILDS indexes it).
extern "C" int picha_upsample_color_build(int fx0, int fy0, int fx1, int fy1, int fx2,
                                          int fy2, int fx3, int fy3, int mode, int c) {
  const int f[4][2] = {{fx0, fy0}, {fx1, fy1}, {fx2, fy2}, {fx3, fy3}};
  return pick_build(f, mode, c);
}

// A build as the card reports it: out[0..4] = registers, local bytes a
// thread, static shared bytes a block, resident blocks an SM, threads
// a block.
extern "C" int picha_upsample_color_info(int build, int* out) {
  if (build < 0 || build >= kBuilds) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = build_fn(build);
  const int threads = build == kGeneric ? 256 : kWarps * 32;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = per_sm;
  out[4] = threads;
  return static_cast<int>(cudaGetLastError());
}
