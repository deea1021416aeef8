// K16: the TIFF sample transforms, from decompressed strip rows to
// top-left oriented rgba, over a batch of images of one signature
// (width, height, spp, bits, photometric, predictor, orientation,
// endian, has_extras).
//
// Replaces: picha_tpu/pipeline/tiff_batch.py::_jit_transform (:139-238),
// row 11c (TIFF half). Per pixel, as that graph computes it:
//   samples: 16-bit with the file's byte order folded, 8-bit, or 1/2/4-bit
//     unpacked MSB-first (sample i of a row at bit i * bits);
//   predictor 2: the running sum of each sample along the row, mod 2^bits
//     (8 and 16 bits only; the wrapper refuses sub-byte);
//   to 8 bits: >> 8 at 16 bits, (x * 255) / maxv below 8;
//   photometric 0/1 grey (0 inverted), replicated to rgb, alpha from the
//     second sample when the file has extra samples; 2 rgb, alpha from
//     the fourth sample; 3 the colormap (already >> 8) at the raw index;
//     5 CMYK, (255 - c)(255 - k) / 255 per channel, alpha from the fifth;
//     6 YCbCr in 16.16 fixed point on the raw samples, in int32 with
//     wrap-around as the reference's int32 graph has it, an arithmetic
//     >> 16, clipped to 0-255;
//   alpha 255 when there is none;
//   orientation 1-8 to top-left, 5-8 transposed (out is (n, w, h, 4)).
//
// What bounds it on an H100: memory traffic, a row's bytes read once and
// four bytes written per pixel (config 4's rgba buckets: 100.7 MB in and
// out, 0.060 ms at 3.35 TB/s); the arithmetic is a few integer operations
// a pixel. A thread per row walking x (the first design) read addresses a
// row apart in neighbouring threads, so no access coalesced. The design:
//   - a warp per source row, 128 pixels a pass, four a lane: each lane
//     loads its pixels' bytes as aligned 16-byte words and shifts them
//     into place with funnel shifts, so a row may start at any byte (the
//     pipeline hands K16 views of its upload buffer at any offset);
//   - predictor 2 as a warp scan: the samples a pixel uses sit packed in
//     a word (four 8-bit or two 16-bit lanes), a lane sums its four
//     pixels with __vadd4 / __vadd2 (sums mod 2^bits are per lane of the
//     word), the lanes combine by __shfl_up_sync, and the row's total
//     carries to the next pass;
//   - orientations 1-4 store straight, 16 bytes a lane where the output
//     row is aligned; 5-8 stage a block's 32 rows x 128 pixels in shared
//     memory (one uint32 a pixel, 16-byte chunks XOR-swizzled by row so
//     that both the row-wise writes and the column-wise reads are free of
//     bank conflicts) and write 128-byte runs of output rows;
//   - the signature is compile-time (bytes a sample, samples a pixel,
//     predictor, transposed or not) for 8- and 16-bit grey, grey + alpha,
//     rgb and rgba; one generic kernel, a thread a row as before, keeps
//     the rare signatures (sub-byte, palette, CMYK, YCbCr, unused extra
//     samples).
#include <cuda_runtime.h>
#include <stdint.h>

#include "byte_stream.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;       // 8 warps
constexpr int kPass = 128;          // pixels a warp pass: 4 a lane
constexpr int kTileRows = 32;       // source rows a transposing block
constexpr int kGenericThreads = 128;

struct Args {
  const uint8_t* rows;
  int n, h, w;
  int64_t rb;
  int spp, bits, photometric, predictor, orientation, big_endian, has_extras;
  const uint8_t* cmap;  // (n, 1 << bits, 3) or null
  uint32_t* out;        // (n, h', w') rgba as one uint32 per pixel
};

// ---------------------------------------------------------------------------
// the fast kernels: 8/16-bit grey, grey + alpha, rgb, rgba

// One pixel's used samples, packed: at 8 bits one word of SPP bytes; at 16
// bits two words of two 16-bit samples each (lo: s0, s1; hi: s2, s3).
struct Px {
  uint32_t lo, hi;
};

template <int BPS, int SPP, int J, int N>
__device__ __forceinline__ Px sample(const uint32_t (&c)[N], bool big) {
  Px p;
  if constexpr (BPS == 1) {
    const uint32_t v = bytes_at<J * SPP>(c);
    p.lo = SPP == 4 ? v : v & ((1u << (8 * SPP)) - 1u);
    p.hi = 0u;
  } else {
    uint32_t lo = bytes_at<J * 2 * SPP>(c), hi = 0u;
    if constexpr (SPP > 2) hi = bytes_at<J * 2 * SPP + 4>(c);
    if (big) {
      lo = __byte_perm(lo, 0u, 0x2301);
      hi = __byte_perm(hi, 0u, 0x2301);
    }
    p.lo = SPP == 1 ? lo & 0xFFFFu : lo;
    p.hi = SPP == 3 ? hi & 0xFFFFu : hi;
  }
  return p;
}

template <int BPS>
__device__ __forceinline__ Px vadd(Px a, Px b) {
  if (BPS == 1) return {__vadd4(a.lo, b.lo), 0u};
  return {__vadd2(a.lo, b.lo), __vadd2(a.hi, b.hi)};
}

template <int BPS>
__device__ __forceinline__ Px vsub(Px a, Px b) {
  if (BPS == 1) return {__vsub4(a.lo, b.lo), 0u};
  return {__vsub2(a.lo, b.lo), __vsub2(a.hi, b.hi)};
}

template <int BPS>
__device__ __forceinline__ Px shfl_up(Px a, int o) {
  Px r;
  r.lo = __shfl_up_sync(kFull, a.lo, o);
  r.hi = BPS == 2 ? __shfl_up_sync(kFull, a.hi, o) : 0u;
  return r;
}

template <int BPS>
__device__ __forceinline__ Px shfl_last(Px a) {
  Px r;
  r.lo = __shfl_sync(kFull, a.lo, 31);
  r.hi = BPS == 2 ? __shfl_sync(kFull, a.hi, 31) : 0u;
  return r;
}

// packed samples -> rgba (r in the low byte)
template <int BPS, int SPP>
__device__ __forceinline__ uint32_t rgba(Px p, bool invert) {
  const uint32_t s8 = BPS == 1 ? p.lo : __byte_perm(p.lo, p.hi, 0x7531);  // high bytes
  if (SPP <= 2) {
    const uint32_t g = (s8 & 0xFFu) ^ (invert ? 0xFFu : 0u);
    const uint32_t al = SPP == 2 ? (s8 >> 8) & 0xFFu : 0xFFu;
    return g * 0x010101u | al << 24;
  }
  return SPP == 3 ? s8 | 0xFF000000u : s8;
}

// One warp pass over pixels x .. x + 3 of a row (x = pass start + 4 * lane)
// -> their rgba words. `carry` is the row's running sum before the pass
// (predictor 2) and comes back after it. All 32 lanes call it.
template <int BPS, int SPP, bool PRED>
__device__ __forceinline__ void pass(const uint8_t* row, int x, int w, bool big, bool invert,
                                     Px& carry, uint32_t (&o)[4]) {
  constexpr int B = BPS * SPP;
  const int nv = max(0, min(4, w - x));
  uint32_t c[B + 1];  // 4 * B bytes
  load_bytes<4 * B>(row + static_cast<int64_t>(x) * B, nv * B, c);
  Px p[4];
  p[0] = sample<BPS, SPP, 0>(c, big);
  p[1] = sample<BPS, SPP, 1>(c, big);
  p[2] = sample<BPS, SPP, 2>(c, big);
  p[3] = sample<BPS, SPP, 3>(c, big);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j >= nv) p[j] = Px{0u, 0u};
  if (PRED) {
#pragma unroll
    for (int j = 1; j < 4; ++j) p[j] = vadd<BPS>(p[j - 1], p[j]);
    const int lane = threadIdx.x & 31;
    Px s = p[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Px u = shfl_up<BPS>(s, d);
      if (lane >= d) s = vadd<BPS>(s, u);
    }
    const Px before = vadd<BPS>(carry, vsub<BPS>(s, p[3]));
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = vadd<BPS>(p[j], before);
    carry = vadd<BPS>(carry, shfl_last<BPS>(s));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = rgba<BPS, SPP>(p[j], invert);
}

// orientations 1-4: a warp a source row, rows stored straight
template <int BPS, int SPP, bool PRED>
__global__ void __launch_bounds__(kThreads) tiff_straight(Args a, int aligned) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= static_cast<int64_t>(a.n) * a.h) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int img = static_cast<int>(r / a.h), y = static_cast<int>(r % a.h);
  const int o = a.orientation;
  const bool flip_x = o == 2 || o == 3, flip_y = o == 3 || o == 4;
  const int oy = flip_y ? a.h - 1 - y : y;
  uint32_t* orow = a.out + (static_cast<int64_t>(img) * a.h + oy) * a.w;
  const uint8_t* row = a.rows + r * a.rb;
  const bool big = a.big_endian, invert = a.photometric == 0;
  Px carry{0u, 0u};
  for (int x0 = 0; x0 < a.w; x0 += kPass) {
    const int x = x0 + 4 * lane;
    uint32_t px[4];
    pass<BPS, SPP, PRED>(row, x, a.w, big, invert, carry, px);
    const int nv = min(4, a.w - x);
    if (nv <= 0) continue;
    if (aligned && nv == 4) {
      if (flip_x)
        *reinterpret_cast<uint4*>(orow + (a.w - 4 - x)) = make_uint4(px[3], px[2], px[1], px[0]);
      else
        *reinterpret_cast<uint4*>(orow + x) = make_uint4(px[0], px[1], px[2], px[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nv) orow[flip_x ? a.w - 1 - x - j : x + j] = px[j];
    }
  }
}

// orientations 5-8: a block per (image, 32 source rows), 128 columns at a
// time through a shared tile; warp k converts rows k, k + 8, k + 16, k + 24.
// Six blocks a multiprocessor (40 registers): on an H100, 7 % faster than
// the four that 54 registers allow on config 4's predictor-2
// orientation-6 bucket.
template <int BPS, int SPP, bool PRED>
__global__ void __launch_bounds__(kThreads, 6) tiff_transposed(Args a, int aligned) {
  // tile[row][chunk ^ swz(row)] holds pixels 4 * chunk .. 4 * chunk + 3
  __shared__ uint4 tile[kTileRows][kPass / 4];
  const int tiles = (a.h + kTileRows - 1) / kTileRows;
  const int img = static_cast<int>(blockIdx.x / tiles);
  const int y0 = static_cast<int>(blockIdx.x % tiles) * kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = a.orientation;
  const bool flip_row = o == 7 || o == 8, flip_col = o == 6 || o == 7;
  const bool big = a.big_endian, invert = a.photometric == 0;
  uint32_t* oimg = a.out + static_cast<int64_t>(img) * a.h * a.w;  // (w, h) pixels
  constexpr int kRowsPerWarp = kTileRows / (kThreads / 32);
  Px carry[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) carry[i] = Px{0u, 0u};
  for (int x0 = 0; x0 < a.w; x0 += kPass) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int yl = warp + 8 * i;
      uint32_t px[4] = {0u, 0u, 0u, 0u};
      if (y0 + yl < a.h) {  // warp-uniform
        const uint8_t* row = a.rows + (static_cast<int64_t>(img) * a.h + y0 + yl) * a.rb;
        pass<BPS, SPP, PRED>(row, x0 + 4 * lane, a.w, big, invert, carry[i], px);
      }
      tile[yl][lane ^ ((yl >> 2) & 7)] = make_uint4(px[0], px[1], px[2], px[3]);
    }
    __syncthreads();
    // output row x (or w - 1 - x) gets source rows y0 .. y0 + 31 at column
    // x: a thread writes four of them, eight threads one 128-byte run
#pragma unroll
    for (int k = 0; k < kPass * kTileRows / 4 / kThreads; ++k) {
      const int idx = threadIdx.x + kThreads * k;
      const int xl = idx >> 3, q = idx & 7;
      const int x = x0 + xl, y = y0 + 4 * q;
      const int nv = min(4, a.h - y);
      if (x >= a.w || nv <= 0) continue;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* t = reinterpret_cast<const uint32_t*>(&tile[4 * q + j][(xl >> 2) ^ q]);
        v[j] = t[xl & 3];
      }
      uint32_t* orow = oimg + static_cast<int64_t>(flip_row ? a.w - 1 - x : x) * a.h;
      if (aligned && nv == 4) {
        if (flip_col)
          *reinterpret_cast<uint4*>(orow + (a.h - 4 - y)) = make_uint4(v[3], v[2], v[1], v[0]);
        else
          *reinterpret_cast<uint4*>(orow + y) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nv) orow[flip_col ? a.h - 1 - y - j : y + j] = v[j];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the generic kernel: every signature, a thread a source row walking x

__device__ __forceinline__ int to8(int v, int bits) {
  if (bits == 16) return v >> 8;
  if (bits == 8) return v;
  return (v * 255) / ((1 << bits) - 1);
}

__global__ void __launch_bounds__(kGenericThreads) tiff_generic(Args a) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kGenericThreads) + threadIdx.x;
  if (r >= static_cast<int64_t>(a.n) * a.h) return;
  const int img = static_cast<int>(r / a.h);
  const int y = static_cast<int>(r % a.h);
  const uint8_t* row = a.rows + r * a.rb;
  const int ph = a.photometric;
  // the samples the photometric reads
  int used;
  if (ph == 0 || ph == 1) used = (a.spp > 1 && a.has_extras) ? 2 : 1;
  else if (ph == 2) used = a.spp > 3 ? 4 : 3;
  else if (ph == 3) used = 1;
  else if (ph == 5) used = a.spp > 4 ? 5 : 4;
  else used = 3;
  const int maxv = (1 << a.bits) - 1;
  const int per = a.bits < 8 ? 8 / a.bits : 1;
  int acc[5] = {0, 0, 0, 0, 0};
  const bool tr = a.orientation >= 5;
  const int ow = tr ? a.h : a.w;  // output row length
  uint32_t* out_img = a.out + static_cast<int64_t>(img) * a.h * a.w;

  for (int x = 0; x < a.w; ++x) {
    int s[5];
    for (int k = 0; k < used; ++k) {
      const int64_t i = static_cast<int64_t>(x) * a.spp + k;
      int v;
      if (a.bits == 16) {
        const int b0 = row[2 * i], b1 = row[2 * i + 1];
        v = a.big_endian ? (b0 << 8) | b1 : (b1 << 8) | b0;
      } else if (a.bits == 8) {
        v = row[i];
      } else {
        const int shift = (per - 1 - static_cast<int>(i % per)) * a.bits;
        v = (row[i / per] >> shift) & maxv;
      }
      if (a.predictor == 2) {
        acc[k] = (acc[k] + v) & maxv;  // bits 8 or 16: mod 2^bits
        v = acc[k];
      }
      s[k] = v;
    }
    int rr, gg, bb, al = 255;
    if (ph == 0 || ph == 1) {
      int g = to8(s[0], a.bits);
      if (ph == 0) g = 255 - g;
      rr = gg = bb = g;
      if (used == 2) al = to8(s[1], a.bits);
    } else if (ph == 2) {
      rr = to8(s[0], a.bits);
      gg = to8(s[1], a.bits);
      bb = to8(s[2], a.bits);
      if (used == 4) al = to8(s[3], a.bits);
    } else if (ph == 3) {
      const uint8_t* e = a.cmap + (static_cast<int64_t>(img) * (maxv + 1) + s[0]) * 3;
      rr = __ldg(e);
      gg = __ldg(e + 1);
      bb = __ldg(e + 2);
    } else if (ph == 5) {
      const int k = to8(s[3], a.bits);
      rr = (255 - to8(s[0], a.bits)) * (255 - k) / 255;
      gg = (255 - to8(s[1], a.bits)) * (255 - k) / 255;
      bb = (255 - to8(s[2], a.bits)) * (255 - k) / 255;
      if (used == 5) al = to8(s[4], a.bits);
    } else {
      // int32 products with wrap-around (as the reference's int32 graph),
      // then an arithmetic shift of the signed sum
      const uint32_t yv = static_cast<uint32_t>(s[0]);
      const uint32_t cb = static_cast<uint32_t>(s[1] - 128);
      const uint32_t cr = static_cast<uint32_t>(s[2] - 128);
      const int dr = static_cast<int32_t>(91881u * cr + 32768u) >> 16;
      const int dg = static_cast<int32_t>(22554u * cb + 46802u * cr + 32768u) >> 16;
      const int db = static_cast<int32_t>(116130u * cb + 32768u) >> 16;
      rr = static_cast<int32_t>(yv + static_cast<uint32_t>(dr));
      gg = static_cast<int32_t>(yv - static_cast<uint32_t>(dg));
      bb = static_cast<int32_t>(yv + static_cast<uint32_t>(db));
      rr = min(max(rr, 0), 255);
      gg = min(max(gg, 0), 255);
      bb = min(max(bb, 0), 255);
    }
    int oy, ox;
    switch (a.orientation) {
      case 2: oy = y; ox = a.w - 1 - x; break;
      case 3: oy = a.h - 1 - y; ox = a.w - 1 - x; break;
      case 4: oy = a.h - 1 - y; ox = x; break;
      case 5: oy = x; ox = y; break;
      case 6: oy = x; ox = a.h - 1 - y; break;
      case 7: oy = a.w - 1 - x; ox = a.h - 1 - y; break;
      case 8: oy = a.w - 1 - x; ox = y; break;
      default: oy = y; ox = x; break;
    }
    out_img[static_cast<int64_t>(oy) * ow + ox] =
        static_cast<uint32_t>(rr & 0xFF) | (static_cast<uint32_t>(gg & 0xFF) << 8) |
        (static_cast<uint32_t>(bb & 0xFF) << 16) | (static_cast<uint32_t>(al & 0xFF) << 24);
  }
}

// ---------------------------------------------------------------------------
// dispatch

using KernelFn = void (*)(Args, int);

struct Plan {
  const void* fn;  // the kernel, for cudaFuncGetAttributes
  KernelFn fast;   // null: the generic kernel
  int route;       // 0 generic, 1 straight, 2 transposed
  int threads;
};

template <int BPS, int SPP>
KernelFn pick(bool pred, bool tr) {
  if (tr) return pred ? tiff_transposed<BPS, SPP, true> : tiff_transposed<BPS, SPP, false>;
  return pred ? tiff_straight<BPS, SPP, true> : tiff_straight<BPS, SPP, false>;
}

template <int BPS>
KernelFn pick_spp(int spp, bool pred, bool tr) {
  switch (spp) {
    case 1: return pick<BPS, 1>(pred, tr);
    case 2: return pick<BPS, 2>(pred, tr);
    case 3: return pick<BPS, 3>(pred, tr);
    default: return pick<BPS, 4>(pred, tr);
  }
}

// the fast kernels take 8/16-bit grey, grey + alpha, rgb and rgba whose
// pixels hold exactly the samples the photometric reads
Plan plan(int spp, int bits, int photometric, int predictor, int orientation, int has_extras) {
  int used = 0;
  if (photometric == 0 || photometric == 1) used = (spp > 1 && has_extras) ? 2 : 1;
  else if (photometric == 2) used = spp > 3 ? 4 : 3;
  if ((bits == 8 || bits == 16) && used == spp && spp <= 4) {
    const bool pred = predictor == 2, tr = orientation >= 5;
    KernelFn k = bits == 8 ? pick_spp<1>(spp, pred, tr) : pick_spp<2>(spp, pred, tr);
    return Plan{reinterpret_cast<const void*>(k), k, tr ? 2 : 1, kThreads};
  }
  return Plan{reinterpret_cast<const void*>(tiff_generic), nullptr, 0, kGenericThreads};
}

bool takes(int n, int h, int w, int64_t rb, int spp, int bits, int photometric, int predictor,
           int orientation, bool has_cmap) {
  const bool bits_ok = bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16;
  const bool ph_ok = photometric == 0 || photometric == 1 || photometric == 2 ||
                     photometric == 3 || photometric == 5 || photometric == 6;
  return !(n < 0 || h < 1 || w < 1 || spp < 1 || !bits_ok || !ph_ok ||
           (predictor != 1 && predictor != 2) || (predictor == 2 && bits < 8) ||
           orientation < 1 || orientation > 8 || (photometric == 3 && !has_cmap) ||
           ((photometric == 2 || photometric == 6) && spp < 3) ||
           (photometric == 5 && spp < 4) || rb * 8 < static_cast<int64_t>(w) * spp * bits);
}

}  // namespace

// rows: (n, h, rb) uint8 decompressed strip rows at any byte offset; spp
// >= 1; bits 1, 2, 4, 8 or 16; photometric 0, 1, 2, 3, 5 or 6 (with the
// samples it reads: 3 for rgb and YCbCr, 4 for CMYK); predictor 1, or 2
// at 8 and 16 bits; orientation 1-8; cmap (n, 1 << bits, 3) uint8 for
// photometric 3; out: (n, h, w, 4) uint8 for orientations 1-4, (n, w, h,
// 4) for 5-8. One launch. Returns cudaGetLastError().
extern "C" int picha_tiff_transform(const void* rows, int n, int h, int w, int64_t rb,
                                    int spp, int bits, int photometric, int predictor,
                                    int orientation, int big_endian, int has_extras,
                                    const void* cmap, void* out, void* stream) {
  if (!takes(n, h, w, rb, spp, bits, photometric, predictor, orientation, cmap != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nrows = static_cast<int64_t>(n) * h;
  if (nrows == 0) return static_cast<int>(cudaGetLastError());
  Args a{static_cast<const uint8_t*>(rows), n, h, w, rb, spp, bits, photometric, predictor,
         orientation, big_endian, has_extras, static_cast<const uint8_t*>(cmap),
         static_cast<uint32_t*>(out)};
  const Plan p = plan(spp, bits, photometric, predictor, orientation, has_extras);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool out16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int64_t blocks;
  if (p.route == 1) {
    blocks = (nrows + kThreads / 32 - 1) / (kThreads / 32);
    p.fast<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a, out16 && w % 4 == 0);
  } else if (p.route == 2) {
    blocks = static_cast<int64_t>(n) * ((h + kTileRows - 1) / kTileRows);
    p.fast<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a, out16 && h % 4 == 0);
  } else {
    blocks = (nrows + kGenericThreads - 1) / kGenericThreads;
    tiff_generic<<<static_cast<unsigned>(blocks), kGenericThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The build of the kernel a signature launches: out[0..5] = registers a
// thread, local (spill) bytes a thread, shared bytes a block, threads a
// block, resident blocks a multiprocessor, route (0 generic, 1 straight,
// 2 transposed). Launches nothing.
extern "C" int picha_tiff_transform_info(int spp, int bits, int photometric, int predictor,
                                         int orientation, int has_extras, int* out) {
  if (!takes(1, 1, 1, static_cast<int64_t>(spp) * 2, spp, bits, photometric, predictor,
             orientation, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(spp, bits, photometric, predictor, orientation, has_extras);
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, p.fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn, p.threads, 0);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = p.threads;
  out[4] = blocks;
  out[5] = p.route;
  return static_cast<int>(rc);
}
