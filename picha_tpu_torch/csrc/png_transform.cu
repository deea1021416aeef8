// K14: the PNG spec transforms, from decoded samples to the target pixel
// format, over a batch of images of one (width, height, depth, colour
// type) signature.
//
// Replaces: picha_tpu/pipeline/png_batch.py::_jit_transform (:38-96),
// row 11c (PNG half). Per pixel, as that graph computes it:
//   palette (colour type 3): rgb = pal[image][index] from a 256-entry
//     zero-padded table (an index past the PLTE gives black), alpha =
//     trns[image][index] (255 past the tRNS) when the batch has tRNS;
//   sub-byte grey: sample * (255 / maxv) (1-, 2-, 4-bit -> 8-bit);
//   grey+alpha, rgb+alpha: the last sample is alpha;
//   grey -> rgb by replication; rgb -> grey in libpng's 15-bit fixed
//     point, (6968 r + 23434 g + 2366 b + 16384) >> 15 in uint32;
//   a target with alpha and no source alpha gets maxval (65535 at depth
//     16, else 255);
//   a deep target keeps the values as uint16, else depth 16 is cut to
//     its high byte.
// The input is the sample bytes: (n, h, w, cin * bps) uint8, bps = 2
// (big-endian, as PNG stores them) at depth 16, else 1 with sub-byte
// samples already unpacked.
//
// What bounds it on an H100: memory traffic, cin * bps bytes read and
// cout * (1 or 2) written a pixel (config 4's rgba bucket: 50.3 MB in and
// out, 0.060 ms at 3.35 TB/s), with a few integer operations each. A
// thread a pixel with byte loads and stores and the signature's branches
// taken at run time (the first design) ran at a sixth of that. The design:
//   - the signature is compile-time (samples a pixel, bytes a sample,
//     colour / alpha / deep target; the palette a kernel of its own), so
//     the branches fold and a byte's place in a word is a constant;
//   - a thread converts a group of G pixels whose input and output bytes
//     are both whole 16-byte words (G = 4 for rgba8 -> rgba, 8 for 16-bit
//     rgb): uint4 loads, fetched aligned and funnel-shifted when the
//     samples start at an odd byte, and uint4 stores; the identity bucket
//     (rgba8 -> rgba) is a vectorised copy in the kernel;
//   - each thread first loads its U groups (about 64 bytes) and then
//     converts and stores them, to keep several loads in flight;
//   - the palette grid is (image, chunk): a block first loads its indices
//     (lane l of a warp takes the four at 4 l + 128 k of a 512-pixel tile,
//     so that each load and each store of the warp is one contiguous run),
//     then builds its image's 256-entry table of output pixels in shared
//     memory (1 KB, from `pal` and `trns` by byte loads, since they are
//     views of the upload buffer at any offset) while those loads are in
//     flight, then looks its pixels up.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "byte_stream.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int word_align(int b) {  // the largest power of two <= 16 dividing b
  return b % 16 == 0 ? 16 : b % 8 == 0 ? 8 : b % 4 == 0 ? 4 : b % 2 == 0 ? 2 : 1;
}

// pixels a group: the fewest whose `bin` input and `bout` output bytes are
// both whole 16-byte words (16 / word_align is a power of two: lcm = max)
__host__ __device__ constexpr int group_px(int bin, int bout) {
  return 16 / word_align(bin) > 16 / word_align(bout) ? 16 / word_align(bin)
                                                      : 16 / word_align(bout);
}

// groups a thread loads before it stores: about 64 bytes of input
__host__ __device__ constexpr int groups_per_thread(int group_bytes) {
  return group_bytes >= 64 ? 1 : 64 / group_bytes;
}

// the pixels of a group of G that lie before the end, `left` pixels away
template <int G>
__device__ __forceinline__ int left_px(int64_t left) {
  return left < G ? static_cast<int>(left) : G;
}

// Stores the first `npx` pixels (BOUT bytes each) of a group's output
// words at dst (16-byte aligned): whole uint4 words when the group is
// full, else byte by byte.
template <int G, int BOUT, int N>
__device__ __forceinline__ void store_group(uint8_t* dst, const uint32_t (&o)[N], int npx) {
  if (npx == G) {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < G * BOUT / 16; ++k)
      d[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int b = 0; b < BOUT; ++b)
      if (j < npx) dst[j * BOUT + b] = static_cast<uint8_t>(o[(j * BOUT + b) / 4] >> (((j * BOUT + b) % 4) * 8));
}

// ---------------------------------------------------------------------------
// colour types 0, 2, 4, 6

// the samples of pixel J (CIN of them, BPS bytes each, big-endian at 16)
template <int CIN, int BPS, int J, int N>
__device__ __forceinline__ void samples_of(const uint32_t (&c)[N], uint32_t (&s)[4]) {
#pragma unroll
  for (int k = 0; k < CIN; ++k) {
    // k is unrolled, so each offset is a constant
    const int o = J * CIN * BPS + k * BPS;
    const uint32_t v = __funnelshift_r(c[o / 4], c[o / 4 + 1], (o % 4) * 8);
    s[k] = BPS == 1 ? v & 0xFFu : ((v & 0xFFu) << 8) | ((v >> 8) & 0xFFu);
  }
}

// one pixel's samples -> its output values, as the reference maps them
template <int CIN, int BPS, bool OUTC, bool OUTA, bool DEEP>
__device__ __forceinline__ void convert(uint32_t (&s)[4], uint32_t scale, uint32_t (&v)[4]) {
  constexpr bool kSrcAlpha = CIN == 2 || CIN == 4;
  constexpr int kColor = kSrcAlpha ? CIN - 1 : CIN;
  constexpr uint32_t kMax = BPS == 2 ? 65535u : 255u;
  if (CIN == 1 && BPS == 1) s[0] = (s[0] * scale) & 0xFFu;  // scale 1 at depth 8
  int k = 0;
  if (OUTC) {
    v[0] = s[0];
    v[1] = kColor == 1 ? s[0] : s[1];
    v[2] = kColor == 1 ? s[0] : s[2];
    k = 3;
  } else {
    v[0] = kColor == 3 ? (6968u * s[0] + 23434u * s[1] + 2366u * s[2] + 16384u) >> 15 : s[0];
    k = 1;
  }
  if (OUTA) v[k] = kSrcAlpha ? s[CIN - 1] : kMax;
  if (!DEEP && BPS == 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] >>= 8;
  }
}

template <int CIN, int BPS, bool OUTC, bool OUTA, bool DEEP, int J, int NI, int NO>
__device__ __forceinline__ void pixel(const uint32_t (&c)[NI], uint32_t scale, uint32_t (&o)[NO]) {
  constexpr int kCout = (OUTC ? 3 : 1) + (OUTA ? 1 : 0);
  constexpr int kOb = DEEP ? 2 : 1;
  uint32_t s[4] = {0u, 0u, 0u, 0u}, v[4] = {0u, 0u, 0u, 0u};
  samples_of<CIN, BPS, J>(c, s);
  convert<CIN, BPS, OUTC, OUTA, DEEP>(s, scale, v);
#pragma unroll
  for (int k = 0; k < kCout; ++k) {
    const int ob = (J * kCout + k) * kOb;
    o[ob / 4] |= (DEEP ? v[k] & 0xFFFFu : v[k] & 0xFFu) << ((ob % 4) * 8);
  }
}

template <int CIN, int BPS, bool OUTC, bool OUTA, bool DEEP, int G, int NI, int NO, int... J>
__device__ __forceinline__ void group(const uint32_t (&c)[NI], uint32_t scale, uint32_t (&o)[NO],
                                      std::integer_sequence<int, J...>) {
  (pixel<CIN, BPS, OUTC, OUTA, DEEP, J>(c, scale, o), ...);
}

// the flat batch: n * h * w pixels, a thread U groups of G at a time
template <int CIN, int BPS, bool OUTC, bool OUTA, bool DEEP>
__global__ void __launch_bounds__(kThreads)
    png_samples(const uint8_t* __restrict__ in, int64_t pixels, uint32_t scale,
                uint8_t* __restrict__ out) {
  constexpr int kBin = CIN * BPS;
  constexpr int kBout = ((OUTC ? 3 : 1) + (OUTA ? 1 : 0)) * (DEEP ? 2 : 1);
  constexpr int G = group_px(kBin, kBout);
  constexpr int U = groups_per_thread(G * kBin);
  constexpr int NI = G * kBin / 4, NO = G * kBout / 4;
  const int64_t groups = (pixels + G - 1) / G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * U;
  for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads * U + threadIdx.x; g0 < groups;
       g0 += stride) {
    uint32_t c[U][NI + 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t g = g0 + static_cast<int64_t>(u) * kThreads;
      const int npx = g < groups ? left_px<G>(pixels - g * G) : 0;
      load_bytes<G * kBin>(in + g * G * kBin, npx * kBin, c[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t g = g0 + static_cast<int64_t>(u) * kThreads;
      if (g >= groups) break;
      uint32_t o[NO];
#pragma unroll
      for (int k = 0; k < NO; ++k) o[k] = 0u;
      group<CIN, BPS, OUTC, OUTA, DEEP, G>(c[u], scale, o, std::make_integer_sequence<int, G>{});
      store_group<G, kBout>(out + g * G * kBout, o, left_px<G>(pixels - g * G));
    }
  }
}

// ---------------------------------------------------------------------------
// colour type 3: a block per (image, chunk of 512-pixel warp tiles)

constexpr int kPalTile = 512;   // pixels a warp tile: lane l takes 4 at 4 l + 128 k
constexpr int kPalTiles = 4;    // warp tiles a warp converts at a time

// Stores 4 pixels of BOUT bytes (BOUT words) at dst: as 16-, 8- or 4-byte
// words when all 4 are there and dst's image is aligned, else byte by byte.
template <int BOUT>
__device__ __forceinline__ void store4(uint8_t* dst, const uint32_t (&o)[BOUT], int npx,
                                       bool aligned) {
  if (aligned && npx == 4) {
    if constexpr (BOUT % 4 == 0) {
#pragma unroll
      for (int k = 0; k < BOUT / 4; ++k)
        reinterpret_cast<uint4*>(dst)[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
    } else if constexpr (BOUT % 2 == 0) {
#pragma unroll
      for (int k = 0; k < BOUT / 2; ++k) reinterpret_cast<uint2*>(dst)[k] = make_uint2(o[2 * k], o[2 * k + 1]);
    } else {
#pragma unroll
      for (int k = 0; k < BOUT; ++k) reinterpret_cast<uint32_t*>(dst)[k] = o[k];
    }
    return;
  }
#pragma unroll
  for (int b = 0; b < 4 * BOUT; ++b)
    if (b < npx * BOUT) dst[b] = static_cast<uint8_t>(o[b / 4] >> ((b % 4) * 8));
}

template <bool OUTC, bool OUTA, bool DEEP>
__global__ void __launch_bounds__(kThreads)
    png_palette(const uint8_t* __restrict__ in, int64_t image_px, int chunks,
                const uint8_t* __restrict__ pal, const uint8_t* __restrict__ trns,
                uint8_t* __restrict__ out) {
  constexpr int kCout = (OUTC ? 3 : 1) + (OUTA ? 1 : 0);
  constexpr int kOb = DEEP ? 2 : 1;
  constexpr int kBout = kCout * kOb;
  __shared__ uint32_t tab[256];
  const int64_t img = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* src = in + img * image_px;
  uint8_t* dst = out + img * image_px * kBout;
  const int64_t tile0 = (static_cast<int64_t>(chunk) * (kThreads / 32) + warp) * kPalTiles;
  // the indices first, so that their loads overlap the table's
  uint32_t c[kPalTiles][4][2];
#pragma unroll
  for (int t = 0; t < kPalTiles; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t x = (tile0 + t) * kPalTile + 128 * k + 4 * lane;
      const int64_t left = image_px - x;
      load_bytes<4>(src + x, left < 0 ? 0 : left < 4 ? static_cast<int>(left) : 4, c[t][k]);
    }
  {
    // entry t: the target's values of palette entry t, a byte each
    const int t = threadIdx.x;
    const uint8_t* e = pal + (img * 256 + t) * 3;
    const uint32_t r = e[0], g = e[1], b = e[2];
    const uint32_t al = trns != nullptr ? trns[img * 256 + t] : 255u;
    uint32_t v = OUTC ? r | g << 8 | b << 16 : (6968u * r + 23434u * g + 2366u * b + 16384u) >> 15;
    if (OUTA) v |= al << (OUTC ? 24 : 8);
    tab[t] = v;
  }
  __syncthreads();
  const bool aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
#pragma unroll
  for (int t = 0; t < kPalTiles; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t x = (tile0 + t) * kPalTile + 128 * k + 4 * lane;
      if (x >= image_px) continue;
      uint32_t o[kBout];
#pragma unroll
      for (int i = 0; i < kBout; ++i) o[i] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t e = tab[(c[t][k][0] >> (8 * j)) & 0xFFu];
#pragma unroll
        for (int v = 0; v < kCout; ++v) {
          const int ob = (j * kCout + v) * kOb;
          o[ob / 4] |= ((e >> (8 * v)) & 0xFFu) << ((ob % 4) * 8);
        }
      }
      const int64_t left = image_px - x;
      store4<kBout>(dst + x * kBout, o, left < 4 ? static_cast<int>(left) : 4, aligned);
    }
}

// ---------------------------------------------------------------------------
// dispatch

using SamplesFn = void (*)(const uint8_t*, int64_t, uint32_t, uint8_t*);
using PaletteFn = void (*)(const uint8_t*, int64_t, int, const uint8_t*, const uint8_t*, uint8_t*);

template <int CIN, int BPS>
SamplesFn pick_target(bool c, bool a, bool d) {
  if (c) {
    if (a) return d ? png_samples<CIN, BPS, true, true, true> : png_samples<CIN, BPS, true, true, false>;
    return d ? png_samples<CIN, BPS, true, false, true> : png_samples<CIN, BPS, true, false, false>;
  }
  if (a) return d ? png_samples<CIN, BPS, false, true, true> : png_samples<CIN, BPS, false, true, false>;
  return d ? png_samples<CIN, BPS, false, false, true> : png_samples<CIN, BPS, false, false, false>;
}

template <int CIN>
SamplesFn pick_depth(int bps, bool c, bool a, bool d) {
  return bps == 2 ? pick_target<CIN, 2>(c, a, d) : pick_target<CIN, 1>(c, a, d);
}

SamplesFn pick_samples(int cin, int bps, bool c, bool a, bool d) {
  switch (cin) {
    case 1: return pick_depth<1>(bps, c, a, d);
    case 2: return pick_depth<2>(bps, c, a, d);
    case 3: return pick_depth<3>(bps, c, a, d);
    default: return pick_depth<4>(bps, c, a, d);
  }
}

PaletteFn pick_palette(bool c, bool a, bool d) {
  if (c) {
    if (a) return d ? png_palette<true, true, true> : png_palette<true, true, false>;
    return d ? png_palette<true, false, true> : png_palette<true, false, false>;
  }
  if (a) return d ? png_palette<false, true, true> : png_palette<false, true, false>;
  return d ? png_palette<false, false, true> : png_palette<false, false, false>;
}

struct Plan {
  SamplesFn samples;  // colour types 0, 2, 4, 6
  PaletteFn palette;  // colour type 3
  const void* fn;     // the one of them, for cudaFuncGetAttributes
  int group;          // pixels a thread's group
  int cin, bps, bout;
};

// cin from the colour type (0 when it is not one PNG has)
int channels(int color_type) {
  switch (color_type) {
    case 0: case 3: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool takes(int color_type, int depth) {
  const int cin = channels(color_type);
  return cin != 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16) &&
         !(depth < 8 && color_type != 0 && color_type != 3) && !(color_type == 3 && depth == 16);
}

Plan plan(int color_type, int depth, bool c, bool a, bool d) {
  Plan p;
  p.cin = channels(color_type);
  p.bps = depth == 16 ? 2 : 1;
  p.bout = ((c ? 3 : 1) + (a ? 1 : 0)) * (d ? 2 : 1);
  p.samples = nullptr;
  p.palette = nullptr;
  if (color_type == 3) {
    p.palette = pick_palette(c, a, d);
    p.fn = reinterpret_cast<const void*>(p.palette);
    p.group = 4;
  } else {
    p.samples = pick_samples(p.cin, p.bps, c, a, d);
    p.fn = reinterpret_cast<const void*>(p.samples);
    p.group = group_px(p.cin * p.bps, p.bout);
  }
  return p;
}

}  // namespace

// in: (n, h, w, cin * bps) uint8 sample bytes (bps 1, or 2 big-endian) at
// any byte offset; colour_type 0 grey, 2 rgb, 3 palette, 4 grey+alpha, 6
// rgba; depth 1, 2, 4, 8 or 16; out: (n, h, w, cout) uint8, or uint16
// when deep, 16-byte aligned; out_color / out_alpha say whether the
// target has colour / alpha channels; pal (n, 256, 3) uint8 and trns (n,
// 256) uint8 at any byte offset for a palette batch (trns may be null: no
// tRNS in the batch). One launch. Returns cudaGetLastError().
extern "C" int picha_png_transform(const void* in, int n, int h, int w, int color_type,
                                   int depth, const void* pal, const void* trns,
                                   int out_color, int out_alpha, int deep, void* out,
                                   void* stream) {
  const bool palette = color_type == 3;
  if (!takes(color_type, depth) || n < 0 || h < 1 || w < 1 || (palette && pal == nullptr) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t image_px = static_cast<int64_t>(h) * w;
  const int64_t pixels = static_cast<int64_t>(n) * image_px;
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan(color_type, depth, out_color != 0, out_alpha != 0, deep != 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (palette) {
    const int64_t per = static_cast<int64_t>(kPalTile) * kPalTiles * (kThreads / 32);
    const int chunks = static_cast<int>((image_px + per - 1) / per);
    p.palette<<<static_cast<unsigned>(n * static_cast<int64_t>(chunks)), kThreads, 0, st>>>(
        src, image_px, chunks, static_cast<const uint8_t*>(pal),
        static_cast<const uint8_t*>(trns), dst);
  } else {
    const int64_t groups = (pixels + p.group - 1) / p.group;
    const int64_t per = static_cast<int64_t>(kThreads) * groups_per_thread(p.group * p.cin * p.bps);
    const uint32_t scale = (color_type == 0 && depth < 8) ? 255u / ((1u << depth) - 1u) : 1u;
    p.samples<<<static_cast<unsigned>((groups + per - 1) / per), kThreads, 0, st>>>(
        src, pixels, scale, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// The build of the kernel a signature launches: out[0..5] = registers a
// thread, local (spill) bytes a thread, shared bytes a block, threads a
// block, resident blocks a multiprocessor, pixels a thread's group.
// Launches nothing.
extern "C" int picha_png_transform_info(int color_type, int depth, int out_color, int out_alpha,
                                        int deep, int* out) {
  if (!takes(color_type, depth)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(color_type, depth, out_color != 0, out_alpha != 0, deep != 0);
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, p.fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn, kThreads, 0);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = p.group;
  return static_cast<int>(rc);
}
