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
// What bounds it on an H100: memory traffic, 1-16 bytes read and 1-16
// written a pixel and ~10 flops. The design (the plan is made on the host,
// picha_tpu_torch/ops/colorconvert.py::map_plan):
//   - the window's rows are segments of contiguous input pixels (a whole
//     row of the crop; an image, or the whole batch, where the window
//     takes full rows or the whole frame). A work item is a chunk of one
//     segment, or several whole segments where they are short (config 4's
//     352-pixel crop rows); the output of an item is contiguous;
//   - a persistent grid, planned from the card's occupancy, walks the
//     items. Each item's rows arrive in shared memory by 16-byte cp.async
//     of the aligned words that cover them (any byte offset: the row's
//     shift inside its first word is kept beside it), in a ring of two
//     stages: the next item's rows arrive while this one is mapped and
//     stored;
//   - a thread a pixel from the staged bytes; the row and the column
//     advance by increments, so no pixel takes a division. Where the
//     channel counts are compiled in and the item's rows and its output
//     start at whole pixel words (a fresh tensor, config 4's crop), a
//     pixel is loaded and stored as whole words (rgba uint8 one 32-bit
//     word, float32 rgba one 128-bit word), else a channel at a time;
//   - the output is staged in shared memory and stored by 16-byte stores,
//     the bytes before the first and after the last whole word singly;
//   - the signatures the callers use are compiled in (the 56 format
//     pairs of colorConvert, the unpack heads and pack tails at equal
//     channel counts, the clip tails), every other one runs the same body
//     with run-time channel counts.
// The numerics are the reference's, bit for bit: uint8 and uint16 are
// unpacked by the reciprocal of MAX (255, 65535) with one FMA correction
// step, which gives the IEEE v / MAX for every value (checked on all 256
// and 65,536 values by the card tests and the CPU model); the luma
// t0*wr + t1*wg + t2*wb and the pack v*MAX + 0.5 are rounded at every
// product and sum (__fmul_rn / __fadd_rn, so nvcc cannot contract them
// into FMAs); the clamp is min(max(v, 0), MAX), then floor. The plain
// versions (picha_tpu_torch/pixels.py unpack_f32, pack_f32;
// ops/colorconvert.py map_channels) do the same operations in the same
// order. NaN input (possible only for float input) is clamped by
// fmaxf/fminf where the reference would carry it.
#include <cuda_runtime.h>
#include <stdint.h>

#include <set>
#include <type_traits>

#include "occupancy.cuh"

namespace {

enum OutMode { PACK = 0, RAW = 1, CLIP = 2 };

constexpr int kThreads = 256;
constexpr int kInBytes = 14336;   // an item's staged rows: 12,288 + a word's slack a row
constexpr int kOutBytes = 12304;  // an item's staged output, from its first word
constexpr int kMaxRows = 64;      // segments an item
constexpr int kChunkBytes = 12288;  // the host plan's chunk: input or output bytes at most

// An item's staged rows: their covering words and, a row, the aligned
// start, the shift of the first pixel into its first word, and the words
struct Stage {
  __align__(16) uint8_t bytes[kInBytes];
  const uint8_t* src[kMaxRows];
  int shift[kMaxRows], words[kMaxRows];
};

// The host's plan (ops/colorconvert.py::map_plan). Input offsets are in
// elements: segment s starts at base + (s / segs_per_img) * img_stride +
// (s % segs_per_img) * row_stride; its output at s * seg_len pixels.
struct Plan {
  int64_t seg_len, segs, segs_per_img, img_stride, row_stride, base, cps, items;
  int chunk, rows;  // pixels a chunk (chunk items: rows 1); segments an item
};

template <typename T>
struct MaxOf;
template <>
struct MaxOf<uint8_t> {
  static constexpr float value = 255.0f, recip = 0x1.010102p-8f;  // 1 / 255 rounded
};
template <>
struct MaxOf<uint16_t> {
  static constexpr float value = 65535.0f, recip = 0x1.0001p-16f;  // 1 / 65535 rounded
};

// v / MAX, correctly rounded: q = v * r (r = 1 / MAX rounded), then
// q + (v - q * MAX) * r by two FMAs
template <typename T>
__device__ __forceinline__ float unpack(T v) {
  constexpr float m = MaxOf<T>::value, r = MaxOf<T>::recip;
  const float f = static_cast<float>(v);
  const float q = __fmul_rn(f, r);
  return __fmaf_rn(__fmaf_rn(-q, m, f), r, q);
}
__device__ __forceinline__ float unpack(float v) { return v; }

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
#pragma unroll
    for (int c = 0; c < 4; ++c)  // static indices: registers, also at run-time counts
      if (c < dc) o[c] = t[c];
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

// The largest power of two up to 16 that divides n bytes (1 for n = 0)
__host__ __device__ constexpr int align_of(int n) {
  return n <= 0 ? 1 : (n % 16 == 0 ? 16 : (n % 8 == 0 ? 8 : (n % 4 == 0 ? 4 : (n % 2 == 0 ? 2 : 1))));
}

// A pixel's C channels of T, loaded or stored as whole words
template <typename T, int C>
struct alignas(align_of(C * sizeof(T))) Pixel {
  T v[C];
};

// One pixel: its channels from the staged bytes at `in`, unpacked, mapped
// and packed into `dst`. kWhole (channel counts compiled in, `in` and
// `dst` aligned to their pixels' words): each end as whole words, the
// channels taken apart in registers; else a load and a store a channel.
template <typename Tin, typename Tout, int MODE, int SC, int DC, bool kWhole>
__device__ __forceinline__ void map_pixel(const uint8_t* in, uint8_t* dst, int sc, int dc, float wr,
                                          float wg, float wb) {
  float t[4], o[4];
  if constexpr (kWhole) {
    const Pixel<Tin, SC> v = *reinterpret_cast<const Pixel<Tin, SC>*>(in);
#pragma unroll
    for (int ch = 0; ch < SC; ++ch) t[ch] = unpack(v.v[ch]);
    map_channels(t, SC, DC, wr, wg, wb, o);
    Pixel<Tout, DC> w;
#pragma unroll
    for (int ch = 0; ch < DC; ++ch) w.v[ch] = store<Tout, MODE>(o[ch]);
    *reinterpret_cast<Pixel<Tout, DC>*>(dst) = w;
  } else {
#pragma unroll
    for (int ch = 0; ch < (SC ? SC : 4); ++ch)
      if (ch < sc) t[ch] = unpack(reinterpret_cast<const Tin*>(in)[ch]);
    map_channels(t, sc, dc, wr, wg, wb, o);
#pragma unroll
    for (int ch = 0; ch < (DC ? DC : 4); ++ch)
      if (ch < dc) reinterpret_cast<Tout*>(dst)[ch] = store<Tout, MODE>(o[ch]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// An item's segments [s, s + rows) and its pixels [c, c + span) of each
__device__ __forceinline__ void item_of(const Plan& p, int64_t item, int64_t& s, int64_t& c,
                                        int& rows, int& span) {
  const int64_t q = item / p.cps;
  s = q * p.rows;
  c = (item - q * p.cps) * p.chunk;
  const int64_t left = p.segs - s, len = p.seg_len - c;
  rows = static_cast<int>(left < p.rows ? left : p.rows);
  span = static_cast<int>(len < p.chunk ? len : p.chunk);
}

// Threads < rows note their segment's covering words (aligned start,
// shift, words); then every thread sends its share of the words by
// cp.async into rows of rw words, as one commit group. Returns rw;
// *aligned: every row's shift a multiple of `align` bytes.
template <typename Tin>
__device__ __forceinline__ int load_item(const Tin* __restrict__ x, const Plan& p, int64_t s,
                                         int64_t c, int rows, int span, int bpi, int align,
                                         Stage& st, bool* aligned) {
  const int rw = (30 + span * bpi) >> 4;
  int ok = 1;
  if (threadIdx.x < rows) {
    const int64_t seg = s + threadIdx.x;
    const int64_t img = seg / p.segs_per_img;
    const int64_t off = p.base + img * p.img_stride +
                        (seg - img * p.segs_per_img) * p.row_stride +
                        c * (bpi / static_cast<int>(sizeof(Tin)));
    const uint8_t* a = reinterpret_cast<const uint8_t*>(x + off);
    const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    st.src[threadIdx.x] = a - sh;
    st.shift[threadIdx.x] = sh;
    st.words[threadIdx.x] = (sh + span * bpi + 15) >> 4;
    ok = sh % align == 0;
  }
  *aligned = __syncthreads_and(ok);
  // word wi of row r, advanced by kThreads words a step
  int r = threadIdx.x / rw, wi = threadIdx.x - r * rw;
  const int dr = kThreads / rw, dw = kThreads - dr * rw;
  while (r < rows) {
    if (wi < st.words[r]) cp_async16(st.bytes + (r * rw + wi) * 16, st.src[r] + wi * 16);
    wi += dw;
    r += dr;
    if (wi >= rw) {
      wi -= rw;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return rw;
}

// An item in flight: its segments, pixels, staged row width, and whether
// every row starts at a whole pixel word
struct Item {
  int64_t s, c;
  int rows, span, rw;
  bool aligned;
};

// An item's pixels from its stage into outbuf + oshift, a pixel a thread,
// advanced by kThreads pixels a step: along the one row, or row by row
// (pixel q = r * span + px) with no division a pixel
template <typename Tin, typename Tout, int MODE, int SC, int DC, bool kWhole>
__device__ __forceinline__ void map_item(const Stage& st, const Item& it, uint8_t* outbuf,
                                         int oshift, int sc, int dc, float wr, float wg,
                                         float wb) {
  const int bpi = sc * static_cast<int>(sizeof(Tin)), bpo = dc * static_cast<int>(sizeof(Tout));
  const int total = it.rows * it.span, span = it.span, rstride = it.rw * 16;
  uint8_t* dst = outbuf + oshift + threadIdx.x * bpo;
  if (it.rows == 1) {
    const uint8_t* in = st.bytes + st.shift[0] + threadIdx.x * bpi;
#pragma unroll 2
    for (int q = threadIdx.x; q < total; q += kThreads) {
      map_pixel<Tin, Tout, MODE, SC, DC, kWhole>(in, dst, sc, dc, wr, wg, wb);
      in += kThreads * bpi;
      dst += kThreads * bpo;
    }
    return;
  }
  int r = threadIdx.x / span, px = threadIdx.x - r * span;
  const int dr = kThreads / span, dp = kThreads - dr * span;
  const uint8_t* in = st.bytes + r * rstride + st.shift[r] + px * bpi;
  for (int q = threadIdx.x; q < total; q += kThreads) {
    map_pixel<Tin, Tout, MODE, SC, DC, kWhole>(in, dst, sc, dc, wr, wg, wb);
    dst += kThreads * bpo;
    const int r0 = r;
    px += dp;
    r += dr;
    if (px >= span) {
      px -= span;
      ++r;
    }
    if (r == r0)
      in += dp * bpi;
    else if (q + kThreads < total)
      in = st.bytes + r * rstride + st.shift[r] + px * bpi;
  }
}

// SC, DC: the channel counts compiled in, or 0 for the run-time ones.
// Two stages: the next item's rows arrive while this item is mapped and
// stored.
template <typename Tin, typename Tout, int MODE, int SC, int DC>
__global__ void __launch_bounds__(kThreads) pixel_map_rows(
    const Tin* __restrict__ x, Plan p, int sc_rt, int dc_rt, float wr, float wg, float wb,
    Tout* __restrict__ out) {
  __shared__ Stage stages[2];
  __shared__ __align__(16) uint8_t outbuf[kOutBytes];
  const int sc = SC ? SC : sc_rt, dc = DC ? DC : dc_rt;
  const int bpi = sc * static_cast<int>(sizeof(Tin)), bpo = dc * static_cast<int>(sizeof(Tout));
  // a pixel's whole words at either end (channel counts compiled in)
  constexpr int kIn = align_of(SC * sizeof(Tin)), kOut = align_of(DC * sizeof(Tout));

  int64_t item = blockIdx.x;
  int cur = 0;
  Item it{}, nx{};
  if (item < p.items) {
    item_of(p, item, it.s, it.c, it.rows, it.span);
    it.rw = load_item(x, p, it.s, it.c, it.rows, it.span, bpi, kIn, stages[0], &it.aligned);
  }
  while (item < p.items) {
    const int64_t next = item + gridDim.x;
    if (next < p.items) {
      item_of(p, next, nx.s, nx.c, nx.rows, nx.span);
      nx.rw = load_item(x, p, nx.s, nx.c, nx.rows, nx.span, bpi, kIn, stages[cur ^ 1],
                        &nx.aligned);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    // this item's output bytes [ob, ob + nb), staged from outbuf[oshift]
    uint8_t* ob = reinterpret_cast<uint8_t*>(out) + (it.s * p.seg_len + it.c) * bpo;
    const int oshift = static_cast<int>(reinterpret_cast<uintptr_t>(ob) & 15);
    const int total = it.rows * it.span;
    if (SC != 0 && DC != 0 && it.aligned && oshift % kOut == 0)
      map_item<Tin, Tout, MODE, SC, DC, SC != 0 && DC != 0>(stages[cur], it, outbuf, oshift, sc,
                                                             dc, wr, wg, wb);
    else
      map_item<Tin, Tout, MODE, SC, DC, false>(stages[cur], it, outbuf, oshift, sc, dc, wr, wg,
                                               wb);
    __syncthreads();
    // [a, e): the whole 16-byte words of the output
    const int nb = total * bpo;
    uint8_t* a = ob + ((16 - oshift) & 15);
    uint8_t* e = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(ob + nb) & ~uintptr_t{15});
    if (a >= e) a = e = ob + nb;
    const int head = static_cast<int>(a - ob), nwords = static_cast<int>((e - a) >> 4);
    for (int i = threadIdx.x; i < nwords; i += kThreads)
      reinterpret_cast<int4*>(a)[i] = reinterpret_cast<const int4*>(outbuf + oshift + head)[i];
    const int tail = static_cast<int>(ob + nb - e);
    if (threadIdx.x < head) ob[threadIdx.x] = outbuf[oshift + threadIdx.x];
    else if (threadIdx.x - head < tail)
      e[threadIdx.x - head] = outbuf[oshift + (e - ob) + threadIdx.x - head];
    __syncthreads();
    item = next;
    it = nx;
    cur ^= 1;
  }
}

// A launch argument set, the same for every build
struct Call {
  const void* x;
  Plan plan;
  int sc, dc;
  float wr, wg, wb;
  void* out;
  unsigned grid;
  cudaStream_t stream;
};

struct Build {
  void (*launch)(const Call&);
  const void* fn;
  bool fixed;  // channel counts compiled in
};

template <typename Tin, typename Tout, int MODE, int SC, int DC>
void launch(const Call& c) {
  pixel_map_rows<Tin, Tout, MODE, SC, DC><<<c.grid, kThreads, 0, c.stream>>>(
      static_cast<const Tin*>(c.x), c.plan, c.sc, c.dc, c.wr, c.wg, c.wb,
      static_cast<Tout*>(c.out));
}

template <typename Tin, typename Tout, int MODE, int SC, int DC>
Build build() {
  return {&launch<Tin, Tout, MODE, SC, DC>,
          reinterpret_cast<const void*>(pixel_map_rows<Tin, Tout, MODE, SC, DC>), SC != 0};
}

// The signatures compiled in: colorConvert's pairs among the eight formats
// (uint8 / uint16 in and out, other channels or another type), the unpack
// heads (uint8 / uint16 -> float32) and pack tails (float32 -> uint8 /
// uint16) at equal channel counts, and the clip tails
template <typename Tin, typename Tout, int MODE, int SC, int DC>
constexpr bool compiled_in() {
  constexpr bool fin = std::is_same<Tin, float>::value, fout = std::is_same<Tout, float>::value;
  if (!fin && !fout) return SC != DC || !std::is_same<Tin, Tout>::value;
  if (!fin) return MODE == RAW && SC == DC;
  if (!fout) return SC == DC;
  return MODE == CLIP && SC == DC;
}

template <typename Tin, typename Tout, int MODE, int SC, int DC>
Build pick_sig() {
  if constexpr (compiled_in<Tin, Tout, MODE, SC, DC>())
    return build<Tin, Tout, MODE, SC, DC>();
  else
    return build<Tin, Tout, MODE, 0, 0>();
}

template <typename Tin, typename Tout, int MODE>
Build pick_channels(int sc, int dc) {
#define PICHA_SIG(S, D) \
  case S * 8 + D:       \
    return pick_sig<Tin, Tout, MODE, S, D>();
  switch (sc * 8 + dc) {
    PICHA_SIG(1, 1) PICHA_SIG(1, 2) PICHA_SIG(1, 3) PICHA_SIG(1, 4)
    PICHA_SIG(2, 1) PICHA_SIG(2, 2) PICHA_SIG(2, 3) PICHA_SIG(2, 4)
    PICHA_SIG(3, 1) PICHA_SIG(3, 2) PICHA_SIG(3, 3) PICHA_SIG(3, 4)
    PICHA_SIG(4, 1) PICHA_SIG(4, 2) PICHA_SIG(4, 3) PICHA_SIG(4, 4)
    default:
      return build<Tin, Tout, MODE, 0, 0>();
  }
#undef PICHA_SIG
}

template <typename Tin>
Build pick_out(int out_kind, int sc, int dc) {
  switch (out_kind) {
    case 0: return pick_channels<Tin, uint8_t, PACK>(sc, dc);
    case 1: return pick_channels<Tin, uint16_t, PACK>(sc, dc);
    case 2: return pick_channels<Tin, float, RAW>(sc, dc);
    default: return pick_channels<Tin, float, CLIP>(sc, dc);
  }
}

Build pick(int in_kind, int out_kind, int sc, int dc) {
  switch (in_kind) {
    case 0: return pick_out<uint8_t>(out_kind, sc, dc);
    case 1: return pick_out<uint16_t>(out_kind, sc, dc);
    default: return pick_out<float>(out_kind, sc, dc);
  }
}

int elem_bytes(int kind) { return kind == 0 ? 1 : (kind == 1 ? 2 : 4); }

// The plan fits the staged buffers and covers the window
bool plan_ok(const Plan& p, int bpi, int bpo) {
  if (p.seg_len < 1 || p.segs < 1 || p.segs_per_img < 1 || p.chunk < 1 || p.rows < 1 ||
      p.rows > kMaxRows || p.cps < 1 || p.img_stride < 0 || p.row_stride < 0 || p.base < 0)
    return false;
  const int64_t span = p.seg_len < p.chunk ? p.seg_len : p.chunk;
  if (p.rows > 1 && (p.cps != 1 || p.seg_len > p.chunk)) return false;
  if (p.cps != (p.seg_len + p.chunk - 1) / p.chunk) return false;
  if (p.items != (p.segs + p.rows - 1) / p.rows * p.cps) return false;
  return p.rows * ((30 + span * bpi) >> 4) * 16 <= kInBytes &&
         p.rows * span * bpo + 15 <= kOutBytes;
}

}  // namespace

// x: (n, h, w, sc) of in_kind 0 uint8, 1 uint16, 2 float32, cut into the
// plan's segments (ops/colorconvert.py::map_plan); out: the window's
// pixels, dense, dc channels of out_kind 0 uint8 (pack), 1 uint16 (pack),
// 2 float32 (as mapped), 3 float32 clipped to [0, 1]. sc, dc in 1..4; wr,
// wg, wb the luma weights. Returns a CUDA error code.
extern "C" int picha_pixel_map(const void* x, int in_kind, int sc, int dc, int out_kind,
                               int64_t seg_len, int64_t segs, int64_t segs_per_img,
                               int64_t img_stride, int64_t row_stride, int64_t base, int64_t cps,
                               int64_t items, int chunk, int rows, float wr, float wg, float wb,
                               void* out, void* stream) {
  const Plan p{seg_len, segs, segs_per_img, img_stride, row_stride, base, cps, items, chunk, rows};
  if (in_kind < 0 || in_kind > 2 || out_kind < 0 || out_kind > 3 || sc < 1 || sc > 4 ||
      dc < 1 || dc > 4 ||
      !plan_ok(p, sc * elem_bytes(in_kind), dc * (out_kind == 1 ? 2 : (out_kind == 0 ? 1 : 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Build b = pick(in_kind, out_kind, sc, dc);
  int per_sm = 0, sms = 0;
  const int rc = picha::occupancy(b.fn, kThreads, &per_sm, &sms);
  if (rc != 0) return rc;
  const int64_t cap = static_cast<int64_t>(per_sm) * sms;
  const Call c{x, p, sc, dc, wr, wg, wb, out,
               static_cast<unsigned>(items < cap ? items : cap), static_cast<cudaStream_t>(stream)};
  if (c.grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  b.launch(c);
  return static_cast<int>(cudaGetLastError());
}

// The build a signature launches: out[0] 1 if compiled in (0: the
// run-time channel body), out[1..5] its registers, local bytes, static
// shared bytes, threads and blocks an SM, out[6] the SMs, out[7] the
// kernels of the library's pixel map (every build), out[8..11] the limits
// the host plan keeps to (ops/colorconvert.py::map_plan): the bytes an
// item's staged rows and staged output hold, its segments, and a chunk's
// bytes. Returns a CUDA error code.
extern "C" int picha_pixel_map_info(int in_kind, int out_kind, int sc, int dc, int* out) {
  if (in_kind < 0 || in_kind > 2 || out_kind < 0 || out_kind > 3 || sc < 1 || sc > 4 ||
      dc < 1 || dc > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Build b = pick(in_kind, out_kind, sc, dc);
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, b.fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int per_sm = 0, sms = 0;
  const int orc = picha::occupancy(b.fn, kThreads, &per_sm, &sms);
  if (orc != 0) return orc;
  std::set<const void*> all;
  for (int i = 0; i < 3; ++i)
    for (int o = 0; o < 4; ++o)
      for (int s = 1; s <= 4; ++s)
        for (int d = 1; d <= 4; ++d) all.insert(pick(i, o, s, d).fn);
  out[0] = b.fixed;
  out[1] = fa.numRegs;
  out[2] = static_cast<int>(fa.localSizeBytes);
  out[3] = static_cast<int>(fa.sharedSizeBytes);
  out[4] = kThreads;
  out[5] = per_sm;
  out[6] = sms;
  out[7] = static_cast<int>(all.size());
  out[8] = kInBytes;
  out[9] = kOutBytes;
  out[10] = kMaxRows;
  out[11] = kChunkBytes;
  return 0;
}
