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
// What bounds it on an H100: memory traffic (a row's bytes read once and
// four bytes written per pixel). The predictor is a running sum along the
// row, so the design is one thread per (image, source row): it walks x,
// carrying the sums of the (at most five) samples the photometric reads,
// and writes each pixel as one 4-byte store at its oriented place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Args {
  const uint8_t* rows;
  int n, h, w;
  int64_t rb;
  int spp, bits, photometric, predictor, orientation, big_endian, has_extras;
  const uint8_t* cmap;  // (n, 1 << bits, 3) or null
  uint32_t* out;        // (n, h', w') rgba as one uint32 per pixel
};

__device__ __forceinline__ int to8(int v, int bits) {
  if (bits == 16) return v >> 8;
  if (bits == 8) return v;
  return (v * 255) / ((1 << bits) - 1);
}

__global__ void __launch_bounds__(kThreads) tiff_transform_kernel(Args a) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
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

}  // namespace

// rows: (n, h, rb) uint8 decompressed strip rows; spp >= 1; bits 1, 2, 4,
// 8 or 16; photometric 0, 1, 2, 3, 5 or 6 (with the samples it reads:
// 3 for rgb and YCbCr, 4 for CMYK); predictor 1, or 2 at 8 and 16 bits;
// orientation 1-8; cmap (n, 1 << bits, 3) uint8 for photometric 3; out:
// (n, h, w, 4) uint8 for orientations 1-4, (n, w, h, 4) for 5-8.
// Returns cudaGetLastError().
extern "C" int picha_tiff_transform(const void* rows, int n, int h, int w, int64_t rb,
                                    int spp, int bits, int photometric, int predictor,
                                    int orientation, int big_endian, int has_extras,
                                    const void* cmap, void* out, void* stream) {
  const bool bits_ok = bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16;
  const bool ph_ok = photometric == 0 || photometric == 1 || photometric == 2 ||
                     photometric == 3 || photometric == 5 || photometric == 6;
  if (n < 0 || h < 1 || w < 1 || spp < 1 || !bits_ok || !ph_ok ||
      (predictor != 1 && predictor != 2) || (predictor == 2 && bits < 8) ||
      orientation < 1 || orientation > 8 || (photometric == 3 && cmap == nullptr) ||
      ((photometric == 2 || photometric == 6) && spp < 3) ||
      (photometric == 5 && spp < 4) || rb * 8 < static_cast<int64_t>(w) * spp * bits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = static_cast<int64_t>(n) * h;
  if (threads == 0) return static_cast<int>(cudaGetLastError());
  Args a{static_cast<const uint8_t*>(rows), n, h, w, rb, spp, bits, photometric, predictor,
         orientation, big_endian, has_extras, static_cast<const uint8_t*>(cmap),
         static_cast<uint32_t*>(out)};
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  tiff_transform_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
