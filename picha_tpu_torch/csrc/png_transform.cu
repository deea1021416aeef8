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
// What bounds it on an H100: memory traffic (cin * bps bytes read and
// cout * (1 or 2) written per pixel; a few integer operations each). The
// design: one thread per pixel, grid-stride, the tables read through the
// read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const uint8_t* in;
  int64_t pixels;      // n * h * w
  int64_t image_px;    // h * w
  int bps, cin, palette, sub_byte_scale, depth16, src_alpha;
  int cout, out_color, out_alpha, deep;
  const uint8_t* pal;   // (n, 256, 3) or null
  const uint8_t* trns;  // (n, 256) or null
};

template <typename Tout>
__global__ void __launch_bounds__(kThreads) png_transform_kernel(Args a, Tout* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; p < a.pixels;
       p += stride) {
    const uint8_t* px = a.in + p * a.cin * a.bps;
    uint32_t s[4];
    for (int c = 0; c < a.cin; ++c)
      s[c] = a.bps == 2 ? (static_cast<uint32_t>(px[2 * c]) << 8) | px[2 * c + 1] : px[c];
    uint32_t color[3];
    int ncolor;
    uint32_t alpha = 0;
    bool has_alpha = false;
    uint32_t maxval = a.depth16 ? 65535u : 255u;
    if (a.palette) {
      const int64_t img = p / a.image_px;
      const uint32_t idx = s[0];
      const uint8_t* e = a.pal + (img * 256 + idx) * 3;
      color[0] = __ldg(e);
      color[1] = __ldg(e + 1);
      color[2] = __ldg(e + 2);
      ncolor = 3;
      if (a.trns) {
        alpha = __ldg(a.trns + img * 256 + idx);
        has_alpha = true;
      }
    } else {
      if (a.sub_byte_scale) s[0] = (s[0] * a.sub_byte_scale) & 0xFF;
      ncolor = a.src_alpha ? a.cin - 1 : a.cin;
      for (int c = 0; c < ncolor; ++c) color[c] = s[c];
      if (a.src_alpha) {
        alpha = s[a.cin - 1];
        has_alpha = true;
      }
    }
    uint32_t v[4];
    int k = 0;
    if (a.out_color) {
      if (ncolor == 1) {
        v[0] = v[1] = v[2] = color[0];
      } else {
        v[0] = color[0];
        v[1] = color[1];
        v[2] = color[2];
      }
      k = 3;
    } else {
      v[0] = ncolor == 3 ? (6968u * color[0] + 23434u * color[1] + 2366u * color[2] + 16384u) >> 15
                         : color[0];
      k = 1;
    }
    if (a.out_alpha) v[k++] = has_alpha ? alpha : maxval;
    Tout* o = out + p * a.cout;
    for (int c = 0; c < k; ++c)
      o[c] = static_cast<Tout>(a.deep ? v[c] : (a.depth16 ? v[c] >> 8 : v[c]));
  }
}

}  // namespace

// in: (n, h, w, cin * bps) uint8 sample bytes (bps 1, or 2 big-endian);
// colour_type 0 grey, 2 rgb, 3 palette, 4 grey+alpha, 6 rgba; depth 1, 2,
// 4, 8 or 16; out: (n, h, w, cout) uint8, or uint16 when deep; out_color
// / out_alpha say whether the target has colour / alpha channels; pal
// (n, 256, 3) uint8 and trns (n, 256) uint8 for a palette batch (trns may
// be null: no tRNS in the batch). Returns cudaGetLastError().
extern "C" int picha_png_transform(const void* in, int n, int h, int w, int color_type,
                                   int depth, const void* pal, const void* trns,
                                   int out_color, int out_alpha, int deep, void* out,
                                   void* stream) {
  int cin;
  switch (color_type) {
    case 0: case 3: cin = 1; break;
    case 2: cin = 3; break;
    case 4: cin = 2; break;
    case 6: cin = 4; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool palette = color_type == 3;
  if (n < 0 || h < 1 || w < 1 || (palette && pal == nullptr) ||
      !(depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16) ||
      (depth < 8 && color_type != 0 && color_type != 3) || (palette && depth == 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.in = static_cast<const uint8_t*>(in);
  a.image_px = static_cast<int64_t>(h) * w;
  a.pixels = static_cast<int64_t>(n) * a.image_px;
  a.bps = depth == 16 ? 2 : 1;
  a.cin = cin;
  a.palette = palette;
  a.sub_byte_scale = (color_type == 0 && depth < 8) ? 255 / ((1 << depth) - 1) : 0;
  a.depth16 = depth == 16;
  a.src_alpha = color_type == 4 || color_type == 6;
  a.out_color = out_color != 0;
  a.out_alpha = out_alpha != 0;
  a.cout = (a.out_color ? 3 : 1) + (a.out_alpha ? 1 : 0);
  a.deep = deep != 0;
  a.pal = static_cast<const uint8_t*>(pal);
  a.trns = static_cast<const uint8_t*>(trns);
  if (a.pixels == 0) return static_cast<int>(cudaGetLastError());
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (a.pixels + kThreads - 1) / kThreads;
  if (blocks > static_cast<int64_t>(sms) * 16) blocks = static_cast<int64_t>(sms) * 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.deep)
    png_transform_kernel<uint16_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, static_cast<uint16_t*>(out));
  else
    png_transform_kernel<uint8_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
