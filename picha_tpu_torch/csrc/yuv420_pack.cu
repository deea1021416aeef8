// K31: the 4:2:0 planes of JpegBatchPipeline(encode_backend="raw420"):
// the pixel stages' image -> one uint8 buffer per image holding the Y
// plane edge-padded to (ceil16(H), ceil16(W)), then Cb and Cr at half
// that, the input of the host JPEG writer (csrc/jpeg_write_host.cu).
//
// Replaces: the yuv420_out branch of picha_tpu/pipeline/jpeg_batch.py::
// _jit_batch_graph (:384-413): the u8 pack floor(clip(v + 0.5)) (float
// pixels; uint8 pixels as they are), jccolor's fixed-point RGB -> YCbCr
// (arithmetic >> 16), the edge pad of Y, Cb and Cr to the 16-multiples
// before the 2x2 box downsample ((sum + 2) >> 2) of Cb and Cr, and the
// concatenation; grey images give Y and constant 128 chroma planes.
//
// What bounds it on an H100: memory traffic, one read of the image (12 B
// a pixel as float32 RGB) and one write of 1.5 B a pixel. The design: one
// thread per chroma sample of the padded grid reads its 2x2 window of the
// image (coordinates clamped to the last row and column: the edge pad),
// writes its four Y bytes and its Cb and Cr byte. Integer colour maps as
// K2's; __fadd_rn keeps the pack's add out of any contraction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// libjpeg jccolor.c fixed point: FIX(x) = int(x * 65536 + 0.5)
constexpr int kFix0299 = 19595, kFix0587 = 38470, kFix0114 = 7471;
constexpr int kFix016874 = 11059, kFix033126 = 21709, kFix05 = 32768;
constexpr int kFix041869 = 27439, kFix008131 = 5329;
constexpr int kOneHalf = 32768;

__device__ __forceinline__ int sample(float v) {
  return static_cast<int>(floorf(fminf(fmaxf(__fadd_rn(v, 0.5f), 0.0f), 255.0f)));
}

__device__ __forceinline__ int sample(uint8_t v) { return v; }

template <typename T>
__global__ void yuv420_pack_kernel(const T* __restrict__ img, int n_img, int h, int w, int c,
                                   int hpad, int wpad, uint8_t* __restrict__ out) {
  const int cw = wpad / 2, ch = hpad / 2;
  const int64_t ysz = static_cast<int64_t>(hpad) * wpad, csz = static_cast<int64_t>(ch) * cw;
  const int64_t total = static_cast<int64_t>(n_img) * csz;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int cx = static_cast<int>(i % cw);
    const int cy = static_cast<int>((i / cw) % ch);
    const int64_t n = i / csz;
    const T* im = img + n * h * w * c;
    uint8_t* o = out + n * (ysz + 2 * csz);
    int sum_cb = 0, sum_cr = 0;
    for (int dy = 0; dy < 2; ++dy) {
      const int yy = 2 * cy + dy, sy = min(yy, h - 1);
      for (int dx = 0; dx < 2; ++dx) {
        const int xx = 2 * cx + dx, sx = min(xx, w - 1);
        const T* p = im + (static_cast<int64_t>(sy) * w + sx) * c;
        int luma;
        if (c == 1) {
          luma = sample(p[0]);
        } else {
          const int r = sample(p[0]), g = sample(p[1]), b = sample(p[2]);
          const int bias = (128 << 16) + kOneHalf - 1;
          luma = (kFix0299 * r + kFix0587 * g + kFix0114 * b + kOneHalf) >> 16;
          sum_cb += (-kFix016874 * r - kFix033126 * g + kFix05 * b + bias) >> 16;
          sum_cr += (kFix05 * r - kFix041869 * g - kFix008131 * b + bias) >> 16;
        }
        o[static_cast<int64_t>(yy) * wpad + xx] = static_cast<uint8_t>(luma);
      }
    }
    const int64_t at = static_cast<int64_t>(cy) * cw + cx;
    o[ysz + at] = static_cast<uint8_t>(c == 1 ? 128 : (sum_cb + 2) >> 2);
    o[ysz + csz + at] = static_cast<uint8_t>(c == 1 ? 128 : (sum_cr + 2) >> 2);
  }
}

}  // namespace

// img: (N, H, W, C) float32 (is_u8 0, the 0-255 scale) or uint8 (is_u8
// 1), C in {1, 3}; out: (N, hpad * wpad + 2 * (hpad / 2) * (wpad / 2))
// uint8 with hpad, wpad = H, W rounded up to 16. Returns
// cudaGetLastError().
extern "C" int picha_yuv420_pack(const void* img, int is_u8, int n_img, int h, int w, int c,
                                 void* out, void* stream) {
  if ((c != 1 && c != 3) || h < 1 || w < 1 || n_img < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hpad = (h + 15) & ~15, wpad = (w + 15) & ~15;
  const int64_t total = static_cast<int64_t>(n_img) * (hpad / 2) * (wpad / 2);
  if (total == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint8_t*>(out);
  if (is_u8)
    yuv420_pack_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(img), n_img, h, w,
                                                  c, hpad, wpad, o);
  else
    yuv420_pack_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(img), n_img, h, w, c,
                                                  hpad, wpad, o);
  return static_cast<int>(cudaGetLastError());
}
