// K13: PNG filter reconstruction (unfilter) over a batch of images.
//
// Replaces: the native host stage `native.png_unfilter`
// (picha_tpu/native/src/pngfilter.cc:110-221, `picha_png_unfilter`),
// which picha_tpu/codecs/png.py:169 calls per image (and per Adam7 pass)
// ahead of the device transform of picha_tpu/pipeline/png_batch.py
// (`_jit_transform`, row 11c). Each row is a filter type byte and the
// residuals; out = (residual + pred) & 0xFF, with a = the reconstructed
// byte bpp to the left, b = the reconstructed byte above, c = above-left
// (a and c are 0 in the first bpp columns, b and c on the first row):
// none 0, sub a, up b, average (a + b) >> 1 in int, Paeth (p = a + b - c;
// a when |p-a| <= |p-b| and |p-a| <= |p-c|, else b when |p-b| <= |p-c|,
// else c). A type byte > 4 sets the image's status to 1 and stops that
// image, as the native function returns -1.
//
// What bounds it on an H100: the recurrence. Rows are in order, and in a
// sub, average or Paeth row each of the bpp byte lanes (x = lane mod bpp)
// is a dependent chain along x; the bytes moved (each input read once,
// each output written once) are far below the time of the chains. The
// design: one block per image walks its rows in order. A none or up row
// has no chain, so all threads of the block take its bytes at once. A
// sub, average or Paeth row goes in tiles: the block copies the tile's
// residuals and the row above into shared memory, then bpp threads walk
// their lanes through the tile, carrying a and c in registers from one
// tile to the next, and the block writes the tile back. __syncthreads()
// between rows makes each row visible to the next.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

__global__ void __launch_bounds__(kThreads) png_unfilter_kernel(
    const uint8_t* __restrict__ src, int64_t src_image_stride, int h, int rb,
    int bpp, uint8_t* __restrict__ out, int* __restrict__ status) {
  __shared__ uint8_t s_in[kTile];
  __shared__ uint8_t s_up[kTile];
  __shared__ uint8_t s_out[kTile];
  const int64_t img = blockIdx.x;
  const uint8_t* in_img = src + img * src_image_stride;
  uint8_t* out_img = out + img * static_cast<int64_t>(h) * rb;
  const int t = threadIdx.x;

  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in_img + static_cast<int64_t>(y) * (rb + 1);
    const uint8_t* res = row + 1;
    uint8_t* dst = out_img + static_cast<int64_t>(y) * rb;
    const uint8_t* up = y > 0 ? dst - rb : nullptr;
    const int type = row[0];  // the same for every thread of the block
    if (type > 4) {
      if (t == 0) status[img] = 1;
      return;
    }
    if (type == 0 || type == 2) {
      for (int i = t; i < rb; i += kThreads)
        dst[i] = static_cast<uint8_t>(res[i] + (type == 2 && up ? up[i] : 0));
    } else {
      int a = 0, c = 0;  // this lane's left and above-left (thread t < bpp)
      for (int t0 = 0; t0 < rb; t0 += kTile) {
        const int len = min(kTile, rb - t0);
        for (int i = t; i < len; i += kThreads) {
          s_in[i] = res[t0 + i];
          s_up[i] = up ? up[t0 + i] : 0;
        }
        __syncthreads();
        if (t < bpp) {
          // this lane's first x in the tile: x = t0 + i with x % bpp == t
          int i = (t - t0 % bpp + bpp) % bpp;
          for (; i < len; i += bpp) {
            const int b = s_up[i];
            int pred;
            if (type == 1) pred = a;
            else if (type == 3) pred = (a + b) >> 1;
            else pred = paeth(a, b, c);
            const int v = (s_in[i] + pred) & 0xFF;
            s_out[i] = static_cast<uint8_t>(v);
            a = v;
            c = b;
          }
        }
        __syncthreads();
        for (int i = t; i < len; i += kThreads) dst[t0 + i] = s_out[i];
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

}  // namespace

// src: n images of h filtered rows (type byte + rb residual bytes each),
// image i at src + i * src_image_stride; out: (n, h, rb) uint8
// reconstructed bytes; status: (n,) int32, zeroed by the caller, set to 1
// for an image with a filter type > 4. bpp >= 1. Returns
// cudaGetLastError().
extern "C" int picha_png_unfilter(const void* src, int64_t src_image_stride,
                                  int n, int h, int rb, int bpp, void* out,
                                  void* status, void* stream) {
  if (n < 0 || h < 1 || rb < 1 || bpp < 1 ||
      src_image_stride < static_cast<int64_t>(h) * (rb + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  png_unfilter_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_image_stride, h, rb, bpp,
      static_cast<uint8_t*>(out), static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}
