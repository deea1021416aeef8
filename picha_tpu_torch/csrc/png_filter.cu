// K12: the PNG encode filters over a batch of images, with the per-row
// adaptive pick.
//
// Replaces: picha_tpu/ops/png_filter_tpu.py::_build (:32-73), the device
// filter behind picha_tpu/pipeline/png_batch.py::encode_filtered. The
// encode direction predicts every byte from the ORIGINAL (unfiltered)
// neighbours, so each row is independent: a = the byte bpp to the left,
// b = the byte above, c = the byte above-left, each 0 outside the image
// (the first row's prev is zeros; a and c are 0 in the first bpp
// columns, and in every column of a row no wider than bpp). Residuals
// are (x - pred) & 0xFF for the five predictors none, sub (a), up (b),
// average ((a + b) >> 1) and Paeth (p = a + b - c; a when |p-a| <=
// |p-b| and |p-a| <= |p-c|, else b when |p-b| <= |p-c|, else c).
// Strategy 0..4 writes that filter's residuals; strategy -1 picks per row
// the filter with the least sum(min(v, 256 - v)) (the |int8| sum, int32),
// the first minimum in type order 0..4.
//
// What bounds it on an H100: memory traffic, one byte read (three with
// the neighbours, mostly from L1) and one written per byte; the
// adaptive pick adds ~40 integer operations per byte. The design: one
// block per (image, row). Its threads stride the row, each summing the
// five costs of its bytes; the five sums are reduced in shared memory
// by a fixed tree (integer sums, exact in any order); thread 0 writes
// the type byte, and every thread writes the chosen filter's residuals
// of its bytes (recomputed, not stored).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int predict(int f, int a, int b, int c) {
  switch (f) {
    case 0: return 0;
    case 1: return a;
    case 2: return b;
    case 3: return (a + b) >> 1;
    default: {
      const int p = a + b - c;
      const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
      if (pa <= pb && pa <= pc) return a;
      return pb <= pc ? b : c;
    }
  }
}

__global__ void __launch_bounds__(kThreads) png_filter_kernel(
    const uint8_t* __restrict__ src, int h, int rb, int bpp, int strategy,
    uint8_t* __restrict__ out) {
  const int64_t r = blockIdx.x;  // image * h + row
  const int y = static_cast<int>(r % h);
  const uint8_t* row = src + r * rb;
  const uint8_t* prev = y > 0 ? row - rb : nullptr;
  uint8_t* dst = out + r * (rb + 1);
  __shared__ int sums[5][kThreads];
  __shared__ int pick;

  int f = strategy;
  if (strategy < 0) {
    int cost[5] = {0, 0, 0, 0, 0};
    for (int i = threadIdx.x; i < rb; i += kThreads) {
      const int x = row[i];
      const int a = i >= bpp ? row[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      for (int k = 0; k < 5; ++k) {
        const int v = (x - predict(k, a, b, c)) & 0xFF;
        cost[k] += min(v, 256 - v);
      }
    }
    for (int k = 0; k < 5; ++k) sums[k][threadIdx.x] = cost[k];
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half)
        for (int k = 0; k < 5; ++k) sums[k][threadIdx.x] += sums[k][threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      int best = 0;
      for (int k = 1; k < 5; ++k)
        if (sums[k][0] < sums[best][0]) best = k;
      pick = best;
    }
    __syncthreads();
    f = pick;
  }
  if (threadIdx.x == 0) dst[0] = static_cast<uint8_t>(f);
  for (int i = threadIdx.x; i < rb; i += kThreads) {
    const int x = row[i];
    const int a = i >= bpp ? row[i - bpp] : 0;
    const int b = prev ? prev[i] : 0;
    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
    dst[1 + i] = static_cast<uint8_t>((x - predict(f, a, b, c)) & 0xFF);
  }
}

}  // namespace

// src: (n, h, rb) uint8 source rows; out: (n, h, rb + 1) uint8 filtered
// rows (type byte, then the residuals). strategy -1 (adaptive) or 0..4;
// bpp >= 1. Returns cudaGetLastError().
extern "C" int picha_png_filter(const void* src, int n, int h, int rb, int bpp,
                                int strategy, void* out, void* stream) {
  if (n < 0 || h < 1 || rb < 1 || bpp < 1 || strategy < -1 || strategy > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(n) * h;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  png_filter_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), h, rb, bpp, strategy, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
