// Loads of a byte stream at any alignment, for the PNG and TIFF transform
// kernels (K14, K16): their inputs are views into an upload buffer at any
// byte offset, so a thread's bytes are fetched as the aligned 16-byte words
// that hold them and funnel-shifted into place.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// `valid` bytes from p (any alignment) -> c[0 .. C/4) little-endian words,
// c[C/4] = 0 (the bytes past `valid` are whatever the loaded words hold).
// Loads only the aligned 16-byte words that hold a valid byte, so every
// word read lies in the allocation that holds p's bytes.
template <int C>
__device__ __forceinline__ void load_bytes(const uint8_t* p, int valid, uint32_t (&c)[C / 4 + 1]) {
  static_assert(C % 4 == 0, "whole words");
  constexpr int kWords = (C + 15) / 16 + 1;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int d = static_cast<int>(a & 15);
  const uint4* base = reinterpret_cast<const uint4*>(a - d);
  uint32_t v[4 * kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (valid > 0 && 16 * i < d + valid) u = __ldg(base + i);
    v[4 * i] = u.x;
    v[4 * i + 1] = u.y;
    v[4 * i + 2] = u.z;
    v[4 * i + 3] = u.w;
  }
  // down by d >> 2 words (a barrel of 2 then 1), then by d & 3 bytes
  const bool two = d & 8, one = d & 4;
#pragma unroll
  for (int k = 0; k + 2 < 4 * kWords; ++k) v[k] = two ? v[k + 2] : v[k];
#pragma unroll
  for (int k = 0; k + 1 < 4 * kWords; ++k) v[k] = one ? v[k + 1] : v[k];
  const unsigned s = (d & 3) * 8;
#pragma unroll
  for (int k = 0; k < C / 4; ++k) c[k] = __funnelshift_r(v[k], v[k + 1], s);
  c[C / 4] = 0u;
}

// the 4 bytes at byte offset O of c (compile-time)
template <int O, int N>
__device__ __forceinline__ uint32_t bytes_at(const uint32_t (&c)[N]) {
  static_assert(O / 4 + 1 < N, "inside c");
  return __funnelshift_r(c[O / 4], c[O / 4 + 1], (O % 4) * 8);
}

}  // namespace
