// The card's occupancy for a kernel, asked once a (kernel, threads,
// device) and kept: the grids of K11 (pixel_map.cu) and of K27-K30's
// grid-stride launches (coef_restore.cu) are planned from it.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace picha {

// *per_sm: blocks of `threads` threads (no dynamic shared memory) of
// `fn` an SM holds at once; *sms: the current device's SMs. Returns a
// CUDA error code: a failed query is an error, and is not kept.
inline int occupancy(const void* fn, int threads, int* per_sm, int* sms) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, std::pair<int, int>> cache;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find({fn, threads, dev});
  if (it == cache.end()) {
    int b = 0, m = 0;
    rc = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, threads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    it = cache.emplace(std::make_tuple(fn, threads, dev), std::make_pair(b, m)).first;
  }
  *per_sm = it->second.first;
  *sms = it->second.second;
  return 0;
}

}  // namespace picha
