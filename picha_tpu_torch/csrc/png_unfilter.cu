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
// else c). A type byte > 4 sets the image's status to 1 (the native
// function returns -1 there; the caller raises before reading the
// image, whose output is then undefined).
//
// What bounds it on an H100: the recurrence. Each byte depends on its
// left, upper and upper-left neighbours, so an image walked row after
// row is a chain of H x W pixel steps (98,304 at 384 x 256); the bytes
// moved take a fraction of the time of that chain.
//
// The design, a skewed row wavefront: pixel x of row y needs only row
// y - 1 at x and x - 1 and row y at x - 1, so rows can run together, each
// one pixel behind the row above: the chain is W + H steps, not W x H.
// One block an image. A warp takes a group of r = 32 / bpp rows, a
// thread (row j, byte lane l) walks row j's lane l; at step s row j
// reconstructs pixel s - j, its b is row j - 1's value of the step
// before (a shuffle up by bpp lanes), its c the previous step's b, its a
// its own previous value. Where every row of a group has one filter
// type (encoders mostly pick one: config 4's probe picks average for
// 255 rows of 256), the chain is compiled for it; where the types
// differ, the predictor is chosen without a branch. The row groups
// advance through column chunks of K pixels in block-wide phases: at
// phase p, group g takes chunk p - g (its warp is g mod the warps a
// block, so tall images wrap around the warps), and a __syncthreads()
// closes each phase. A group's first row reads the row above (the last
// row of group g - 1, written in the phase before) and every row its
// left and upper-left neighbours from the chunk before from the output
// in device memory. Residuals come into shared memory by 4-byte
// cp.async while those loads are in flight, the chunk's outputs are
// written back over them and stored by the whole warp. K and the warps
// a block come from the shape and the card's occupancy (`plan`). A bad
// type byte sets the status and its row runs as type 0: a warp that
// stopped would stall the block at the next barrier.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxChunk = 64;

// A row's bytes in shared memory: the chunk's K x bpp bytes at the
// misalignment m < 4 of its first byte in device memory, the 4-byte
// words that hold them copied whole; 12 more bytes keep the pitch an odd
// number of words (the rows of a warp in distinct banks) and the words
// of one row clear of the next.
__host__ __device__ constexpr int row_pitch(int chunk, int bpp) { return chunk * bpp + 12; }

// shared bytes a warp: r <= 32 / bpp rows, and the row above's chunk
// with the pixel before it, (K + 1) x bpp <= 8 (K + 1) bytes
__host__ __device__ constexpr int warp_bytes(int chunk) {
  return (32 * chunk + 12 * 32 + 8 * (chunk + 1) + 15) / 16 * 16;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

struct Plan {
  int warps, chunk;
};

constexpr int kMixed = 5;  // a group whose rows' filter types differ

// One item's chain: at step s, row j of the group reconstructs its
// pixel s - j (sp and ap advance a pixel a step: this row's byte in the
// staged chunk, and for row 0 the row above's). b is row j - 1's value
// of the step before (a shuffle up by bpp lanes), or the row above for
// row 0; c the previous b; a the previous value. T is the group's filter
// type when every row has it (1-4); at kMixed the predictor is chosen
// without a branch from the row's own type.
template <int T>
__device__ __forceinline__ void chain(uint8_t* sp, const uint8_t* ap, int j, int bpp,
                                      int todo, int steps, int type, int a, int cc) {
  const int ma = (type == 1 || type == 3) ? -1 : 0;
  const int mb = (type == 2 || type == 3) ? -1 : 0;
  const int sh = type == 3;
  int prev = 0;
#pragma unroll 2
  for (int s = 0; s < steps; ++s, sp += bpp, ap += bpp) {
    int up = 0;
    if (T != 1) up = __shfl_up_sync(0xffffffffu, prev, bpp);
    if (static_cast<unsigned>(s - j) < static_cast<unsigned>(todo)) {
      const int b = T == 1 ? 0 : (j == 0 ? *ap : up);
      int pred;
      if (T == 1) {
        pred = a;
      } else if (T == 2) {
        pred = b;
      } else if (T == 3) {
        pred = (a + b) >> 1;
      } else {
        const int pa = abs(b - cc), pb = abs(a - cc), pc = abs(a + b - 2 * cc);
        const int pp = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
        pred = (T == 4 || type == 4) ? pp : ((a & ma) + (b & mb)) >> sh;
      }
      const int v = (*sp + pred) & 0xff;
      *sp = static_cast<uint8_t>(v);
      a = v;
      cc = b;
      prev = v;
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32) png_unfilter_kernel(
    const uint8_t* __restrict__ src, int64_t src_image_stride, int h, int rb,
    int bpp, int chunk, uint8_t* out, int* __restrict__ status) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pitch = row_pitch(chunk, bpp);
  uint8_t* rows = smem + warp * warp_bytes(chunk);  // r rows at the pitch
  uint8_t* above = rows + 32 * chunk + 12 * 32;     // pixel cs - 1 .. cs + K - 1 of the row above
  const int r = 32 / bpp;
  const int j = lane / bpp, l = lane - j * bpp;     // row in the group, byte lane
  const bool lane_live = j < r;
  const int kbytes = chunk * bpp;
  const int npix = (rb + bpp - 1) / bpp;
  const int chunks = (npix + chunk - 1) / chunk;
  const int groups = (h + r - 1) / r;
  const int64_t img = blockIdx.x;
  const uint8_t* in_img = src + img * src_image_stride;
  uint8_t* out_img = out + img * static_cast<int64_t>(h) * rb;
  const bool words = (rb & 3) == 0;  // output rows and chunks 4-byte aligned
  bool bad = false;

  for (int p = 0; p < groups + chunks - 1; ++p) {
    for (int g = warp; g < groups; g += nw) {
      const int c = p - g;
      if (c < 0) break;
      if (c >= chunks) continue;
      const int y0 = g * r, x0 = c * kbytes;
      const int kb = min(kbytes, rb - x0);      // bytes of the chunk a row
      const int kpix = (kb + bpp - 1) / bpp;    // its pixels
      const int nrows = min(r, h - y0);
      // the residuals by cp.async, the 4-byte words that hold them
      for (int jj = 0; jj < nrows; ++jj) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            in_img + static_cast<int64_t>(y0 + jj) * (rb + 1) + 1 + x0);
        const uint32_t* w0 = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
        const int nwords = (static_cast<int>(a & 3) + kb + 3) >> 2;
        for (int w = lane; w < nwords; w += 32) cp_async4(rows + jj * pitch + 4 * w, w0 + w);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      // meanwhile the row above (zeros above the first row), and this
      // thread's row: type, a and c at the chunk's first pixel
      for (int x = lane; x < kb + bpp; x += 32) {
        const int xb = x0 - bpp + x;
        above[x] = (y0 > 0 && xb >= 0) ? out_img[static_cast<int64_t>(y0 - 1) * rb + xb] : 0;
      }
      const int y = y0 + j;
      const bool row_live = lane_live && j < nrows;
      int type = 0, a = 0, cc = 0, m = 0;
      if (row_live) {
        const uint8_t* row = in_img + static_cast<int64_t>(y) * (rb + 1);
        type = __ldg(row);
        m = static_cast<int>(reinterpret_cast<uintptr_t>(row + 1 + x0) & 3);
        if (type > 4) {
          bad = true;
          type = 0;
        }
        if (x0 > 0) {
          a = out_img[static_cast<int64_t>(y) * rb + x0 - bpp + l];
          if (y > 0) cc = out_img[static_cast<int64_t>(y - 1) * rb + x0 - bpp + l];
        }
      }
      // pixels this lane reconstructs, and its bytes at step 0 (pixel -j)
      const int todo = row_live && kb > l ? min(kpix, (kb - l + bpp - 1) / bpp) : 0;
      uint8_t* sp = rows + j * pitch + m + l - j * bpp;
      const uint8_t* ap = above + bpp + l;
      // the group's filter type where every row has it, else kMixed
      const int t0 = __shfl_sync(0xffffffffu, type, 0);
      const int kind = __all_sync(0xffffffffu, !row_live || type == t0) ? t0 : kMixed;
      asm volatile("cp.async.wait_all;\n" ::);
      __syncwarp();
      const int steps = kpix + nrows - 1;
      switch (kind) {
        case 0: break;  // none: the residuals are the bytes
        case 1: chain<1>(sp, ap, j, bpp, todo, steps, type, a, cc); break;
        case 2: chain<2>(sp, ap, j, bpp, todo, steps, type, a, cc); break;
        case 3: chain<3>(sp, ap, j, bpp, todo, steps, type, a, cc); break;
        case 4: chain<4>(sp, ap, j, bpp, todo, steps, type, a, cc); break;
        default: chain<kMixed>(sp, ap, j, bpp, todo, steps, type, a, cc); break;
      }
      __syncwarp();
      // the chunk's outputs, stored by the whole warp
      for (int jj = 0; jj < nrows; ++jj) {
        const uint8_t* srow = rows + jj * pitch;
        const int mj = static_cast<int>(reinterpret_cast<uintptr_t>(
            in_img + static_cast<int64_t>(y0 + jj) * (rb + 1) + 1 + x0) & 3);
        uint8_t* dst = out_img + static_cast<int64_t>(y0 + jj) * rb + x0;
        if (words) {
          const uint32_t* sw = reinterpret_cast<const uint32_t*>(srow);
          for (int w = lane; w < (kb >> 2); w += 32)
            reinterpret_cast<uint32_t*>(dst)[w] = __funnelshift_r(sw[w], sw[w + 1], 8 * mj);
        } else {
          for (int x = lane; x < kb; x += 32) dst[x] = srow[mj + x];
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
  if (bad) status[img] = 1;
}

constexpr int kMaxDevices = 64;
constexpr int kChunks = 4;  // chunk widths 8 << i pixels

// Per device, read once: whether the launch's dynamic shared memory is
// opted in there, its SM count, and the resident blocks an SM of each
// (warps, chunk width) launch, stored + 1 (0: not read yet).
std::atomic<bool> g_ready[kMaxDevices];
std::atomic<int> g_sms[kMaxDevices];
std::atomic<int> g_per_sm[kMaxDevices][kMaxWarps][kChunks];

cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_ready[*dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(png_unfilter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxWarps * warp_bytes(kMaxChunk));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err != cudaSuccess) return err;
  g_sms[*dev].store(sms, std::memory_order_relaxed);
  g_ready[*dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

// Resident blocks an SM of a launch of `warps` warps at chunk width
// 8 << ci on device dev.
cudaError_t blocks_per_sm(int dev, int warps, int ci, int* per_sm) {
  std::atomic<int>& slot = g_per_sm[dev][warps - 1][ci];
  const int known = slot.load(std::memory_order_relaxed);
  if (known > 0) {
    *per_sm = known - 1;
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, png_unfilter_kernel, warps * 32, warps * warp_bytes(8 << ci));
  if (err == cudaSuccess) slot.store(*per_sm + 1, std::memory_order_relaxed);
  return err;
}

// Chunk width K and warps a block for n images of this shape on the
// current device: the K whose waves x phases x (groups a warp a phase)
// x (K + r - 1 + the staging) is least, where a phase takes group g to
// chunk p - g, the warps are the groups a phase can use (up to 32), and
// a wave is the blocks the card holds at once.
cudaError_t plan(int n, int h, int rb, int bpp, Plan* best, int* best_per_sm) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  const int sms = g_sms[dev].load(std::memory_order_relaxed);
  const int r = 32 / bpp;
  const int groups = (h + r - 1) / r;
  const int npix = (rb + bpp - 1) / bpp;
  int64_t best_cost = -1;
  for (int ci = 0; ci < kChunks; ++ci) {
    const int k = 8 << ci;
    const int chunks = (npix + k - 1) / k;
    const int active = std::min(groups, chunks);
    const int warps = std::max(1, std::min(kMaxWarps, active));
    int per_sm = 0;
    err = blocks_per_sm(dev, warps, ci, &per_sm);
    if (err != cudaSuccess) return err;
    const int64_t wave = static_cast<int64_t>(sms) * std::max(per_sm, 1);
    const int64_t cost = (n + wave - 1) / wave * (groups + chunks - 1) *
                         ((active + warps - 1) / warps) * (k + r - 1 + k / 2 + 16);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *best = {warps, k};
      *best_per_sm = per_sm;
    }
  }
  return cudaSuccess;
}

}  // namespace

// src: n images of h filtered rows (type byte + rb residual bytes each),
// image i at src + i * src_image_stride; out: (n, h, rb) uint8
// reconstructed bytes; status: (n,) int32, zeroed by the caller, set to 1
// for an image with a filter type > 4. bpp in 1..8 (the PNG range).
// Returns the first failed runtime call's error, else cudaGetLastError().
extern "C" int picha_png_unfilter(const void* src, int64_t src_image_stride,
                                  int n, int h, int rb, int bpp, void* out,
                                  void* status, void* stream) {
  if (n < 0 || h < 1 || rb < 1 || bpp < 1 || bpp > 8 ||
      src_image_stride < static_cast<int64_t>(h) * (rb + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  Plan pl;
  int per_sm = 0;
  const cudaError_t err = plan(n, h, rb, bpp, &pl, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  png_unfilter_kernel<<<static_cast<unsigned>(n), pl.warps * 32,
                        pl.warps * warp_bytes(pl.chunk),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_image_stride, h, rb, bpp, pl.chunk,
      static_cast<uint8_t*>(out), static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}

// The launch picha_png_unfilter makes for n images of this shape, as the
// card reports it: out[0..7] = registers, local bytes a thread, dynamic
// shared bytes a block, resident blocks an SM, threads a block, chunk
// width in pixels, rows a warp, phases.
extern "C" int picha_png_unfilter_info(int n, int h, int rb, int bpp, int* out) {
  if (n < 1 || h < 1 || rb < 1 || bpp < 1 || bpp > 8) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int per_sm = 0;
  cudaError_t err = plan(n, h, rb, bpp, &pl, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = pl.warps * warp_bytes(pl.chunk);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, png_unfilter_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int r = 32 / bpp;
  const int npix = (rb + bpp - 1) / bpp;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = smem;
  out[3] = per_sm;
  out[4] = pl.warps * 32;
  out[5] = pl.chunk;
  out[6] = r;
  out[7] = (h + r - 1) / r + (npix + pl.chunk - 1) / pl.chunk - 1;
  return static_cast<int>(cudaGetLastError());
}
