// K15: TIFF LZW strip decode, every strip of a batch in one launch.
//
// Replaces: the native host stage `native.lzw_decode` /
// `native.lzw_decode_multi` (picha_tpu/native/src/lzw.cc:85-169 and
// :176-190), which picha_tpu/codecs/tiff.py:158 and :312 call per strip
// ahead of the device transform of picha_tpu/pipeline/tiff_batch.py
// (`_jit_transform`, row 11c). The semantics are lzw.cc's: MSB-first
// codes of 9 to 12 bits, Clear 256, EOI 257, first free code 258; the
// decoder widens early, when its next free code reaches (1 << width) - 1;
// the first code after a Clear must be a literal; a code past the next
// free one is an error; output stops at the strip's cap and the rest of
// the stream is ignored, as libtiff does; the end of the input ends the
// strip without an error.
//
// Design: a block a strip, epoch by epoch. LZW looks serial, but within an
// epoch (the codes after a Clear, or from the strip's start) the
// decoder's state is a function of the code's index k alone:
// - code k has width 9 + [n >= 511] + [n >= 1023] + [n >= 2047], n =
//   min(257 + max(k, 1), 4096), so its bit offset is a closed form;
// - the next free code before it is min(257 + k, 4096), so the test for
//   an undefined code is local to the code;
// - step k >= 1 creates entry 257 + k, so a code c >= 258 names the string
//   of the code at index c - 258 plus one byte, the first byte of the code
//   at index c - 257.
// The block takes 4096 codes of an epoch at a time (a chunk): (1) each
// thread reads 8 consecutive codes at their offsets from the 4 aligned
// words that hold them;
// the first code that stops the chunk (Clear, EOI, the input's end, an
// undefined code) is a shared atomicMin of 4 k + kind; (2) lengths and
// first bytes by pointer jumping over k -> c_k - 258, one packed word a
// code in shared memory, updated in place (a word is read whole, old or
// new, and either keeps L[k] = D[k] + L[anc[k]]: at most 12 rounds, 2-3
// on noisy data); (3) output offsets by a block scan of the lengths; (4)
// each code writes its string backwards along its chain into a 16 KB
// window of the chunk's output in shared memory, which whole warps then
// store as consecutive bytes; the code whose output passes the cap
// writes only its bytes below the cap, so a strip writes nothing
// outside [out_off, out_off + cap). A Clear starts the next
// epoch at the bit after it; an epoch past 4096 codes (the table full, no
// Clear) goes on in further chunks against the first chunk's entries,
// which the full table freezes.
//
// What bounds it on an H100: latency, not bytes. Each strip's epochs run
// in order, and each epoch is a chain of block barriers (read, jump
// rounds, scan, expand, store) over dependent loads from L1 and shared
// memory: one strip of config 4 (12-13 epochs) takes 0.118 ms alone on
// the card, ~9 us an epoch, which is this design's floor for the batch.
// The card holds 3 strips an SM (40 registers under the launch bounds,
// with a 64-byte spill; a build for 2 blocks without the spill ran
// slower), so config 4's 1,792 strips run in 4.5 waves, and the strips
// sharing an SM stretch each other's barriers: 0.94 ms a batch against a
// bytes bound (segments in, rows out) of 0.065 ms. Staging the output
// (consecutive bytes a warp, where each code's thread alone would write
// bytes hundreds apart) took the long-string buckets from 1.73 to 0.81
// ms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;              // codes a pass: the table's size
constexpr int kPer = kChunk / kThreads;   // consecutive codes a thread
constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kNoStop = 0x7fffffff;
constexpr uint32_t kRoot = 1u << 31;      // info: kRoot | L << 8 | F, final
constexpr int kWindow = 16384;            // output bytes staged at a time
enum { kCleared = 0, kEnded = 1, kFailed = 2 };   // a stop key's low bits

// shared index of code j: a pad word after every 8, so a warp's threads
// (8 consecutive codes each) meet no bank twice
__device__ __forceinline__ int pad(int j) { return j + (j >> 3); }
constexpr int kPadded = kChunk + kChunk / 8;

__device__ __forceinline__ int code_width(int k) {
  return 9 + (k >= 254) + (k >= 766) + (k >= 1790);
}

// bit offset of code k from its epoch's first bit
__device__ __forceinline__ int64_t code_pos(int64_t k) {
  return 9 * k + max(k - 254, int64_t{0}) + max(k - 766, int64_t{0}) +
         max(k - 1790, int64_t{0});
}

// The output length of chunk code j (value c; s the chunk's stop): its own
// info word in an epoch's first chunk; past it (the table full, no new
// entries) one more than its entry's.
__device__ __forceinline__ uint32_t code_length(int j, int c, int s, bool first,
                                                const uint32_t* info) {
  if (j >= s) return 0u;
  if (first) return (info[pad(j)] >> 8) & 0x1fffu;
  return c < 256 ? 1u : ((info[pad(c - kFirst)] >> 8) & 0x1fffu) + 1u;
}

// Code value e's string, ending before chunk byte p, into the window
// [w0, w1) of the chunk's output staged at `stage`: backwards along its
// chain (byte F[e - 257], then the code at index e - 258), stopping at
// the window's start.
__device__ __forceinline__ void emit(int e, uint32_t p, uint32_t w0, uint32_t w1,
                                     uint8_t* stage, const uint16_t* code,
                                     const uint32_t* info) {
  for (; e >= kFirst; e = code[pad(e - kFirst)]) {
    if (--p < w1) stage[p - w0] = static_cast<uint8_t>(info[pad(e - 257)]);
    if (p == w0) return;
  }
  stage[p - 1 - w0] = static_cast<uint8_t>(e);
}

__global__ void __launch_bounds__(kThreads, 3) lzw_decode_kernel(
    const uint8_t* __restrict__ segs, const int64_t* __restrict__ seg_off,
    const int64_t* __restrict__ seg_len, const int64_t* __restrict__ out_off,
    const int64_t* __restrict__ cap, uint8_t* __restrict__ out, int* __restrict__ out_len,
    int* __restrict__ status) {
  __shared__ uint16_t code[kPadded];  // the epoch's first chunk
  __shared__ uint32_t info[kPadded];  // kRoot | L << 8 | F, or anc << 16 | D
  __shared__ uint8_t stage[kWindow];  // output bytes on their way out
  __shared__ uint32_t wsum[kWarps];
  __shared__ int stop[2];             // by chunk parity

  const int sidx = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = tid * kPer;
  const uint8_t* seg = segs + seg_off[sidx];
  const uint8_t* seg_end = seg + seg_len[sidx];
  const int64_t nbits = seg_len[sidx] * 8;
  uint8_t* o = out + out_off[sidx];
  const uint32_t lim = static_cast<uint32_t>(cap[sidx]);
  uint32_t written = 0;
  int rc = 0, parity = 0;
  int64_t start = 0;                  // the epoch's first bit
  if (tid < 2) stop[tid] = kNoStop;
  __syncthreads();

  for (bool done = false; !done;) {               // epochs
    for (int k0 = 0;; k0 += kChunk) {             // chunks of 4096 codes
      // 1. read codes k0 + j0 .. + kPer - 1 (at most 96 bits, MSB first)
      // from the 4 aligned words that hold them, loading only words that
      // hold a byte of the segment; the chunk's first stop
      const int64_t p0 = start + code_pos(k0 + j0);
      const uint8_t* at = seg + (p0 >> 3);
      const uint32_t* q = reinterpret_cast<const uint32_t*>(
          reinterpret_cast<uintptr_t>(at) & ~uintptr_t{3});
      uint32_t wd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* wa = reinterpret_cast<const uint8_t*>(q + i);
        wd[i] = wa < seg_end && wa + 4 > seg ? __byte_perm(__ldg(q + i), 0, 0x0123) : 0u;
      }
      uint64_t hi = static_cast<uint64_t>(wd[0]) << 32 | wd[1];
      uint64_t lo = static_cast<uint64_t>(wd[2]) << 32 | wd[3];
      const int s0 = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 3) * 8 +
                     static_cast<int>(p0 & 7);
      if (s0) {
        hi = hi << s0 | lo >> (64 - s0);
        lo <<= s0;
      }
      const int64_t rem = nbits - p0;     // bits left from the first code
      int c[kPer];
      int mine = kNoStop, used = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = k0 + j0 + i;
        const int w = code_width(k);
        used += w;
        c[i] = used <= rem ? static_cast<int>(hi >> (64 - w)) : -1;
        hi = hi << w | lo >> (64 - w);
        lo <<= w;
        const bool ends = c[i] < 0 || c[i] == kEoi;
        const bool stops = ends || c[i] == kClear || c[i] > 257 + k;
        if (stops && mine == kNoStop)
          mine = 4 * (j0 + i) + (c[i] == kClear ? kCleared : ends ? kEnded : kFailed);
        if (k0 == 0) {
          code[pad(j0 + i)] = static_cast<uint16_t>(c[i] < 0 ? kEoi : c[i]);
          info[pad(j0 + i)] = stops        ? kRoot
                         : c[i] < 256 ? kRoot | 1u << 8 | static_cast<uint32_t>(c[i])
                                      : static_cast<uint32_t>(c[i] - kFirst) << 16 | 1u;
        }
      }
      const int m = __reduce_min_sync(0xffffffffu, mine);
      if (lane == 0 && m != kNoStop) atomicMin(&stop[parity], m);
      if (tid == 0) stop[parity ^ 1] = kNoStop;   // the next chunk's slot
      __syncthreads();
      const int key = stop[parity];
      parity ^= 1;
      const int s = key == kNoStop ? kChunk : key >> 2;

      // 2. lengths (and first bytes, in info) of the codes before the stop
      if (k0 == 0) {
        volatile uint32_t* vi = info;
        bool open;
        do {
          open = false;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const uint32_t v = vi[pad(j0 + i)];
            if (v & kRoot) continue;
            const uint32_t a = vi[pad(static_cast<int>(v >> 16))];
            if (a & kRoot) {
              vi[pad(j0 + i)] = kRoot | (((a >> 8) & 0x1fffu) + (v & 0xffffu)) << 8 | (a & 0xffu);
            } else {
              vi[pad(j0 + i)] = (a & 0xffff0000u) | ((v & 0xffffu) + (a & 0xffffu));
              open = true;
            }
          }
        } while (__syncthreads_or(open));
      }
      // 3. output offsets: a block scan of the lengths
      uint32_t t = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) t += code_length(j0 + i, c[i], s, k0 == 0, info);
      uint32_t incl = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      uint32_t before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t x = wsum[w];
        before += w < warp ? x : 0u;
        total += x;
      }

      // 4. expand every code before the stop whose output starts below
      // the cap, the one that passes it only up to the cap: a window of
      // the chunk's output at a time, staged in shared memory by each
      // code's thread, then stored by whole warps (consecutive bytes)
      const uint32_t mine0 = before + incl - t;   // the thread's first byte
      const uint32_t out_n = min(total, lim - written);
      for (uint32_t w0 = 0; w0 < out_n; w0 += kWindow) {
        const uint32_t w1 = min(w0 + kWindow, out_n);
        uint32_t r = mine0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const uint32_t n = code_length(j0 + i, c[i], s, k0 == 0, info);
          if (n && r < w1 && r + n > w0) emit(c[i], r + n, w0, w1, stage, code, info);
          r += n;
        }
        __syncthreads();
        for (uint32_t x = tid; x < w1 - w0; x += kThreads) o[written + w0 + x] = stage[x];
        if (w1 < out_n) __syncthreads();
      }

      // 5. the next state, the same in every thread
      if (written + total > lim) {    // cut at the cap
        written = lim;
        done = true;
        break;
      }
      written += total;
      if (s < kChunk) {
        if ((key & 3) == kCleared) {
          start += code_pos(k0 + s) + code_width(k0 + s);
        } else {
          rc = (key & 3) == kFailed;
          done = true;
        }
        break;
      }
    }
    __syncthreads();                  // the next epoch rewrites code, info
  }
  if (tid == 0) {
    out_len[sidx] = static_cast<int>(written);
    status[sidx] = rc;
  }
}

}  // namespace

// segs: the batch's LZW strips back to back (uint8, any alignment); per
// strip s (each table int64): seg_off[s] and seg_len[s] into segs,
// out_off[s] into out, cap[s] the bytes the strip may write (< 2^31);
// out_len, status: (nstrips,) int32. Returns cudaGetLastError().
extern "C" int picha_lzw_decode(const void* segs, const void* seg_off, const void* seg_len,
                                const void* out_off, const void* cap, int nstrips, void* out,
                                void* out_len, void* status, void* stream) {
  if (nstrips < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nstrips == 0) return static_cast<int>(cudaGetLastError());
  lzw_decode_kernel<<<static_cast<unsigned>(nstrips), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(segs), static_cast<const int64_t*>(seg_off),
      static_cast<const int64_t*>(seg_len), static_cast<const int64_t*>(out_off),
      static_cast<const int64_t*>(cap), static_cast<uint8_t*>(out), static_cast<int*>(out_len),
      static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's build: out[0..4] = registers a thread, local (spill) bytes
// a thread, shared bytes a block, threads a block, resident blocks a
// multiprocessor. Launches nothing.
extern "C" int picha_lzw_decode_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, lzw_decode_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lzw_decode_kernel, kThreads, 0);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = blocks;
  return static_cast<int>(rc);
}
