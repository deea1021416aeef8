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
// free one, or equal to it once the table is full, is an error, and so is
// a stale (never written) entry; KwKwK copies byte by byte; output stops
// at the strip's cap and the rest of the stream is ignored, as libtiff
// does; the end of the input ends the strip without an error.
//
// What bounds it on an H100: the dependent chain of codes within a strip
// (each code's width and meaning depend on every earlier code), so
// latency, not bytes. Strips are independent (libtiff resets the table
// per strip), so the design is one thread per strip. Every table entry's
// expansion already sits contiguously in the strip's own output (entry =
// the previous emission plus the first byte of the next), so the table
// holds (output position, length) pairs, 4096 x 8 bytes of per-thread
// global scratch, and an emission is a forward copy from the output
// itself. Each strip writes its bytes into the (n, h, rowbytes) buffer at
// its row offset, its decoded length and a status (0 ok, 1 failed).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kTable = 4096;

struct BitReader {
  const uint8_t* p;
  int64_t len, pos;
  uint64_t acc;  // top `nbits` bits valid (left-aligned)
  int nbits;
  __device__ int read(int width) {
    while (nbits < width) {
      if (pos >= len) return -1;
      acc |= static_cast<uint64_t>(__ldg(p + pos)) << (56 - nbits);
      ++pos;
      nbits += 8;
    }
    const int v = static_cast<int>(acc >> (64 - width));
    acc <<= width;
    nbits -= width;
    return v;
  }
};

__global__ void __launch_bounds__(kThreads) lzw_decode_kernel(
    const uint8_t* __restrict__ segs, const int64_t* __restrict__ seg_off,
    const int64_t* __restrict__ seg_len, const int64_t* __restrict__ out_off,
    const int64_t* __restrict__ cap, int nstrips, uint8_t* out, uint2* __restrict__ scratch,
    int* __restrict__ out_len, int* __restrict__ status) {
  const int sidx = blockIdx.x * kThreads + threadIdx.x;
  if (sidx >= nstrips) return;
  uint2* table = scratch + static_cast<int64_t>(sidx) * kTable;  // (pos, len)
  BitReader br{segs + seg_off[sidx], seg_len[sidx], 0, 0, 0};
  uint8_t* o = out + out_off[sidx];
  const uint32_t outcap = static_cast<uint32_t>(cap[sidx]);
  uint32_t written = 0;
  int width = 9;
  int next = kFirst;
  int old_code = -1;
  uint32_t w_old = 0, len_old = 0;
  int rc = 0;

  for (;;) {
    const int code = br.read(width);
    if (code < 0 || code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      old_code = -1;
      continue;
    }
    if (old_code < 0) {
      if (code >= kFirst) { rc = 1; break; }
      if (written >= outcap) break;  // full: ignore the rest (libtiff)
      o[written] = static_cast<uint8_t>(code);
      w_old = written;
      len_old = 1;
      written += 1;
      old_code = code;
      continue;
    }
    if (code > next) { rc = 1; break; }  // undefined code
    if (code == next && next >= kTable) { rc = 1; break; }
    if (next < kTable) {
      // new entry = expansion(old) + first byte of this emission; both
      // sit adjacent in the output: [w_old, w_old + len_old + 1)
      table[next] = make_uint2(w_old, len_old + 1);
      ++next;
    }
    uint32_t n;
    if (code < 256) {
      if (written >= outcap) break;  // full: truncate like libtiff
      o[written] = static_cast<uint8_t>(code);
      n = 1;
    } else {
      const uint2 e = table[code];
      n = e.y;
      if (n == 0) { rc = 1; break; }  // stale entry
      if (written + n > outcap) {
        n = outcap - written;
        for (uint32_t i = 0; i < n; ++i) o[written + i] = o[e.x + i];
        written += n;
        break;
      }
      // forward byte copy: KwKwK (the entry's last byte is its first
      // output byte) reads what this loop has just written
      for (uint32_t i = 0; i < n; ++i) o[written + i] = o[e.x + i];
    }
    w_old = written;
    len_old = n;
    written += n;
    old_code = code;
    if (next == (1 << width) - 1 && width < 12) ++width;
  }
  out_len[sidx] = static_cast<int>(written);
  status[sidx] = rc;
}

}  // namespace

// segs: the batch's LZW strips back to back (uint8); per strip s (each
// table int64): seg_off[s] and seg_len[s] into segs, out_off[s] into out,
// cap[s] the bytes the strip may write (< 2^31); scratch:
// nstrips * 4096 * 8 bytes; out_len, status: (nstrips,) int32. Returns
// cudaGetLastError().
extern "C" int picha_lzw_decode(const void* segs, const void* seg_off, const void* seg_len,
                                const void* out_off, const void* cap, int nstrips, void* out,
                                void* scratch, void* out_len, void* status, void* stream) {
  if (nstrips < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nstrips == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((nstrips + kThreads - 1) / kThreads);
  lzw_decode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(segs), static_cast<const int64_t*>(seg_off),
      static_cast<const int64_t*>(seg_len), static_cast<const int64_t*>(out_off),
      static_cast<const int64_t*>(cap), nstrips, static_cast<uint8_t*>(out),
      static_cast<uint2*>(scratch), static_cast<int*>(out_len), static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}
