// The host JPEG writer of JpegBatchPipeline(encode_backend="raw420" |
// "tpu"): padded 4:2:0 planes (K31's buffer) or quantised coefficient
// planes (K2's) -> the baseline scan bytes of one image. Host C++ only, no
// device code: it is built into the kernel library by the same nvcc, so
// that the port needs no libjpeg (the card machine has none).
//
// Replaces the reference's host stages through libjpeg:
//   picha_jpeg_encode_raw420 (picha_tpu/native/src/jpegshim.cc:296-357,
//     jpeg_write_raw_data with jpeg_set_defaults + jpeg_set_quality(q,
//     TRUE) + raw_data_in): picha_host_jpeg_write_raw420;
//   picha_jpeg_coef_write (jpegshim.cc:533-620, jpeg_write_coefficients):
//     picha_host_jpeg_write_coefficients.
// With those settings libjpeg does three things, which this file does the
// same way: the integer "islow" forward DCT (jfdctint.c: CONST_BITS 13,
// PASS1_BITS 2, outputs scaled by 8), jcdctmgr.c's rounded division by
// quantval << 3, and a sequential Huffman scan with the JPEG Annex K
// tables, 0xFF bytes stuffed and the last byte padded with 1-bits.
// Blocks of the last MCU past a component's ceil(width / 8) x ceil(height
// / 8) grid are libjpeg's dummy blocks (jccoefct.c, jctrans.c): zero AC
// and the DC of the block before them, so they code a DC difference of 0
// and an end of block. The header is written by the caller
// (picha_tpu_torch/ops/jpeg_write.py::libjpeg_header). The numpy writer
// of that module is this file's plain version: the same bytes.
//
// What bounds it: one core's ~20 ns a coefficient (DCT, division) and a
// table lookup per Huffman symbol; the pipeline runs one image a call on
// its thread pool, and ctypes releases the GIL for the call.
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// zigzag position k -> natural (row-major) index (JPEG figure A.6)
const uint8_t kZigzagNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jfdctint.c's constants: FIX(x) = x * 2^13 rounded
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298631336 = 2446, F0390180644 = 3196, F0541196100 = 4433,
                  F0765366865 = 6270, F0899976223 = 7373, F1175875602 = 9633,
                  F1501321110 = 12299, F1847759065 = 15137, F1961570560 = 16069,
                  F2053119869 = 16819, F2562915447 = 20995, F3072711026 = 25172;

// libjpeg's INT32 arithmetic: samples - 128 times 2^13-scaled constants stay
// below 2^31
inline int32_t descale(int32_t x, int n) { return (x + (int32_t{1} << (n - 1))) >> n; }

// one 8-point pass over d[0], d[s], ..., d[7 s] (jpeg_fdct_islow's row pass
// when pass1, its column pass otherwise)
inline void fdct_pass(int32_t* d, int s, bool pass1) {
  const int32_t tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
  const int32_t tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
  const int32_t tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
  const int32_t tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
  const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int sh = pass1 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
  if (pass1) {
    d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    d[4 * s] = (tmp10 - tmp11) * (1 << kPass1Bits);
  } else {
    d[0] = descale(tmp10 + tmp11, kPass1Bits);
    d[4 * s] = descale(tmp10 - tmp11, kPass1Bits);
  }
  int32_t z1 = (tmp12 + tmp13) * F0541196100;
  d[2 * s] = descale(z1 + tmp13 * F0765366865, sh);
  d[6 * s] = descale(z1 - tmp12 * F1847759065, sh);
  z1 = tmp4 + tmp7;
  int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int32_t z5 = (z3 + z4) * F1175875602;
  const int32_t t4 = tmp4 * F0298631336, t5 = tmp5 * F2053119869;
  const int32_t t6 = tmp6 * F3072711026, t7 = tmp7 * F1501321110;
  z1 *= -F0899976223;
  z2 *= -F2562915447;
  z3 = z3 * -F1961570560 + z5;
  z4 = z4 * -F0390180644 + z5;
  d[7 * s] = descale(t4 + z1 + z3, sh);
  d[5 * s] = descale(t5 + z2 + z4, sh);
  d[3 * s] = descale(t6 + z2 + z3, sh);
  d[s] = descale(t7 + z1 + z4, sh);
}

// an 8x8 block of samples (row stride `stride`) -> quantised coefficients
// in natural order: islow fDCT of the samples - 128, then the rounded
// division by q << 3 (unsigned 32-bit: the magnitudes stay below 2^17)
void fdct_quant(const uint8_t* px, int64_t stride, const int32_t* qtab, int16_t* out) {
  int32_t d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[8 * r + c] = static_cast<int32_t>(px[r * stride + c]) - 128;
  for (int r = 0; r < 8; ++r) fdct_pass(d + 8 * r, 1, true);
  for (int c = 0; c < 8; ++c) fdct_pass(d + c, 8, false);
  for (int i = 0; i < 64; ++i) {
    const uint32_t q = static_cast<uint32_t>(qtab[i]) << 3;
    const int32_t x = d[i];
    const uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
    const int32_t v = static_cast<int32_t>((a + (q >> 1)) / q);
    out[i] = static_cast<int16_t>(x < 0 ? -v : v);
  }
}

// MSB-first bit writer with 0xFF stuffing into a caller-sized buffer
struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;
  int cnt = 0;
  bool full = false;

  void byte(uint8_t b) {
    if (n + 2 > cap) {
      full = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0;
  }
  void put(uint32_t code, int len) {
    if (len == 0) return;
    acc = (acc << len) | (code & ((1u << len) - 1u));
    cnt += len;
    while (cnt >= 8) {
      cnt -= 8;
      byte(static_cast<uint8_t>(acc >> cnt));
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (cnt > 0) put((1u << (8 - cnt)) - 1u, 8 - cnt);
  }
};

inline int bitsize(int v) {
  int a = v < 0 ? -v : v, s = 0;
  while (a) {
    ++s;
    a >>= 1;
  }
  return s;
}

// one block's DC difference and AC run-lengths; code rows: (len << 16 |
// code) of DC luma, DC chroma, AC luma, AC chroma
inline void encode_block(BitWriter& bw, const int16_t* blk, int diff, const int32_t* dc,
                         const int32_t* ac) {
  int s = bitsize(diff);
  bw.put(static_cast<uint32_t>(dc[s] & 0xFFFF), dc[s] >> 16);
  bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = blk ? blk[kZigzagNat[k]] : 0;
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(static_cast<uint32_t>(ac[0xF0] & 0xFFFF), ac[0xF0] >> 16);
      run -= 16;
    }
    s = bitsize(v);
    const int sym = (run << 4) | s;
    bw.put(static_cast<uint32_t>(ac[sym] & 0xFFFF), ac[sym] >> 16);
    bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run > 0) bw.put(static_cast<uint32_t>(ac[0] & 0xFFFF), ac[0] >> 16);
}

}  // namespace

// planes[c]: (bh[c], bw[c], 64) int16 quantised coefficients in natural
// order; hs / vs: sampling factors; code: (4, 256) int32 (len << 16 |
// code) rows DC luma, DC chroma, AC luma, AC chroma; out: cap bytes.
// Writes the interleaved baseline scan (MCUs of hs x vs blocks per
// component, dummy blocks past each grid, table 0 for component 0 and 1
// for the others; stuffed, 1-padded, no EOI) and its byte count. Returns
// 0, 1 when cap is too small, -1 for bad arguments.
extern "C" int picha_host_jpeg_write_coefficients(int ncomp, const int16_t* const* planes,
                                                  const int* bh, const int* bw, const int* hs,
                                                  const int* vs, const int32_t* code,
                                                  uint8_t* out, int64_t cap, int64_t* nbytes) {
  if (ncomp < 1 || ncomp > 4 || cap < 0) return -1;
  for (int c = 0; c < ncomp; ++c)
    if (bh[c] < 1 || bw[c] < 1 || hs[c] < 1 || vs[c] < 1) return -1;
  const int mcu_y = (bh[0] + vs[0] - 1) / vs[0], mcu_x = (bw[0] + hs[0] - 1) / hs[0];
  BitWriter w{out, cap};
  int pred[4] = {0, 0, 0, 0};
  for (int my = 0; my < mcu_y; ++my)
    for (int mx = 0; mx < mcu_x; ++mx)
      for (int c = 0; c < ncomp; ++c) {
        const int t = c == 0 ? 0 : 1;
        const int32_t *dc = code + 256 * t, *ac = code + 256 * (2 + t);
        for (int dy = 0; dy < vs[c]; ++dy)
          for (int dx = 0; dx < hs[c]; ++dx) {
            const int row = my * vs[c] + dy, col = mx * hs[c] + dx;
            if (row >= bh[c] || col >= bw[c]) {
              encode_block(w, nullptr, 0, dc, ac);  // dummy: DC of the block before
              continue;
            }
            const int16_t* blk = planes[c] + (static_cast<int64_t>(row) * bw[c] + col) * 64;
            encode_block(w, blk, blk[0] - pred[c], dc, ac);
            pred[c] = blk[0];
          }
      }
  w.flush();
  *nbytes = w.n;
  return w.full ? 1 : 0;
}

// y: (ceil16(eh), ceil16(ew)) uint8, cb / cr: half that (K31's planes);
// qluma / qchroma: (64,) int32 natural order; code and out as above. The
// islow fDCT and quantisation of each block of the ceil(w / 8) x ceil(h /
// 8) grids (Y at eh x ew, Cb / Cr at ceil(eh / 2) x ceil(ew / 2)), then the
// 4:2:0 scan.
extern "C" int picha_host_jpeg_write_raw420(const uint8_t* y, const uint8_t* cb,
                                            const uint8_t* cr, int ew, int eh,
                                            const int32_t* qluma, const int32_t* qchroma,
                                            const int32_t* code, uint8_t* out, int64_t cap,
                                            int64_t* nbytes) {
  if (ew < 1 || eh < 1) return -1;
  const int wpad = (ew + 15) & ~15;
  const int ch = (eh + 1) / 2, cw = (ew + 1) / 2;
  int bh[3] = {(eh + 7) / 8, (ch + 7) / 8, (ch + 7) / 8};
  int bw[3] = {(ew + 7) / 8, (cw + 7) / 8, (cw + 7) / 8};
  const int hs[3] = {2, 1, 1}, vs[3] = {2, 1, 1};
  const uint8_t* src[3] = {y, cb, cr};
  const int64_t stride[3] = {wpad, wpad / 2, wpad / 2};
  std::vector<int16_t> coefs[3];
  for (int c = 0; c < 3; ++c) {
    coefs[c].resize(static_cast<size_t>(bh[c]) * bw[c] * 64);
    const int32_t* q = c == 0 ? qluma : qchroma;
    for (int by = 0; by < bh[c]; ++by)
      for (int bx = 0; bx < bw[c]; ++bx)
        fdct_quant(src[c] + static_cast<int64_t>(by) * 8 * stride[c] + bx * 8, stride[c], q,
                   coefs[c].data() + (static_cast<size_t>(by) * bw[c] + bx) * 64);
  }
  const int16_t* planes[3] = {coefs[0].data(), coefs[1].data(), coefs[2].data()};
  return picha_host_jpeg_write_coefficients(3, planes, bh, bw, hs, vs, code, out, cap, nbytes);
}
