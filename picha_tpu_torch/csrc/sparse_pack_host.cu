// The host packers of the sparse coefficient wires (JpegBatchPipeline
// upload="gap8" and "gap4"): quantised coefficient planes -> the wire
// rows that the restore kernels K29 / K30 (coef_restore.cu) take apart on
// the device. Host C++ only, built into the kernel library by the same
// nvcc; the plain versions are the numpy packers of
// picha_tpu_torch/ops/coef_host.py, which give the same bytes.
//
// The port's copy of picha_tpu/native/src/sparsepack.cc (picha_gap8_pack,
// picha_gap4_batch_begin / _finish), without its AVX2 scan (the same
// bytes; the compiler here is not asked for AVX2). The wire, as the
// reference defines it:
//   gap8: one (gap u8, value i8) pair per nonzero, index = the running sum
//     of the gaps - 1; a gap past 255 inserts (255, 0) pairs; a value past
//     int8 is clamped and repaired by a (flat index i32, residual i16)
//     correction; a final (gap to n - 1, 0) pair pins the last index;
//   gap4: one byte per nonzero, gap << 4 | code, code 0-14 = value + 7 (7
//     adds zero: gap extensions (15 << 4 | 7) and the tail pin), 15 = an
//     escape whose value rides a gap8 side stream with its own gap chain
//     and corrections; batch rows padded with 0x07 (primary) and (0, 0)
//     (side), corrections laid out batch-flat with + j * n offsets and
//     padded with (nb * n - 1, 0).
// What bounds it: one pass over the coefficients on one core.
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct Packer {
  uint8_t* gaps;
  int8_t* vals;
  int32_t* corr_idx;
  int16_t* corr_val;
  size_t k = 0, c = 0;
  size_t prev = (size_t)-1;

  inline void emit(size_t i, int16_t v) {
    size_t gap = i - prev;
    while (gap > 255) {
      gaps[k] = 255;
      vals[k] = 0;
      ++k;
      gap -= 255;
    }
    int16_t v8 = v < -128 ? -128 : (v > 127 ? 127 : v);
    gaps[k] = (uint8_t)gap;
    vals[k] = (int8_t)v8;
    ++k;
    if (v != v8) {
      corr_idx[c] = (int32_t)i;
      corr_val[c] = (int16_t)(v - v8);
      ++c;
    }
    prev = i;
  }
};

// one plane's gap4 streams; corrections at corr_base + index, at most
// corr_cap of them written (all counted)
inline void gap4_one(const int16_t* coefs, size_t n, uint8_t* prim, size_t* nprim,
                     uint8_t* sgaps, int8_t* svals, size_t* nsec, int32_t* corr_idx,
                     int16_t* corr_val, size_t* ncorr, int64_t corr_base, size_t corr_cap) {
  size_t k = 0, s = 0, c = 0;
  size_t prev = (size_t)-1, sprev = (size_t)-1;
  for (size_t i = 0; i < n; ++i) {
    const int16_t v = coefs[i];
    if (v == 0) continue;
    size_t gap = i - prev;
    while (gap > 15) {
      prim[k++] = (15u << 4) | 7u;  // advance 15, add zero
      gap -= 15;
    }
    if (v >= -7 && v <= 7) {
      prim[k++] = ((uint8_t)gap << 4) | (uint8_t)(v + 7);
    } else {
      prim[k++] = ((uint8_t)gap << 4) | 15u;  // escape: side stream
      size_t sg = i - sprev;
      while (sg > 255) {
        sgaps[s] = 255;
        svals[s] = 0;
        ++s;
        sg -= 255;
      }
      const int16_t v8 = v < -128 ? -128 : (v > 127 ? 127 : v);
      sgaps[s] = (uint8_t)sg;
      svals[s] = (int8_t)v8;
      ++s;
      if (v != v8) {
        if (c < corr_cap) {
          corr_idx[c] = (int32_t)(corr_base + (int64_t)i);
          corr_val[c] = (int16_t)(v - v8);
        }
        ++c;
      }
      sprev = i;
    }
    prev = i;
  }
  {  // pin both tails at n-1 with zero adds, keeping indices sorted
    size_t gap = (n - 1) - prev;
    if (prev == (size_t)-1) gap = n;
    while (gap > 15) {
      prim[k++] = (15u << 4) | 7u;
      gap -= 15;
    }
    prim[k++] = ((uint8_t)gap << 4) | 7u;
    size_t sg = (n - 1) - sprev;
    if (sprev == (size_t)-1) sg = n;
    while (sg > 255) {
      sgaps[s] = 255;
      svals[s] = 0;
      ++s;
      sg -= 255;
    }
    sgaps[s] = (uint8_t)sg;
    svals[s] = 0;
    ++s;
  }
  *nprim = k;
  *nsec = s;
  *ncorr = c;
}

// a batch packed into worst-case-sized per-image scratch, behind a handle
// until the caller has sized the padded rows
struct Gap4Batch {
  int nb = 0;
  size_t n = 0;
  std::vector<std::unique_ptr<uint8_t[]>> prim, sgaps;
  std::vector<std::unique_ptr<int8_t[]>> svals;
  std::vector<std::unique_ptr<int32_t[]>> cidx;
  std::vector<std::unique_ptr<int16_t[]>> cval;
  std::vector<size_t> np_, ns_, nc_;
};

}  // namespace

// coefs: n int16 values -> gaps, vals (room for n + n / 255 + 2 each),
// corr_idx, corr_val (room for n each); *npairs, *ncorr: the counts.
// Returns 0.
extern "C" int picha_host_gap8_pack(const int16_t* coefs, size_t n, uint8_t* gaps, int8_t* vals,
                                    size_t* npairs, int32_t* corr_idx, int16_t* corr_val,
                                    size_t* ncorr) {
  Packer p{gaps, vals, corr_idx, corr_val};
  for (size_t i = 0; i < n; ++i)
    if (coefs[i] != 0) p.emit(i, coefs[i]);
  // pin the tail at index n-1 (zero value) so padded entries stay sorted
  size_t gap = (n - 1) - p.prev;  // prev == -1 (all zero) wraps to n
  while (gap > 255) {
    p.gaps[p.k] = 255;
    p.vals[p.k] = 0;
    ++p.k;
    gap -= 255;
  }
  p.gaps[p.k] = (uint8_t)gap;
  p.vals[p.k] = 0;
  ++p.k;
  *npairs = p.k;
  *ncorr = p.c;
  return 0;
}

// pack nb planes of n int16 values (coefs[j]) into per-image scratch;
// nprim, nsec, ncorr: (nb,) int64 out, the streams' lengths. Returns 0, or
// -2 when the batch-flat correction indices would pass int32.
extern "C" int picha_host_gap4_batch_begin(const int16_t* const* coefs, int nb, size_t n,
                                           void** handle, int64_t* nprim, int64_t* nsec,
                                           int64_t* ncorr) {
  if ((int64_t)nb * (int64_t)n > INT32_MAX) return -2;
  auto* h = new Gap4Batch;
  h->nb = nb;
  h->n = n;
  const size_t cap1 = n + n / 15 + 2, cap2 = n + n / 255 + 2;
  h->prim.resize(nb);
  h->sgaps.resize(nb);
  h->svals.resize(nb);
  h->cidx.resize(nb);
  h->cval.resize(nb);
  h->np_.resize(nb);
  h->ns_.resize(nb);
  h->nc_.resize(nb);
  for (int j = 0; j < nb; ++j) {
    h->prim[j].reset(new uint8_t[cap1]);
    h->sgaps[j].reset(new uint8_t[cap2]);
    h->svals[j].reset(new int8_t[cap2]);
    size_t ccap = n / 64 + 256;
    h->cidx[j].reset(new int32_t[ccap]);
    h->cval[j].reset(new int16_t[ccap]);
    size_t k = 0, s = 0, c = 0;
    gap4_one(coefs[j], n, h->prim[j].get(), &k, h->sgaps[j].get(), h->svals[j].get(), &s,
             h->cidx[j].get(), h->cval[j].get(), &c, (int64_t)j * (int64_t)n, ccap);
    if (c > ccap) {  // corrections are rare; re-pack with exact room
      ccap = c;
      h->cidx[j].reset(new int32_t[ccap]);
      h->cval[j].reset(new int16_t[ccap]);
      k = s = c = 0;
      gap4_one(coefs[j], n, h->prim[j].get(), &k, h->sgaps[j].get(), h->svals[j].get(), &s,
               h->cidx[j].get(), h->cval[j].get(), &c, (int64_t)j * (int64_t)n, ccap);
    }
    h->np_[j] = k;
    h->ns_[j] = s;
    h->nc_[j] = c;
    nprim[j] = (int64_t)k;
    nsec[j] = (int64_t)s;
    ncorr[j] = (int64_t)c;
  }
  *handle = h;
  return 0;
}

// the handle's streams into their padded rows: prim (nb, k1) u8, sgaps /
// svals (nb, k2), corrections (kc,) batch-flat; frees the handle. Returns
// 0, or 1 when a stream does not fit its row.
extern "C" int picha_host_gap4_batch_finish(void* handle, uint8_t* prim, size_t k1,
                                            uint8_t* sgaps, int8_t* svals, size_t k2,
                                            int32_t* corr_idx, int16_t* corr_val, size_t kc) {
  auto* h = static_cast<Gap4Batch*>(handle);
  size_t c_off = 0;
  int rc = 0;
  for (int j = 0; j < h->nb; ++j) {
    const size_t k = h->np_[j], s = h->ns_[j], c = h->nc_[j];
    if (k > k1 || s > k2 || c_off + c > kc) {
      rc = 1;
      break;
    }
    memcpy(prim + (size_t)j * k1, h->prim[j].get(), k);
    memset(prim + (size_t)j * k1 + k, 0x07, k1 - k);
    memcpy(sgaps + (size_t)j * k2, h->sgaps[j].get(), s);
    memset(sgaps + (size_t)j * k2 + s, 0, k2 - s);
    memcpy(svals + (size_t)j * k2, h->svals[j].get(), s);
    memset(svals + (size_t)j * k2 + s, 0, k2 - s);
    memcpy(corr_idx + c_off, h->cidx[j].get(), c * sizeof(int32_t));
    memcpy(corr_val + c_off, h->cval[j].get(), c * sizeof(int16_t));
    c_off += c;
  }
  if (rc == 0)
    for (; c_off < kc; ++c_off) {
      corr_idx[c_off] = (int32_t)((int64_t)h->nb * (int64_t)h->n - 1);
      corr_val[c_off] = 0;
    }
  delete h;
  return rc;
}
