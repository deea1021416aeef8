// K2: JPEG encoder front — u8 pack, RGB->YCbCr, 2x2 chroma downsample,
// 8x8 block edge padding, forward DCT and quantisation.
//
// Replaces: picha_tpu/ops/jpeg_tpu.py::_jit_encode (rgb_to_ycbcr,
// box_downsample_2x2, plane_to_blocks, fdct_quant) together with the
// u8 pack of picha_tpu/pipeline/jpeg_batch.py (floor(clip(v+0.5))).
// The TPU graph materialises the packed image, the three full-size
// planes, the padded block tensors and runs the 64x64 Kronecker fDCT
// as one large matmul on the MXU.
//
// The arithmetic, fixed since the first port: coefficient k of a block
// is the p-ordered chain f = fmaf(s[p], kron[k][p], f) from f = 0 over
// its 64 samples s[p] = pack - 128 (pack, jccolor fixed point in int32
// with arithmetic >> 16, chroma 2x2 average (+2) >> 2, edge replication
// into partial blocks and MCUs), then rintf(f / q) (round half to even,
// like torch.round). A coefficient may differ from the plain version's
// matmul by one where f / q lies within f32 rounding of a .5 tie.
//
// What bounds it on an H100: one read of the float image (12 B a pixel
// at 3 channels) and one write of the int16 coefficients (3 B a pixel at
// 4:2:0): 0.037 ms for 16 images at 960x544. The 64 FMAs a coefficient
// are 0.024 ms at 67 TFLOP/s. Measured on an H100 (tools/
// torch_encode_variants.py: clock64 around each phase of a tile, and
// builds without a phase), the fDCT takes about a third of the kernel's
// time and the rest goes to issuing the pixel loads 16 bytes a thread,
// to converting and to the IEEE division of every coefficient; without
// its loads the kernel still takes 0.077 of its 0.094 ms, and the loads
// alone run at ~2 TB/s with one tile in flight a CTA.
//
// The design: a persistent grid of 256-thread CTAs, two an SM, walks
// tiles of whole MCUs in raster order (16 MCUs of 16x16 pixels at 4:2:0,
// 96 8x8 blocks for grey; 96 sample blocks a tile either way). A tile's
// float pixels arrive once, by 16-byte cp.async (rows clamped to the
// image, columns past it not loaded; rows padded so that a warp's
// 16-byte reads hit distinct banks), while the previous tile's fDCT
// runs (bulk copies by a loader warp, and a ring of three tiles on one
// CTA an SM, measured no faster). A thread then
// converts 2 rows x 4 pixels of an MCU inside the image from six 16-byte
// shared loads: the pack is an add rounded down at 2^23 scale on the FP32
// pipe, the jccolor sums run on the packed floats' bits (the 2^23 bias
// cancels mod 2^32, as the weights sum to 65536 or to 0), and one read
// gives four Y samples (stored as a float4) and the Cb and Cr of two
// quads. Edge MCUs take the per-pixel path with the plain version's
// clamps. The fDCT is register-tiled: each thread owns four coefficients
// of six blocks (one MCU), each step loads four p's of its four
// Kronecker rows and of its six samples rows as float4 and issues 96
// FMAs. Quotients go back into the blocks' sample rows as int16, and each
// warp stores its 12 blocks as 16-byte pieces, whole 128-byte blocks a
// warp instruction. The grid is planned from the card's occupancy once a
// device and layout.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBlocks = 96;             // sample blocks a tile
constexpr int kRow = 68;                    // floats a staged block (64 + pad)

template <bool kColour>
struct Layout {
  static constexpr int kUnit = kColour ? 16 : 8;          // pixels a unit side
  static constexpr int kUnits = kColour ? 16 : 96;        // units a tile
  static constexpr int kC = kColour ? 3 : 1;
  static constexpr int kChunks = kUnit * kC / 4;          // 16-byte pieces a row
  static constexpr int kStride = kColour ? 56 : 8;        // floats a staged row
  static constexpr int kRawFloats = kUnits * kUnit * kStride;
  static constexpr size_t kSmem =
      (kRawFloats + kTileBlocks * kRow + 16 * 64 * 4 + 2 * 64) * sizeof(float);
};

// libjpeg jccolor.c fixed point: FIX(x) = int(x * 65536 + 0.5)
constexpr unsigned kFix0299 = 19595, kFix0587 = 38470, kFix0114 = 7471;
constexpr unsigned kFix016874 = 11059, kFix033126 = 21709, kFix05 = 32768;
constexpr unsigned kFix041869 = 27439, kFix008131 = 5329;
constexpr unsigned kOneHalf = 32768, kChromaBias = (128u << 16) + kOneHalf - 1;
constexpr float kMagic = 12582912.0f;       // 1.5 * 2^23: integers in the mantissa
constexpr unsigned kMagicBits = 0x4B400000u;

// floor(clip(v + 0.5, 0, 255)) + kMagicBits, on the FP32 pipe: the add
// rounded down at 2^23 scale is the floor (floorf and the float-to-int
// conversion issue at a quarter of the FMA rate)
__device__ __forceinline__ unsigned pack(float v) {
  const float c = fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
  return __float_as_uint(__fadd_rd(c, kMagic));
}

// the jccolor sums of biased samples (pack's): exact mod 2^32, since the
// bias has 16 low zero bits and the weights sum to 65536 (Y) or 0 (Cb,
// Cr), and each true sum lies in [0, 2^24)
__device__ __forceinline__ int luma(unsigned r, unsigned g, unsigned b) {
  return static_cast<int>((kFix0299 * r + kFix0587 * g + kFix0114 * b + kOneHalf) >> 16);
}

__device__ __forceinline__ int cb_of(unsigned r, unsigned g, unsigned b) {
  return static_cast<int>((kFix05 * b - kFix016874 * r - kFix033126 * g + kChromaBias) >> 16);
}

__device__ __forceinline__ int cr_of(unsigned r, unsigned g, unsigned b) {
  return static_cast<int>((kFix05 * r - kFix041869 * g - kFix008131 * b + kChromaBias) >> 16);
}

// a sample 0..255 as float(s - 128), exactly
__device__ __forceinline__ float centred(int s) {
  return __uint_as_float(kMagicBits + static_cast<unsigned>(s)) - (kMagic + 128.0f);
}

// a grey pixel's centred sample
__device__ __forceinline__ float grey(float v) { return __uint_as_float(pack(v)) - (kMagic + 128.0f); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

struct Geom {
  int h, w, uh, uw, ybh, ybw, n_tiles, vec;
  long long units;
};

// one tile's units: image, unit row and column (n < 0: past the batch),
// the float offset of the unit's first pixel, its rows and columns
// inside the image
struct Units {
  long long base[kTileBlocks];
  int n[kTileBlocks], uy[kTileBlocks], ux[kTileBlocks], vy[kTileBlocks], vx[kTileBlocks];
};

template <bool kColour>
__device__ void unit_info(const Geom& g, int tile, Units& u) {
  using L = Layout<kColour>;
  for (int i = threadIdx.x; i < L::kUnits; i += kThreads) {
    const long long q = static_cast<long long>(tile) * L::kUnits + i;
    if (q >= g.units) {
      u.n[i] = -1;
      continue;
    }
    const long long per = static_cast<long long>(g.uh) * g.uw;
    const int n = static_cast<int>(q / per);
    const int rem = static_cast<int>(q - n * per);
    const int uy = rem / g.uw, ux = rem - uy * g.uw;
    u.n[i] = n;
    u.uy[i] = uy;
    u.ux[i] = ux;
    u.vy[i] = min(L::kUnit, g.h - L::kUnit * uy);
    u.vx[i] = min(L::kUnit, g.w - L::kUnit * ux);
    u.base[i] = ((static_cast<long long>(n) * g.h + L::kUnit * uy) * g.w + L::kUnit * ux) * L::kC;
  }
}

// raw[i][r][kStride]: row r of unit i (rows past the image repeat its
// last row; columns past it are left unloaded)
template <bool kColour>
__device__ void load_tile(const float* __restrict__ img, const Geom& g, const Units& u,
                          float* raw) {
  using L = Layout<kColour>;
  constexpr int kPerRow = L::kUnits * L::kChunks;
  for (int q = threadIdx.x; q < L::kUnit * kPerRow; q += kThreads) {
    const int r = q / kPerRow, rem = q - r * kPerRow;
    const int i = rem / L::kChunks, ch = rem - i * L::kChunks;
    if (u.n[i] < 0 || ch * 4 >= u.vx[i] * L::kC) continue;
    const float* src = img + u.base[i] + static_cast<long long>(min(r, u.vy[i] - 1)) * g.w * L::kC;
    float* dst = raw + (i * L::kUnit + r) * L::kStride + ch * 4;
    if (g.vec) {
      cp_async16(dst, src + ch * 4);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (ch * 4 + e < u.vx[i] * L::kC) dst[e] = src[ch * 4 + e];
    }
  }
  cp_commit();
}

// raw pixels -> centred samples smp[b][p], b = 6 * unit + (Y0 Y1 Y2 Y3 Cb
// Cr) at 4:2:0, b = unit for grey
template <bool kColour>
__device__ void convert_tile(const Geom& g, const Units& u, const float* raw, float* smp) {
  using L = Layout<kColour>;
  constexpr int kS = L::kStride;
  if constexpr (kColour) {
    const int ch = (g.h + 1) >> 1, cw = (g.w + 1) >> 1;
    // an item: rows 2 rp and 2 rp + 1, pixels 4 cq .. 4 cq + 3 of unit i
    for (int e = threadIdx.x; e < L::kUnits * 32; e += kThreads) {
      const int i = e >> 5, rp = (e >> 2) & 7, cq = e & 3;
      if (u.n[i] < 0) continue;
      float* ys = smp + (i * 6 + (rp >> 2) * 2 + (cq >> 1)) * kRow + (2 * rp & 7) * 8 + 4 * (cq & 1);
      float* cs = smp + (i * 6 + 4) * kRow + rp * 8 + 2 * cq;
      if (u.vx[i] == 16 && u.vy[i] == 16) {
        int sb[2] = {0, 0}, sr[2] = {0, 0};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const float4* row = reinterpret_cast<const float4*>(raw + (i * 16 + 2 * rp + dy) * kS + 12 * cq);
          const float4 a = row[0], b = row[1], c = row[2];
          const float v[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
          float y[4];
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const unsigned rr = pack(v[3 * d]), gg = pack(v[3 * d + 1]), bb = pack(v[3 * d + 2]);
            y[d] = centred(luma(rr, gg, bb));
            sb[d >> 1] += cb_of(rr, gg, bb);
            sr[d >> 1] += cr_of(rr, gg, bb);
          }
          *reinterpret_cast<float4*>(ys + dy * 8) = make_float4(y[0], y[1], y[2], y[3]);
        }
        *reinterpret_cast<float2*>(cs) = make_float2(centred((sb[0] + 2) >> 2), centred((sb[1] + 2) >> 2));
        *reinterpret_cast<float2*>(cs + kRow) =
            make_float2(centred((sr[0] + 2) >> 2), centred((sr[1] + 2) >> 2));
        continue;
      }
      // an MCU cut by the image's edge: columns (and chroma rows) clamped
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float* px = raw + (i * 16 + 2 * rp + dy) * kS + 3 * min(4 * cq + d, u.vx[i] - 1);
          ys[dy * 8 + d] = centred(luma(pack(px[0]), pack(px[1]), pack(px[2])));
        }
      }
      const int r0 = 2 * min(rp, ch - 8 * u.uy[i] - 1);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c0 = 2 * min(2 * cq + t, cw - 8 * u.ux[i] - 1);
        int sb = 0, sr = 0;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float* px = raw + (i * 16 + r0 + dy) * kS + 3 * min(c0 + dx, u.vx[i] - 1);
            const unsigned rr = pack(px[0]), gg = pack(px[1]), bb = pack(px[2]);
            sb += cb_of(rr, gg, bb);
            sr += cr_of(rr, gg, bb);
          }
        }
        cs[t] = centred((sb + 2) >> 2);
        cs[kRow + t] = centred((sr + 2) >> 2);
      }
    }
  } else {
    // an item: 4 pixels of a row
    for (int e = threadIdx.x; e < L::kUnits * 16; e += kThreads) {
      const int i = e >> 4, r = (e >> 1) & 7, h4 = 4 * (e & 1);
      if (u.n[i] < 0) continue;
      float* ys = smp + i * kRow + r * 8 + h4;
      const float* row = raw + (i * 8 + r) * kS;
      if (u.vx[i] == 8) {
        const float4 a = *reinterpret_cast<const float4*>(row + h4);
        *reinterpret_cast<float4*>(ys) = make_float4(grey(a.x), grey(a.y), grey(a.z), grey(a.w));
        continue;
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) ys[d] = grey(row[min(h4 + d, u.vx[i] - 1)]);
    }
  }
}

template <bool kColour>
__global__ void __launch_bounds__(kThreads) jpeg_encode_front_kernel(
    const float* __restrict__ img, Geom g, const int* __restrict__ qluma,
    const int* __restrict__ qchroma, const float* __restrict__ kron,
    int16_t* __restrict__ out_y, int16_t* __restrict__ out_cb, int16_t* __restrict__ out_cr) {
  using L = Layout<kColour>;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;
  float* smp = raw + L::kRawFloats;
  float4* kr = reinterpret_cast<float4*>(smp + kTileBlocks * kRow);  // kr[c * 64 + k]
  float* qf = reinterpret_cast<float*>(kr + 16 * 64);                 // luma, chroma
  __shared__ Units units[2];

  for (int i = threadIdx.x; i < 64 * 16; i += kThreads) {
    const int k = i & 63, c = i >> 6;
    kr[c * 64 + k] = *reinterpret_cast<const float4*>(kron + k * 64 + 4 * c);
  }
  for (int i = threadIdx.x; i < 128; i += kThreads)
    qf[i] = static_cast<float>(i < 64 ? qluma[i] : qchroma[i - 64]);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane & 15;                   // coefficients kg + 16 r
  const int bg = warp * 2 + (lane >> 4);      // blocks 6 bg .. 6 bg + 5
  int tile = blockIdx.x, buf = 0;
  if (tile < g.n_tiles) {
    unit_info<kColour>(g, tile, units[0]);
    __syncthreads();
    load_tile<kColour>(img, g, units[0], raw);
  }
  for (; tile < g.n_tiles; tile += gridDim.x, buf ^= 1) {
    cp_wait_all();
    __syncthreads();
    convert_tile<kColour>(g, units[buf], raw, smp);
    const int next = tile + gridDim.x;
    if (next < g.n_tiles) unit_info<kColour>(g, next, units[buf ^ 1]);
    __syncthreads();
    if (next < g.n_tiles) load_tile<kColour>(img, g, units[buf ^ 1], raw);

    // fDCT: acc[j][r] = coefficient kg + 16 r of block 6 bg + j
    float acc[6][4];
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
    const float4* s4 = reinterpret_cast<const float4*>(smp) + bg * 6 * (kRow / 4);
#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      float4 kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) kv[r] = kr[c * 64 + kg + 16 * r];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float4 s = s4[j * (kRow / 4) + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float a = acc[j][r];
          a = fmaf(s.x, kv[r].x, a);
          a = fmaf(s.y, kv[r].y, a);
          a = fmaf(s.z, kv[r].z, a);
          a = fmaf(s.w, kv[r].w, a);
          acc[j][r] = a;
        }
      }
    }
    __syncwarp();
    // the quotients overwrite the samples of the thread's own blocks
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float* q = qf + ((kColour && j >= 4) ? 64 : 0);
      int16_t* o = reinterpret_cast<int16_t*>(smp + (bg * 6 + j) * kRow);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = kg + 16 * r;
        o[k] = static_cast<int16_t>(rintf(acc[j][r] / q[k]));
      }
    }
    __syncwarp();
    // the warp's 12 blocks, 16 bytes a lane
    const Units& u = units[buf];
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int qd = it * 32 + lane;
      const int b = warp * 12 + (qd >> 3), piece = qd & 7;
      const int i = kColour ? b / 6 : b, which = kColour ? b - 6 * i : 0;
      if (u.n[i] < 0) continue;
      int16_t* dst;
      if (!kColour || which < 4) {
        const int by = kColour ? 2 * u.uy[i] + (which >> 1) : u.uy[i];
        const int bx = kColour ? 2 * u.ux[i] + (which & 1) : u.ux[i];
        if (by >= g.ybh || bx >= g.ybw) continue;
        dst = out_y + ((static_cast<long long>(u.n[i]) * g.ybh + by) * g.ybw + bx) * 64;
      } else {
        dst = (which == 4 ? out_cb : out_cr) +
              ((static_cast<long long>(u.n[i]) * g.uh + u.uy[i]) * g.uw + u.ux[i]) * 64;
      }
      *reinterpret_cast<int4*>(dst + piece * 8) =
          *reinterpret_cast<const int4*>(smp + b * kRow + piece * 4);
    }
  }
}

// blocks an SM and SMs, asked of the card once a device and layout
struct Card {
  int sms, occ;
};

template <bool kColour>
int card_plan(Card* out) {
  static std::mutex mu;
  static std::map<int, Card> cards;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cards.find(dev);
  if (it == cards.end()) {
    const auto fn = jpeg_encode_front_kernel<kColour>;
    const int smem = static_cast<int>(Layout<kColour>::kSmem);
    Card c{0, 0};
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, fn, kThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (c.occ < 1 || c.sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    it = cards.emplace(dev, c).first;
  }
  *out = it->second;
  return 0;
}

template <bool kColour>
int launch(const float* img, Geom g, const int* ql, const int* qc, const float* kron,
           int16_t* oy, int16_t* ocb, int16_t* ocr, cudaStream_t st) {
  Card c;
  const int rc = card_plan<kColour>(&c);
  if (rc != 0) return rc;
  const long long units = g.units;
  const long long tiles = (units + Layout<kColour>::kUnits - 1) / Layout<kColour>::kUnits;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  g.n_tiles = static_cast<int>(tiles);
  const long long most = static_cast<long long>(c.sms) * c.occ;
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  jpeg_encode_front_kernel<kColour><<<grid, kThreads, Layout<kColour>::kSmem, st>>>(
      img, g, ql, qc, kron, oy, ocb, ocr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2's build and plan for c channels (1 or 3): out[0..7] = registers,
// local bytes a thread, static shared bytes, dynamic shared bytes,
// blocks an SM, SMs, threads a block, MCUs (units) a tile. Returns a
// CUDA error code.
extern "C" int picha_jpeg_encode_front_info(int c, int* out) {
  if (c != 1 && c != 3) return static_cast<int>(cudaErrorInvalidValue);
  const bool colour = c == 3;
  Card card;
  const int rc = colour ? card_plan<true>(&card) : card_plan<false>(&card);
  if (rc != 0) return rc;
  cudaFuncAttributes fa;
  const cudaError_t err =
      colour ? cudaFuncGetAttributes(&fa, jpeg_encode_front_kernel<true>)
             : cudaFuncGetAttributes(&fa, jpeg_encode_front_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = static_cast<int>(colour ? Layout<true>::kSmem : Layout<false>::kSmem);
  out[4] = card.occ;
  out[5] = card.sms;
  out[6] = kThreads;
  out[7] = colour ? Layout<true>::kUnits : Layout<false>::kUnits;
  return 0;
}

// img: (N, H, W, C) float32, C in {1, 3} (colour encodes 4:2:0);
// qluma/qchroma: (64,) int32 natural order; kron: the (64, 64) float32
// Kronecker DCT (picha_tpu.ops.jpeg_tpu._idct_kron), 16-byte aligned;
// outputs (N, bh, bw, 64) int16, 16-byte aligned. out_cb/out_cr are
// unused for C == 1. Returns cudaGetLastError() (or the error of the
// occupancy query that plans the grid).
extern "C" int picha_jpeg_encode_front(
    const void* img, int n_img, int h, int w, int c, const void* qluma,
    const void* qchroma, const void* kron, void* out_y, void* out_cb, void* out_cr,
    int ybh, int ybw, int cbh, int cbw, void* stream) {
  if ((c != 1 && c != 3) || h < 1 || w < 1 || n_img < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_img == 0) return static_cast<int>(cudaGetLastError());
  const bool colour = c == 3;
  Geom g{};
  g.h = h;
  g.w = w;
  g.uh = colour ? cbh : ybh;
  g.uw = colour ? cbw : ybw;
  g.ybh = ybh;
  g.ybw = ybw;
  g.vec = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(img) % 16 == 0);
  g.units = static_cast<long long>(n_img) * g.uh * g.uw;
  const float* im = static_cast<const float*>(img);
  const int* ql = static_cast<const int*>(qluma);
  const int* qc = static_cast<const int*>(qchroma);
  const float* kr = static_cast<const float*>(kron);
  int16_t* oy = static_cast<int16_t*>(out_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (colour)
    return launch<true>(im, g, ql, qc, kr, oy, static_cast<int16_t*>(out_cb),
                        static_cast<int16_t*>(out_cr), st);
  return launch<false>(im, g, ql, qc, kr, oy, oy, oy, st);
}
