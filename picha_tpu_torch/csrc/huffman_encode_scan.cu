// K3: baseline JPEG Huffman scan encode (standard Annex K tables): the
// scan's bits by a single-pass chained scan over tiles of scan-order
// blocks, then its bytes with 0xFF stuffing by a second chained scan over
// chunks of bytes.
//
// Replaces: picha_tpu/ops/jpeg_huffman_tpu.py::build_scan_encoder. The
// TPU graph lays every block out as 65 dense packet slots, takes bit
// offsets by cumsum and rebuilds each output word from prefix sums,
// because scalar scatters serialise on the TPU.
//
// What bounds it on an H100: reading the int16 coefficients once (2 B a
// coefficient, 25 MB for 16 images at 960x544 4:2:0) and writing the
// scan bytes: 0.0077 ms. The work is irregular and data-dependent (a
// q85 block holds a handful of nonzero coefficients among its 64), and
// the offsets of each block's bits and of each byte's stuffing are
// prefix sums over the whole image.
//
// The design. scan_bits_kernel: a persistent grid takes tiles of 256
// scan-order blocks of one image by an atomic ticket, one block a
// thread. A warp stages its 32 blocks by 16-byte cp.async; each thread
// forms its block's zigzag nonzero mask (64 bits, compile-time bit
// positions) and walks only the set bits, twice: once for the block's
// bit length, once to emit its packets. Between the walks a block-wide
// scan gives every block its bit offset inside the tile and the tile's
// length, and a decoupled look-back over the image's earlier tiles
// (aggregates published at once, inclusive prefixes after the
// look-back) gives the tile's bit offset in the image. The tile's bits
// are assembled at that alignment in shared memory (a thread ORs only
// the first and last word of its block there) and stored as whole
// words; a word shared with a neighbour tile is stored by the second of
// the two to get there, from both halves (an atomic count a boundary),
// so that no tile waits for another's stores. Each block's DC predictor
// comes from the staged rows when it lies in the tile. The last tile
// appends the final 1-bit pad and writes the image's byte count.
// stuff_kernel:
// one CTA per 4,096 raw bytes of an image (the chunks cover byte_cap),
// 16 bytes a thread: the chunk's 0xFF count, a look-back over the
// image's earlier chunks for its shift, the stuffed bytes laid out in
// shared memory, and the chunk's output range (data, then zeros up to
// the next chunk's) stored a byte a thread, whole warps on consecutive
// bytes. Each byte of `out` is written exactly once, so nothing is
// zeroed beforehand; the tickets and look-back descriptors are zeroed by
// one memset a call. Bytes past `byte_cap` are dropped and `nbytes`
// still reports the full length, so nbytes > byte_cap signals overflow.
//
// Block order, dummy blocks and the DC chain follow
// picha_tpu/ops/jpeg_huffman_tpu.py::_mcu_layout exactly: gidx maps
// scan position -> block of the flat component concatenation (resolved
// to the component's own plane here), dummy blocks code DC diff 0 and
// no AC, prev names the previous real block of the same component for
// DC prediction.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int kTile = 256;           // scan blocks a tile, one a thread
constexpr int kThreads = 256;
constexpr int kBlk = 72;             // int16 a staged block (64 + 8: 144 B)
constexpr int kMaxBlockBits = 1723;  // DC 11 + 11, then 63 x (16 + 11)
constexpr int kSegWords = (kTile * kMaxBlockBits + 31 + 7) / 32 + 2;
constexpr size_t kBitsSmem = kTile * kBlk * sizeof(int16_t) + kSegWords * sizeof(uint32_t);
constexpr int kChunk = 4096;         // raw bytes a stuff CTA, 16 a thread
constexpr int kMaxPlanes = 3;
constexpr unsigned long long kAggregate = 1ull << 62, kInclusive = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

// zigzag position of natural index i (row-major 8x8)
__host__ __device__ constexpr int zigzag_of(int i) {
  const int r = i >> 3, c = i & 7, s = r + c;
  if (s < 8) return s * (s + 1) / 2 + ((s & 1) ? r : s - r);
  return 64 - (15 - s) * (16 - s) / 2 + ((s & 1) ? r - (s - 7) : 7 - r);
}

struct Planes {
  const int16_t* p[kMaxPlanes];
  int size[kMaxPlanes];   // blocks an image
};

struct Layout {
  const int* gidx;   // (nblk,) scan position -> flat block
  const int* dummy;  // (nblk,) 1 for MCU padding blocks
  const int* tid;    // (nblk,) 0 luma / 1 chroma tables
  const int* prev;   // (nblk,) previous real block of the component, -1
  const int* tab;    // (4, 256) (len << 16 | code): DC luma, DC chroma,
                     // AC luma, AC chroma
};

__device__ __forceinline__ const int16_t* block_ptr(const Planes& P, int n, int g) {
  const int16_t* base = P.p[0];
  int size = P.size[0];
#pragma unroll
  for (int c = 1; c < kMaxPlanes; ++c) {
    if (g >= size && P.size[c] > 0) {
      g -= size;
      base = P.p[c];
      size = P.size[c];
    }
  }
  return base + (static_cast<long long>(n) * size + g) * 64;
}

// bits of |x| capped at 11, as the reference's 11 threshold passes
__device__ __forceinline__ int bitsize(int x) {
  const int a = x < 0 ? -x : x;
  return a ? min(32 - __clz(a), 11) : 0;
}

__device__ __forceinline__ unsigned low_bits(int x, int s) {
  return static_cast<unsigned>(x < 0 ? x - 1 : x) & ((1u << s) - 1u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// exclusive scan of one int a thread over the CTA; *total gets the sum
__device__ int cta_exclusive_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = (wid ? warp_sums[wid - 1] : 0) + x - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return excl;
}

// exclusive prefix of tile `t` (index `u` in its chain) after publishing
// its own `total`: one thread walks back over the chain's earlier
// descriptors, adding aggregates until an inclusive prefix
__device__ long long look_back(unsigned long long* desc, int t, int u, long long total) {
  if (u == 0) {
    st_release(desc + t, kInclusive | static_cast<unsigned long long>(total));
    return 0;
  }
  st_release(desc + t, kAggregate | static_cast<unsigned long long>(total));
  long long prefix = 0;
  for (int k = t - 1;; --k) {
    unsigned long long d;
    do {
      d = ld_acquire(desc + k);
    } while (d == 0);
    prefix += static_cast<long long>(d & kValue);
    if (d & kInclusive) break;
  }
  st_release(desc + t, kInclusive | static_cast<unsigned long long>(prefix + total));
  return prefix;
}

// one half of the word at the boundary before tile b (half 0: the end of
// tile b - 1, half 1: the start of tile b); the second to arrive stores
// the word
__device__ void meet(unsigned long long* halves, int* meets, int b, int half, uint32_t v,
                     uint32_t* dst, bool store) {
  volatile uint32_t* slot = reinterpret_cast<volatile uint32_t*>(halves + b);
  slot[half] = v;
  __threadfence();
  if (atomicAdd(meets + 2 * b, 1) == 1) {
    __threadfence();
    if (store) *dst = v | slot[half ^ 1];
  }
}

// MSB-first bit writer into the tile's shared words: the first word of a
// block and its last partial word may hold a neighbour's bits (ORed),
// the words between are the block's own (stored)
struct BitWriter {
  uint32_t* seg;
  unsigned long long acc;
  int nb, w;
  bool first;
  __device__ BitWriter(uint32_t* s, int bit) : seg(s), acc(0), nb(bit & 31), w(bit >> 5), first(true) {}
  __device__ __forceinline__ void put(unsigned pkt, int len) {  // len <= 27
    acc = (acc << len) | pkt;
    nb += len;
    if (nb >= 32) {
      const uint32_t word = static_cast<uint32_t>(acc >> (nb - 32));
      if (first) atomicOr(seg + w, word);
      else seg[w] = word;
      first = false;
      ++w;
      nb -= 32;
    }
  }
  __device__ __forceinline__ void finish() {
    if (nb > 0) atomicOr(seg + w, static_cast<uint32_t>(acc << (32 - nb)));
  }
};

__global__ void __launch_bounds__(kThreads) scan_bits_kernel(
    Planes P, int nblk, Layout L, int tiles_per_image, int n_tiles, uint32_t* __restrict__ words,
    int nwords, int* __restrict__ nraw, unsigned long long* desc, int* meets,
    unsigned long long* halves, int* ticket) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* blk = reinterpret_cast<int16_t*>(smem);
  uint32_t* seg = reinterpret_cast<uint32_t*>(smem + kTile * kBlk * sizeof(int16_t));
  __shared__ int tab[4 * 256];
  __shared__ unsigned char zz[64];   // natural index of zigzag position k
  __shared__ int warp_sums[32];
  __shared__ int tile_s;
  __shared__ long long base_s;
  for (int i = threadIdx.x; i < 4 * 256; i += kThreads) tab[i] = L.tab[i];
  if (threadIdx.x < 64) zz[zigzag_of(threadIdx.x)] = static_cast<unsigned char>(threadIdx.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (;;) {
    if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1);
    __syncthreads();
    const int tile = tile_s;
    if (tile >= n_tiles) break;
    const int n = tile / tiles_per_image, u = tile - n * tiles_per_image;
    const int j = u * kTile + threadIdx.x;
    const bool live = j < nblk;
    int g = 0, dum = 1, t = 0, pv = -1;
    if (live) {
      g = L.gidx[j];
      dum = L.dummy[j];
      t = L.tid[j];
      pv = L.prev[j];
    }
    const bool coded = live && !dum;
    // stage the warp's blocks: four 128-byte blocks a warp instruction
    const int16_t* bp = block_ptr(P, n, g);
    int16_t* row = blk + threadIdx.x * kBlk;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int b = q * 4 + (lane >> 3);
      const unsigned long long src =
          __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(bp), b);
      if (__shfl_sync(0xffffffffu, coded, b))
        cp_async16(blk + (warp * 32 + b) * kBlk + (lane & 7) * 8,
                   reinterpret_cast<const int16_t*>(src) + (lane & 7) * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // the DC predictor: a block of an earlier tile read from global
    // memory now, one of this tile from its staged row below
    const int pt = pv - u * kTile;
    int pdc = 0;
    if (coded && pv >= 0 && pt < 0) pdc = block_ptr(P, n, L.gidx[pv])[0];
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (coded && pv >= 0 && pt >= 0) pdc = blk[pt * kBlk];

    // zigzag nonzero mask of the AC coefficients, and the DC packet
    unsigned lo = 0, hi = 0;
    int dc = 0;
    if (coded) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int4 v4 = reinterpret_cast<const int4*>(row)[q];
        const int vw[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = q * 8 + e;
          const int v = static_cast<int16_t>((e & 1) ? (vw[e >> 1] >> 16) : vw[e >> 1]);
          if (i == 0) {
            dc = v;
            continue;
          }
          const int z = zigzag_of(i);
          if (z < 32) lo |= (v != 0) ? (1u << z) : 0u;
          else hi |= (v != 0) ? (1u << (z - 32)) : 0u;
        }
      }
    }
    const int diff = coded ? dc - pdc : 0;
    const int ds = bitsize(diff);
    const int dcl = tab[t * 256 + ds];
    const unsigned dpkt = ((static_cast<unsigned>(dcl) & 0xFFFFu) << ds) | low_bits(diff, ds);
    const int dlen = (dcl >> 16) + ds;
    const int* ac = tab + (2 + t) * 256;
    const int zrl = ac[0xF0], eob = ac[0];
    const unsigned long long mask = (static_cast<unsigned long long>(hi) << 32) | lo;

    // walk 1: the block's bit length
    int len = 0;
    if (live) {
      len = dlen;
      int pk = 0;
      for (unsigned long long m = mask; m; m &= m - 1) {
        const int k = __ffsll(static_cast<long long>(m)) - 1;
        const int run = k - pk - 1;
        const int sz = bitsize(row[zz[k]]);
        len += (run >> 4) * (zrl >> 16) + (ac[((run & 15) << 4) | sz] >> 16) + sz;
        pk = k;
      }
      if (pk != 63) len += eob >> 16;
    }
    int total;
    const int off = cta_exclusive_scan(len, &total, warp_sums);
    if (threadIdx.x == 0) base_s = look_back(desc, tile, u, total);
    __syncthreads();
    const long long base = base_s;
    const bool last_tile = u == tiles_per_image - 1;
    const int pad = last_tile ? static_cast<int>((-(base + total)) & 7) : 0;
    const int sh = static_cast<int>(base & 31);
    const int nseg = (sh + total + pad + 31) >> 5;
    for (int i = threadIdx.x; i < nseg; i += kThreads) seg[i] = 0;
    __syncthreads();

    // walk 2: the packets, at the tile's alignment in the image
    if (live) {
      BitWriter bw(seg, sh + off);
      bw.put(dpkt, dlen);
      int pk = 0;
      for (unsigned long long m = mask; m; m &= m - 1) {
        const int k = __ffsll(static_cast<long long>(m)) - 1;
        const int run = k - pk - 1;
        const int v = row[zz[k]];
        const int sz = bitsize(v);
        for (int z = run >> 4; z > 0; --z) bw.put(zrl & 0xFFFF, zrl >> 16);
        const int c2 = ac[((run & 15) << 4) | sz];
        bw.put(((static_cast<unsigned>(c2) & 0xFFFFu) << sz) | low_bits(v, sz), (c2 >> 16) + sz);
        pk = k;
      }
      if (pk != 63) bw.put(eob & 0xFFFF, eob >> 16);
      if (j == nblk - 1) bw.put((1u << pad) - 1u, pad);  // final partial byte of 1-bits
      bw.finish();
    }
    __syncthreads();

    // the tile's words; a word shared with a neighbour tile (the first,
    // when the tile starts inside a word; the last, when the next tile
    // does) is stored by whichever of the two arrives second, from both
    // halves
    uint32_t* wimg = words + static_cast<long long>(n) * nwords;
    const long long w0 = base >> 5;
    const bool head = sh != 0;
    const bool tail = !last_tile && ((base + total) & 31) != 0;
    const int last = nseg - 1;
    for (int i = threadIdx.x; i < nseg; i += kThreads)
      if (!(i == 0 && head) && !(i == last && tail) && w0 + i < nwords) wimg[w0 + i] = seg[i];
    if (threadIdx.x == 0) {
      if (head) meet(halves, meets, tile, 1, seg[0], wimg + w0, w0 < nwords);
      if (tail) meet(halves, meets, tile + 1, 0, seg[last], wimg + w0 + last, w0 + last < nwords);
      if (last_tile) nraw[n] = static_cast<int>((base + total + pad) >> 3);
    }
  }
}

__global__ void __launch_bounds__(kThreads) stuff_kernel(
    const uint32_t* __restrict__ words, int nwords, const int* __restrict__ nraw,
    uint8_t* __restrict__ out, int byte_cap, int* __restrict__ nbytes, int chunks_per_image,
    unsigned long long* desc, int* ticket) {
  __shared__ __align__(16) uint8_t ob[2 * kChunk];
  __shared__ int warp_sums[32];
  __shared__ int chunk_s;
  __shared__ long long base_s;
  if (threadIdx.x == 0) chunk_s = atomicAdd(ticket, 1);
  for (int i = threadIdx.x; i < 2 * kChunk / 16; i += kThreads)
    reinterpret_cast<int4*>(ob)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int c = chunk_s;
  const int n = c / chunks_per_image, u = c - n * chunks_per_image;
  const int lim = min(nraw[n], byte_cap);
  const int b0 = u * kChunk + threadIdx.x * 16;
  uint32_t w[4] = {0, 0, 0, 0};
  if (b0 < lim) {
    const int4 v = *reinterpret_cast<const int4*>(words + static_cast<long long>(n) * nwords + b0 / 4);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  const int nv = max(0, min(16, lim - b0));   // raw bytes of this thread
  int ff = 0;
#pragma unroll
  for (int e = 0; e < 16; ++e)
    ff += (e < nv) && ((w[e >> 2] >> (24 - 8 * (e & 3))) & 0xFF) == 0xFF;
  int total;
  const int pos = cta_exclusive_scan(ff, &total, warp_sums);
  if (threadIdx.x == 0) base_s = look_back(desc, c, u, total);
  int o = threadIdx.x * 16 + pos;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (e < nv) {
      const unsigned v = (w[e >> 2] >> (24 - 8 * (e & 3))) & 0xFF;
      ob[o++] = static_cast<uint8_t>(v);
      o += v == 0xFF;   // the stuffed 0x00 (ob is zeroed)
    }
  }
  __syncthreads();
  // this chunk's output range: its bytes, then zeros up to the next
  // chunk's first byte
  const long long start = static_cast<long long>(u) * kChunk + base_s;
  uint8_t* dst = out + static_cast<long long>(n) * byte_cap;
  for (int i = threadIdx.x; i < kChunk + total; i += kThreads)
    if (start + i < byte_cap) dst[start + i] = ob[i];
  if (threadIdx.x == 0 && u == chunks_per_image - 1)
    nbytes[n] = nraw[n] + static_cast<int>(base_s) + total;
}

// blocks an SM and SMs, asked of the card once a device
struct Card {
  int sms, occ;
};

int card_plan(Card* out) {
  static std::mutex mu;
  static std::map<int, Card> cards;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cards.find(dev);
  if (it == cards.end()) {
    Card c{0, 0};
    rc = cudaFuncSetAttribute(scan_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kBitsSmem));
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, scan_bits_kernel, kThreads,
                                                         kBitsSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (c.occ < 1 || c.sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    it = cards.emplace(dev, c).first;
  }
  *out = it->second;
  return 0;
}

}  // namespace

// K3's builds and plan: out[0..9] = scan_bits_kernel's registers, local
// bytes, static shared bytes, dynamic shared bytes and blocks an SM;
// stuff_kernel's registers, local bytes, static shared bytes and blocks
// an SM; SMs. out[10..11] = scan blocks a tile, raw bytes a stuff chunk.
extern "C" int picha_huffman_encode_scan_info(int* out) {
  Card card;
  int rc = card_plan(&card);
  if (rc != 0) return rc;
  cudaFuncAttributes a, b;
  int occ = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, scan_bits_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&b, stuff_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, stuff_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = static_cast<int>(kBitsSmem);
  out[4] = card.occ;
  out[5] = b.numRegs;
  out[6] = static_cast<int>(b.localSizeBytes);
  out[7] = static_cast<int>(b.sharedSizeBytes);
  out[8] = occ;
  out[9] = card.sms;
  out[10] = kTile;
  out[11] = kChunk;
  return 0;
}

// planes: n_planes (<= 3) (N, bh, bw, 64) int16 natural-order coefficient
// planes, 16-byte aligned, sizes[c] = bh * bw of plane c (gidx indexes
// their concatenation); gidx/dummy/tid/prev: (nblk,) int32; tab: (4,
// 256) int32. scratch: int32, N * nwords words (nwords a multiple of 4,
// 4 * nwords >= byte_cap) then N byte counts. sync: sync_len int64 of
// tickets, descriptors and boundary words, at least 2 + N * (3 *
// ceil(nblk / 256) + ceil(byte_cap / 4096)), zeroed here. Outputs: out (N, byte_cap) u8
// (every byte written), nbytes (N) int32. Returns cudaGetLastError()
// (or the error of a refused launch or memset).
extern "C" int picha_huffman_encode_scan(
    const void* p0, const void* p1, const void* p2, int s0, int s1, int s2, int n_planes,
    int n_img, int nblk, const void* gidx, const void* dummy,
    const void* tid, const void* prev, const void* tab, void* scratch, int nwords, void* sync,
    long long sync_len, void* out, int byte_cap, void* nbytes, void* stream) {
  if (n_img < 1 || nblk < 1 || byte_cap < 1 || n_planes < 1 || n_planes > kMaxPlanes ||
      nwords % 4 || static_cast<long long>(nwords) * 4 < byte_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpi = (nblk + kTile - 1) / kTile;
  const int cpi = (byte_cap + kChunk - 1) / kChunk;
  const long long n_tiles = static_cast<long long>(n_img) * tpi;
  const long long n_chunks = static_cast<long long>(n_img) * cpi;
  const long long need = 2 + 3 * n_tiles + n_chunks;
  if (sync_len < need || n_tiles > 0x7fffffffLL || n_chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Card card;
  const int rc = card_plan(&card);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* s = static_cast<unsigned long long*>(sync);
  cudaError_t err = cudaMemsetAsync(s, 0, need * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* tickets = reinterpret_cast<int*>(s);   // two ints in s[0]; s[1] unused
  unsigned long long* desc = s + 2;
  int* meets = reinterpret_cast<int*>(desc + n_tiles);   // a counter a boundary, 8 bytes apart
  unsigned long long* halves = desc + 2 * n_tiles;        // the two halves of its word
  unsigned long long* cdesc = desc + 3 * n_tiles;
  Planes P{};
  const void* ps[kMaxPlanes] = {p0, p1, p2};
  const int ss[kMaxPlanes] = {s0, s1, s2};
  for (int c = 0; c < kMaxPlanes; ++c) {
    P.p[c] = static_cast<const int16_t*>(c < n_planes ? ps[c] : ps[0]);
    P.size[c] = c < n_planes ? ss[c] : 0;
  }
  const Layout L{static_cast<const int*>(gidx), static_cast<const int*>(dummy),
                 static_cast<const int*>(tid), static_cast<const int*>(prev),
                 static_cast<const int*>(tab)};
  uint32_t* words = static_cast<uint32_t*>(scratch);
  int* nraw = static_cast<int*>(scratch) + static_cast<long long>(n_img) * nwords;
  const long long most = static_cast<long long>(card.sms) * card.occ;
  const int grid = static_cast<int>(n_tiles < most ? n_tiles : most);
  scan_bits_kernel<<<grid, kThreads, kBitsSmem, st>>>(P, nblk, L, tpi, static_cast<int>(n_tiles),
                                                       words, nwords, nraw, desc, meets, halves,
                                                       tickets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stuff_kernel<<<static_cast<int>(n_chunks), kThreads, 0, st>>>(
      words, nwords, nraw, static_cast<uint8_t*>(out), byte_cap, static_cast<int*>(nbytes), cpi,
      cdesc, tickets + 1);
  return static_cast<int>(cudaGetLastError());
}
