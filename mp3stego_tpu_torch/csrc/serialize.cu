// Frame serializer of the MP3 encode path, written by hand for Hopper
// (sm_90a): every frame's header, side info and Huffman main data packed
// on the card from the quantized spectra (ix) where the rate search left
// them.
//
// It replaces no TPU kernel: the JAX package serializes on the host with
// the C source that the port's host route still runs
// (mp3stego_tpu_torch/native/src/mp3_serialize.cpp, mp3_format_frames), one
// put after another. It was added because that serial loop, ~20 us a frame,
// held most of a hide request once the rest of it ran on the card. Its plain
// PyTorch version is mp3stego_tpu_torch/ops/serialize.py::pack_frames_torch.
// The kernel writes mp3_format_frames' bytes bit for bit, with the same
// length and the same carried 32-bit cache, on the plane path's inputs:
// scalefactors are written as zeros (slen bits under scfsi), as the plane
// path has none other; a lane reads its own 576 samples only (big_values
// <= 288, the count1 quads inside the lane: the search's output).
//
// Why it can run in parallel: the only thing that chains the host's puts is
// the bit position, and every piece's length is known before a code is
// written. main_data_begin is 0, so a frame's main data follows its side
// info; a granule's piece is its scalefactors, its Huffman codes, then
// all-ones stuffing up to part2_3_length (the host's reservoir chain fixed
// it); a frame's header and side info have a size fixed by the version and
// the channels. So the stream, frame > (header, then gr > ch), is built in
// four launches:
//   1. lengths: one warp a lane (a granule of a channel) sums its codes'
//      lengths, signs and escape bits included, over its big-values pairs
//      and count1 quads, 32 at a time;
//   2. scan: one CTA of 1,024 threads turns the pieces' lengths, in stream
//      order, into bit offsets after the bits pending in the carried-in
//      cache (a run of pieces a thread, warp scans of the runs' sums), and
//      stores those bits as the stream's first word;
//   3. headers: one thread a frame writes its header and side info;
//   4. pack: one warp a lane places its codes by a warp scan of their
//      lengths into a shared-memory image of its words (a shared atomicOr
//      a put: neighbouring codes share words), then stores the words, the
//      stuffing's ones computed per word.
// A piece's first and last words may be shared with its neighbours and take
// a global atomicOr into the zeroed output; the words wholly inside a piece
// are stored plainly. Words are stored byte-swapped: the output's bytes are
// the stream's, big-endian.
//
// What bounds it on this card: bytes. It reads each lane's coded samples
// twice (lengths, pack), 2 x big_values + 4 x count1 int32s, and the side
// fields (14 int32 a lane) and writes the stream once: for a 278 s stereo
// song at 320 kbps, ~10.8 MB out against at most 98 MB of ix, so ~0.04 ms at
// 3.35 TB/s. Its design keeps the reads coalesced (a warp's 32 pairs are
// 256 contiguous bytes), the codes' placement in shared memory, and the
// global atomics to two words a piece; the scan is one CTA, ~50,000 pieces
// a song.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // lanes a CTA, lengths and pack
constexpr int kThreads = 32 * kWarps;
constexpr int kScanThreads = 1024;
constexpr int kSamples = 576;
constexpr int kPairs = kSamples / 2;
constexpr unsigned kFull = 0xffffffffu;
// side fields, (kFields, lanes) int32: mp3_format_frames' gi fields in its
// order, then the three table selects
enum Field {
  kPart23 = 0, kBigValues, kGlobalGain, kScalefacCompress, kRegion0,
  kRegion1, kPreflag, kScalefacScale, kCount1Table, kCount1, kPart2,
  kTable0, kTable1, kTable2, kFields
};
// per frame, (nf, kFrameInts) int32: bitrate index, padding, scfsi[2][4]
constexpr int kFrameInts = 10;
// the tables, one int32 array: the 34 Huffman tables' entries code | length
// << 24 (34 x 256), linbits (32), slen1 (16), slen2 (16)
constexpr int kCodes = 34 * 256;
constexpr int kLinbits = kCodes;
constexpr int kSlen1 = kLinbits + 32;
constexpr int kSlen2 = kSlen1 + 16;
constexpr int kTableInts = kSlen2 + 16;
// a lane's Huffman image in words: at most 288 pairs of 45 bits (a 17-bit
// escape code, 2 x 13 linbits, 2 signs) after up to 31 bits of its word
constexpr int kImage = 416;

struct Cfg {
  int version, layer, crc, sr_mod3, ext, mode, mode_ext, copyright,
      original, emphasis, private_bits, nch, gpf;
  int band[23];
  int nf, tg, lanes, pieces;               // pieces a frame: 1 + gpf x nch
  long long cap_words;                     // words the output holds
};

__host__ __device__ int header_bits(const Cfg& c) {
  const int info = c.version == 3 ? 9 + (c.nch == 2 ? 3 : 5) + 4 * c.nch
                                  : 8 + (c.nch == 2 ? 2 : 1);
  return 32 + info + c.gpf * c.nch * (c.version == 3 ? 59 : 61);
}

__device__ __forceinline__ uint32_t swap_bytes(uint32_t v) {
  return (v >> 24) | ((v >> 8) & 0xff00u) | ((v << 8) & 0xff0000u)
         | (v << 24);
}

__device__ __forceinline__ uint32_t low_bits(uint32_t v, int n) {
  return n >= 32 ? v : v & ((1u << n) - 1u);
}

// ones over bits [a, a + n) of a word, its first bit at 31
__device__ __forceinline__ uint32_t ones(int a, int n) {
  const uint32_t hi = kFull >> a;
  return a + n >= 32 ? hi : hi & ~(kFull >> (a + n));
}

// A code and what follows it, two puts of at most 32 bits: a pair's code
// with its signs (tables 1-15) or its code, then its escape bits and signs
// (tables 16-31); a quad's code, then its signs.
struct Item {
  uint32_t code;
  int clen;
  uint32_t ext;
  int elen;
};

__device__ __forceinline__ uint32_t entry(const uint32_t* tab, int p) {
  return __ldg(tab + min(max(p, 0), kCodes - 1));
}

// __huffman_code of the reference (MP3_Encoder.py), as mp3_format_frames
// writes a big-values pair: nothing under table 0
__device__ Item pair_item(const uint32_t* tab, int t, int x, int y) {
  Item it{0u, 0, 0u, 0};
  if (t == 0) {
    return it;
  }
  const uint32_t sx = x > 0 ? 0u : 1u;
  const uint32_t sy = y > 0 ? 0u : 1u;
  if (x < 0) x = -x;
  if (y < 0) y = -y;
  if (t > 15) {
    const int lb = static_cast<int>(__ldg(tab + kLinbits + (t & 31)));
    int lx = 0;
    int ly = 0;
    if (x > 14) { lx = x - 15; x = 15; }
    if (y > 14) { ly = y - 15; y = 15; }
    const uint32_t e = entry(tab, t * 256 + x * 16 + y);
    uint32_t ext = 0u;
    int xb = 0;
    if (x > 14) { ext |= static_cast<uint32_t>(lx); xb += lb; }
    if (x != 0) { ext = (ext << 1) | sx; xb += 1; }
    if (y > 14) { ext = (ext << lb) | static_cast<uint32_t>(ly); xb += lb; }
    if (y != 0) { ext = (ext << 1) | sy; xb += 1; }
    it.code = e & 0xffffffu;
    it.clen = static_cast<int>(e >> 24);
    it.ext = ext;
    it.elen = xb;
  } else {
    const uint32_t e = entry(tab, t * 256 + x * 16 + y);
    uint32_t code = e & 0xffffffu;
    int cb = static_cast<int>(e >> 24);
    if (x != 0) { code = (code << 1) | sx; cb += 1; }
    if (y != 0) { code = (code << 1) | sy; cb += 1; }
    it.code = code;
    it.clen = cb;
  }
  return it;
}

// __huffman_coder_count1: the quad's code under table 32 + c1, then a sign
// bit for each nonzero value
__device__ Item quad_item(const uint32_t* tab, int c1, int v, int w, int x,
                          int y) {
  const uint32_t sv = v > 0 ? 0u : 1u;
  const uint32_t sw = w > 0 ? 0u : 1u;
  const uint32_t sx = x > 0 ? 0u : 1u;
  const uint32_t sy = y > 0 ? 0u : 1u;
  if (v < 0) v = -v;
  if (w < 0) w = -w;
  if (x < 0) x = -x;
  if (y < 0) y = -y;
  const uint32_t e =
      entry(tab, (32 + c1) * 256 + v + (w << 1) + (x << 2) + (y << 3));
  uint32_t code = 0u;
  int cb = 0;
  if (v) { code = sv; cb = 1; }
  if (w) { code = (code << 1) | sw; cb += 1; }
  if (x) { code = (code << 1) | sx; cb += 1; }
  if (y) { code = (code << 1) | sy; cb += 1; }
  return Item{e & 0xffffffu, static_cast<int>(e >> 24), code, cb};
}

// One lane (a granule of a channel, g = ch x tg + f x gpf + gr, the search's
// order): its fields, its coded samples and where its piece sits.
struct Lane {
  const int* row;                          // its 576 samples
  int f, gr, ch;
  int piece;                               // f x pieces + 1 + gr x nch + ch
  int part23, part2, c1sel;
  int ts[3];
  int r1, r2;                              // region starts
  int pairs, items;                        // big-values pairs, then quads
  int sf;                                  // scalefactor bits

  __device__ Lane(const Cfg& c, const int* ix, const int* side,
                  const int* frames, const uint32_t* tab, int g) {
    const auto field = [&](int k) {
      return __ldg(side + static_cast<long long>(k) * c.lanes + g);
    };
    row = ix + static_cast<long long>(g) * kSamples;
    ch = g / c.tg;
    f = (g % c.tg) / c.gpf;
    gr = g % c.gpf;
    piece = f * c.pieces + 1 + gr * c.nch + ch;
    part23 = field(kPart23);
    part2 = field(kPart2);
    c1sel = field(kCount1Table);
    ts[0] = field(kTable0);
    ts[1] = field(kTable1);
    ts[2] = field(kTable2);
    const int r0c = field(kRegion0);
    const int r1c = field(kRegion1);
    r1 = c.band[min(max(r0c + 1, 0), 22)];
    r2 = c.band[min(max(r0c + r1c + 2, 0), 22)];
    pairs = min(max(field(kBigValues), 0), kPairs);
    const int quads = min(max(field(kCount1), 0), (kSamples - 2 * pairs) / 4);
    items = pairs + quads;
    const int sfc = field(kScalefacCompress) & 15;
    const int s1 = static_cast<int>(__ldg(tab + kSlen1 + sfc));
    const int s2 = static_cast<int>(__ldg(tab + kSlen2 + sfc));
    const int* scfsi = frames + f * kFrameInts + 2 + 4 * ch;
    sf = 0;
    if (gr == 0 || __ldg(scfsi) == 0) sf += 6 * s1;
    if (gr == 0 || __ldg(scfsi + 1) == 0) sf += 5 * s1;
    if (gr == 0 || __ldg(scfsi + 2) == 0) sf += 5 * s2;
    if (gr == 0 || __ldg(scfsi + 3) == 0) sf += 5 * s2;
  }

  // item j: pair j below pairs, else quad j - pairs
  __device__ Item item(const uint32_t* tab, int j) const {
    if (j < pairs) {
      const int i = 2 * j;
      const int2 xy = __ldg(reinterpret_cast<const int2*>(row) + j);
      return pair_item(tab, ts[(i >= r1) + (i >= r2)], xy.x, xy.y);
    }
    const int i = 2 * pairs + 4 * (j - pairs);
    return quad_item(tab, c1sel, __ldg(row + i), __ldg(row + i + 1),
                     __ldg(row + i + 2), __ldg(row + i + 3));
  }
};

// a piece's word gw: plainly where the piece holds it whole, else OR'd
// with its neighbours'; zeros are the output's already
__device__ __forceinline__ void emit(uint32_t* out, long long cap,
                                     long long gw, uint32_t v, long long at,
                                     long long end) {
  if (v == 0u || gw >= cap) {
    return;
  }
  if (gw * 32 >= at && gw * 32 + 32 <= end) {
    out[gw] = swap_bytes(v);
  } else {
    atomicOr(out + gw, swap_bytes(v));
  }
}

__global__ void __launch_bounds__(kThreads)
lengths_kernel(const Cfg c, const int* __restrict__ ix,
               const int* __restrict__ side, const int* __restrict__ frames,
               const uint32_t* __restrict__ tab, int* __restrict__ len) {
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= c.lanes) {
    return;                                // the whole warp
  }
  const int l = threadIdx.x & 31;
  const Lane ln(c, ix, side, frames, tab, g);
  int bits = 0;
  for (int j = l; j < ln.items; j += 32) {
    const Item it = ln.item(tab, j);
    bits += it.clen + it.elen;
  }
  const int hw = __reduce_add_sync(kFull, bits);
  if (l == 0) {
    len[ln.piece] = ln.sf + hw + max(ln.part23 - ln.part2 - hw, 0);
    if (ln.gr == 0 && ln.ch == 0) {
      len[ln.piece - 1] = header_bits(c);
    }
  }
}

// off[i] = pending + the lengths before piece i; off[n] the stream's bits.
// Each thread sums a run of pieces; a warp scan of the runs, then one of
// the warps' totals, gives each run's start.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ len, long long n, int pending,
            uint32_t cache, long long* __restrict__ off,
            uint32_t* __restrict__ out) {
  __shared__ long long warp_sum[kScanThreads / 32];
  const int t = threadIdx.x;
  const int l = t & 31;
  const int w = t >> 5;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long a = min(n, t * per);
  const long long b = min(n, a + per);
  long long s = 0;
  for (long long i = a; i < b; ++i) {
    s += len[i];
  }
  long long inc = s;                       // inclusive over the warp's runs
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_sync(kFull, inc, (l - d) & 31);
    if (l >= d) {
      inc += y;
    }
  }
  if (l == 31) {
    warp_sum[w] = inc;
  }
  __syncthreads();
  if (w == 0) {
    long long v = warp_sum[l];
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_sync(kFull, v, (l - d) & 31);
      if (l >= d) {
        v += y;
      }
    }
    warp_sum[l] = v;                       // inclusive over the warps
  }
  __syncthreads();
  if (t == 0) {
    off[n] = pending + warp_sum[kScanThreads / 32 - 1];
    if (pending > 0) {
      out[0] = swap_bytes(cache & ~(kFull >> pending));
    }
  }
  long long run = pending + (w > 0 ? warp_sum[w - 1] : 0) + inc - s;
  for (long long i = a; i < b; ++i) {
    off[i] = run;
    run += len[i];
  }
}

// a frame's header and side info, MSB first, from bit pos of its first word
struct Bits {
  uint32_t w[12];
  int pos;

  __device__ void put(uint32_t v, int n) {
    v = low_bits(v, n);
    const int i = pos >> 5;
    const int b = pos & 31;
    const uint64_t x = static_cast<uint64_t>(v) << (64 - b - n);
    w[i] |= static_cast<uint32_t>(x >> 32);
    w[i + 1] |= static_cast<uint32_t>(x);
    pos += n;
  }
};

__global__ void __launch_bounds__(kThreads)
header_kernel(const Cfg c, const int* __restrict__ side,
              const int* __restrict__ frames,
              const long long* __restrict__ off, uint32_t* __restrict__ out) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= c.nf) {
    return;
  }
  const long long at = off[static_cast<long long>(f) * c.pieces];
  const int* fr = frames + f * kFrameInts;
  Bits bs;
  for (int k = 0; k < 12; ++k) {
    bs.w[k] = 0u;
  }
  bs.pos = static_cast<int>(at & 31);
  const int v3 = c.version == 3;
  bs.put(0x7ff, 11);
  bs.put(c.version, 2);
  bs.put(c.layer, 2);
  bs.put(c.crc ? 0 : 1, 1);
  bs.put(__ldg(fr), 4);
  bs.put(c.sr_mod3, 2);
  bs.put(__ldg(fr + 1), 1);
  bs.put(c.ext, 1);
  bs.put(c.mode, 2);
  bs.put(c.mode_ext, 2);
  bs.put(c.copyright, 1);
  bs.put(c.original, 1);
  bs.put(c.emphasis, 2);
  if (v3) {
    bs.put(0, 9);
    bs.put(c.private_bits, c.nch == 2 ? 3 : 5);
    for (int ch = 0; ch < c.nch; ++ch) {
      for (int b = 0; b < 4; ++b) {
        bs.put(__ldg(fr + 2 + 4 * ch + b), 1);
      }
    }
  } else {
    bs.put(0, 8);
    bs.put(c.private_bits, c.nch == 2 ? 2 : 1);
  }
  for (int gr = 0; gr < c.gpf; ++gr) {
    for (int ch = 0; ch < c.nch; ++ch) {
      const int g = ch * c.tg + f * c.gpf + gr;
      const auto field = [&](int k) {
        return static_cast<uint32_t>(
            __ldg(side + static_cast<long long>(k) * c.lanes + g));
      };
      bs.put(field(kPart23), 12);
      bs.put(field(kBigValues), 9);
      bs.put(field(kGlobalGain), 8);
      bs.put(field(kScalefacCompress), v3 ? 4 : 9);
      bs.put(0, 1);
      bs.put(field(kTable0), 5);
      bs.put(field(kTable1), 5);
      bs.put(field(kTable2), 5);
      bs.put(field(kRegion0), 4);
      bs.put(field(kRegion1), 3);
      if (v3) {
        bs.put(field(kPreflag), 1);
        bs.put(field(kScalefacScale), 1);
        bs.put(field(kCount1Table), 1);
      }
    }
  }
  const long long end = at + header_bits(c);
  const long long w0 = at >> 5;
  for (int k = 0; k < (bs.pos + 31) >> 5; ++k) {
    emit(out, c.cap_words, w0 + k, bs.w[k], at, end);
  }
}

// one put of at most 32 bits into a lane's image, from its bit p
__device__ __forceinline__ void place(uint32_t* img, int p, uint32_t v,
                                      int n) {
  if (n <= 0) {
    return;
  }
  v = low_bits(v, n);
  if (v == 0u) {
    return;
  }
  const int i = p >> 5;
  const int b = p & 31;
  const uint64_t x = static_cast<uint64_t>(v) << (64 - b - n);
  atomicOr(img + i, static_cast<uint32_t>(x >> 32));
  if (static_cast<uint32_t>(x) != 0u) {
    atomicOr(img + i + 1, static_cast<uint32_t>(x));
  }
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const Cfg c, const int* __restrict__ ix,
            const int* __restrict__ side, const int* __restrict__ frames,
            const uint32_t* __restrict__ tab,
            const long long* __restrict__ off, uint32_t* __restrict__ out) {
  __shared__ uint32_t image[kWarps * kImage];
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= c.lanes) {
    return;                                // the whole warp
  }
  const int l = threadIdx.x & 31;
  uint32_t* img = image + (threadIdx.x >> 5) * kImage;
  const Lane ln(c, ix, side, frames, tab, g);
  const long long at = off[ln.piece];
  const long long base = at + ln.sf;       // the first code's bit
  const long long w0 = base >> 5;
  for (int k = l; k < kImage; k += 32) {
    img[k] = 0u;
  }
  __syncwarp();
  int run = static_cast<int>(base & 31);   // image bits so far
  for (int j0 = 0; j0 < ln.items; j0 += 32) {
    const int j = j0 + l;
    const Item it = j < ln.items ? ln.item(tab, j) : Item{0u, 0, 0u, 0};
    const int n = it.clen + it.elen;
    int inc = n;                           // inclusive scan over the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_sync(kFull, inc, (l - d) & 31);
      if (l >= d) {
        inc += y;
      }
    }
    const int p = run + inc - n;
    place(img, p, it.code, it.clen);
    place(img, p + it.clen, it.ext, it.elen);
    run += __shfl_sync(kFull, inc, 31);
  }
  __syncwarp();
  const long long hend = base + (run - static_cast<int>(base & 31));
  const long long end =
      hend + max(static_cast<long long>(ln.part23) - ln.part2 - (hend - base),
                 0LL);
  if (end <= at) {
    return;
  }
  for (long long gw = (at >> 5) + l; gw <= (end - 1) >> 5; gw += 32) {
    const long long k = gw - w0;
    uint32_t v = k >= 0 && k < kImage ? img[k] : 0u;
    const long long a = max(hend, gw * 32);
    const long long b = min(end, gw * 32 + 32);
    if (a < b) {
      v |= ones(static_cast<int>(a - gw * 32), static_cast<int>(b - a));
    }
    emit(out, c.cap_words, gw, v, at, end);
  }
}

}  // namespace

// Serialize nf frames on `stream`: four launches; returns the first
// cudaGetLastError() that is not 0, else 0. cfg (host) holds 36 int32
// (ops/serialize.py CONFIG): version, layer, crc, sr_mod3, ext, mode, mode_ext, copyright,
// original, emphasis, private_bits, nch, gpf, then the band row (23).
// Device pointers: ix (nch x nf x gpf, 576) int32, lane g = ch x tg + f x
// gpf + gr; side (14, lanes) int32; frames (nf, 10) int32; tables
// (kTableInts,) int32; len (nf x pieces,) int32 and off (nf x pieces + 1,)
// int64 scratch, off[-1] the stream's bits after the call; out
// (cap_words,) int32, zeroed by the caller, the stream's words after it
// (bytes in stream order). pending (0-31) bits of cache, left-aligned,
// start the stream.
extern "C" int serialize_frames(const int* cfg, int nf, const void* ix,
                                const void* side, const void* frames,
                                const void* tables, void* len, void* off,
                                void* out, long long cap_words,
                                unsigned cache, int pending, void* stream) {
  Cfg c;
  c.version = cfg[0];
  c.layer = cfg[1];
  c.crc = cfg[2];
  c.sr_mod3 = cfg[3];
  c.ext = cfg[4];
  c.mode = cfg[5];
  c.mode_ext = cfg[6];
  c.copyright = cfg[7];
  c.original = cfg[8];
  c.emphasis = cfg[9];
  c.private_bits = cfg[10];
  c.nch = cfg[11];
  c.gpf = cfg[12];
  for (int k = 0; k < 23; ++k) {
    c.band[k] = cfg[13 + k];
  }
  if (nf <= 0 || c.nch < 1 || c.nch > 2 || c.gpf < 1 || c.gpf > 2
      || pending < 0 || pending > 31 || cap_words < 1
      || (reinterpret_cast<uintptr_t>(ix) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  c.nf = nf;
  c.tg = nf * c.gpf;
  c.lanes = c.nch * c.tg;
  c.pieces = 1 + c.gpf * c.nch;
  c.cap_words = cap_words;
  const long long n = static_cast<long long>(nf) * c.pieces;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned lane_blocks =
      static_cast<unsigned>((c.lanes + kWarps - 1) / kWarps);
  const unsigned frame_blocks =
      static_cast<unsigned>((nf + kThreads - 1) / kThreads);
  const int* ix_ = static_cast<const int*>(ix);
  const int* side_ = static_cast<const int*>(side);
  const int* frames_ = static_cast<const int*>(frames);
  const uint32_t* tab = static_cast<const uint32_t*>(tables);
  int* len_ = static_cast<int*>(len);
  long long* off_ = static_cast<long long*>(off);
  uint32_t* out_ = static_cast<uint32_t*>(out);
  lengths_kernel<<<lane_blocks, kThreads, 0, s>>>(c, ix_, side_, frames_,
                                                  tab, len_);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(len_, n, pending, cache, off_,
                                         out_);
  e = cudaGetLastError();
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  header_kernel<<<frame_blocks, kThreads, 0, s>>>(c, side_, frames_, off_,
                                                  out_);
  e = cudaGetLastError();
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  pack_kernel<<<lane_blocks, kThreads, 0, s>>>(c, ix_, side_, frames_, tab,
                                               off_, out_);
  return static_cast<int>(cudaGetLastError());
}

// The ints of the tables array the kernels read (ops/serialize.py builds
// it): a check that the wrapper and the source agree.
extern "C" int serialize_table_ints() { return kTableInts; }
