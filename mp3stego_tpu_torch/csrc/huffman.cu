// Huffman sample decode of the MP3 decode path (the device bit-scan), written
// by hand for Hopper (sm_90a).
//
// Replaces the JAX package's mp3stego_tpu/ops/huffman_device.py::
// decode_samples_device, an XLA fori_loop that decodes 8 symbols of every
// granule per step in lockstep (not a pallas_call). Its plain PyTorch version
// is mp3stego_tpu_torch/ops/huffman_device.py::decode_samples_plain; the
// kernel equals it bit for bit.
//
// One thread walks one lane: one granule of one channel, lanes in parse order
// frame > gr > ch (G = 4 F), whose samples go to out[ch][2f + gr][0..575]
// (out is (2, 2F, 576) int32, the decode plane's layout, so no transpose
// follows). Per lane, 8 int32 fields: the first word and the word count of
// its frame's main data in `words` (big-endian uint32, each frame's data
// once), the first sample bit and the end bit (part2_3_length), the region
// boundaries r0 and r1, big2 = 2 x big_values, and ts0 | ts1 << 5 | ts2 << 10
// | c1sel << 15. Words past the frame's count read as zeros.
//
//   big-values pairs, s = 0, 2, .. < big2: the table of s's region picks a
//     codebook (book row -1: tables 0, 4, 14 decode as a skip). The next 19
//     bits index its LUT entry x << 9 | y << 5 | length; length 0 (no
//     codeword, a corrupt stream) skips the pair and consumes nothing. Each of
//     x, y reads linbits more bits when it is maxval - 1 and the table has
//     linbits, then a sign bit when it is nonzero.
//   count1 quads, s = big2, big2 + 4, .. while bit < end bit and s + 4 < 576:
//     table B is 4 inverted bits, table A the 6-bit QUAD_LUT (p << 5 |
//     length); a sign bit per nonzero value.
//   every other sample is zero; the thread writes all 576 of its lane.
//
// The bit reader is a 64-bit register cache, the upcoming bits at its top,
// refilled 32 bits at a time whenever 32 or fewer remain: before each
// codeword (19 bits) and before each value's linbits (up to 13) and sign.
//
// What bounds it: neither bytes nor operations but the dependent chain. A
// pair's codeword length, read from the LUT, sets where the next pair
// starts, so each of a lane's up to 288 pairs waits for one gather from the
// 2 MiB LUT of its codebook (the 15 LUTs, 30 MiB in all, stay in L2), and
// each of its up to 144 quads for a shared-memory read. The small tables
// (book row, linbits, maxval per table id, QUAD_LUT) live in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLutBits = 19;
constexpr int kSamples = 576;
constexpr int kSmall = 32 * 3 + 64;        // book row, linbits, maxval, quad

struct Reader {
  const uint32_t* w;                       // the lane's frame words
  int n;                                   // their count
  uint64_t cache;                          // upcoming bits, from bit 63 down
  int nbits;                               // valid bits in the cache
  int wpos;                                // the next word to load
  int bit;                                 // the absolute cursor

  __device__ uint32_t word(int i) const {
    return (i >= 0 && i < n) ? __ldg(w + i) : 0u;
  }

  __device__ void init(int start) {
    const int i = start >> 5;
    const int off = start & 31;
    cache = ((static_cast<uint64_t>(word(i)) << 32) | word(i + 1)) << off;
    nbits = 64 - off;
    wpos = i + 2;
    bit = start;
  }

  __device__ void refill() {
    if (nbits <= 32) {
      cache |= static_cast<uint64_t>(word(wpos)) << (32 - nbits);
      nbits += 32;
      ++wpos;
    }
  }

  __device__ uint32_t peek(int k) const {
    return static_cast<uint32_t>(cache >> (64 - k));
  }

  __device__ void consume(int k) {
    cache <<= k;
    nbits -= k;
    bit += k;
  }

  // One big-values value: its escape (linbits) and its sign.
  __device__ int value(int v, int lb, int mv) {
    refill();
    int ext = 0;
    if (lb != 0 && v == mv - 1) {
      ext = static_cast<int>(peek(16) >> (16 - lb));
      consume(lb);
    }
    bool neg = false;
    if (v > 0) {
      neg = peek(1) != 0;
      consume(1);
    }
    return neg ? -(v + ext) : v + ext;
  }
};

__global__ void __launch_bounds__(kThreads)
huffman_scan_kernel(const uint32_t* __restrict__ words,
                    const int4* __restrict__ fields, int lanes,
                    const int* __restrict__ luts,
                    const int* __restrict__ small, int* __restrict__ out) {
  __shared__ int tab[kSmall];
  for (int i = threadIdx.x; i < kSmall; i += kThreads) {
    tab[i] = small[i];
  }
  __syncthreads();
  const int* book_row = tab;
  const int* linbits = tab + 32;
  const int* maxval = tab + 64;
  const int* quad = tab + 96;

  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= lanes) {
    return;
  }
  const int4 f0 = fields[2 * g];           // wbase, wlen, start, end bit
  const int4 f1 = fields[2 * g + 1];       // r0, r1, big2, tables
  const int max_bit = f0.w;
  const int r0 = f1.x;
  const int r1 = f1.y;
  const int big2 = f1.z;
  const int ts[3] = {f1.w & 31, (f1.w >> 5) & 31, (f1.w >> 10) & 31};
  const bool table_b = ((f1.w >> 15) & 1) == 1;

  Reader rd;
  rd.w = words + f0.x;
  rd.n = f0.y;
  rd.init(f0.z);

  // out[ch][t] with ch = g & 1, t = 2f + gr = g >> 1, T = lanes / 2
  const int t_len = lanes >> 1;
  int* o = out + (static_cast<int64_t>(g & 1) * t_len + (g >> 1)) * kSamples;

  int s = 0;
  for (; s < big2; s += 2) {
    rd.refill();
    const int table = s < r0 ? ts[0] : (s < r1 ? ts[1] : ts[2]);
    const int book = book_row[table];
    int v0 = 0;
    int v1 = 0;
    if (table != 0 && book >= 0) {
      const int packed =
          __ldg(luts + (static_cast<int64_t>(book) << kLutBits)
                + rd.peek(kLutBits));
      const int size = packed & 31;
      if (size > 0) {
        rd.consume(size);
        const int lb = linbits[table];
        const int mv = maxval[table];
        v0 = rd.value(packed >> 9, lb, mv);
        v1 = rd.value((packed >> 5) & 15, lb, mv);
      }
    }
    o[s] = v0;
    o[s + 1] = v1;
  }

  for (s = big2; rd.bit < max_bit && s + 4 < kSamples; s += 4) {
    rd.refill();
    int v[4];
    if (table_b) {
      const uint32_t b = rd.peek(4);
      for (int i = 0; i < 4; ++i) {
        v[i] = 1 - static_cast<int>((b >> (3 - i)) & 1u);
      }
      rd.consume(4);
    } else {
      const int qp = quad[rd.peek(6)];
      const int p = qp >> 5;
      for (int i = 0; i < 4; ++i) {
        v[i] = (p >> (3 - i)) & 1;
      }
      rd.consume(qp & 31);
    }
    for (int i = 0; i < 4; ++i) {
      if (v[i] > 0) {
        if (rd.peek(1) != 0) {
          v[i] = -v[i];
        }
        rd.consume(1);
      }
      o[s + i] = v[i];
    }
  }
  for (; s < kSamples; ++s) {
    o[s] = 0;
  }
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers: words (n_words,) uint32 with the frames' main data and zero pad
// words at the end; fields (lanes, 8) int32, 16-byte aligned; luts (books,
// 2^19) int32; small (160,) int32 = book row, linbits, maxval (32 each by
// table id), QUAD_LUT (64); out (2, lanes / 2, 576) int32, allocated by the
// caller. lanes must be a positive multiple of 4.
extern "C" int huffman_scan(const void* words, const void* fields, int lanes,
                            const void* luts, const void* small, void* out,
                            int n_words, void* stream) {
  if (lanes <= 0 || lanes % 4 != 0 || n_words <= 0
      || (reinterpret_cast<uintptr_t>(fields) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1)
                                                / kThreads);
  huffman_scan_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int4*>(fields),
      lanes, static_cast<const int*>(luts), static_cast<const int*>(small),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
