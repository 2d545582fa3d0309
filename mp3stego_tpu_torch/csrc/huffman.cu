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
// boundaries r0 and r1, big2 = 2 x big_values (even, 0..576), and ts0 | ts1
// << 5 | ts2 << 10 | c1sel << 15. Words past the frame's count read as zeros.
//
//   big-values pairs, s = 0, 2, .. < big2: the table of s's region picks a
//     codebook (tables 0, 4, 14 decode as a skip). Its codeword gives the
//     entry x << 9 | y << 5 | length; length 0 (no codeword, a corrupt
//     stream) skips the pair and consumes nothing. Each of x, y reads linbits
//     more bits when it is maxval - 1 and the table has linbits, then a sign
//     bit when it is nonzero.
//   count1 quads, s = big2, big2 + 4, .. while bit < end bit and s + 4 < 576:
//     table B is 4 inverted bits, table A the 6-bit QUAD_LUT (p << 5 |
//     length); a sign bit per nonzero value.
//   every other sample is zero.
//
// Design (measured step by step on an H100 against the step before; the
// numbers and the variants that lost are in PERF.md):
//   * the codebooks: the 15 big-values codebooks as one two-level table of
//     16-bit entries (ops/huffman_device.py::codebook_table), 7,522 entries
//     (15 KB) at an 8-bit first level, loaded into shared memory once a CTA
//     with the per-table-id metadata (first-level base, linbits, escape
//     value) and QUAD_LUT. A first-level entry, indexed by the next 8 bits,
//     is a leaf x << 9 | y << 5 | length, or (bit 15 set) a sub-table: ext
//     << 11 | offset / 2, indexed by the ext bits after the first 8. The
//     flat 2^19-entry LUTs (30 MiB) stay on the host for the plain version.
//   * the words: a warp's lanes are 8 frames, whose main data lie back to
//     back; the warp stages that range (up to kStage words, else it reads
//     global memory) in shared memory by cp.async before it walks.
//   * the reader: a bit cursor; each codeword, pair or quad peeks the 32
//     bits at the cursor from two words and consumes once: a pair's
//     codeword (<= 19 bits) and both sign bits, a quad's code (<= 6) and
//     its sign bits. A pair with an escape reads each value's linbits and
//     sign from a peek of its own.
//   * the plane: a lane's samples as int4 vectors (a pair fills half of
//     one). The pair loop runs to the warp's largest big2, so all 32 lanes
//     are in it together: each lane puts its complete vectors into its row
//     of a per-warp chunk buffer in shared memory, and every 32 samples the
//     warp writes the 32 rows' chunks, 4 rows of 128 contiguous bytes a
//     store. The quads store their vectors themselves (by selects, as
//     lanes' quads start apart); each row's zero tail is written by the
//     whole warp, a row at a time, 512 contiguous bytes a store.
//
// What bounds it: neither bytes nor operations but the instruction stream of
// the walk. A pair's codeword length sets where the next pair starts, so a
// lane's up to 288 pairs and 144 quads run one after another, and all the
// song's 36,864 lanes are resident at once (9 warps an SM): the SM's issue
// and shared-memory pipes, shared by the walk's reads and the plane's
// stores, set the pace. A small launch (a few warps an SM) is bound by the
// chain's latency instead, which the chunk buffer's flushes lengthen.

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSamples = 576;
constexpr int kFirst = 8;                  // first-level index bits
constexpr int kSub = 0x8000;               // a first-level entry's sub flag
constexpr int kMeta = 32;                  // per table id: base | lb | esc
constexpr int kQuad = 64;                  // QUAD_LUT
constexpr int kSmall = kMeta + kQuad;      // ints before the codebook table
constexpr int kStage = 2560;               // words staged a warp: 10 KB
constexpr int kChunk = 8;                  // vectors of a row a flush
constexpr int kChunkRow = kChunk + 1;      // a row in the buffer, padded

// A lane's bit cursor over its frame's words (shared memory when staged,
// else global): 32 bits at a time from any position, words past the
// frame's count reading as zeros.
template <bool kShared>
struct Reader {
  const uint32_t* w;                       // the lane's frame words
  int n;                                   // their count
  int pos;                                 // the absolute bit cursor

  __device__ uint32_t word(int i) const {
    if (static_cast<unsigned>(i) >= static_cast<unsigned>(n)) {
      return 0u;
    }
    return kShared ? w[i] : __ldg(w + i);
  }

  // the 32 bits from the cursor, the first at bit 31
  __device__ uint32_t peek() const {
    const int i = pos >> 5;
    const uint64_t two = (static_cast<uint64_t>(word(i)) << 32) | word(i + 1);
    return static_cast<uint32_t>((two << (pos & 31)) >> 32);
  }

  // One big-values value of a pair with an escape: its linbits (<= 13)
  // and its sign, from one peek.
  __device__ int escaped(int v, int lb, int esc) {
    const uint32_t u = peek();
    int k = 0;
    int ext = 0;
    if (v == esc) {
      ext = static_cast<int>(u >> (32 - lb));
      k = lb;
    }
    const bool neg = v > 0 && ((u << k) >> 31) != 0;
    pos += k + (v > 0);
    return neg ? -(v + ext) : v + ext;
  }
};

// Where a lane's samples go: its row of the plane, as int4 stores of 4
// samples (16 bytes), a pair filling half a vector and the second half
// storing it. s is a sample index, always even.
struct Row {
  int4* o;                                 // the lane's row
  int4 acc;                                // the vector being filled
  int4* cb;                                // the warp's chunk buffer
  int* out;
  int g;
  int lanes;
  int big2;

  // out[ch][t] with ch = g & 1, t = 2f + gr = g >> 1, T = lanes / 2
  static __device__ int4* row(int* out, int g, int lanes) {
    return reinterpret_cast<int4*>(
        out + (static_cast<int64_t>(g & 1) * (lanes >> 1) + (g >> 1))
                  * kSamples);
  }

  __device__ Row(int* out_, int g_, int lanes_, int big2_, int4* cb_)
      : cb(cb_), out(out_), g(g_), lanes(lanes_), big2(big2_) {
    o = row(out, g, lanes);
    acc = make_int4(0, 0, 0, 0);
  }

  // the pair loop runs to the warp's largest big2, so every lane is here:
  // a live pair fills the lane's vector, each complete vector goes to the
  // lane's row of the chunk buffer, and a full chunk (32 samples of every
  // row) goes out by the whole warp
  __device__ void pair(int s, int a, int b, bool live) {
    if (live) {
      if (s & 2) {
        acc.z = a;
        acc.w = b;
        cb[(threadIdx.x & 31) * kChunkRow + ((s >> 2) & (kChunk - 1))] = acc;
      } else {
        acc.x = a;
        acc.y = b;
      }
    }
    if ((s & (4 * kChunk - 1)) == 4 * kChunk - 2) {
      flush(s / (4 * kChunk));
    }
  }

  // after the pair loop, at the warp's largest big2: the last chunk
  __device__ void pairs_done(int wmax) {
    if (wmax & (4 * kChunk - 1)) {
      flush(wmax / (4 * kChunk));
    }
  }

  // chunk c of the warp's 32 rows, each row's complete pair vectors only:
  // 4 rows a store, 128 contiguous bytes each
  __device__ void flush(int c) {
    const int l = threadIdx.x & 31;
    __syncwarp();
    for (int it = 0; it < 32 / (32 / kChunk); ++it) {
      const int j = it * (32 / kChunk) + l / kChunk;
      const int k = l & (kChunk - 1);
      const int bj = __shfl_sync(0xffffffffu, big2, j);
      const int gj = g - l + j;
      const int q = c * kChunk + k;
      if (gj < lanes && q < (bj >> 2)) {
        row(out, gj, lanes)[q] = cb[j * kChunkRow + k];
      }
    }
    __syncwarp();
  }

  // a quad at s = 2 mod 4 completes the pending pair's vector and leaves
  // its second half pending; by selects, as lanes' quads start apart
  __device__ void quad(int s, int a, int b, int c, int d) {
    const bool half = (s & 2) != 0;
    o[s >> 2] = half ? make_int4(acc.x, acc.y, a, b) : make_int4(a, b, c, d);
    acc.x = half ? c : acc.x;
    acc.y = half ? d : acc.y;
  }

  // the pending half vector, zero-filled; returns the first vector left
  __device__ int finish(int s) {
    if (s & 2) {
      acc.z = 0;
      acc.w = 0;
      o[s >> 2] = acc;
      s += 2;
    }
    return s >> 2;
  }

  // the zero tails of the warp's 32 rows, from each lane's first vector
  // left q, a row at a time by the whole warp: 512 contiguous bytes a store
  static __device__ void tail(int* out, int g, int lanes, int q) {
    const int l = threadIdx.x & 31;
    for (int j = 0; j < 32; ++j) {
      const int qj = __shfl_sync(0xffffffffu, q, j);
      const int gj = g - l + j;
      if (gj >= lanes) {
        break;
      }
      int4* o = row(out, gj, lanes);
      for (int k = qj + l; k < kSamples / 4; k += 32) {
        o[k] = make_int4(0, 0, 0, 0);
      }
    }
  }
};

// The chain alone, a measurement: each lane's sum of (s + 1) x sample,
// wrapped to 32 bits, into out[g] in place of its row.
struct Sum {
  int* o;
  unsigned sum;

  __device__ Sum(int* out, int g, int lanes, int, int4*)
      : o(g < lanes ? out + g : nullptr), sum(0) {}

  __device__ void pair(int s, int a, int b, bool live) {
    if (live) {
      sum += (s + 1u) * a + (s + 2u) * b;
    }
  }

  __device__ void pairs_done(int) {}

  __device__ void quad(int s, int a, int b, int c, int d) {
    sum += (s + 1u) * a + (s + 2u) * b + (s + 3u) * c + (s + 4u) * d;
  }

  __device__ int finish(int) {
    if (o) {
      *o = static_cast<int>(sum);
    }
    return kSamples / 4;
  }

  static __device__ void tail(int*, int, int, int) {}
};

// What every lane's walk reads: the launch's arrays and the tables in
// shared memory.
struct Scan {
  const uint32_t* words;
  const int4* fields;
  int lanes;
  int* out;
  const int* meta;                         // per table id: base | lb | esc
  const int* quad;                         // QUAD_LUT
  const uint16_t* code;                    // the codebook table
  int4* chunks;                            // the warps' chunk buffers
};

// Lane g's walk from its fields to its sink, by all the warp's threads (a
// thread past the last lane walks nothing).
template <class Sink, bool kShared>
__device__ int walk(const Scan& c, int g, const uint32_t* words) {
  const bool lane = g < c.lanes;
  const int4 f0 = lane ? __ldg(c.fields + 2 * g) : make_int4(0, 0, 0, 0);
  const int4 f1 = lane ? __ldg(c.fields + 2 * g + 1) : make_int4(0, 0, 0, 0);
  const int max_bit = f0.w;
  const int r0 = f1.x;
  const int r1 = f1.y;
  const int big2 = min(max(f1.z, 0), kSamples);
  const int m[3] = {c.meta[f1.w & 31], c.meta[(f1.w >> 5) & 31],
                    c.meta[(f1.w >> 10) & 31]};
  const bool table_b = ((f1.w >> 15) & 1) == 1;

  Reader<kShared> rd;
  rd.w = words + f0.x;
  rd.n = f0.y;
  rd.pos = f0.z;

  Sink sink(c.out, g, c.lanes, big2,
            c.chunks + (threadIdx.x >> 5) * 32 * kChunkRow);
  const int wmax = __reduce_max_sync(0xffffffffu, big2);
  int s = 0;
  // big-values pairs: one peek holds the codeword (<= 19 bits) and both
  // sign bits; a pair with an escape reads each value's bits again
  for (; s < wmax; s += 2) {
    const int mt = s < r0 ? m[0] : (s < r1 ? m[1] : m[2]);
    int v0 = 0;
    int v1 = 0;
    if (s < big2 && mt >= 0) {
      const int base = mt & 0x3fff;
      const uint32_t u = rd.peek();
      int e = c.code[base + (u >> (32 - kFirst))];
      if (e & kSub) {
        const int ext = (e >> 11) & 15;
        e = c.code[base + ((e & 0x7ff) << 1) + ((u << kFirst) >> (32 - ext))];
      }
      const int size = e & 31;
      const int x = e >> 9;
      const int y = (e >> 5) & 15;
      const int lb = (mt >> 14) & 15;
      const int esc = lb != 0 ? (mt >> 18) & 15 : -1;
      if (size == 0) {
        // no codeword: the pair is skipped and nothing consumed
      } else if (x != esc && y != esc) {
        const uint32_t t = u << size;              // the bits after it
        const int nx = x != 0;
        const int ny = y != 0;
        const bool neg_x = nx && (t >> 31) != 0;
        const bool neg_y = ny && ((nx ? t << 1 : t) >> 31) != 0;
        rd.pos += size + nx + ny;
        v0 = neg_x ? -x : x;
        v1 = neg_y ? -y : y;
      } else {
        rd.pos += size;
        v0 = rd.escaped(x, lb, esc);
        v1 = rd.escaped(y, lb, esc);
      }
    }
    sink.pair(s, v0, v1, s < big2);
  }
  sink.pairs_done(wmax);
  s = big2;

  // count1 quads: one peek holds the code (<= 6 bits) and its sign bits
  for (; rd.pos < max_bit && s + 4 < kSamples; s += 4) {
    const uint32_t u = rd.peek();
    int p;
    int size;
    if (table_b) {
      p = static_cast<int>(~(u >> 28) & 15u);
      size = 4;
    } else {
      const int qp = c.quad[u >> 26];
      p = qp >> 5;
      size = qp & 31;
    }
    const int a = (p >> 3) & 1;
    const int b = (p >> 2) & 1;
    const int d = (p >> 1) & 1;
    const int e = p & 1;
    const uint32_t sg = (u << size) >> 28;       // sign bits, first at 3
    const int k1 = a;
    const int k2 = k1 + b;
    const int k3 = k2 + d;
    rd.pos += size + k3 + e;
    sink.quad(s, a && (sg & 8u) ? -1 : a,
              b && ((sg >> (3 - k1)) & 1u) ? -1 : b,
              d && ((sg >> (3 - k2)) & 1u) ? -1 : d,
              e && ((sg >> (3 - k3)) & 1u) ? -1 : e);
  }
  return sink.finish(s);
}

// tables: kSmall int32 (meta per table id: -1 for a skip, else base |
// linbits << 14 | (maxval - 1) << 18; QUAD_LUT) then the codebook table's
// 16-bit entries, two an int, table_ints ints in all (a multiple of 4).
// Dynamic shared memory: the tables, then kStage words a warp, then a warp's
// chunk buffer (32 rows of kChunkRow vectors) a warp. Sink: Row or Sum.
template <class Sink>
__global__ void __launch_bounds__(kThreads)
huffman_scan_kernel(const uint32_t* __restrict__ words, int n_words,
                    const int4* __restrict__ fields, int lanes,
                    const int* __restrict__ tables, int table_ints,
                    int* __restrict__ out) {
  extern __shared__ int tab[];
  for (int i = threadIdx.x; i < table_ints; i += kThreads) {
    tab[i] = tables[i];
  }
  __syncthreads();
  const Scan c{words, fields, lanes, out, tab, tab + kMeta,
               reinterpret_cast<const uint16_t*>(tab + kSmall),
               reinterpret_cast<int4*>(tab + table_ints
                                       + kThreads / 32 * kStage)};
  // the warp's frames' words, one contiguous range from 16-byte boundary
  // to 16-byte boundary, staged by cp.async if it fits in kStage words
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int l = threadIdx.x & 31;
  uint32_t* st = reinterpret_cast<uint32_t*>(tab + table_ints)
                 + (threadIdx.x >> 5) * kStage;
  const int4 f0 = g < lanes ? __ldg(fields + 2 * g) : make_int4(0, 0, 0, 0);
  const int lo = -__reduce_max_sync(0xffffffffu,
                                    f0.y > 0 ? -f0.x : -(1 << 30));
  const int hi = __reduce_max_sync(0xffffffffu, f0.y > 0 ? f0.x + f0.y : 0);
  const int start = lo & ~3;
  const int n16 = (hi - start + 3) >> 2;
  const bool staged = hi > 0 && n16 * 4 <= kStage
                      && start + n16 * 4 <= n_words;
  if (staged) {
    for (int k = l; k < n16; k += 32) {
      __pipeline_memcpy_async(st + 4 * k, words + start + 4 * k, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncwarp();
  const int q = staged ? walk<Sink, true>(c, g, st - start)
                       : walk<Sink, false>(c, g, words);
  Sink::tail(out, g, lanes, q);
}

int shared_bytes(int table_ints) {
  return (table_ints + kThreads / 32 * (kStage + 32 * kChunkRow * 4))
         * static_cast<int>(sizeof(int));
}

template <class Sink>
int launch(const void* words, const void* fields, int lanes,
           const void* tables, int table_ints, void* out, int n_words,
           void* stream) {
  if (lanes <= 0 || lanes % 4 != 0 || n_words <= 0 || table_ints <= kSmall
      || (reinterpret_cast<uintptr_t>(fields) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1)
                                                / kThreads);
  const int smem = shared_bytes(table_ints);
  const cudaError_t e = cudaFuncSetAttribute(
      huffman_scan_kernel<Sink>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  huffman_scan_kernel<Sink><<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int4*>(fields), lanes,
      static_cast<const int*>(tables), table_ints, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers: words (n_words,) uint32 with the frames' main data and zero pad
// words at the end; fields (lanes, 8) int32, 16-byte aligned; tables
// (table_ints,) int32 as the kernel reads them; out (2, lanes / 2, 576)
// int32, allocated by the caller. lanes must be a positive multiple of 4.
extern "C" int huffman_scan(const void* words, const void* fields, int lanes,
                            const void* tables, int table_ints, void* out,
                            int n_words, void* stream) {
  return launch<Row>(words, fields, lanes, tables, table_ints, out, n_words,
                     stream);
}

// The chain alone: out (lanes,) int32, each lane's sum of (s + 1) x sample.
extern "C" int huffman_scan_chain(const void* words, const void* fields,
                                  int lanes, const void* tables,
                                  int table_ints, void* out, int n_words,
                                  void* stream) {
  return launch<Sum>(words, fields, lanes, tables, table_ints, out, n_words,
                     stream);
}

// What the runtime gives the kernel on the current device with table_ints
// ints of dynamic shared memory: CTAs an SM, threads a CTA, dynamic bytes.
extern "C" int huffman_occupancy(int table_ints, int* ctas, int* threads,
                                 int* smem) {
  *threads = kThreads;
  *smem = shared_bytes(table_ints);
  const cudaError_t e = cudaFuncSetAttribute(
      huffman_scan_kernel<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      *smem);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, huffman_scan_kernel<Row>, kThreads, *smem));
}
