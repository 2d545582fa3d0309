// Q31 encode analysis of the MP3 encode path (kernel K3), written by hand for
// Hopper (sm_90a): polyphase window, 32-band filter with the analysis
// inversion, the 36 -> 18 MDCT per band and the alias butterflies.
//
// Replaces the JAX package's mp3stego_tpu/ops/encode_plane.py::analysis_mdct
// (:35; also analysis_mdct_i16 :105 and run_analysis_device :161), an XLA
// program (dense gathers, products and reductions over the whole stream;
// not a pallas_call). Its plain PyTorch version is
// mp3stego_tpu_torch/ops/encode_plane.py::analysis_stream_torch; the kernel
// equals it bit for bit, and the host C++ twin native/src/encode_plane.cpp
// (encode_analysis), whose arithmetic it copies. Per channel stream s of
// int16 samples (480 of history in front), window step t and granule g:
//
//   tmp[t][i] = sum_k mulhi(s[32 t + 511 - 64 k - i] << 16, en[64 k + i])
//   sb[t][b]  = sum_j mulhi(fl[b][j], tmp[t][j]), negated (0u - v) where
//               t % 18 and b are both odd
//   freq[g][b][l] = sum_m mulhi(in[b][m], cos[l][m]),
//               in[b] = [sb(g - 1) ; sb(g)] over 36 steps, sb(-1) = 0
//   alias:   for b >= 1, i < 8, from the unmodified MDCT outputs
//            bu = freq[b][i], bd = freq[b - 1][17 - i]:
//            freq[b][i]        = (bu cs[i] - bd ca[i]) >> 31
//            freq[b - 1][17 - i] = (bu ca[i] + bd cs[i]) >> 31   (int64)
//
// The streams come either as padded int16 rows (channels, 480 + tg * 576)
// or as the WAV's interleaved int16 samples as the host holds them,
// channel c at c + nch * t, zero before the stream and past the buffer's
// end; the spectra are the same.
//
// Exactness. mulhi is __mulhi, the high word of the 64-bit product, which is
// fx.mul's int32((int64 a * int64 b) >> 32) for int32 operands (the window
// table fits int32; the wrapper checks). Sums are uint32 and wrap mod 2^32,
// so no summation order can change a bit; but each product is floored on
// its own, so no two merge: neither the tensor cores nor a fast DCT apply.
// The butterflies take their int64 differences in unsigned arithmetic (a
// sum may reach 2^63) and shift the int64 result right by 31
// arithmetically, keeping the low 32 bits.
//
// What bounds it on this card: operations. Per (channel, granule) the
// function takes 66,816 Q31 products (window 18 x 512, filter 18 x 32 x 64,
// MDCT 32 x 18 x 36) and 248 butterflies of 8 operations. sm_90a issues a
// product and its add as one IMAD.HI (its addend a register pair whose low
// word is zero), which holds the INT32 (FMA) pipe two cycles
// (tools/imad_probe.py on an H100: 7.79 T/s against 16.66 for IMAD): 135,616
// cycles a (channel, granule), so the 240.7 s song (2 x 18,432 granules)
// needs 5.0 G, 0.30 ms at 16.75 T/s; its bytes (42.5 MB of int16 read,
// 84.9 MB of int32 written) take 0.04 ms.
//
// Design. Persistent CTAs of 8 warps, 2 an SM (up to 128 registers, no
// spills; the grid comes from the runtime's occupancy query). The wrapper
// cuts each channel's output granules into tiles of g <= 8 granules and
// the tiles into runs, from the stream's length (encode_plane.schedule): a
// song gets tiles of 8 in runs of ~18, a 7-frame streaming window one
// granule a tile on 28 CTAs. A CTA takes one (channel, run) after another
// and walks the run's tiles in order; only a run's first tile computes the
// window and filter of the granule before it (the MDCT's context), every
// later tile takes that granule's 18 x 32 subband rows from the tile
// before, kept in shared memory. A tile's samples (from the interleaved
// buffer, both channels') arrive by 16-byte cp.async while the tile before
// runs its MDCT. Then:
// (1) the window, in batches of 9 steps, warp w taking batches w, w + 8, ..:
//     lane i makes columns i and i + 32 from a sliding window of 16
//     upshifted samples in registers (one load and one shift a step for 16
//     products; its 16 taps in registers) into the warp's scratch rows;
// (2) the filter of the batch's rows, lane b its band: its 64 taps in
//     quarters of 16 registers (read transposed, coalesced), each row as
//     broadcast int4 loads, then the inversion;
// (3) the MDCT: warp w takes granule w, lane b its band, its 18 outputs in
//     two halves of 9 accumulators, the cosines broadcast int4 loads from
//     shared memory, into the warp's scratch in the plane's layout;
// (4) the butterflies from those unmodified outputs, every lane computing
//     from clamped neighbours, four slots at a time;
// (5) the granule leaves as 18 coalesced 128-byte rows, out[ch][g][18 b + l].

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxG = 8;                       // output granules a tile
constexpr int kWarps = 8;                      // one granule per warp (MDCT)
constexpr int kThreads = 32 * kWarps;
constexpr int kPast = 480;                     // window history per stream
constexpr int kSteps = (kMaxG + 1) * 18;       // window steps, context first
constexpr int kSpan = (kMaxG + 1) * 576 + kPast;  // a tile's samples
constexpr int kBatch = 9;                      // window steps a batch
constexpr int kScratch = 576;                  // ints a warp's scratch
constexpr int kCos = 24;                       // a cosine row: 2 x 9, padded
constexpr int kSmem = sizeof(int) * kSteps * 32        // sb
                      + sizeof(int) * kWarps * kScratch  // warp scratch
                      + sizeof(int) * 36 * kCos          // MDCT cosines
                      + 2 * sizeof(short) * kSpan;       // the samples,
                                                         // two channels

static_assert(kWarps == kMaxG, "the MDCT takes one granule per warp");
static_assert(kBatch * 64 == kScratch, "a batch's window rows fit");
static_assert(18 % kBatch == 0, "a tile's steps are whole batches");
static_assert(kSpan % 8 == 0, "the sample buffer is whole 16-byte chunks");
static_assert(kPast % 8 == 0 && 576 % 8 == 0,
              "interleaved tiles start on 16-byte boundaries");

struct Params {
  const short* pcm;        // (channels, stride) int16 streams, or (len,)
                           // interleaved samples: channel c at c + nch * t
  const int* window;       // (512,) the analysis window, int32
  const int* filter_t;     // (64, 32) the subband filter, transposed [j][b]
  int* out;                // (channels, n_out, 576)
  long long stride;        // 480 + tg * 576
  long long len;           // interleaved: int16 values in the buffer
  int tg;                  // granules in the stream
  int n_out;               // tg - skip
  int items;               // (channel, run) pairs: channels * runs
  int nch;                 // 0: streams; 1 or 2: the interleaved buffer's
                           // channels
  int skip;                // granules of context in front of the first output
  int g;                   // output granules a tile
  int run;                 // tiles a run
  int runs;                // runs a channel
  int tiles;               // tiles a channel
  int cos_l[18 * 36];      // MDCT cosines [l][m]
  int cs[8];               // alias butterfly coefficients
  int ca[8];
};

// One tile of a CTA's walk. ng = 0 marks the end of the walk.
struct Tile {
  int g0;                  // first output granule, a stream index
  int c;                   // channel
  int ng;                  // output granules
  int first;               // first local window step computed: 0 computes
                           // the context granule, 18 takes it from the
                           // tile before (carry) or zeroes it (g0 = 0)
  bool carry;              // the context rows are the tile before's, a
                           // full tile of the same run
};

__device__ Tile tile_of(const Params& p, int item, int k) {
  Tile t{};
  if (item >= p.items || k >= p.run) return t;
  const int tile = item % p.runs * p.run + k;
  if (tile >= p.tiles) return t;
  t.c = item / p.runs;
  t.g0 = p.skip + tile * p.g;
  t.ng = min(p.g, p.tg - t.g0);
  t.carry = k > 0;
  t.first = k == 0 && t.g0 > 0 ? 0 : 18;
  return t;
}

// A tile's samples, padded stream indices (g0 - 1) * 576 + x for x from
// first * 32 to (ng + 1) * 576 + 480, into buf[x] (streams) or, from the
// interleaved buffer, every channel's: buf[nch * x + c] = pcm[nch * ((g0 -
// 1) * 576 + x - 480) + c], zero in front of the buffer and past its end.
// 16-byte cp.async chunks (stream rows, interleaved tiles and the 480
// samples of history start on 16-byte boundaries, and the wrapper checks
// the base); the chunk that holds the buffer's end is copied by element.
__device__ void load_tile(const Params& p, const Tile& t, short* buf) {
  const long long base = (t.g0 - 1) * 576LL;
  const int end = ((t.ng + 1) * 576 + kPast) / 8;
  if (p.nch == 0) {
    const short* src = p.pcm + t.c * p.stride + base;
    for (int q = t.first * 4 + static_cast<int>(threadIdx.x); q < end;
         q += kThreads) {
      __pipeline_memcpy_async(buf + 8 * q, src + 8 * q, 16);
    }
  } else {
    const long long e0 = p.nch * (base - kPast);  // buffer index of buf[0]
    for (int q = p.nch * t.first * 4 + static_cast<int>(threadIdx.x);
         q < p.nch * end; q += kThreads) {
      const long long e = e0 + 8 * q;
      if (e >= 0 && e + 8 <= p.len) {
        __pipeline_memcpy_async(buf + 8 * q, p.pcm + e, 16);
      } else if (e + 8 <= 0 || e >= p.len) {
        *reinterpret_cast<int4*>(buf + 8 * q) = make_int4(0, 0, 0, 0);
      } else {
        for (int r = 0; r < 8; ++r) {
          buf[8 * q + r] = e + r >= 0 && e + r < p.len ? p.pcm[e + r]
                                                       : short(0);
        }
      }
    }
  }
  __pipeline_commit();
}

__device__ __forceinline__ unsigned mulhi(int a, int b) {
  return static_cast<unsigned>(__mulhi(a, b));
}

// a sample upshifted by 16: the window's Q31 operand
__device__ __forceinline__ int up16(short s) {
  return static_cast<int>(static_cast<unsigned>(s) << 16);
}

// int32 of (v >> 31) for the int64 bit pattern v
__device__ __forceinline__ int shr31(unsigned long long v) {
  return static_cast<int>(static_cast<unsigned>(
      static_cast<unsigned long long>(static_cast<long long>(v) >> 31)));
}

__device__ __forceinline__ unsigned long long wide(int a, int b) {
  return static_cast<unsigned long long>(static_cast<long long>(a) * b);
}

// the analysis inversion: odd step within the granule, odd band
__device__ __forceinline__ int invert(unsigned v, int step, int band) {
  return static_cast<int>((step % 18 & 1) && (band & 1) ? 0u - v : v);
}

// The window of the kBatch steps from local step t0 into rows[s][64]:
// lane i makes columns i and i + 32. Step t reads V(t - m) = s[32 (t - m)
// + 511 - i] for m < 16 (column i the even m, column i + 32 the odd), so a
// lane keeps a sliding window of 16 upshifted samples: one load and one
// shift a step for 16 products.
__device__ __forceinline__ void window_batch(const Params& p,
                                             const short* pcm, int step,
                                             int t0, int lane, int* rows) {
  int e[16];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    e[2 * q] = p.window[64 * q + lane];
    e[2 * q + 1] = p.window[64 * q + 32 + lane];
  }
  const short* s = pcm + (511 - lane) * step;
  const int row = 32 * step;                   // a window step's samples
  int u[16];                                   // u[(j - m) & 15] = V(t - m)
#pragma unroll
  for (int m = 1; m < 16; ++m) u[16 - m] = up16(s[row * (t0 - m)]);
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    u[j] = up16(s[row * (t0 + j)]);
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      lo += mulhi(u[(j - 2 * q) & 15], e[2 * q]);
      hi += mulhi(u[(j - 2 * q - 1) & 15], e[2 * q + 1]);
    }
    rows[j * 64 + lane] = static_cast<int>(lo);
    rows[j * 64 + 32 + lane] = static_cast<int>(hi);
  }
}

// The filter and the inversion of the kBatch window rows into sb rows t0
// .. t0 + kBatch - 1: lane b, its 64 taps in four quarters of 16
// registers, each row read as broadcast int4 loads.
__device__ __forceinline__ void filter_batch(const Params& p,
                                             const int* rows, int t0,
                                             int lane, int* sb) {
  unsigned acc[kBatch];
#pragma unroll
  for (int s = 0; s < kBatch; ++s) acc[s] = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    int f[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = p.filter_t[(16 * h + j) * 32 + lane];
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int4* r = reinterpret_cast<const int4*>(rows + s * 64 + 16 * h);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = r[q];
        acc[s] += mulhi(f[4 * q], v.x) + mulhi(f[4 * q + 1], v.y)
                  + mulhi(f[4 * q + 2], v.z) + mulhi(f[4 * q + 3], v.w);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kBatch; ++s) {
    sb[(t0 + s) * 32 + lane] = invert(acc[s], t0 + s, lane);
  }
}

// The MDCT of one granule, lane b its band, and the alias butterflies,
// into rows[b][18] (the plane's layout): the 18 outputs in two halves of 9
// accumulators, each cosine row half read as three broadcast int4 loads;
// the butterflies read the unmodified outputs back from rows.
__device__ __forceinline__ void mdct_granule(const Params& p,
                                             const int* in,
                                             const int* cos_s, int lane,
                                             int* rows) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned acc[9];
#pragma unroll
    for (int l = 0; l < 9; ++l) acc[l] = 0;
#pragma unroll
    for (int m = 0; m < 36; ++m) {
      const int x = in[m * 32];
      const int4* c = reinterpret_cast<const int4*>(cos_s + m * kCos
                                                    + 12 * h);
      const int4 c0 = c[0], c1 = c[1], c2 = c[2];
      const int cl[9] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w,
                         c2.x};
#pragma unroll
      for (int l = 0; l < 9; ++l) acc[l] += mulhi(x, cl[l]);
    }
#pragma unroll
    for (int l = 0; l < 9; ++l) {
      rows[lane * 18 + 9 * h + l] = static_cast<int>(acc[l]);
    }
  }
  __syncwarp();
  // band b slot i ("bu") with band b - 1 slot 17 - i ("bd"): lane b makes
  // its slot i from band b - 1 and its slot 17 - i from band b + 1, four i
  // at a time (every lane computes both; band 0 keeps its slots i, band 31
  // its slots 17 - i)
  const int up = max(lane - 1, 0);
  const int dn = min(lane + 1, 31);
#pragma unroll
  for (int i0 = 0; i0 < 8; i0 += 4) {
    int lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = shr31(wide(rows[lane * 18 + i0 + i], p.cs[i0 + i])
                    - wide(rows[up * 18 + 17 - i0 - i], p.ca[i0 + i]));
      hi[i] = shr31(wide(rows[dn * 18 + i0 + i], p.ca[i0 + i])
                    + wide(rows[lane * 18 + 17 - i0 - i], p.cs[i0 + i]));
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (lane > 0) rows[lane * 18 + i0 + i] = lo[i];
      if (lane < 31) rows[lane * 18 + 17 - i0 - i] = hi[i];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
analysis_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sb = reinterpret_cast<int*>(smem);                    // [kSteps][32]
  int* scratch = sb + kSteps * 32;                    // [kWarps][kScratch]
  int* cos_s = scratch + kWarps * kScratch;                  // [36][kCos]
  short* pcm = reinterpret_cast<short*>(cos_s + 36 * kCos);  // [2 kSpan]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* rows = scratch + warp * kScratch;

  // cos_s[m][12 h + j] = cos[9 h + j][m]
  for (int x = tid; x < 36 * 18; x += kThreads) {
    const int l = x / 36;
    cos_s[(x % 36) * kCos + 12 * (l / 9) + l % 9] = p.cos_l[x];
  }

  int item = blockIdx.x;
  int k = 0;
  Tile cur = tile_of(p, item, 0);
  if (cur.ng) load_tile(p, cur, pcm);
  while (cur.ng) {
    __pipeline_wait_prior(0);
    __syncthreads();                 // the samples are in, the tile before done
    const int first = cur.first;
    const int steps = (cur.ng + 1) * 18;       // local steps, context first
    // the tile's channel: its own buffer, or every nch-th sample from c
    const int step = max(p.nch, 1);
    const short* samples = pcm + (p.nch ? cur.c : 0);

    // the context granule's subband rows: the last granule of the tile
    // before (full: only a channel's last tile is not, and it ends its
    // run), or zero in front of the stream
    if (first == 18) {
      for (int x = tid; x < 18 * 32; x += kThreads) {
        sb[x] = cur.carry ? sb[p.g * 18 * 32 + x] : 0;
      }
      __syncthreads();
    }

    // ---- (1)-(2) window and filter: the tile's steps in batches of
    // kBatch, warp w taking batches w, w + 8, ... through its scratch rows
    for (int t0 = first + kBatch * warp; t0 < steps; t0 += kBatch * kWarps) {
      window_batch(p, samples, step, t0, lane, rows);
      __syncwarp();
      filter_batch(p, rows, t0, lane, sb);
      __syncwarp();
    }
    __syncthreads();

    // the next tile of the walk: the run's next, else the next item's
    // first; its samples load while this tile's MDCT runs
    int next_item = item;
    int next_k = k + 1;
    Tile nxt = tile_of(p, item, next_k);
    if (!nxt.ng) {
      next_item = item + gridDim.x;
      next_k = 0;
      nxt = tile_of(p, next_item, 0);
    }
    if (nxt.ng) load_tile(p, nxt, pcm);

    // ---- (3)-(5) warp w: output granule g0 + w, lane b: band b; the
    // granule leaves through the warp's scratch as 18 coalesced rows
    if (warp < cur.ng) {
      mdct_granule(p, sb + warp * 18 * 32 + lane, cos_s, lane, rows);
      int* dst = p.out + (static_cast<long long>(cur.c) * p.n_out
                          + cur.g0 + warp - p.skip) * 576;
#pragma unroll
      for (int r = 0; r < 18; ++r) dst[r * 32 + lane] = rows[r * 32 + lane];
    }

    cur = nxt;
    item = next_item;
    k = next_k;
  }
}

// Above 48 KB a launch may use dynamic shared memory only up to the
// kernel's raised limit.
cudaError_t raise_smem_limit() {
  return cudaFuncSetAttribute(analysis_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem);
}

}  // namespace
// The CTAs of analysis_kernel an SM holds at its dynamic shared memory (the
// runtime's occupancy query), its warps a CTA, its bytes of shared memory a
// CTA and the most output granules a tile; returns the CUDA error (0 =
// success).
extern "C" int analysis_occupancy(int* ctas, int* warps, int* smem,
                                  int* granules) {
  cudaError_t err = raise_smem_limit();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, analysis_kernel, kThreads, kSmem);
  }
  *warps = kWarps;
  *smem = kSmem;
  *granules = kMaxG;
  return static_cast<int>(err);
}

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers: pcm, on a 16-byte boundary, either the streams (channels, 480
// + tg * 576) int16 C-contiguous (`interleaved` 0) or the WAV's
// interleaved int16 samples (len,), channel c at c + channels * t for t <
// tg * 576, zero past len, with 480 zeros of history in front of each
// channel (`interleaved` 1, channels 1 or 2); window (512,) and the
// transposed filter_t (64, 32) int32; out (channels, tg - skip, 576)
// int32, which the caller allocates. Host pointers: cos_l (18, 36), cs8
// and ca8 (8,) int32, copied into the launch's parameters. Granules skip ..
// tg - 1 are written, in tiles of g and runs of `run` tiles, by `blocks`
// persistent CTAs; granule 0 reads a zero previous granule, every other
// one the granule before it.
extern "C" int analysis_mdct(const void* pcm, int channels, long long tg,
                             int skip, int interleaved, long long len,
                             int g, int run, int blocks,
                             const void* window, const void* filter_t,
                             const int* cos_l, const int* cs8, const int* ca8,
                             void* out, void* stream) {
  if (!pcm || !window || !filter_t || !cos_l || !cs8 || !ca8 || !out
      || channels <= 0 || skip < 0 || tg <= skip || g < 1 || g > kMaxG
      || run < 1 || blocks < 1 || reinterpret_cast<uintptr_t>(pcm) % 16
      || (interleaved && (channels > 2 || len < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (tg - skip + g - 1) / g;
  const long long runs = (tiles + run - 1) / run;
  if (tg > 0x7fffffffLL - kMaxG || channels * runs > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.pcm = static_cast<const short*>(pcm);
  p.window = static_cast<const int*>(window);
  p.filter_t = static_cast<const int*>(filter_t);
  p.out = static_cast<int*>(out);
  p.stride = kPast + tg * 576;
  p.tg = static_cast<int>(tg);
  p.n_out = static_cast<int>(tg - skip);
  p.items = static_cast<int>(channels * runs);
  p.len = len;
  p.nch = interleaved ? channels : 0;
  p.skip = skip;
  p.g = g;
  p.run = run;
  p.runs = static_cast<int>(runs);
  p.tiles = static_cast<int>(tiles);
  for (int x = 0; x < 18 * 36; ++x) p.cos_l[x] = cos_l[x];
  for (int i = 0; i < 8; ++i) {
    p.cs[i] = cs8[i];
    p.ca[i] = ca8[i];
  }
  const cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  analysis_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
