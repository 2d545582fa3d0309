// Granule half of the MP3 decode plane (kernel K2), written by hand for
// Hopper (sm_90a), in float and in double: requantize, MS and intensity
// stereo, the short-block reorder, the alias butterflies and the windowed
// IMDCT of one granule of both channels, from the Huffman samples to the
// blocks that the synthesis kernel K1 (csrc/synth.cu) reads.
//
// Replaces the JAX package's mp3stego_tpu/ops/decode_plane.py::granule_blocks
// (:729) with its stages _requantize_stage, _stereo_stage,
// _reorder_alias_stage and _imdct_stage, an XLA program (one-hot matmuls,
// gathers and elementwise passes over the whole file; not a pallas_call). Its
// plain PyTorch version is mp3stego_tpu_torch/ops/decode_plane.py::
// granule_blocks_torch; the kernel equals it bit for bit in both types, and
// in double the float64 NumPy plane (decode_granules_np) and the host C++
// plane (native/src/decode_plane_f64.cpp) too. Per channel c, granule t and
// sample i (x[c][i], 576 a granule):
//
//   1. requantize: a = pow43[|r|], s = r < 0 ? -a : a; the exponents of the
//      sample's slot on the 61-slot grid (22 long bands, 3 x 13 short),
//      exp1 = clamp(gg - 210 [- 8 sbg[w]] + 266, 0, 511) and exp2x2 =
//      clamp(mult2 * (sfl[b] + pre * pre_ext[b] | sfs[w][b]), 0, 63);
//      double: (s * e1lut[exp1]) * e2lut[exp2x2]; float: q = exp1 - 266 -
//      2 exp2x2, s * (quarter[q & 3] * 2^(q >> 2)), the power of two built
//      from exponent bits.
//   2. stereo: MS granules (l, r) = ((x0 + x1) / sqrt2, (x0 - x1) / sqrt2), a
//      true division; intensity granules where the band's position p >= 0:
//      (x0, x1) = (x0 A[p], x0 B[p]) from the post-MS left channel.
//   3. reorder, alias and the ISO-mixed blend: short samples take
//      x[perm[i]] (+0 where perm is -1); long ones the butterflies
//      x1 cs - x2 ca and x2 cs + x1 ca of the unmodified pair; mode-3
//      (ISO-mixed) granules split the columns three ways (raw, the 8 kHz
//      unreordered middle, reordered above the boundary).
//   4. IMDCT: long bands xi[n] = sum_k s[k] C[k][n] over 18 k, times the
//      window row; short bands three 6 -> 12 transforms, each times the
//      short window, overlapped into 36 with +0 in the 6 + 6 edge slots.
//
// Exactness. The file is built with --fmad=false, and every product, sum and
// division is an explicit _rn intrinsic besides, so nothing contracts. Both
// IMDCT sums start from +0 and add in ascending k, as ascending_matmul does,
// so a -0 product sum ends as +0 there too; a short output slot with one
// window term is that term, not 0 + term. The kernel computes only the path a
// band takes (long or short) and only the alias or reorder value a sample
// keeps, which is what the plain version keeps of its whole-array passes.
//
// The samples. The host parse hands over the int8 plane (|x| <= 127, the
// sign kept where a sample was clipped) and its sparse linbits escapes in
// granule order, with exc_start (T + 1) marking each granule's range
// (decode_plane.index_escapes); the kernel reads both and writes a granule's
// escapes over its clipped samples in shared memory, as the JAX package's
// _requantize_stage does with its scatter. The device Huffman decode hands
// over an int32 plane instead, which needs no escapes.
//
// What bounds it on this card: bytes. Per (channel, granule) row the function
// reads 576 int8 samples and writes 1,152 values, against about 46 k
// separately rounded operations (the long IMDCT's 32 x 36 x 18 products and
// sums take 41 k of them): the 240.7 s song's 2 x 18,432 rows move 361 MB in
// double (0.108 ms at 3.35 TB/s) and take 1.7 G operations (0.10 ms at 17
// T/s). So every intermediate lives in shared memory and only the samples,
// the escapes, the side information and the blocks touch device memory.
//
// Design (a first, simple one). One CTA of 9 warps per granule index t holds
// both channels, since MS and intensity couple them: (0) the two channels'
// 61 exponent slots and 2 x 576 samples into shared memory, then the
// granule's escapes over them; (1) the requantized samples into a shared
// buffer, one thread a sample; (2) stereo in place, one thread per sample
// index over both channels; (3) reorder, alias and blend from that buffer
// into a second one, so both butterfly inputs are read before any write;
// (4) one thread per (channel, band, output) computes only its band's path
// and stores along the 36-wide rows, 1,152 contiguous values a channel.
// pow43 (8,207 entries) and the small tables are read through the read-only
// cache; the cosines are the same few KB for every CTA. Tensor cores, TMA,
// several granules per CTA and overlap are left for later.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 288;                  // 9 warps
constexpr int kSamples = 576;
constexpr int kSlots = 61;                     // exponent grid: 22 + 3 x 13
constexpr int kExp1Off = 266;
constexpr int kMaxPow43 = 8206;                // pow43 has 8,207 rows

using i8 = signed char;
using u8 = unsigned char;

// the order of the input pointers the entry points take
enum Input {
  kRaw, kExcStart, kExcT, kExcCh, kExcS, kExcVal, kMode, kGg, kSfscale, kPre, kSbg, kSfl, kSfs, kWinRow, kIsShortBlk,
  kReorderMask, kMsMask, kIsMask, kIsPos, kIsTab, kSlotExp, kSlotIs,
  kReorderPerm, kPreExt, kMixShortCols, kMixRawCols, kMixLinCols,
  kMixLongBand, kPow43, kE1lut, kE2lut, kQuarter, kIsCoef, kCs, kCa, kCLongT,
  kCShortT, kSine, kSqrt2, kInputs
};

template <typename F, typename R>
struct Params {
  const R* raw;                // (2, T, 576) Huffman samples, int8 or int32
  const int* exc_start;        // (T + 1,) escape ranges (int8 plane only)
  const int* exc_t;            // (n_exc,) granule of each escape
  const i8* exc_ch;            // (n_exc,) its channel
  const short* exc_s;          // (n_exc,) its sample index
  const short* exc_val;        // (n_exc,) its value
  const i8* mode;              // (2, T) walk mode 0..3
  const short* gg;             // (2, T) global gain
  const i8* sfscale;           // (2, T)
  const i8* pre;               // (2, T)
  const i8* sbg;               // (2, T, 3) subblock gain
  const i8* sfl;               // (2, T, 22) long scalefactors
  const i8* sfs;               // (2, T, 39) short scalefactors [w][13]
  const i8* win_row;           // (2, T) sine-window row
  const u8* is_short_blk;      // (2, T)
  const u8* reorder_mask;      // (2, T)
  const u8* ms_mask;           // (T,)
  const u8* is_mask;           // (T,)
  const i8* is_pos;            // (T, 4, 22) intensity positions
  const i8* is_tab;            // (T,) coefficient row
  const short* slot_exp;       // (4, 576) sample -> exponent slot
  const short* slot_is;        // (4, 576) sample -> position slot
  const int* reorder_perm;     // (576,)
  const int* pre_ext;          // (22,)
  const u8* mix_short_cols;    // (576,)
  const u8* mix_raw_cols;      // (576,)
  const u8* mix_lin_cols;      // (576,)
  const u8* mix_long_band;     // (32,)
  const F* pow43;              // (8207,)
  const F* e1lut;              // (512,)
  const F* e2lut;              // (64,)
  const F* quarter;            // (4,)
  const F* is_coef;            // (6, 2, 16)
  const F* cs;                 // (8 * 31,), the 8 coefficients repeated
  const F* ca;
  const F* c_long_t;           // (18, 36) [k][n]
  const F* c_short_t;          // (6, 12) [k][n]
  const F* sine;               // (4, 36) window rows
  const F* sqrt2;              // (1,)
  F* out;                      // (2, T, 32, 36)
  long long tt;                // granules a channel
  long long n_exc;             // escapes
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }

// requantize's scale in decode_granules_np's order: (s * e1) * e2
template <typename R>
__device__ __forceinline__ double requant(double s, int exp1, int exp2x2,
                                          const Params<double, R>& p) {
  return rmul(rmul(s, __ldg(p.e1lut + exp1)), __ldg(p.e2lut + exp2x2));
}

// float: s * (quarter[q & 3] * 2^(q >> 2)), q >> 2 an arithmetic shift; q
// lies in [-392, 245], so 2^(q >> 2) is a normal float
template <typename R>
__device__ __forceinline__ float requant(float s, int exp1, int exp2x2,
                                         const Params<float, R>& p) {
  const int q = exp1 - kExp1Off - 2 * exp2x2;
  const float scale = rmul(__ldg(p.quarter + (q & 3)),
                          __int_as_float(((q >> 2) + 127) << 23));
  return rmul(s, scale);
}

// source column of the 8 kHz unreordered middle (columns 36..71): a
// per-18-chunk transpose of (6, 3) into (3, 6); other columns read
// themselves
__device__ __forceinline__ int lin_src(int i) {
  if (i < 36 || i >= 72) return i;
  const int j = i - 36;
  const int rem = j % 18;
  return 36 + (j / 18) * 18 + (rem % 6) * 3 + rem / 6;
}

// the alias-reduced value of column i: band b = i / 18 >= 1 pairs its first
// 8 columns with the last 8 of band b - 1, mirrored
template <typename F, typename R>
__device__ __forceinline__ F alias(const F* x, int i, const Params<F, R>& p) {
  const int k = i % 18;
  const int b = i / 18;
  if (k >= 10 && b <= 30) {                    // upper half, s = 17 - k
    const int s = 17 - k;
    const F s1 = x[i];
    const F s2 = x[i + 2 * s + 1];
    return rsub(rmul(s1, __ldg(p.cs + s)), rmul(s2, __ldg(p.ca + s)));
  }
  if (k <= 7 && b >= 1) {                      // lower half, s = k
    const F s2 = x[i];
    const F s1 = x[i - 2 * k - 1];
    return radd(rmul(s2, __ldg(p.cs + k)), rmul(s1, __ldg(p.ca + k)));
  }
  return x[i];
}

template <typename F, typename R>
__global__ void __launch_bounds__(kThreads)
granule_kernel(const __grid_constant__ Params<F, R> p) {
  __shared__ int rs[2][kSamples];              // samples, escapes written in
  __shared__ F xs[2][kSamples];                // requantized, then stereo
  __shared__ F ys[2][kSamples];                // reordered / aliased
  __shared__ int e1s[2][kSlots];
  __shared__ int e2s[2][kSlots];

  const long long t = blockIdx.x;
  const long long tt = p.tt;
  const int tid = threadIdx.x;

  // ---- (0) the exponent grid of both channels
  if (tid < 2 * kSlots) {
    const int c = tid / kSlots;
    const int s = tid - c * kSlots;
    const long long g = c * tt + t;
    const int gg = p.gg[g];
    int exp1, val;
    if (s < 22) {
      exp1 = gg - 210;
      val = int(p.sfl[g * 22 + s]) + int(p.pre[g]) * p.pre_ext[s];
    } else {
      exp1 = gg - 210 - 8 * int(p.sbg[g * 3 + (s - 22) / 13]);
      val = p.sfs[g * 39 + (s - 22)];
    }
    const int mult2 = p.sfscale[g] == 0 ? 1 : 2;
    e1s[c][s] = min(max(exp1 + kExp1Off, 0), 511);
    e2s[c][s] = min(max(mult2 * val, 0), 63);
  }
  // ... and the samples of both channels
  for (int o = tid; o < 2 * kSamples; o += kThreads) {
    const int c = o / kSamples;
    const int i = o - c * kSamples;
    rs[c][i] = int(p.raw[(c * tt + t) * kSamples + i]);
  }
  __syncthreads();

  // the int8 plane's escapes of granule t over its clipped samples; an
  // entry outside the granule or the plane (a malformed index) is skipped,
  // so no read or write leaves the arrays
  if (p.exc_start) {
    const long long lo = max(static_cast<long long>(p.exc_start[t]), 0LL);
    const long long hi = min(static_cast<long long>(p.exc_start[t + 1]),
                             p.n_exc);
    for (long long k = lo + tid; k < hi; k += kThreads) {
      const int c = p.exc_ch[k];
      const int i = p.exc_s[k];
      if (p.exc_t[k] == t && c >= 0 && c < 2 && i >= 0 && i < kSamples) {
        rs[c][i] = p.exc_val[k];
      }
    }
    __syncthreads();
  }

  // ---- (1) requantize, one thread a sample
  for (int o = tid; o < 2 * kSamples; o += kThreads) {
    const int c = o / kSamples;
    const int i = o - c * kSamples;
    const long long g = c * tt + t;
    const int r = rs[c][i];
    const int slot = p.slot_exp[int(p.mode[g]) * kSamples + i];
    // |r| <= 8206 for every stream a parser gives; the clamp only keeps a
    // corrupt plane's reads inside the table
    const unsigned mag = r < 0 ? 0u - unsigned(r) : unsigned(r);
    const F a = __ldg(p.pow43 + min(mag, unsigned(kMaxPow43)));
    xs[c][i] = requant(r < 0 ? -a : a, e1s[c][slot], e2s[c][slot], p);
  }
  __syncthreads();

  // ---- (2) MS and intensity stereo, in place
  const bool ms = p.ms_mask[t];
  const bool is = p.is_mask[t];
  if (ms || is) {
    const F sqrt2 = *p.sqrt2;
    const int mode1 = p.mode[tt + t];
    const F* coef = p.is_coef + int(p.is_tab[t]) * 32;
    for (int i = tid; i < kSamples; i += kThreads) {
      F x0 = xs[0][i];
      F x1 = xs[1][i];
      if (ms) {
        const F l = rdiv(radd(x0, x1), sqrt2);
        const F r = rdiv(rsub(x0, x1), sqrt2);
        x0 = l;
        x1 = r;
      }
      if (is) {
        const int pos = p.is_pos[t * 88 + p.slot_is[mode1 * kSamples + i]];
        if (pos >= 0) {
          const int pc = min(pos, 15);
          x1 = rmul(x0, __ldg(coef + 16 + pc));
          x0 = rmul(x0, __ldg(coef + pc));
        }
      }
      xs[0][i] = x0;
      xs[1][i] = x1;
    }
  }
  __syncthreads();

  // ---- (3) reorder / alias / ISO-mixed blend, xs -> ys
  for (int o = tid; o < 2 * kSamples; o += kThreads) {
    const int c = o / kSamples;
    const int i = o - c * kSamples;
    const long long g = c * tt + t;
    const F* x = xs[c];
    const bool m3 = p.mode[g] == 3;
    F v;
    if (m3 && p.mix_raw_cols[i]) {
      v = x[i];
    } else if (m3 && p.mix_lin_cols[i]) {
      v = x[lin_src(i)];
    } else if (m3 ? p.mix_short_cols[i] : p.reorder_mask[g]) {
      const int src = p.reorder_perm[i];
      v = src >= 0 ? x[src] : F(0);
    } else {
      v = alias(x, i, p);
    }
    ys[c][i] = v;
  }
  __syncthreads();

  // ---- (4) IMDCT and windows, one thread per (channel, band, output)
  for (int o = tid; o < 2 * 32 * 36; o += kThreads) {
    const int c = o / (32 * 36);
    const int rem = o - c * (32 * 36);
    const int b = rem / 36;
    const int n = rem - b * 36;
    const long long g = c * tt + t;
    const F* s = ys[c] + 18 * b;
    const bool short_band = p.is_short_blk[g]
        && !(p.mode[g] == 3 && p.mix_long_band[b]);
    F v = F(0);
    if (!short_band) {
      F acc = F(0);
#pragma unroll
      for (int k = 0; k < 18; ++k) {
        acc = radd(acc, rmul(s[k], __ldg(p.c_long_t + k * 36 + n)));
      }
      const int row = min(max(int(p.win_row[g]), 0), 3);
      v = rmul(acc, __ldg(p.sine + row * 36 + n));
    } else {
      // [0 x 6, w0[0:6], w0[6:12] + w1[0:6], w1[6:12] + w2[0:6], w2[6:12],
      //  0 x 6]: window w covers outputs 6 + 6w .. 17 + 6w
      bool first = true;
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const int m = n - 6 - 6 * w;
        if (m < 0 || m >= 12) continue;
        F acc = F(0);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          acc = radd(acc, rmul(s[6 * w + k], __ldg(p.c_short_t + k * 12 + m)));
        }
        acc = rmul(acc, __ldg(p.sine + 2 * 36 + m));
        v = first ? acc : radd(v, acc);
        first = false;
      }
    }
    p.out[g * (32 * 36) + rem] = v;
  }
}

template <typename F, typename R>
int launch(const void* const* in, long long tt, long long n_exc, void* out,
           void* stream) {
  // the escape arrays of an empty list have no storage
  for (int k = 0; k < kInputs; ++k) {
    const bool may_be_null = k == kExcT || k == kExcCh || k == kExcS
        || k == kExcVal ? n_exc == 0 : k == kExcStart && sizeof(R) != 1;
    if (!in[k] && !may_be_null) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Params<F, R> p;
  p.raw = static_cast<const R*>(in[kRaw]);
  p.exc_start = sizeof(R) == 1 ? static_cast<const int*>(in[kExcStart])
                               : nullptr;
  p.exc_t = static_cast<const int*>(in[kExcT]);
  p.exc_ch = static_cast<const i8*>(in[kExcCh]);
  p.exc_s = static_cast<const short*>(in[kExcS]);
  p.exc_val = static_cast<const short*>(in[kExcVal]);
  p.mode = static_cast<const i8*>(in[kMode]);
  p.gg = static_cast<const short*>(in[kGg]);
  p.sfscale = static_cast<const i8*>(in[kSfscale]);
  p.pre = static_cast<const i8*>(in[kPre]);
  p.sbg = static_cast<const i8*>(in[kSbg]);
  p.sfl = static_cast<const i8*>(in[kSfl]);
  p.sfs = static_cast<const i8*>(in[kSfs]);
  p.win_row = static_cast<const i8*>(in[kWinRow]);
  p.is_short_blk = static_cast<const u8*>(in[kIsShortBlk]);
  p.reorder_mask = static_cast<const u8*>(in[kReorderMask]);
  p.ms_mask = static_cast<const u8*>(in[kMsMask]);
  p.is_mask = static_cast<const u8*>(in[kIsMask]);
  p.is_pos = static_cast<const i8*>(in[kIsPos]);
  p.is_tab = static_cast<const i8*>(in[kIsTab]);
  p.slot_exp = static_cast<const short*>(in[kSlotExp]);
  p.slot_is = static_cast<const short*>(in[kSlotIs]);
  p.reorder_perm = static_cast<const int*>(in[kReorderPerm]);
  p.pre_ext = static_cast<const int*>(in[kPreExt]);
  p.mix_short_cols = static_cast<const u8*>(in[kMixShortCols]);
  p.mix_raw_cols = static_cast<const u8*>(in[kMixRawCols]);
  p.mix_lin_cols = static_cast<const u8*>(in[kMixLinCols]);
  p.mix_long_band = static_cast<const u8*>(in[kMixLongBand]);
  p.pow43 = static_cast<const F*>(in[kPow43]);
  p.e1lut = static_cast<const F*>(in[kE1lut]);
  p.e2lut = static_cast<const F*>(in[kE2lut]);
  p.quarter = static_cast<const F*>(in[kQuarter]);
  p.is_coef = static_cast<const F*>(in[kIsCoef]);
  p.cs = static_cast<const F*>(in[kCs]);
  p.ca = static_cast<const F*>(in[kCa]);
  p.c_long_t = static_cast<const F*>(in[kCLongT]);
  p.c_short_t = static_cast<const F*>(in[kCShortT]);
  p.sine = static_cast<const F*>(in[kSine]);
  p.sqrt2 = static_cast<const F*>(in[kSqrt2]);
  p.out = static_cast<F*>(out);
  p.tt = tt;
  p.n_exc = n_exc;
  granule_kernel<F, R><<<static_cast<unsigned>(tt), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int dispatch(const void* const* in, int n_in, long long tt, int wide,
             long long n_exc, void* out, void* stream) {
  if (!in || !out || n_in != kInputs || tt <= 0 || tt > 0x7fffffffLL
      || n_exc < 0 || (wide && n_exc != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return wide ? launch<F, int>(in, tt, n_exc, out, stream)
              : launch<F, signed char>(in, tt, n_exc, out, stream);
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 = launched). `in` is a
// host array of n_in == 39 device pointers in the order of enum Input: the
// sample plane (2, tt, 576), int8 (wide == 0) or int32 (wide == 1); for the
// int8 plane exc_start (tt + 1) int32 and the n_exc escapes in granule order
// (exc_t int32, exc_ch int8, exc_s and exc_val int16; null when n_exc == 0),
// for the int32 plane five ignored pointers and n_exc == 0; the
// per-granule side information and the static maps as host_prepare types
// them (int8, int16, int32, bool as one byte), then the plane's tables in the
// kernel's type (pow43, e1lut, e2lut, quarter, is_coef, cs, ca, c_long_t,
// c_short_t, sine, sqrt2), every tensor C-contiguous. out (2, tt, 32, 36) is
// allocated by the caller. One CTA per granule index, tt <= 2^31 - 1.
extern "C" int granule_blocks_f32(const void* const* in, int n_in,
                                  long long tt, int wide, long long n_exc,
                                  void* out, void* stream) {
  return dispatch<float>(in, n_in, tt, wide, n_exc, out, stream);
}

extern "C" int granule_blocks_f64(const void* const* in, int n_in,
                                  long long tt, int wide, long long n_exc,
                                  void* out, void* stream) {
  return dispatch<double>(in, n_in, tt, wide, n_exc, out, stream);
}
