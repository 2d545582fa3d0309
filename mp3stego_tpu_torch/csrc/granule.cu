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
// (decode_plane.index_escapes); the kernel reads both and lays a granule's
// escapes over its clipped samples in shared memory, as the JAX package's
// _requantize_stage does with its scatter. The device Huffman decode hands
// over an int32 plane instead, which needs no escapes.
//
// What bounds it on this card. The function's floor is its bytes: per
// (channel, granule) row it reads 576 int8 samples and writes 1,152 values,
// against about 46 k separately rounded operations (the long IMDCT's 32 x
// 36 x 18 products and sums take 41 k of them): the 240.7 s song's 2 x
// 18,432 rows move 361 MB in double (0.108 ms at 3.35 TB/s) and take 1.7 G
// operations (0.10 ms at 17 T/s). A kernel that keeps every intermediate
// in shared memory meets neither: a first design (one CTA a granule, every
// IMDCT product two loads) ran at 16-20 % of the bytes, and what holds such
// a kernel is its instruction stream, ~15 k warp instructions a granule
// issued at ~4 a cycle an SM, more than the loads, the FP64 pipe or the
// bytes (PERF.md, K2's findings).
//
// Design: fewer instructions a granule, and the next granule's inputs in
// flight behind the current one's work.
// * Persistent CTAs of 9 warps, as many as the runtime's occupancy query
//   fits (4 an SM in float at <= 56 registers, 3 in double at <= 72, no
//   spills); each walks a contiguous run of granule indices holding both
//   channels, since MS and intensity couple them, and loads the long
//   cosines and the windows into shared memory once.
// * While granule t computes, the next one's 2 x 576 samples arrive by
//   16-byte cp.async in a second buffer, and its side information and
//   escapes are fetched into registers and published into shared memory
//   after the requantize stage (the exponent grid computed there), so no
//   stage reads global memory for them and no fetched register is live
//   across the IMDCT.
// * (1)-(2) requantize and stereo fused, one thread a sample index over
//   both channels; (3) alias-only channels (every long-block granule) as
//   248 butterflies, each both outputs from one pair, and 80 copies, the
//   rest (reorder, ISO-mixed blend, the 8 kHz middle) a sample at a time,
//   into a band-strided buffer; three barriers a long-block granule.
// * (4) The IMDCT: a thread owns one output column n, its 18 cosines
//   C[k][n] in registers, and walks the long bands of each channel, the
//   band's samples read as broadcast double2 / float4 vectors (0.5 / 0.3
//   loads a product). Float computes only the 18 distinct sums of the
//   tables' exact symmetry (Layout) and writes the mirror 0 - y or y, each
//   times its own window value. Short bands, rare, go through the dead
//   requantize buffer window by window, then overlap.
// * (5) Float stages both channels' blocks in shared memory and one thread
//   sends them as two contiguous rows by Hopper's bulk copy
//   (cp.async.bulk), overlapped with the next granule; double's 36-wide
//   rows are stored from the IMDCT, which measured no slower.

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 288;                  // 9 warps
constexpr int kSamples = 576;
constexpr int kSlots = 61;                     // exponent grid: 22 + 3 x 13
constexpr int kExp1Off = 266;
constexpr int kMaxPow43 = 8206;                // pow43 has 8,207 rows
constexpr int kNoEscape = -2147483647 - 1;     // no escape at a sample

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
  int run;                     // granule indices a CTA
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }

#ifdef __CUDACC__
// Hopper's bulk copy (cp.async.bulk, no tensor map): `bytes` (a multiple of
// 16) from shared memory to global memory, both on 16-byte boundaries,
// issued by one thread; the waits are that thread's
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the copies committed so far have read their source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written their destination
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes made visible to the bulk copy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
#endif

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

// The IMDCT's layout in type F. Float computes 18 sums a long band and 6 a
// short window: its cosine tables are exactly antisymmetric and symmetric
// (C[k][17 - n] == -C[k][n] for n < 9, C[k][53 - n] == C[k][n] for 18 <= n
// < 27; S[k][5 - m] == -S[k][m] for m < 3, S[k][17 - m] == S[k][m] for 6
// <= m < 9; decode_plane._consts asserts it), and a sum from +0 in round to
// nearest never reaches -0, so the mirrored sum is 0 - y exactly and the
// equal one y. The double tables are not symmetric: double computes all 36.
template <typename F>
struct Layout {
  static constexpr bool kHalf = sizeof(F) == 4;
  static constexpr int kCols = kHalf ? 18 : 36;      // sums a long band
  static constexpr int kGroups = kThreads / kCols;   // bands at once: 16, 8
  static constexpr int kStride = kHalf ? 20 : 18;    // a band's slots in ys,
                                                     // 16-byte aligned
  static constexpr int kShortSums = kHalf ? 6 : 12;  // sums a short window
  static constexpr int kMinBlocks = kHalf ? 4 : 3;   // CTAs an SM: at most
                                                     // 56 or 72 registers
  // float stages a granule's blocks in shared memory and sends them by bulk
  // copy; double, whose stores measured no slower than the copy, stores
  // them from the IMDCT
  static constexpr bool kStaged = kHalf;
  static constexpr int kBlockBytes = kStaged ? 2 * 32 * 36 * sizeof(F) : 0;
};

// xi = sum_k s[k] c[k] from +0 in ascending k, s read as broadcast vectors
__device__ __forceinline__ double long_sum(const double* s,
                                           const double (&c)[18]) {
  const double2* v = reinterpret_cast<const double2*>(s);
  double acc = 0.0;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const double2 x = v[q];
    acc = radd(acc, rmul(x.x, c[2 * q]));
    acc = radd(acc, rmul(x.y, c[2 * q + 1]));
  }
  return acc;
}

__device__ __forceinline__ float long_sum(const float* s,
                                          const float (&c)[18]) {
  const float4* v = reinterpret_cast<const float4*>(s);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 x = v[q];
    acc = radd(acc, rmul(x.x, c[4 * q]));
    acc = radd(acc, rmul(x.y, c[4 * q + 1]));
    acc = radd(acc, rmul(x.z, c[4 * q + 2]));
    acc = radd(acc, rmul(x.w, c[4 * q + 3]));
  }
  const float2 x = reinterpret_cast<const float2*>(s)[8];
  acc = radd(acc, rmul(x.x, c[16]));
  return radd(acc, rmul(x.y, c[17]));
}

// A thread's column n of the long IMDCT (in float also its mirror np): its
// 18 cosines C[k][n], read from the CTA's shared copy into registers.
template <typename F>
struct Column {
  F c[18];
  int n, np;

  __device__ Column(const F* cos_s, int j) {
    n = Layout<F>::kHalf && j >= 9 ? j + 9 : j;
    np = !Layout<F>::kHalf ? n : n < 9 ? 17 - n : 53 - n;
#pragma unroll
    for (int k = 0; k < 18; ++k) c[k] = cos_s[36 * k + n];
  }

  // the band's samples s (18) -> its outputs in dst (36), times the
  // window's values at n (wn) and np (wp)
  __device__ __forceinline__ void long_band(const F* s, F wn, F wp,
                                            F* dst) const {
    const F acc = long_sum(s, c);
    dst[n] = rmul(acc, wn);
    if (Layout<F>::kHalf) {
      dst[np] = rmul(n < 9 ? rsub(F(0), acc) : acc, wp);
    }
  }
};

// Both channels of an alias-only granule (no reorder, not ISO-mixed), xs ->
// the band-strided ys: the 248 butterflies of a channel, s = q % 8 at the
// boundary of bands b - 1 and b = 1 + q / 8, both outputs from the
// unmodified pair (as ``alias`` computes each; a thread's s is the same in
// every pass, since 248 and kThreads are multiples of 8), then the 80
// samples no butterfly touches (k = 8, 9 of every band, k < 8 of band 0,
// k > 9 of band 31), copied.
template <typename F, typename R>
__device__ __forceinline__ void alias_only(const F* xs, F* ys,
                                           const Params<F, R>& p) {
  constexpr int kStride = Layout<F>::kStride;
  constexpr int kPairs = 31 * 8;
  const int tid = threadIdx.x;
  const int s = tid & 7;
  const F cs = __ldg(p.cs + s);
  const F ca = __ldg(p.ca + s);
  for (int q = tid; q < 2 * kPairs; q += kThreads) {
    const int c = q >= kPairs;
    const int b = 1 + ((q - c * kPairs) >> 3);
    const F* x = xs + c * kSamples;
    const F s1 = x[18 * b - 1 - s];            // band b - 1, k = 17 - s
    const F s2 = x[18 * b + s];                // band b, k = s
    F* y = ys + c * 32 * kStride;
    y[kStride * (b - 1) + 17 - s] = rsub(rmul(s1, cs), rmul(s2, ca));
    y[kStride * b + s] = radd(rmul(s2, cs), rmul(s1, ca));
  }
  if (tid < 2 * 80) {
    const int c = tid >= 80;
    const int r = tid - c * 80;
    const int b = r < 64 ? r >> 1 : r < 72 ? 0 : 31;
    const int k = r < 64 ? 8 + (r & 1) : r < 72 ? r - 64 : r - 62;
    ys[c * 32 * kStride + kStride * b + k] = xs[c * kSamples + 18 * b + k];
  }
}

// Short window sum jj of the 6 samples s into the window's 12 windowed
// outputs x (both of a mirrored pair in float).
template <typename F, typename R>
__device__ __forceinline__ void short_window(const Params<F, R>& p,
                                             const F* s, int jj, F* x) {
  const int m = Layout<F>::kHalf && jj >= 3 ? jj + 3 : jj;
  F acc = F(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    acc = radd(acc, rmul(s[k], __ldg(p.c_short_t + 12 * k + m)));
  }
  x[m] = rmul(acc, __ldg(p.sine + 2 * 36 + m));
  if (Layout<F>::kHalf) {
    const int mp = m < 3 ? 5 - m : 17 - m;
    x[mp] = rmul(m < 3 ? rsub(F(0), acc) : acc, __ldg(p.sine + 2 * 36 + mp));
  }
}

// A granule's side information as the stages read it, staged in shared
// memory a granule ahead: the exponent grid of both channels (61 slots:
// 22 long bands, 3 x 13 short) and the per-granule fields.
struct Side {
  int e1[2][kSlots];
  int e2[2][kSlots];
  int mode[2];
  int win_row[2];
  int is_short[2];
  int reorder[2];
  int ms, is, is_tab;
  signed char is_pos[88];
};

// What a thread fetches of the next granule while the current one computes,
// held in registers (no use of them until publish): by role, tid < 122 an
// exponent slot of channel tid / 61 (gg, sfscale, pre or the subblock
// gain, the scalefactor, pre_ext), 122..209 an intensity position,
// 210..220 a per-granule field, 221 the escape index two granules on; and
// every thread escape tid of the granule's range.
struct Fetch {
  int a = 0, b = 0, c = 0, d = 0, e = 0;
  int et = -1, ec = 0, ei = 0, ev = 0;
};

constexpr int kSlotThreads = 2 * kSlots;                 // 122
constexpr int kPosThreads = kSlotThreads + 88;           // 210
constexpr int kIndexThread = kPosThreads + 11;           // 221

template <typename F, typename R>
__device__ __forceinline__ Fetch fetch(const Params<F, R>& p, long long u,
                                       const int* estart) {
  const int tid = threadIdx.x;
  const long long tt = p.tt;
  Fetch f;
  if (tid < kSlotThreads) {
    const int c = tid / kSlots;
    const int s = tid - c * kSlots;
    const long long g = c * tt + u;
    f.a = p.gg[g];
    f.c = p.sfscale[g];
    if (s < 22) {
      f.b = p.pre[g];
      f.d = p.sfl[g * 22 + s];
      f.e = __ldg(p.pre_ext + s);
    } else {
      f.b = p.sbg[g * 3 + (s - 22) / 13];
      f.d = p.sfs[g * 39 + (s - 22)];
    }
  } else if (tid < kPosThreads) {
    f.a = p.is_pos[u * 88 + (tid - kSlotThreads)];
  } else if (tid < kIndexThread) {
    const int k = tid - kPosThreads;          // 0..10
    const int c = k & 1;
    const long long g = c * tt + u;
    f.a = k < 2 ? p.mode[g]
        : k < 4 ? p.win_row[g]
        : k < 6 ? p.is_short_blk[g]
        : k < 8 ? p.reorder_mask[g]
        : k == 8 ? p.ms_mask[u]
        : k == 9 ? p.is_mask[u]
                 : p.is_tab[u];
  } else if (tid == kIndexThread && p.exc_start) {
    f.a = p.exc_start[min(u + 2, tt)];
  }
  if (p.exc_start) {
    const long long k = max(static_cast<long long>(estart[u & 3]), 0LL) + tid;
    if (k < min(static_cast<long long>(estart[(u + 1) & 3]), p.n_exc)) {
      f.et = p.exc_t[k];
      f.ec = p.exc_ch[k];
      f.ei = p.exc_s[k];
      f.ev = p.exc_val[k];
    }
  }
  return f;
}

// the int8 plane's escape (c, i) = v of granule u over its clipped sample;
// an entry outside the granule or the plane (a malformed index) is skipped,
// so no write leaves the arrays
__device__ __forceinline__ void put_escape(int* ov, long long u, int t, int c,
                                           int i, int v) {
  if (t == u && c >= 0 && c < 2 && i >= 0 && i < kSamples) {
    ov[c * kSamples + i] = v;
  }
}

// Writes what ``fetch`` brought of granule u into its shared buffers: the
// side information (the exponent grid computed here), the escape index two
// granules on, and the escapes over the overlay ov; a granule's escapes past
// the first kThreads are read here.
template <typename F, typename R>
__device__ __forceinline__ void publish(const Params<F, R>& p, const Fetch& f,
                                        long long u, Side& sd, int* ov,
                                        int* estart) {
  const int tid = threadIdx.x;
  if (tid < kSlotThreads) {
    const int c = tid / kSlots;
    const int s = tid - c * kSlots;
    int exp1, val;
    if (s < 22) {
      exp1 = f.a - 210;
      val = f.d + f.b * f.e;
    } else {
      exp1 = f.a - 210 - 8 * f.b;
      val = f.d;
    }
    const int mult2 = f.c == 0 ? 1 : 2;
    sd.e1[c][s] = min(max(exp1 + kExp1Off, 0), 511);
    sd.e2[c][s] = min(max(mult2 * val, 0), 63);
  } else if (tid < kPosThreads) {
    sd.is_pos[tid - kSlotThreads] = static_cast<signed char>(f.a);
  } else if (tid < kIndexThread) {
    const int k = tid - kPosThreads;
    const int c = k & 1;
    if (k < 2) sd.mode[c] = f.a;
    else if (k < 4) sd.win_row[c] = min(max(f.a, 0), 3);
    else if (k < 6) sd.is_short[c] = f.a;
    else if (k < 8) sd.reorder[c] = f.a;
    else if (k == 8) sd.ms = f.a;
    else if (k == 9) sd.is = f.a;
    else sd.is_tab = f.a;
  } else if (tid == kIndexThread && p.exc_start) {
    estart[(u + 2) & 3] = f.a;
  }
  if (p.exc_start) {
    if (f.et >= 0) put_escape(ov, u, f.et, f.ec, f.ei, f.ev);
    const long long hi = min(static_cast<long long>(estart[(u + 1) & 3]),
                             p.n_exc);
    for (long long k = max(static_cast<long long>(estart[u & 3]), 0LL)
             + kThreads + tid; k < hi; k += kThreads) {
      put_escape(ov, u, p.exc_t[k], p.exc_ch[k], p.exc_s[k], p.exc_val[k]);
    }
  }
}

// granule u's 2 x 576 samples into dst by 16-byte cp.async (the wrapper
// hands a plane on a 16-byte boundary; a row is 576 or 2,304 bytes)
template <typename R>
__device__ __forceinline__ void stage_samples(const R* raw, long long tt,
                                              long long u, R* dst) {
  constexpr int kChunk = 16 / sizeof(R);
  constexpr int kChunks = kSamples / kChunk;   // a channel's
  for (int q = threadIdx.x; q < 2 * kChunks; q += kThreads) {
    const int c = q / kChunks;
    const int j = (q - c * kChunks) * kChunk;
    __pipeline_memcpy_async(dst + c * kSamples + j,
                            raw + (c * tt + u) * kSamples + j, 16);
  }
  __pipeline_commit();
}

template <typename F, typename R>
__global__ void __launch_bounds__(kThreads, Layout<F>::kMinBlocks)
granule_kernel(const __grid_constant__ Params<F, R> p) {
  __shared__ __align__(16) R rs[2][2 * kSamples];   // staged samples
  __shared__ int ov[2 * kSamples];             // escapes, kNoEscape elsewhere
  __shared__ F xs[2][kSamples];                // requantized + stereo
  __shared__ __align__(16) F ys[2][32 * Layout<F>::kStride];  // reordered
                                               // / aliased, by band
  __shared__ Side side[2];
  __shared__ int estart[4];                    // exc_start[u] at u & 3
  __shared__ F cos_s[18 * 36];                 // c_long_t [k][n]
  __shared__ F win_s[4 * 36];                  // sine [row][n]
  // float: the granule's blocks of both channels, [c][32 x 36], leaving by
  // bulk copy while the next granule computes
  extern __shared__ __align__(16) unsigned char smem[];
  F* const ob = reinterpret_cast<F*>(smem);

  const int tid = threadIdx.x;
  const long long tt = p.tt;
  const long long t0 = static_cast<long long>(blockIdx.x) * p.run;
  const long long t1 = min(t0 + p.run, tt);
  if (t0 >= t1) return;

  using L = Layout<F>;
  const int grp = tid / L::kCols;

  // the cosines and windows once a CTA; the first granule's inputs,
  // fetched and published at once
  for (int x = tid; x < 18 * 36; x += kThreads) {
    cos_s[x] = __ldg(p.c_long_t + x);
  }
  for (int x = tid; x < 4 * 36; x += kThreads) win_s[x] = __ldg(p.sine + x);
  for (int i = tid; i < 2 * kSamples; i += kThreads) ov[i] = kNoEscape;
  if (tid < 2 && p.exc_start) {
    estart[(t0 + tid) & 3] = p.exc_start[t0 + tid];
  }
  __syncthreads();
  stage_samples(p.raw, tt, t0, rs[0]);
  publish(p, fetch(p, t0, estart), t0, side[0], ov, estart);

#pragma unroll 1
  for (long long t = t0; t < t1; ++t) {
    const int cur = static_cast<int>(t - t0) & 1;
    __pipeline_wait_prior(0);
    __syncthreads();           // granule t's inputs in, granule t - 1 done
    const Side& sd = side[cur];
    const bool more = t + 1 < t1;
    Fetch f;
    if (more) {                // granule t + 1 comes in while t computes
      stage_samples(p.raw, tt, t + 1, rs[cur ^ 1]);
      f = fetch(p, t + 1, estart);
    }

    // ---- (1)-(2) requantize and stereo, one thread a sample index over
    // both channels
    const bool ms = sd.ms;
    const bool is = sd.is;
    const F* coef = p.is_coef + sd.is_tab * 32;
    for (int i = tid; i < kSamples; i += kThreads) {
      F x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int r = rs[cur][c * kSamples + i];
        if (sizeof(R) == 1) {
          const int e = ov[c * kSamples + i];
          if (e != kNoEscape) {
            r = e;
            ov[c * kSamples + i] = kNoEscape;
          }
        }
        const int slot = __ldg(p.slot_exp + sd.mode[c] * kSamples + i);
        // |r| <= 8206 for every stream a parser gives; the clamp only
        // keeps a corrupt plane's reads inside the table
        const unsigned mag = r < 0 ? 0u - unsigned(r) : unsigned(r);
        const F a = __ldg(p.pow43 + min(mag, unsigned(kMaxPow43)));
        x[c] = requant(r < 0 ? -a : a, sd.e1[c][slot], sd.e2[c][slot], p);
      }
      if (ms) {
        const F sqrt2 = *p.sqrt2;
        const F l = rdiv(radd(x[0], x[1]), sqrt2);
        const F r = rdiv(rsub(x[0], x[1]), sqrt2);
        x[0] = l;
        x[1] = r;
      }
      if (is) {
        const int pos = sd.is_pos[__ldg(p.slot_is + sd.mode[1] * kSamples
                                        + i)];
        if (pos >= 0) {
          const int pc = min(pos, 15);
          x[1] = rmul(x[0], __ldg(coef + 16 + pc));
          x[0] = rmul(x[0], __ldg(coef + pc));
        }
      }
      xs[0][i] = x[0];
      xs[1][i] = x[1];
    }
    __syncthreads();
    // granule t + 1's side information and escapes into its buffers, now
    // that granule t's escapes are read
    if (more) publish(p, f, t + 1, side[cur ^ 1], ov, estart);

    // ---- (3) reorder / alias / ISO-mixed blend, xs -> ys: alias-only
    // channels (every long-block granule) by butterfly, the rest a sample
    // at a time
    if (sd.mode[0] != 3 && !sd.reorder[0] && sd.mode[1] != 3
        && !sd.reorder[1]) {
      alias_only(xs[0], ys[0], p);
    } else {
      for (int o = tid; o < 2 * kSamples; o += kThreads) {
        const int c = o / kSamples;
        const int i = o - c * kSamples;
        const F* x = xs[c];
        const bool m3 = sd.mode[c] == 3;
        F v;
        if (m3 && __ldg(p.mix_raw_cols + i)) {
          v = x[i];
        } else if (m3 && __ldg(p.mix_lin_cols + i)) {
          v = x[lin_src(i)];
        } else if (m3 ? __ldg(p.mix_short_cols + i) : sd.reorder[c]) {
          const int src = __ldg(p.reorder_perm + i);
          v = src >= 0 ? x[src] : F(0);
        } else {
          v = alias(x, i, p);
        }
        ys[c][L::kStride * (i / 18) + i % 18] = v;
      }
    }
    if (L::kStaged && tid == 0) bulk_wait_read();  // ob free: t - 1 read
    __syncthreads();

    // ---- (4) IMDCT and windows: a thread owns one output column (a pair
    // in float) with its cosines in registers and walks the long bands
    // grp, grp + kGroups, ... of each channel
    {
      const Column<F> col(cos_s, tid % L::kCols);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const F wn = win_s[36 * sd.win_row[c] + col.n];
        const F wp = win_s[36 * sd.win_row[c] + col.np];
        const bool any_short = sd.is_short[c];
        const bool m3 = sd.mode[c] == 3;
        const F* s = ys[c] + L::kStride * grp;
        F* dst = (L::kStaged ? ob + c * (32 * 36)
                             : p.out + (c * tt + t) * (32 * 36)) + 36 * grp;
#pragma unroll 1
        for (int b = grp; b < 32; b += L::kGroups) {
          if (!any_short || (m3 && __ldg(p.mix_long_band + b))) {
            col.long_band(s, wn, wp, dst);
          }
          s += L::kStride * L::kGroups;
          dst += 36 * L::kGroups;
        }
      }
    }
    // short bands (none in a long-block granule): per channel, each
    // window's 12 outputs into the dead xs, then the overlap into the blocks
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
      if (!sd.is_short[c]) continue;           // the same in every thread
      __syncthreads();                         // xs free (and c = 0 done)
      F* xw = xs[0];                           // [band][3 x 12]
      const bool m3 = sd.mode[c] == 3;
      for (int it = tid; it < 32 * 3 * L::kShortSums; it += kThreads) {
        const int b = it / (3 * L::kShortSums);
        const int rem = it - b * (3 * L::kShortSums);
        const int w = rem / L::kShortSums;
        if (m3 && __ldg(p.mix_long_band + b)) continue;
        short_window(p, ys[c] + L::kStride * b + 6 * w,
                     rem - w * L::kShortSums, xw + 36 * b + 12 * w);
      }
      __syncthreads();
      F* dst = L::kStaged ? ob + c * (32 * 36)
                          : p.out + (c * tt + t) * (32 * 36);
      for (int o = tid; o < 32 * 36; o += kThreads) {
        const int b = o / 36;
        const int n = o - 36 * b;
        if (m3 && __ldg(p.mix_long_band + b)) continue;
        // [0 x 6, w0[0:6], w0[6:12] + w1[0:6], w1[6:12] + w2[0:6],
        //  w2[6:12], 0 x 6]: window w covers outputs 6 + 6w .. 17 + 6w
        const F* x = xw + 36 * b;
        F v = F(0);
        if (n >= 6 && n < 30) {
          const int q = (n - 6) / 6;           // a sixth of the 24 slots
          const int j = n - 6 - 6 * q;
          v = q == 0 ? x[j]
            : q == 3 ? x[30 + j]
                     : radd(x[12 * q - 6 + j], x[12 * q + j]);
        }
        dst[o] = v;
      }
    }
    // ---- (5) float: the blocks leave as two contiguous 1,152-value rows
    // by bulk copy, overlapped with the next granule
    if (L::kStaged) {
      fence_async_shared();
      __syncthreads();
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          bulk_store(p.out + (c * tt + t) * (32 * 36), ob + c * (32 * 36),
                     32 * 36 * sizeof(F));
        }
        bulk_commit();
      }
    }
  }
  if (L::kStaged && tid == 0) bulk_wait();
}

// Above 48 KB of static and dynamic shared memory a launch needs the
// kernel's raised limit.
template <typename F, typename R>
cudaError_t raise_smem_limit() {
  return cudaFuncSetAttribute(granule_kernel<F, R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<F>::kBlockBytes);
}

template <typename F, typename R>
cudaError_t occupancy(int* ctas) {
  cudaError_t err = raise_smem_limit<F, R>();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, granule_kernel<F, R>, kThreads, Layout<F>::kBlockBytes);
  }
  return err;
}

template <typename F, typename R>
int launch(const void* const* in, long long tt, long long n_exc, int blocks,
           void* out, void* stream) {
  // the escape arrays of an empty list have no storage
  for (int k = 0; k < kInputs; ++k) {
    const bool may_be_null = k == kExcT || k == kExcCh || k == kExcS
        || k == kExcVal ? n_exc == 0 : k == kExcStart && sizeof(R) != 1;
    if (!in[k] && !may_be_null) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (reinterpret_cast<uintptr_t>(in[kRaw]) % 16
      || reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.run = static_cast<int>((tt + blocks - 1) / blocks);
  const cudaError_t err = raise_smem_limit<F, R>();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  granule_kernel<F, R><<<static_cast<unsigned>((tt + p.run - 1) / p.run),
                         kThreads, Layout<F>::kBlockBytes,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int dispatch(const void* const* in, int n_in, long long tt, int wide,
             long long n_exc, int blocks, void* out, void* stream) {
  if (!in || !out || n_in != kInputs || tt <= 0 || tt > 0x7fffffffLL
      || n_exc < 0 || (wide && n_exc != 0) || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return wide ? launch<F, int>(in, tt, n_exc, blocks, out, stream)
              : launch<F, signed char>(in, tt, n_exc, blocks, out, stream);
}

}  // namespace

// The CTAs of granule_kernel an SM holds (the runtime's occupancy query) for
// the instantiation of `dbl` (0 float, 1 double) and `wide` (0 the int8
// plane, 1 the int32 one), its warps a CTA and its bytes of dynamic shared
// memory a CTA; returns the CUDA error (0 = success).
extern "C" int granule_occupancy(int dbl, int wide, int* ctas, int* warps,
                                 int* smem) {
  *warps = kThreads / 32;
  *smem = dbl ? Layout<double>::kBlockBytes : Layout<float>::kBlockBytes;
  const cudaError_t err =
      dbl ? (wide ? occupancy<double, int>(ctas)
                  : occupancy<double, signed char>(ctas))
          : (wide ? occupancy<float, int>(ctas)
                  : occupancy<float, signed char>(ctas));
  return static_cast<int>(err);
}

// Launch on `stream` and return cudaGetLastError() (0 = launched). `in` is a
// host array of n_in == 39 device pointers in the order of enum Input: the
// sample plane (2, tt, 576) on a 16-byte boundary, int8 (wide == 0) or int32
// (wide == 1); for the int8 plane exc_start (tt + 1) int32 and the n_exc
// escapes in granule order (exc_t int32, exc_ch int8, exc_s and exc_val
// int16; null when n_exc == 0), for the int32 plane five ignored pointers
// and n_exc == 0; the per-granule side information and the static maps as
// host_prepare types them (int8, int16, int32, bool as one byte), then the
// plane's tables in the kernel's type (pow43, e1lut, e2lut, quarter, is_coef,
// cs, ca, c_long_t, c_short_t, sine, sqrt2), every tensor C-contiguous. out
// (2, tt, 32, 36) is allocated by the caller. At most `blocks` persistent
// CTAs, each a contiguous run of granule indices, tt <= 2^31 - 1.
extern "C" int granule_blocks_f32(const void* const* in, int n_in,
                                  long long tt, int wide, long long n_exc,
                                  int blocks, void* out, void* stream) {
  return dispatch<float>(in, n_in, tt, wide, n_exc, blocks, out, stream);
}

extern "C" int granule_blocks_f64(const void* const* in, int n_in,
                                  long long tt, int wide, long long n_exc,
                                  int blocks, void* out, void* stream) {
  return dispatch<double>(in, n_in, tt, wide, n_exc, blocks, out, stream);
}
