// Native float64 decode numeric plane: the bit-exact parity twin of
// ops/decode_plane.decode_granules_np, in C++.
//
// Behavioural reference (float-for-float): /root/reference/mp3stego/decoder/
//   Frame.py:157-218 (requantize), 561-572 (MS stereo), 574-602 (reorder),
//   604-622 (alias), 106-154 (IMDCT + windowing + overlap-add), 624-631
//   (frequency inversion), 65-103 (polyphase synthesis + 16-tap FIR).
//
// Why this exists: the reference's outputs are float64 and the facade's
// default decode (and hide/reveal/clear, whose re-encode consumes the WAV)
// must be byte-identical, so the parity plane runs on host. The NumPy twin
// (decode_granules_np) needs ~40 full-array passes; this is one fused pass
// per granule, ~10x on a single-core host. decode_granules_np remains the
// oracle; tests pin float-for-float equality.
//
// FP-exactness notes: scalar arithmetic in source order only. The build must
// NOT enable FP contraction or reassociation (-ffp-contract=off, no
// -ffast-math) — an FMA would single-round a*b+c and diverge from NumPy.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#if defined(__x86_64__)
#include <x86intrin.h>
#endif

// Explicit AVX-512 kernels for the three hot accumulations. The FP-exactness
// contract holds: each output element still accumulates in ascending k/j
// order with separate multiply and add (no FMA — intrinsics are never
// contracted), only *different outputs* ride the vector lanes. gcc's
// autovectorizer produces the same semantics but spills the accumulators to
// the stack every iteration; keeping them in zmm registers is ~2-3x here.
// -DMP3STEGO_FORCE_SCALAR builds the portable scalar paths even on an
// AVX-512 host — tests/test_native_scalar.py differential-tests them so
// the non-AVX fallback cannot bit-rot unnoticed.
#if defined(__AVX512F__) && defined(__AVX512VL__) && defined(__AVX512BW__) \
    && !defined(MP3STEGO_FORCE_SCALAR)
#define MP3STEGO_PLANE_AVX512 1
#endif

namespace {

// MP3STEGO_TPU_PLANE_PROF=1: per-stage cycle split printed to stderr per
// call (tuning aid; zero overhead when off — one branch per stage).
inline uint64_t prof_tsc() {
#if defined(__x86_64__)
  return __rdtsc();
#else
  return 0;
#endif
}
inline bool prof_enabled() {
  static const bool on = [] {
    const char* e = std::getenv("MP3STEGO_TPU_PLANE_PROF");
    return e && e[0] == '1';
  }();
  return on;
}
constexpr double kSqrt2 = 1.4142135623730951;  // math.sqrt(2), exact f64

// Output modes: float64 (2,T,576) planes for the parity oracle, or the WAV
// product — interleaved int16 (T*576, nch), reproducing numpy's
// (pcm * 32767).astype(int16) truncate-toward-zero + mod-2^16 wrap.
struct OutF64 {
  double* out;
  int64_t T;
  inline void write(int ch, int64_t t, int step, int n, double v) const {
    out[((int64_t(ch) * T + t) * 576) + step * 32 + n] = v;
  }
  // acc is already in output order (step*32+n contiguous): one copy
  inline void write_granule(int ch, int64_t t, const double (*acc)[32]) const {
    std::memcpy(out + (int64_t(ch) * T + t) * 576, &acc[0][0],
                576 * sizeof(double));
  }
};
struct OutI16 {
  int16_t* out;
  int nch;
  // wrap=true reproduces numpy's (pcm*32767).astype(int16) truncate +
  // mod-2^16 wrap (the reference's conversion; MP3STEGO_TPU_REF_PCM_WRAP=1).
  // wrap=false (default) SATURATES clipping peaks to [-32768, 32767] like
  // every production decoder — the wrap turns overshooting transients into
  // full-scale sign flips.
  bool wrap;
  inline double clampd(double x) const {
    if (wrap) return x;
    return x > 32767.0 ? 32767.0 : (x < -32768.0 ? -32768.0 : x);
  }
  inline void write(int ch, int64_t t, int step, int n, double v) const {
    if (ch >= nch) return;
    out[(t * 576 + step * 32 + n) * nch + ch] =
        int16_t(int32_t(clampd(v * 32767.0)));
  }
  inline void write_granule(int ch, int64_t t, const double (*acc)[32]) const {
#if defined(MP3STEGO_PLANE_AVX512)
    // vector cvttpd matches the scalar int32_t(v*32767.0) truncation lane
    // for lane (including the 0x80000000 overflow sentinel, which both
    // wrap to 0 as int16 in wrap mode); saturation clamps in the double
    // domain, matching numpy's clip-then-truncate exactly
    static thread_local int16_t stage[576];  // ch0 parked until ch1 lands
    const __m512d scale = _mm512_set1_pd(32767.0);
    const __m512d hi = _mm512_set1_pd(32767.0);
    const __m512d lo = _mm512_set1_pd(-32768.0);
    const bool wr = wrap;
    auto cvt = [&](const double* src) -> __m256i {
      __m512d x = _mm512_mul_pd(_mm512_loadu_pd(src), scale);
      if (!wr) x = _mm512_max_pd(lo, _mm512_min_pd(hi, x));
      return _mm512_cvttpd_epi32(x);
    };
    const double* a = &acc[0][0];
    if (nch == 1) {
      if (ch > 0) return;
      int16_t* dst = out + t * 576;
      for (int s = 0; s < 576; s += 8)
        _mm_storeu_si128((__m128i*)(dst + s), _mm256_cvtepi32_epi16(cvt(a + s)));
      return;
    }
    if (ch == 0) {
      for (int s = 0; s < 576; s += 8)
        _mm_storeu_si128((__m128i*)(stage + s),
                         _mm256_cvtepi32_epi16(cvt(a + s)));
      return;
    }
    int16_t* dst = out + t * 1152;   // interleave parked L with this R
    const __m256i lo16 = _mm256_set1_epi32(0xFFFF);
    for (int s = 0; s < 576; s += 8) {
      const __m256i l = _mm256_cvtepi16_epi32(
          _mm_loadu_si128((const __m128i*)(stage + s)));
      const __m256i r = cvt(a + s);
      const __m256i comb = _mm256_or_si256(_mm256_and_si256(l, lo16),
                                           _mm256_slli_epi32(r, 16));
      _mm256_storeu_si256((__m256i*)(dst + 2 * s), comb);
    }
#else
    for (int step = 0; step < 18; ++step)
      for (int n = 0; n < 32; ++n) write(ch, t, step, n, acc[step][n]);
#endif
  }
};

template <class Out>
int64_t decode_plane_run(
    int64_t F,
    // parsed per-granule fields, reference layouts (mp3_parse outputs)
    const int32_t* raw,              // (F,2,2,576)
    const int32_t* block_type,       // (F,2,2)
    const int32_t* mixed_block_flag, // (F,2,2)
    const int32_t* global_gain,      // (F,2,2)
    const int32_t* scale_fac_scale,  // (F,2,2)
    const int32_t* pre_flag,         // (F,2,2)
    const int32_t* sub_block_gain,   // (F,2,2,3)
    const int32_t* scale_fac_l,      // (F,2,2,22)
    const int32_t* scale_fac_s,      // (F,2,2,3,13)
    const uint8_t* ms_stereo,        // (2F,) per granule
    const uint8_t* is_stereo,        // (2F,) per granule: intensity flag
    const int8_t* is_pos,            // (2F,4,22) intensity positions, -1=off
                                     //   (rows 0..2 windows, row 3 long)
    const int8_t* is_tab,            // (2F,) coefficient-table row
    const double* is_ab,             // (6,2,16) [row][A|B][pos] coefficients
    // static walk / permutation tables (samplerate-specific, from python)
    const int32_t* walk_is_short,    // (4,576) rows: 0 long, 1 short,
                                 //   2 reference-mixed, 3 ISO mixed
    const int32_t* walk_sfb,         // (4,576)
    const int32_t* walk_win,         // (4,576)
    const int32_t* pre_ext,          // (23,)
    const int32_t* reorder_perm,     // (576,) -1 = zero-filled tail
    // float64 constant tables
    const double* pow43,             // (8207,)
    const double* e1lut,             // (512,)
    const double* e2lut,             // (64,)
    const double* alias_cs,          // (8,)
    const double* alias_ca,          // (8,)
    const double* c_long,            // (36,18)
    const double* c_short,           // (12,6)
    const double* sine,              // (4,36)
    const double* n_mat,             // (64,32)
    const double* d_win,             // (16,32)
    // ISO-mixed long-WINDOW subband count (2 at every rate — the
    // mpg123/ffmpeg hybrid behavior); 0 = reference mixed handling
    // (MP3STEGO_TPU_REF_MIXED / REF_SHORT_BANDS)
    int64_t mix_nlong,
    // ISO-mixed requantize/reorder boundary sample S (36, or 72 at 8 kHz
    // — decode_plane._mix_geometry); samples 18*mix_nlong..S-1 stay raw
    int64_t mix_s,
    // output
    const Out& sink) {
  const int64_t T = 2 * F;
  // Transposed constant tables: the hot accumulations loop k/j OUTER and the
  // output index INNER, so each output element still accumulates in the
  // NumPy oracle's ascending order (bit-exact) while the compiler vectorizes
  // across outputs (a reduction over k could NOT be vectorized without
  // reassociation, which would change the rounding).
  double c_longT[18][36], c_shortT[6][12], n_matT[32][64];
  for (int i = 0; i < 36; ++i)
    for (int k = 0; k < 18; ++k) c_longT[k][i] = c_long[i * 18 + k];
  for (int i = 0; i < 12; ++i)
    for (int k = 0; k < 6; ++k) c_shortT[k][i] = c_short[i * 6 + k];
  for (int i = 0; i < 64; ++i)
    for (int j = 0; j < 32; ++j) n_matT[j][i] = n_mat[i * 32 + j];
  // per-channel sequential carries: previous granule's window tail and the
  // last 15 synthesis V rows (zero history before stream start)
  double tail_c[2][32][18];
  // rows 0..14: history; 15..32: this granule's V. Rows padded 64 -> 72
  // doubles (576 B, an odd number of cache lines): the FIR slides a
  // 16-row window over these, and a 512 B stride lands every row in the
  // same few L1 sets (measured ~5x the isolated kernel's cycles); the
  // padding spreads the sets. Layout only — values and order unchanged.
  double vlin[2][33][72];
  std::memset(tail_c, 0, sizeof(tail_c));
  std::memset(vlin, 0, sizeof(vlin));

  double x[2][584];          // per-granule working spectra (both channels);
                             // 8 doubles of tail padding absorb the dequant
                             // kernel's unmasked 8-lane stores
  double blk[2][32][36];     // windowed IMDCT blocks
  double y[2][32][18];       // overlap-added, pre-inversion

  // Per-mode RLE of the requantize walk: the exponent indices are constant
  // within a (is_short, sfb, win) run, so the index math hoists out of the
  // per-sample loop (identical FP ops and order inside).
  struct Seg { int start, end, is_short, sfb, win; };
  static thread_local Seg segs[4][576];  // worst case: every sample a run
  int nseg[4];
  for (int m = 0; m < 4; ++m) {
    const int32_t* wis = walk_is_short + m * 576;
    const int32_t* wsf = walk_sfb + m * 576;
    const int32_t* wwi = walk_win + m * 576;
    int k = 0;
    for (int s = 0; s < 576;) {
      int e = s + 1;
      while (e < 576 && wis[e] == wis[s] && wsf[e] == wsf[s]
             && wwi[e] == wwi[s])
        ++e;
      segs[m][k++] = {s, e, int(wis[s]), int(wsf[s]), int(wwi[s])};
      s = e;
    }
    nseg[m] = k;
  }

  const bool prof = prof_enabled();
  uint64_t c_deq = 0, c_pre = 0, c_imdct = 0, c_ov = 0, c_mat = 0, c_fir = 0;
  uint64_t c_sink = 0;
  uint64_t tp0 = 0, tp1 = 0;

  for (int64_t t = 0; t < T; ++t) {
    const int64_t f = t >> 1;
    const int gr = int(t & 1);
    const bool ms = ms_stereo[t] != 0;
    if (prof) tp0 = prof_tsc();

    // ---- requantize (exact multiply order: ((sign*a)*b)*c )
    for (int ch = 0; ch < 2; ++ch) {
      const int64_t g = (f * 2 + gr) * 2 + ch;
      const int bt = block_type[g];
      const int mixed = mixed_block_flag[g];
      const int mode =
          bt == 2 ? ((mixed && mix_nlong) ? 3 : 1) : (mixed ? 2 : 0);
      const int gg = global_gain[g];
      const int mult2 = scale_fac_scale[g] == 0 ? 1 : 2;
      const int pre = pre_flag[g];
      const int32_t* sbg = sub_block_gain + g * 3;
      const int32_t* sfl = scale_fac_l + g * 22;
      const int32_t* sfs = scale_fac_s + g * 39;  // (3,13) flattened
      const int32_t* rw = raw + g * 576;
      double* xc = x[ch];
#if defined(MP3STEGO_PLANE_AVX512)
      // elementwise, so lane-parallel is exact: sign is applied as a real
      // multiply by ±1.0 (the scalar op), pow43 rides a vpgatherdpd.
      // Stores are UNMASKED into the padded row: a block overrunning its
      // segment writes wrong exponents into the next segment's samples,
      // which that segment then overwrites (ascending, non-overlapping).
      const __m512d ones = _mm512_set1_pd(1.0);
      const __m512d negs = _mm512_set1_pd(-1.0);
      const __m256i bound = _mm256_set1_epi32(8206);
      const __m256i zero = _mm256_setzero_si256();
      for (int si = 0; si < nseg[mode]; ++si) {
        const Seg& sg = segs[mode][si];
        int e1i = gg - 210 - (sg.is_short ? 8 * sbg[sg.win] : 0) + 266;
        if (e1i < 0) e1i = 0;
        if (e1i > 511) e1i = 511;
        const int sfb_c = sg.sfb < 21 ? sg.sfb : 21;
        const int sf = sg.is_short ? sfs[sg.win * 13 + sg.sfb]
                                   : sfl[sfb_c] + pre * pre_ext[sfb_c];
        int e2i = mult2 * sf;
        if (e2i < 0) e2i = 0;
        if (e2i > 63) e2i = 63;
        const __m512d e1 = _mm512_set1_pd(e1lut[e1i]);
        const __m512d e2 = _mm512_set1_pd(e2lut[e2i]);
        for (int s = sg.start; s < sg.end; s += 8) {
          // the load stays masked: the final block of the final granule
          // must not read past the caller's raw plane
          const __mmask8 m =
              sg.end - s >= 8 ? __mmask8(0xFF)
                              : __mmask8((1u << (sg.end - s)) - 1);
          const __m256i v =
              _mm256_maskz_loadu_epi32(m, (const int*)(rw + s));
          const __m256i av = _mm256_min_epi32(_mm256_abs_epi32(v), bound);
          const __m512d p = _mm512_i32gather_pd(av, pow43, 8);
          const __mmask8 neg = _mm256_cmplt_epi32_mask(v, zero);
          const __m512d sign = _mm512_mask_blend_pd(neg, ones, negs);
          const __m512d r = _mm512_mul_pd(
              _mm512_mul_pd(_mm512_mul_pd(sign, p), e1), e2);
          _mm512_storeu_pd(xc + s, r);
        }
      }
#else
      for (int si = 0; si < nseg[mode]; ++si) {
        const Seg& sg = segs[mode][si];
        int e1i = gg - 210 - (sg.is_short ? 8 * sbg[sg.win] : 0) + 266;
        if (e1i < 0) e1i = 0;
        if (e1i > 511) e1i = 511;
        const int sfb_c = sg.sfb < 21 ? sg.sfb : 21;
        const int sf = sg.is_short ? sfs[sg.win * 13 + sg.sfb]
                                   : sfl[sfb_c] + pre * pre_ext[sfb_c];
        int e2i = mult2 * sf;
        if (e2i < 0) e2i = 0;
        if (e2i > 63) e2i = 63;
        const double e1v = e1lut[e1i], e2v = e2lut[e2i];
        for (int s = sg.start; s < sg.end; ++s) {
          int32_t v = rw[s];
          int32_t av = v < 0 ? -v : v;
          if (av > 8206) av = 8206;  // linbits bound; corrupt input clamps
          const double sign = v < 0 ? -1.0 : 1.0;
          xc[s] = ((sign * pow43[av]) * e1v) * e2v;
        }
      }
#endif
    }

    // ---- MS stereo
    if (ms) {
#if defined(MP3STEGO_PLANE_AVX512)
      const __m512d rt2 = _mm512_set1_pd(kSqrt2);
      for (int s = 0; s < 576; s += 8) {   // 576 % 8 == 0
        const __m512d mid = _mm512_loadu_pd(x[0] + s);
        const __m512d side = _mm512_loadu_pd(x[1] + s);
        _mm512_storeu_pd(x[0] + s,
                         _mm512_div_pd(_mm512_add_pd(mid, side), rt2));
        _mm512_storeu_pd(x[1] + s,
                         _mm512_div_pd(_mm512_sub_pd(mid, side), rt2));
      }
#else
      for (int s = 0; s < 576; ++s) {
        const double mid = x[0][s], side = x[1][s];
        x[0][s] = (mid + side) / kSqrt2;
        x[1][s] = (mid - side) / kSqrt2;
      }
#endif
    }

    // ---- intensity stereo overlay (beyond-reference; validated vs mpg123
    // on crafted streams — tests/test_intensity.py). Flagged (win, band)
    // pairs replace BOTH channels from the post-MS left: L'=v*A, R'=v*B;
    // plain element-wise f64 multiplies, identical to the NumPy oracle.
    if (is_stereo[t] != 0) {
      const int64_t g1 = (f * 2 + gr) * 2 + 1;   // right channel drives
      const int bt1 = block_type[g1];
      const int mode1 = bt1 == 2 ? ((mixed_block_flag[g1] && mix_nlong) ? 3 : 1)
                                 : (mixed_block_flag[g1] ? 2 : 0);
      const int8_t* ip = is_pos + t * 4 * 22;
      const double* tabA = is_ab + int(is_tab[t]) * 32;
      const double* tabB = tabA + 16;
      for (int si = 0; si < nseg[mode1]; ++si) {
        const Seg& sg = segs[mode1][si];
        const int sfb_c = sg.sfb < 21 ? sg.sfb : 21;
        // short samples read their window row; long samples (incl. the
        // long prefix of mixed granules) the dedicated long row 3
        const int wrow = sg.is_short ? sg.win : 3;
        const int pos = ip[wrow * 22 + sfb_c];
        if (pos < 0) continue;   // off / illegal (host pre-marks both)
        const double a = tabA[pos], b = tabB[pos];
        for (int s = sg.start; s < sg.end; ++s) {
          const double v = x[0][s];
          x[0][s] = v * a;
          x[1][s] = v * b;
        }
      }
    }
    if (prof) { tp1 = prof_tsc(); c_deq += tp1 - tp0; tp0 = tp1; }

    for (int ch = 0; ch < 2; ++ch) {
      const int64_t g = (f * 2 + gr) * 2 + ch;
      const int bt = block_type[g];
      const int mixed = mixed_block_flag[g];
      // ISO mixed (walk mode 3): subbands 0..K-1 long-windowed with
      // butterflies 1..K-1; raw spectrum from 18K up to the reorder
      // boundary S (at 8 kHz S=72 > 18K=36: unreordered long-walk
      // samples under short windows — mpg123/ffmpeg behavior); short
      // region reordered from short band 3 (the full-short perm's
      // entries above S ARE the mixed reorder — geometry note in
      // decode_plane._mix_geometry)
      const bool mode3 = (bt == 2) && mixed && mix_nlong != 0;
      const bool do_reorder = (bt == 2) || mixed;
      double* xc = x[ch];
      if (prof) tp0 = prof_tsc();

      // ---- reorder (short) or alias reduction (long)
      double w[576];
      if (mode3) {
        const int S = int(mix_s);
        const int L = int(mix_nlong) * 18;  // long-window region (36)
        std::memcpy(w, xc, L * sizeof(double));
        for (int sb = 1; sb < int(mix_nlong); ++sb) {
          for (int i = 0; i < 8; ++i) {
            const int o1 = 18 * sb - i - 1;
            const int o2 = 18 * sb + i;
            const double s1 = w[o1], s2 = w[o2];
            w[o1] = s1 * alias_cs[i] - s2 * alias_ca[i];
            w[o2] = s2 * alias_cs[i] + s1 * alias_ca[i];
          }
        }
        // 8 kHz-only middle L..S-1: long-walk, unreordered spectrum under
        // short windows; mpg123's dct12 reads it with stride 3 — in this
        // window-major layout a per-18-chunk transpose (decode_plane
        // geometry note, tests/test_mixed_blocks.py)
        for (int b = L; b < S; b += 18)
          for (int wv = 0; wv < 3; ++wv)
            for (int sv = 0; sv < 6; ++sv)
              w[b + 6 * wv + sv] = xc[b + 3 * sv + wv];
        for (int s = S; s < 576; ++s) {
          const int p = reorder_perm[s];
          w[s] = p >= 0 ? xc[p] : 0.0;
        }
      } else if (do_reorder) {
        for (int s = 0; s < 576; ++s) {
          const int p = reorder_perm[s];
          w[s] = p >= 0 ? xc[p] : 0.0;
        }
      } else {
        std::memcpy(w, xc, sizeof(w));
        for (int sb = 1; sb < 32; ++sb) {
          for (int i = 0; i < 8; ++i) {
            const int o1 = 18 * sb - i - 1;
            const int o2 = 18 * sb + i;
            const double s1 = w[o1], s2 = w[o2];
            w[o1] = s1 * alias_cs[i] - s2 * alias_ca[i];
            w[o2] = s2 * alias_cs[i] + s1 * alias_ca[i];
          }
        }
      }

      if (prof) { tp1 = prof_tsc(); c_pre += tp1 - tp0; tp0 = tp1; }

      // ---- IMDCT + windowing (ascending-k accumulation). Subbands
      // below nlong take the long path (all 32 for long granules, the
      // first K with block_type-0 windows for ISO-mixed granules).
      const bool short_blk = bt == 2;
      const int nlong = mode3 ? int(mix_nlong) : (short_blk ? 0 : 32);
      int wr = mode3 ? 0 : bt;
      if (wr < 0) wr = 0;
      if (wr > 3) wr = 3;
      const double* win_l = sine + wr * 36;
#if defined(MP3STEGO_PLANE_AVX512)
      if (nlong > 0) {
        // TWO bands per pass: the ck row loads amortize over both, and 10
        // independent accumulator chains hide the add latency (5 chains per
        // band leave the FP ports half idle on the 18-step dependency).
        // Each output still sums ascending k with separate mul/add.
        for (int band = 0; band < nlong; band += 2) {
          const double* sA = w + band * 18;
          const double* sB = sA + 18;
          double* bA = blk[ch][band];
          double* bB = blk[ch][band + 1];
          __m512d a0 = _mm512_setzero_pd(), a1 = a0, a2 = a0, a3 = a0;
          __m512d b0 = a0, b1 = a0, b2 = a0, b3 = a0;
          __m256d a4 = _mm256_setzero_pd(), b4 = a4;
          for (int k = 0; k < 18; ++k) {
            const double* ck = c_longT[k];
            const __m512d c0 = _mm512_loadu_pd(ck);
            const __m512d c1 = _mm512_loadu_pd(ck + 8);
            const __m512d c2 = _mm512_loadu_pd(ck + 16);
            const __m512d c3 = _mm512_loadu_pd(ck + 24);
            const __m256d c4 = _mm256_loadu_pd(ck + 32);
            const __m512d skA = _mm512_set1_pd(sA[k]);
            const __m512d skB = _mm512_set1_pd(sB[k]);
            a0 = _mm512_add_pd(a0, _mm512_mul_pd(skA, c0));
            a1 = _mm512_add_pd(a1, _mm512_mul_pd(skA, c1));
            a2 = _mm512_add_pd(a2, _mm512_mul_pd(skA, c2));
            a3 = _mm512_add_pd(a3, _mm512_mul_pd(skA, c3));
            a4 = _mm256_add_pd(a4, _mm256_mul_pd(_mm512_castpd512_pd256(skA),
                                                 c4));
            b0 = _mm512_add_pd(b0, _mm512_mul_pd(skB, c0));
            b1 = _mm512_add_pd(b1, _mm512_mul_pd(skB, c1));
            b2 = _mm512_add_pd(b2, _mm512_mul_pd(skB, c2));
            b3 = _mm512_add_pd(b3, _mm512_mul_pd(skB, c3));
            b4 = _mm256_add_pd(b4, _mm256_mul_pd(_mm512_castpd512_pd256(skB),
                                                 c4));
          }
          const __m512d w0 = _mm512_loadu_pd(win_l);
          const __m512d w1 = _mm512_loadu_pd(win_l + 8);
          const __m512d w2 = _mm512_loadu_pd(win_l + 16);
          const __m512d w3 = _mm512_loadu_pd(win_l + 24);
          const __m256d w4 = _mm256_loadu_pd(win_l + 32);
          // overlap-add + frequency inversion fused with the windowed
          // store: y = b[0..17] + carried tail (sign-bit xor inversion on
          // odd bands), the carry becomes b[18..35] — this replaces the
          // separate overlap pass over blk for long blocks
          const __m512d odd_neg = _mm512_castsi512_pd(_mm512_set_epi64(
              INT64_C(0x8000000000000000), 0, INT64_C(0x8000000000000000), 0,
              INT64_C(0x8000000000000000), 0, INT64_C(0x8000000000000000),
              0));
          const __m128d odd_neg2 = _mm_castsi128_pd(
              _mm_set_epi64x(INT64_C(0x8000000000000000), 0));
          const __m512d none = _mm512_setzero_pd();
          const __m128d none2 = _mm_setzero_pd();
          for (int half = 0; half < 2; ++half) {
            const __m512d v0 = _mm512_mul_pd(half ? b0 : a0, w0);
            const __m512d v1 = _mm512_mul_pd(half ? b1 : a1, w1);
            const __m512d v2 = _mm512_mul_pd(half ? b2 : a2, w2);
            const __m512d v3 = _mm512_mul_pd(half ? b3 : a3, w3);
            const __m256d v4 = _mm256_mul_pd(half ? b4 : a4, w4);
            const int bd = band + half;
            double* yb = y[ch][bd];
            double* tb = tail_c[ch][bd];
            const __m512d inv = (bd & 1) ? odd_neg : none;
            const __m128d inv2 = (bd & 1) ? odd_neg2 : none2;
            const __m512d y0 =
                _mm512_add_pd(v0, _mm512_loadu_pd(tb));
            const __m512d y1 =
                _mm512_add_pd(v1, _mm512_loadu_pd(tb + 8));
            const __m128d y2 = _mm_add_pd(_mm512_castpd512_pd128(v2),
                                          _mm_loadu_pd(tb + 16));
            _mm512_storeu_pd(yb, _mm512_xor_pd(y0, inv));
            _mm512_storeu_pd(yb + 8, _mm512_xor_pd(y1, inv));
            _mm_storeu_pd(yb + 16, _mm_xor_pd(y2, inv2));
            // carry = b[18..35]: realign the register tile (bit moves only)
            const __m512i v2i = _mm512_castpd_si512(v2);
            const __m512i v3i = _mm512_castpd_si512(v3);
            const __m512i v4i = _mm512_castpd_si512(
                _mm512_insertf64x4(_mm512_setzero_pd(), v4, 0));
            _mm512_storeu_pd(
                tb, _mm512_castsi512_pd(_mm512_alignr_epi64(v3i, v2i, 2)));
            _mm512_storeu_pd(
                tb + 8,
                _mm512_castsi512_pd(_mm512_alignr_epi64(v4i, v3i, 2)));
            _mm_storeu_pd(tb + 16, _mm256_extractf128_pd(v4, 1));
          }
        }
      }
#endif
      for (int band = 0; band < 32; ++band) {
        const double* s18 = w + band * 18;
        double* b = blk[ch][band];
        if (band < nlong) {
#if defined(MP3STEGO_PLANE_AVX512)
          continue;  // long bands handled by the blocked kernel above
#else
          double acc[36];
          for (int i = 0; i < 36; ++i) acc[i] = 0.0;
          for (int k = 0; k < 18; ++k) {
            const double sk = s18[k];
            const double* ck = c_longT[k];
            for (int i = 0; i < 36; ++i) acc[i] += sk * ck[i];
          }
          for (int i = 0; i < 36; ++i) b[i] = acc[i] * win_l[i];
#endif
        } else {
          // 3 windows of 6 inputs -> 12 outputs, windowed by sine[2][:12]
          double xs[3][12];
          for (int wn = 0; wn < 3; ++wn) {
            const double* s6 = s18 + wn * 6;
            double acc[12];
            for (int i = 0; i < 12; ++i) acc[i] = 0.0;
            for (int k = 0; k < 6; ++k) {
              const double sk = s6[k];
              const double* ck = c_shortT[k];
              for (int i = 0; i < 12; ++i) acc[i] += sk * ck[i];
            }
            for (int i = 0; i < 12; ++i)
              xs[wn][i] = acc[i] * sine[2 * 36 + i];
          }
          for (int i = 0; i < 6; ++i) {
            b[i] = 0.0;
            b[6 + i] = xs[0][i];
            b[12 + i] = xs[0][6 + i] + xs[1][i];
            b[18 + i] = xs[1][6 + i] + xs[2][i];
            b[24 + i] = xs[2][6 + i];
            b[30 + i] = 0.0;
          }
        }
      }

      if (prof) { tp1 = prof_tsc(); c_imdct += tp1 - tp0; tp0 = tp1; }

      // ---- overlap-add with the carried tail, then update the carry,
      // with the frequency inversion folded in (negation = sign-bit xor,
      // bit-exact vs the scalar unary minus). Long blocks on AVX-512 fused
      // this into the IMDCT store above.
#if defined(MP3STEGO_PLANE_AVX512)
      if (nlong < 32) {  // bands below nlong were fused-written above
        const __m512d odd_neg = _mm512_castsi512_pd(_mm512_set_epi64(
            INT64_C(0x8000000000000000), 0, INT64_C(0x8000000000000000), 0,
            INT64_C(0x8000000000000000), 0, INT64_C(0x8000000000000000), 0));
        const __m512d none = _mm512_setzero_pd();
        for (int band = nlong; band < 32; ++band) {
          const double* bb = blk[ch][band];
          double* yb = y[ch][band];
          double* tb = tail_c[ch][band];
          const __m512d inv = (band & 1) ? odd_neg : none;
          __m512d y0 =
              _mm512_add_pd(_mm512_loadu_pd(bb), _mm512_loadu_pd(tb));
          __m512d y1 =
              _mm512_add_pd(_mm512_loadu_pd(bb + 8), _mm512_loadu_pd(tb + 8));
          double y16 = bb[16] + tb[16], y17 = bb[17] + tb[17];
          if (band & 1) y17 = -y17;
          _mm512_storeu_pd(yb, _mm512_xor_pd(y0, inv));
          _mm512_storeu_pd(yb + 8, _mm512_xor_pd(y1, inv));
          yb[16] = y16;
          yb[17] = y17;
          _mm512_storeu_pd(tb, _mm512_loadu_pd(bb + 18));
          _mm512_storeu_pd(tb + 8, _mm512_loadu_pd(bb + 26));
          tb[16] = bb[34];
          tb[17] = bb[35];
        }
      }
#else
      for (int band = 0; band < 32; ++band) {
        for (int i = 0; i < 18; ++i) {
          y[ch][band][i] = blk[ch][band][i] + tail_c[ch][band][i];
          tail_c[ch][band][i] = blk[ch][band][18 + i];
        }
      }

      // ---- frequency inversion
      for (int band = 1; band < 32; band += 2)
        for (int i = 1; i < 18; i += 2) y[ch][band][i] = -y[ch][band][i];
#endif
      if (prof) { tp1 = prof_tsc(); c_ov += tp1 - tp0; tp0 = tp1; }
    }

    // ---- polyphase synthesis, whole granule at once: V rows 15..32 from
    // the matmul, then the 16-tap FIR with j OUTER over an 18x32 block —
    // per-output accumulation stays ascending-j (bit-exact), the linear
    // history rows replace ring-index arithmetic.
    for (int ch = 0; ch < 2; ++ch) {
      if (prof) tp0 = prof_tsc();
      double* vg = &vlin[ch][15][0];           // rows 15..32: this granule
#if defined(MP3STEGO_PLANE_AVX512)
      // step OUTER / j INNER with the 64-wide V row in 8 zmm accumulators:
      // each v[i] still sums ascending-j (bit-exact), but the row is written
      // once instead of loaded+stored per j.
      for (int step = 0; step < 18; ++step) {
        __m512d a0 = _mm512_setzero_pd(), a1 = a0, a2 = a0, a3 = a0;
        __m512d a4 = a0, a5 = a0, a6 = a0, a7 = a0;
        for (int j = 0; j < 32; ++j) {
          const __m512d ys = _mm512_set1_pd(y[ch][j][step]);
          const double* nj = n_matT[j];
          a0 = _mm512_add_pd(a0, _mm512_mul_pd(ys, _mm512_loadu_pd(nj)));
          a1 = _mm512_add_pd(a1, _mm512_mul_pd(ys, _mm512_loadu_pd(nj + 8)));
          a2 = _mm512_add_pd(a2, _mm512_mul_pd(ys, _mm512_loadu_pd(nj + 16)));
          a3 = _mm512_add_pd(a3, _mm512_mul_pd(ys, _mm512_loadu_pd(nj + 24)));
          a4 = _mm512_add_pd(a4, _mm512_mul_pd(ys, _mm512_loadu_pd(nj + 32)));
          a5 = _mm512_add_pd(a5, _mm512_mul_pd(ys, _mm512_loadu_pd(nj + 40)));
          a6 = _mm512_add_pd(a6, _mm512_mul_pd(ys, _mm512_loadu_pd(nj + 48)));
          a7 = _mm512_add_pd(a7, _mm512_mul_pd(ys, _mm512_loadu_pd(nj + 56)));
        }
        double* v = vg + step * 72;
        _mm512_storeu_pd(v, a0);
        _mm512_storeu_pd(v + 8, a1);
        _mm512_storeu_pd(v + 16, a2);
        _mm512_storeu_pd(v + 24, a3);
        _mm512_storeu_pd(v + 32, a4);
        _mm512_storeu_pd(v + 40, a5);
        _mm512_storeu_pd(v + 48, a6);
        _mm512_storeu_pd(v + 56, a7);
      }
#else
      std::memset(vg, 0, 18 * 72 * sizeof(double));
      for (int j = 0; j < 32; ++j) {
        const double* yj = y[ch][j];           // 18 steps, contiguous
        const double* nj = n_matT[j];
        for (int step = 0; step < 18; ++step) {
          double* v = vg + step * 72;
          const double ys = yj[step];
          for (int i = 0; i < 64; ++i) v[i] += ys * nj[i];
        }
      }
#endif
      if (prof) { tp1 = prof_tsc(); c_mat += tp1 - tp0; tp0 = tp1; }
      double acc[18][32];
#if defined(MP3STEGO_PLANE_AVX512)
      // two steps per pass: the window-row loads are shared and eight
      // independent chains hide the add latency (same per-output
      // ascending-j order)
      for (int step = 0; step < 18; step += 2) {
        __m512d a0 = _mm512_setzero_pd(), a1 = a0, a2 = a0, a3 = a0;
        __m512d e0 = a0, e1 = a0, e2 = a0, e3 = a0;
        for (int j = 0; j < 16; ++j) {
          const double* dw = d_win + j * 32;
          const int base = (j & 1) ? 32 : 0;
          const double* vA = &vlin[ch][15 + step - j][base];
          const double* vB = &vlin[ch][16 + step - j][base];
          const __m512d d0 = _mm512_loadu_pd(dw);
          const __m512d d1 = _mm512_loadu_pd(dw + 8);
          const __m512d d2 = _mm512_loadu_pd(dw + 16);
          const __m512d d3 = _mm512_loadu_pd(dw + 24);
          a0 = _mm512_add_pd(a0, _mm512_mul_pd(_mm512_loadu_pd(vA), d0));
          a1 = _mm512_add_pd(a1, _mm512_mul_pd(_mm512_loadu_pd(vA + 8), d1));
          a2 = _mm512_add_pd(a2, _mm512_mul_pd(_mm512_loadu_pd(vA + 16), d2));
          a3 = _mm512_add_pd(a3, _mm512_mul_pd(_mm512_loadu_pd(vA + 24), d3));
          e0 = _mm512_add_pd(e0, _mm512_mul_pd(_mm512_loadu_pd(vB), d0));
          e1 = _mm512_add_pd(e1, _mm512_mul_pd(_mm512_loadu_pd(vB + 8), d1));
          e2 = _mm512_add_pd(e2, _mm512_mul_pd(_mm512_loadu_pd(vB + 16), d2));
          e3 = _mm512_add_pd(e3, _mm512_mul_pd(_mm512_loadu_pd(vB + 24), d3));
        }
        _mm512_storeu_pd(acc[step], a0);
        _mm512_storeu_pd(acc[step] + 8, a1);
        _mm512_storeu_pd(acc[step] + 16, a2);
        _mm512_storeu_pd(acc[step] + 24, a3);
        _mm512_storeu_pd(acc[step + 1], e0);
        _mm512_storeu_pd(acc[step + 1] + 8, e1);
        _mm512_storeu_pd(acc[step + 1] + 16, e2);
        _mm512_storeu_pd(acc[step + 1] + 24, e3);
      }
#else
      std::memset(acc, 0, sizeof(acc));
      for (int j = 0; j < 16; ++j) {
        const double* dw = d_win + j * 32;
        const int base = (j & 1) ? 32 : 0;
        for (int step = 0; step < 18; ++step) {
          const double* vj = &vlin[ch][15 + step - j][base];
          double* a = acc[step];
          for (int n = 0; n < 32; ++n) a[n] += vj[n] * dw[n];
        }
      }
#endif
      if (prof) { tp1 = prof_tsc(); c_fir += tp1 - tp0; tp0 = tp1; }
      sink.write_granule(ch, t, acc);
      // carry: last 15 V rows become the next granule's history
      std::memmove(&vlin[ch][0][0], &vlin[ch][18][0],
                   15 * 72 * sizeof(double));
      if (prof) { tp1 = prof_tsc(); c_sink += tp1 - tp0; tp0 = tp1; }
    }
  }
  if (prof && T > 0) {
    std::fprintf(stderr,
                 "[plane_prof] T=%lld cyc/granule: dequant+ms=%.0f "
                 "reorder/alias=%.0f imdct=%.0f overlap/inv=%.0f "
                 "synth_mat=%.0f fir=%.0f sink+move=%.0f total=%.0f\n",
                 (long long)T, double(c_deq) / T, double(c_pre) / T,
                 double(c_imdct) / T, double(c_ov) / T, double(c_mat) / T,
                 double(c_fir) / T, double(c_sink) / T,
                 double(c_deq + c_pre + c_imdct + c_ov + c_mat + c_fir
                        + c_sink) / T);
  }
  return 0;
}

}  // namespace

#define DECODE_PLANE_ARGS                                                   \
  int64_t F, const int32_t* raw, const int32_t* block_type,                 \
      const int32_t* mixed_block_flag, const int32_t* global_gain,          \
      const int32_t* scale_fac_scale, const int32_t* pre_flag,              \
      const int32_t* sub_block_gain, const int32_t* scale_fac_l,            \
      const int32_t* scale_fac_s, const uint8_t* ms_stereo,                 \
      const uint8_t* is_stereo, const int8_t* is_pos,                       \
      const int8_t* is_tab, const double* is_ab,                            \
      const int32_t* walk_is_short,                                         \
      const int32_t* walk_sfb,                                              \
      const int32_t* walk_win, const int32_t* pre_ext,                      \
      const int32_t* reorder_perm, const double* pow43, const double* e1lut,\
      const double* e2lut, const double* alias_cs, const double* alias_ca,  \
      const double* c_long, const double* c_short, const double* sine,      \
      const double* n_mat, const double* d_win, int64_t mix_nlong,           \
      int64_t mix_s

#define DECODE_PLANE_PASS                                                   \
  F, raw, block_type, mixed_block_flag, global_gain, scale_fac_scale,       \
      pre_flag, sub_block_gain, scale_fac_l, scale_fac_s, ms_stereo,        \
      is_stereo, is_pos, is_tab, is_ab, walk_is_short, walk_sfb, walk_win,  \
      pre_ext, reorder_perm, pow43,                                         \
      e1lut, e2lut, alias_cs, alias_ca, c_long, c_short, sine, n_mat, d_win, \
      mix_nlong, mix_s

extern "C" int64_t decode_plane_f64(DECODE_PLANE_ARGS, double* out) {
  return decode_plane_run(DECODE_PLANE_PASS, OutF64{out, 2 * F});
}

// WAV-product form: interleaved int16 (T*576, nch) written straight from the
// FIR accumulators — skips the (2,T,576) float64 materialization + the numpy
// transpose/scale/cast passes (the host is page-fault-bandwidth-bound).
extern "C" int64_t decode_plane_i16(DECODE_PLANE_ARGS, int16_t* out,
                                    int64_t nch, int64_t wrap) {
  return decode_plane_run(DECODE_PLANE_PASS, OutI16{out, int(nch), wrap != 0});
}
