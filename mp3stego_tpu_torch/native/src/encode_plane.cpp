// Native twin of the encode analysis plane (ops/encode_plane.analysis_mdct):
// polyphase window + 32-band filter + forward MDCT + alias butterflies in
// exact Q31 fixed point.
//
// Behavioural reference (bit-for-bit): /root/reference/mp3stego/encoder/
//   MP3_Encoder.py:321-370, 751-758 (window+filter), 681-701 (MDCT),
//   703-744 (alias butterflies); fixed point ops encoder/util.py:123-172.
//
// Everything is integer arithmetic (int64 products, int32 wraparound sums —
// associative, so any summation order matches the reference). This is the
// enabler for the fully-host single-stream encode engine: spectra never
// cross the device link.
//
// Loop structure is chosen for auto-vectorization (AVX-512 via -march=native
// -mprefer-vector-width=512):
//   * window taps iterate ASCENDING over contiguous int16 samples (the
//     reference's descending base[-i] walk is re-indexed j = 63-i, with the
//     enwindow and filter tables pre-reversed to match), giving unit-stride
//     widening loads;
//   * the 32-band filter is a 64x32 matvec with the filter TRANSPOSED so the
//     32 output lanes are contiguous per tap (broadcast-multiply-accumulate);
//   * the MDCT iterates over the 36 input sub-steps with the 32 bands as
//     contiguous lanes (sb rows are band-contiguous), accumulating an 18x32
//     tile that is transposed on store.
// Every product is (int64)int32 * (int64)int32 >> 32 (or >> 16 for the
// window, see below) accumulated mod 2^32 — per-element exact, so
// vectorization cannot change results.

#include <cstdint>
#include <cstring>
#include <vector>
#if defined(__AVX512F__) && defined(__AVX512DQ__) \
    && !defined(MP3STEGO_FORCE_SCALAR)
#include <x86intrin.h>
#define MP3STEGO_ENC_AVX512 1
#endif

// pcm: (nch, 480 + tg*576) int16 front-padded streams (raw samples; the <<16
// upshift of the reference's WAV read happens here). out: (nch, tg, 576).
// Returns -1 if an enwindow entry exceeds int32 range (never for the ISO
// table; guards the exactness of the >>16 re-association below).
extern "C" int64_t encode_analysis(
    const int16_t* pcm, int64_t nch, int64_t tg,
    const int64_t* enwindow,   // (512,) int64 fixed-point window
    const int32_t* fl,         // (32,64) subband filter
    const int32_t* cos_l,      // (18,36) MDCT cosine
    const int32_t* cs8, const int32_t* ca8,  // alias butterfly coefs
    int32_t* out) {
  const int64_t stride = 480 + tg * 576;
  const int64_t ts = tg * 18;

  // Reversed window: enr[k][j] = enwindow[64k + 63 - j]. The reference
  // computes q31mul(sample << 16, en) = ((s<<16) * en) >> 32 == (s * en)
  // >> 16 exactly (no overflow: |s| < 2^15, |en| < 2^31 -> |product| < 2^46;
  // both shifts are arithmetic on the same value).
  int32_t enr[8][64];
  for (int k = 0; k < 8; ++k)
    for (int j = 0; j < 64; ++j) {
      const int64_t v = enwindow[64 * k + 63 - j];
      if (v != int64_t(int32_t(v))) return -1;
      enr[k][j] = int32_t(v);
    }
  // Transposed+reversed filter: flt[j][b] = fl[b][63 - j], so the b-loop is
  // contiguous in both the table and the accumulator.
  std::vector<int32_t> flt(64 * 32);
  for (int j = 0; j < 64; ++j)
    for (int b = 0; b < 32; ++b) flt[j * 32 + b] = fl[b * 64 + (63 - j)];

  std::vector<int32_t> sb(size_t(ts) * 32);

#if defined(MP3STEGO_ENC_AVX512)
  // Window table split for 32-bit-lane exactness: with en = enhi*2^16 + enlo
  // (enlo unsigned 16-bit) and |s| < 2^15,
  //   (s*en) >> 16 == s*enhi + ((s*enlo) >> 16)
  // exactly (s*enhi*2^16 is a multiple of 2^16; both partial products fit
  // int32), so the whole window stage runs in 16-lane vpmulld instead of
  // 8-lane 64-bit multiplies.
  alignas(64) int32_t enhi[8][64], enlo[8][64];
  for (int k = 0; k < 8; ++k)
    for (int j = 0; j < 64; ++j) {
      enhi[k][j] = enr[k][j] >> 16;
      enlo[k][j] = enr[k][j] & 0xffff;
    }
#endif

  for (int64_t ch = 0; ch < nch; ++ch) {
    const int16_t* s = pcm + ch * stride;

    // ---- window + 32-band filter per 32-sample step
#if defined(MP3STEGO_ENC_AVX512)
    // Two t-steps per pass share the filter-table loads; the filter matvec
    // keeps even/odd 32-bit lanes in separate 64-bit accumulators (vpmuldq
    // multiplies the even dwords), interleaved back at the store. All sums
    // are mod-2^32 associative, so lane order cannot change results; ts is
    // always even (= 18 * tg).
    for (int64_t t = 0; t < ts; t += 2) {
      alignas(64) int32_t tarr[2][64];
      for (int tt = 0; tt < 2; ++tt) {
        const int16_t* st = s + 32 * (t + tt);
        __m512i ta0 = _mm512_setzero_si512(), ta1 = ta0, ta2 = ta0, ta3 = ta0;
        for (int k = 0; k < 8; ++k) {
          const int16_t* base = st + 448 - 64 * k;  // ascending window
#define MP3S_WIN_V(acc, v)                                                   \
          {                                                                  \
            const __m512i s32 = _mm512_cvtepi16_epi32(                       \
                _mm256_loadu_si256((const __m256i*)(base + 16 * (v))));      \
            const __m512i hi = _mm512_mullo_epi32(                           \
                s32, _mm512_load_si512(enhi[k] + 16 * (v)));                 \
            const __m512i lo = _mm512_srai_epi32(                            \
                _mm512_mullo_epi32(                                          \
                    s32, _mm512_load_si512(enlo[k] + 16 * (v))), 16);        \
            acc = _mm512_add_epi32(acc, _mm512_add_epi32(hi, lo));           \
          }
          MP3S_WIN_V(ta0, 0)
          MP3S_WIN_V(ta1, 1)
          MP3S_WIN_V(ta2, 2)
          MP3S_WIN_V(ta3, 3)
#undef MP3S_WIN_V
        }
        _mm512_store_si512(tarr[tt] + 0, ta0);
        _mm512_store_si512(tarr[tt] + 16, ta1);
        _mm512_store_si512(tarr[tt] + 32, ta2);
        _mm512_store_si512(tarr[tt] + 48, ta3);
      }

      // acc32[b] = sum_j hi32(flt[j][b] * tj) mod 2^32; 64-bit partial sums
      // of the >>32 terms (|term| < 2^31, 64 terms — no int64 overflow) keep
      // the low dword identical to the scalar uint32 accumulation.
      __m512i ae00 = _mm512_setzero_si512(), ao00 = ae00, ae01 = ae00,
              ao01 = ae00, ae10 = ae00, ao10 = ae00, ae11 = ae00, ao11 = ae00;
      for (int j = 0; j < 64; ++j) {
        const __m512i t0 = _mm512_set1_epi32(tarr[0][j]);
        const __m512i t1 = _mm512_set1_epi32(tarr[1][j]);
        const int32_t* fj = flt.data() + j * 32;
        const __m512i f0 = _mm512_loadu_si512(fj);
        const __m512i f1 = _mm512_loadu_si512(fj + 16);
        const __m512i f0o = _mm512_srli_epi64(f0, 32);
        const __m512i f1o = _mm512_srli_epi64(f1, 32);
#define MP3S_FLT_ACC(acc, f, tb)                                             \
        acc = _mm512_add_epi64(                                              \
            acc, _mm512_srai_epi64(_mm512_mul_epi32(f, tb), 32));
        MP3S_FLT_ACC(ae00, f0, t0)
        MP3S_FLT_ACC(ao00, f0o, t0)
        MP3S_FLT_ACC(ae01, f1, t0)
        MP3S_FLT_ACC(ao01, f1o, t0)
        MP3S_FLT_ACC(ae10, f0, t1)
        MP3S_FLT_ACC(ao10, f0o, t1)
        MP3S_FLT_ACC(ae11, f1, t1)
        MP3S_FLT_ACC(ao11, f1o, t1)
#undef MP3S_FLT_ACC
      }

      const __m512i* ae[2][2] = {{&ae00, &ae01}, {&ae10, &ae11}};
      const __m512i* ao[2][2] = {{&ao00, &ao01}, {&ao10, &ao11}};
      for (int tt = 0; tt < 2; ++tt) {
        int32_t* sbt = sb.data() + (t + tt) * 32;
        const bool odd_step = ((t + tt) % 18) & 1;
        for (int h = 0; h < 2; ++h) {
          // even b's ride the ae low dwords; odd b's are the ao low dwords
          // shifted into the odd lanes
          __m512i comb = _mm512_mask_blend_epi32(
              0xAAAA, *ae[tt][h], _mm512_slli_epi64(*ao[tt][h], 32));
          if (odd_step)  // odd bands negate (wraparound 0 - v)
            comb = _mm512_mask_sub_epi32(comb, 0xAAAA,
                                         _mm512_setzero_si512(), comb);
          _mm512_storeu_si512(sbt + 16 * h, comb);
        }
      }
    }
#else
    for (int64_t t = 0; t < ts; ++t) {
      // taccr[j] holds the reference's tacc[63 - j]
      uint32_t taccr[64];
      std::memset(taccr, 0, sizeof(taccr));
      for (int k = 0; k < 8; ++k) {
        const int16_t* base = s + 32 * t + 448 - 64 * k;  // ascending window
        const int32_t* en = enr[k];
        for (int j = 0; j < 64; ++j)
          taccr[j] += uint32_t((int64_t(base[j]) * en[j]) >> 16);
      }

      int32_t* sbt = sb.data() + t * 32;
      uint32_t acc[32];
      std::memset(acc, 0, sizeof(acc));
      for (int j = 0; j < 64; ++j) {
        const int64_t tj = int32_t(taccr[j]);
        const int32_t* fj = flt.data() + j * 32;
        for (int b = 0; b < 32; ++b)
          acc[b] += uint32_t((int64_t(fj[b]) * tj) >> 32);
      }
      const bool odd_step = (t % 18) & 1;
      for (int b = 0; b < 32; ++b) {
        int32_t v = int32_t(acc[b]);
        if (odd_step && (b & 1)) v = int32_t(0u - uint32_t(v));
        sbt[b] = v;
      }
    }
#endif

    // ---- MDCT over [prev granule ; current granule] per band, then alias
    for (int64_t g = 0; g < tg; ++g) {
      int32_t* og = out + (ch * tg + g) * 576;
      const int32_t* cur = sb.data() + g * 18 * 32;
      const int32_t* prv = g > 0 ? cur - 18 * 32 : nullptr;

      // macc[l][b], accumulated lane-parallel over the 32 bands
      uint32_t macc[18][32];
#if defined(MP3STEGO_ENC_AVX512)
      // Register-block the 18x32 tile: 6 l-rows x 8 bands live in 6 zmm
      // accumulators across all 36 m (the autovectorized form reloads and
      // stores the tile every (m,l)). Integer sums are associative mod
      // 2^32, and accumulating the >>32 products in 64-bit lanes keeps the
      // low 32 bits identical to the uint32 scalar accumulation.
      for (int bh = 0; bh < 32; bh += 8) {
        for (int lb = 0; lb < 18; lb += 6) {
          __m512i a0 = _mm512_setzero_si512(), a1 = a0, a2 = a0, a3 = a0,
                  a4 = a0, a5 = a0;
          const int32_t* cl = cos_l + lb * 36;
          for (int m = 0; m < 36; ++m) {
            const int32_t* row =
                m < 18 ? (prv ? prv + m * 32 : nullptr) : cur + (m - 18) * 32;
            if (!row) continue;  // first granule: prev half is zero
            const __m512i r = _mm512_cvtepi32_epi64(
                _mm256_loadu_si256((const __m256i*)(row + bh)));
            // vpmuldq: int32 x int32 -> int64 per lane, then >>32
            a0 = _mm512_add_epi64(
                a0, _mm512_srai_epi64(
                        _mm512_mul_epi32(r, _mm512_set1_epi64(cl[m])), 32));
            a1 = _mm512_add_epi64(
                a1, _mm512_srai_epi64(
                        _mm512_mul_epi32(r, _mm512_set1_epi64(cl[36 + m])),
                        32));
            a2 = _mm512_add_epi64(
                a2, _mm512_srai_epi64(
                        _mm512_mul_epi32(r, _mm512_set1_epi64(cl[72 + m])),
                        32));
            a3 = _mm512_add_epi64(
                a3, _mm512_srai_epi64(
                        _mm512_mul_epi32(r, _mm512_set1_epi64(cl[108 + m])),
                        32));
            a4 = _mm512_add_epi64(
                a4, _mm512_srai_epi64(
                        _mm512_mul_epi32(r, _mm512_set1_epi64(cl[144 + m])),
                        32));
            a5 = _mm512_add_epi64(
                a5, _mm512_srai_epi64(
                        _mm512_mul_epi32(r, _mm512_set1_epi64(cl[180 + m])),
                        32));
          }
          _mm256_storeu_si256((__m256i*)&macc[lb + 0][bh],
                              _mm512_cvtepi64_epi32(a0));
          _mm256_storeu_si256((__m256i*)&macc[lb + 1][bh],
                              _mm512_cvtepi64_epi32(a1));
          _mm256_storeu_si256((__m256i*)&macc[lb + 2][bh],
                              _mm512_cvtepi64_epi32(a2));
          _mm256_storeu_si256((__m256i*)&macc[lb + 3][bh],
                              _mm512_cvtepi64_epi32(a3));
          _mm256_storeu_si256((__m256i*)&macc[lb + 4][bh],
                              _mm512_cvtepi64_epi32(a4));
          _mm256_storeu_si256((__m256i*)&macc[lb + 5][bh],
                              _mm512_cvtepi64_epi32(a5));
        }
      }
#else
      std::memset(macc, 0, sizeof(macc));
      for (int m = 0; m < 36; ++m) {
        const int32_t* row =
            m < 18 ? (prv ? prv + m * 32 : nullptr) : cur + (m - 18) * 32;
        if (!row) continue;  // first granule: prev half is zero
        for (int l = 0; l < 18; ++l) {
          const int64_t c = cos_l[l * 36 + m];
          uint32_t* ml = macc[l];
          for (int b = 0; b < 32; ++b)
            ml[b] += uint32_t((int64_t(row[b]) * c) >> 32);
        }
      }
#endif
      for (int b = 0; b < 32; ++b)
        for (int l = 0; l < 18; ++l) og[b * 18 + l] = int32_t(macc[l][b]);

      // alias butterflies: each (b, i) pair touches exactly freq[b][i] and
      // freq[b-1][17-i]; read both, write both (cmuls semantics, >>31)
      for (int b = 1; b < 32; ++b) {
        for (int i = 0; i < 8; ++i) {
          const int64_t bu = og[b * 18 + i];
          const int64_t bd = og[(b - 1) * 18 + 17 - i];
          og[b * 18 + i] = int32_t((bu * cs8[i] - bd * ca8[i]) >> 31);
          og[(b - 1) * 18 + 17 - i] = int32_t((bu * ca8[i] + bd * cs8[i]) >> 31);
        }
      }
    }
  }
  return 0;
}
