// Packs the parser's (F, 2, 2, 576) int32 Huffman sample tensor into the
// device plane's (2ch, T=2F, 576) int8 layout plus the sparse int16
// exception list for |v| > 127 (linbits samples, decoder/Frame.py:443-559).
//
// This is the hot half of ops/decode_plane.host_prepare: in NumPy it takes
// three full passes over ~85 MB per 2 minutes of audio (moveaxis copy,
// nonzero scan, clip+astype), ~0.9 s on a single-core host. One fused C++
// pass is memory-bound (~50 ms). The NumPy path stays as the oracle;
// tests/test_units.py pins equality.

#include <cstdint>

extern "C" int64_t pack_raw_plane(
    const int32_t* raw, int64_t F,
    int8_t* out,  // (2, 2F, 576), ch-major time-major like host_prepare's to_ct
    int32_t* exc_t, int8_t* exc_ch, int16_t* exc_s, int16_t* exc_val,
    int64_t exc_cap) {
  const int64_t T = 2 * F;
  int64_t n_exc = 0;
  for (int64_t f = 0; f < F; ++f)
    for (int gr = 0; gr < 2; ++gr)
      for (int ch = 0; ch < 2; ++ch) {
        const int32_t* src = raw + ((f * 2 + gr) * 2 + ch) * 576;
        int8_t* dst = out + (ch * T + f * 2 + gr) * 576;
        for (int s = 0; s < 576; ++s) {
          int32_t v = src[s];
          if (v > 127 || v < -128) {
            if (n_exc < exc_cap) {
              exc_t[n_exc] = int32_t(f * 2 + gr);
              exc_ch[n_exc] = int8_t(ch);
              exc_s[n_exc] = int16_t(s);
              exc_val[n_exc] = int16_t(v);  // linbits bound 8206 fits int16
            }
            ++n_exc;  // past cap: keep counting so the caller can retry
            dst[s] = int8_t(v > 127 ? 127 : -128);  // np.clip twin
          } else {
            dst[s] = int8_t(v);
          }
        }
      }
  return n_exc;
}
