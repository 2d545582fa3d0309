// Native MP3 frame serializer: header + side info + scalefactors + Huffman
// main data with the reference's exact 32-bit-cache bitstream semantics.
//
// Behavioural reference (bit-for-bit): /root/reference/mp3stego/encoder/
//   MP3_Encoder.py:1266-1547 (__format_bitstream, __encode_side_info,
//   __encode_main_data, __put_bits, __huffman_code_bits incl. the all-ones
//   stuffing padding, __huffman_code, __huffman_coder_count1).
//
// The cache/cache_bits state persists across frames (per-frame byte chunks are
// cut at data_position while up to 31 bits stay cached), exactly like the
// reference's BitstreamStruct. C twin of bitstream/bits.py:BitWriter +
// models/encoder.py:_format_bitstream (the pure-python fallback).

#include <cstdint>
#include <cstring>

namespace {

struct BitSink {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  uint32_t cache;   // external io form: pending bits left-aligned, 32-bit
  int cache_bits;   // external io form: 32 - pending
  uint64_t acc = 0;  // working form: pending bits in the BOTTOM nacc bits
  int nacc = 0;

  // The byte stream (and the 32-bit cache io contract at the entry points)
  // is what must match the reference — internally the pending bits ride a
  // 64-bit accumulator so a put is two shifts and one predictable flush.
  inline void init() {
    nacc = 32 - cache_bits;
    acc = nacc ? (cache >> cache_bits) : 0;
  }
  inline void fini() {
    cache_bits = 32 - nacc;
    cache = nacc ? (uint32_t)((acc << cache_bits) & 0xFFFFFFFFu) : 0;
  }
  inline void put(uint32_t val, int n) {
    const uint32_t mask =
        (n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1u);
    acc = (acc << n) | (uint64_t)(val & mask);
    nacc += n;
    if (nacc >= 32) {   // at most once: nacc was <= 31, n <= 32
      nacc -= 32;
      const uint32_t w = (uint32_t)(acc >> nacc);
      if (pos + 4 <= cap) {
        out[pos] = (uint8_t)(w >> 24);
        out[pos + 1] = (uint8_t)(w >> 16);
        out[pos + 2] = (uint8_t)(w >> 8);
        out[pos + 3] = (uint8_t)w;
      }
      pos += 4;
      acc &= (nacc ? ((1ull << nacc) - 1) : 0);
    }
  }
  inline int64_t bits_count() const { return pos * 8 + nacc; }
};

// gi field order (must match models/encoder.py packing)
enum {
  F_PART23 = 0, F_BIGV, F_GG, F_SFC, F_R0C, F_R1C, F_PRE, F_SFSCALE,
  F_C1SEL, F_COUNT1, F_PART2, F_NFIELDS
};

}  // namespace

extern "C" {

// Serialize one frame. Returns bytes written to `out` (the frame chunk).
// cache/cache_bits carry the bitstream state across calls.
int64_t mp3_format_frame(
    uint32_t* cache, int32_t* cache_bits, uint8_t* out, int64_t out_cap,
    // header/frame params
    int32_t version, int32_t layer, int32_t crc, int32_t bitrate_index,
    int32_t sr_mod3, int32_t padding, int32_t ext, int32_t mode,
    int32_t mode_ext, int32_t copyright, int32_t original, int32_t emphasis,
    int32_t private_bits, int32_t nch, int32_t granules,
    // per-channel scfsi (2,4)
    const int32_t* scfsi,
    // per-(gr,ch) side info: [gr][ch][F_NFIELDS] int64
    const int64_t* gi,
    const int32_t* table_select,   // [gr][ch][3]
    const int32_t* sfl,            // [gr][ch][22] scale factors
    const int32_t* slen1_tab, const int32_t* slen2_tab,
    const int32_t* l3_enc,         // [ch][gr][576] (reference layout)
    // Huffman tables
    const uint32_t* huff_code, const uint8_t* huff_len,   // [34][16][16]
    const int32_t* huff_linbits,
    const int32_t* band) {         // scale_fact_band_index row, 23 entries
  BitSink bs{out, out_cap, 0, *cache, *cache_bits};
  bs.init();

  auto gif = [&](int gr, int ch, int f) -> int64_t {
    return gi[(gr * 2 + ch) * F_NFIELDS + f];
  };
  auto ts_of = [&](int gr, int ch, int r) -> int32_t {
    return table_select[(gr * 2 + ch) * 3 + r];
  };

  // ---- header + side info (MP3_Encoder.py:1281-1337)
  bs.put(0x7FF, 11);
  bs.put(version, 2);
  bs.put(layer, 2);
  bs.put(crc ? 0 : 1, 1);
  bs.put(bitrate_index, 4);
  bs.put(sr_mod3, 2);
  bs.put(padding, 1);
  bs.put(ext, 1);
  bs.put(mode, 2);
  bs.put(mode_ext, 2);
  bs.put(copyright, 1);
  bs.put(original, 1);
  bs.put(emphasis, 2);

  if (version == 3) {
    bs.put(0, 9);
    bs.put(private_bits, nch == 2 ? 3 : 5);
    for (int ch = 0; ch < nch; ++ch)
      for (int band_i = 0; band_i < 4; ++band_i)
        bs.put(scfsi[ch * 4 + band_i], 1);
  } else {
    bs.put(0, 8);
    bs.put(private_bits, nch == 2 ? 2 : 1);
  }

  for (int gr = 0; gr < granules; ++gr)
    for (int ch = 0; ch < nch; ++ch) {
      bs.put((uint32_t)gif(gr, ch, F_PART23), 12);
      bs.put((uint32_t)gif(gr, ch, F_BIGV), 9);
      bs.put((uint32_t)gif(gr, ch, F_GG), 8);
      bs.put((uint32_t)gif(gr, ch, F_SFC), version == 3 ? 4 : 9);
      bs.put(0, 1);
      for (int r = 0; r < 3; ++r) bs.put(ts_of(gr, ch, r), 5);
      bs.put((uint32_t)gif(gr, ch, F_R0C), 4);
      bs.put((uint32_t)gif(gr, ch, F_R1C), 3);
      if (version == 3) {
        bs.put((uint32_t)gif(gr, ch, F_PRE), 1);
        bs.put((uint32_t)gif(gr, ch, F_SFSCALE), 1);
        bs.put((uint32_t)gif(gr, ch, F_C1SEL), 1);
      }
    }

  // ---- main data (MP3_Encoder.py:1339-1446)
  for (int gr = 0; gr < granules; ++gr)
    for (int ch = 0; ch < nch; ++ch) {
      int sfc = (int)gif(gr, ch, F_SFC);
      int slen1 = slen1_tab[sfc];
      int slen2 = slen2_tab[sfc];
      const int32_t* sf = sfl + (gr * 2 + ch) * 22;
      if (gr == 0 || scfsi[ch * 4 + 0] == 0)
        for (int sfb = 0; sfb < 6; ++sfb) bs.put(sf[sfb], slen1);
      if (gr == 0 || scfsi[ch * 4 + 1] == 0)
        for (int sfb = 6; sfb < 11; ++sfb) bs.put(sf[sfb], slen1);
      if (gr == 0 || scfsi[ch * 4 + 2] == 0)
        for (int sfb = 11; sfb < 16; ++sfb) bs.put(sf[sfb], slen2);
      if (gr == 0 || scfsi[ch * 4 + 3] == 0)
        for (int sfb = 16; sfb < 21; ++sfb) bs.put(sf[sfb], slen2);

      // Huffman-coded spectrum (__huffman_code_bits)
      int64_t before = bs.bits_count();
      int big_values = (int)gif(gr, ch, F_BIGV) << 1;
      int idx0 = (int)gif(gr, ch, F_R0C) + 1;
      int region1_start = band[idx0];
      int region2_start = band[idx0 + (int)gif(gr, ch, F_R1C) + 1];
      const int32_t* enc = l3_enc + (ch * 2 + gr) * 576;

      for (int i = 0; i < big_values; i += 2) {
        int region = (i >= region1_start) + (i >= region2_start);
        int t = ts_of(gr, ch, region);
        if (t == 0) continue;
        int x = enc[i], y = enc[i + 1];
        int sign_x = x > 0 ? 0 : 1;
        int sign_y = y > 0 ? 0 : 1;
        if (x < 0) x = -x;
        if (y < 0) y = -y;
        if (t > 15) {  // ESC tables
          int lin_bits = huff_linbits[t];
          int lx = 0, ly = 0;
          if (x > 14) { lx = x - 15; x = 15; }
          if (y > 14) { ly = y - 15; y = 15; }
          int p = (t * 256) + x * 16 + y;
          uint32_t ext_bits = 0;
          int xb = 0;
          if (x > 14) { ext_bits |= (uint32_t)lx; xb += lin_bits; }
          if (x != 0) { ext_bits = (ext_bits << 1) | (uint32_t)sign_x; xb += 1; }
          if (y > 14) { ext_bits = (ext_bits << lin_bits) | (uint32_t)ly; xb += lin_bits; }
          if (y != 0) { ext_bits = (ext_bits << 1) | (uint32_t)sign_y; xb += 1; }
          bs.put(huff_code[p], huff_len[p]);
          bs.put(ext_bits, xb);
        } else {
          int p = (t * 256) + x * 16 + y;
          uint32_t code = huff_code[p];
          int cb = huff_len[p];
          if (x != 0) { code = (code << 1) | (uint32_t)sign_x; cb += 1; }
          if (y != 0) { code = (code << 1) | (uint32_t)sign_y; cb += 1; }
          bs.put(code, cb);
        }
      }

      // count1 quadruples (__huffman_coder_count1)
      int c1table = 32 + (int)gif(gr, ch, F_C1SEL);
      int count1_end = big_values + ((int)gif(gr, ch, F_COUNT1) << 2);
      for (int i = big_values; i < count1_end; i += 4) {
        int v = enc[i], w = enc[i + 1], x = enc[i + 2], y = enc[i + 3];
        int sv = v > 0 ? 0 : 1, sw = w > 0 ? 0 : 1;
        int sx = x > 0 ? 0 : 1, sy = y > 0 ? 0 : 1;
        if (v < 0) v = -v;
        if (w < 0) w = -w;
        if (x < 0) x = -x;
        if (y < 0) y = -y;
        int p = v + (w << 1) + (x << 2) + (y << 3);
        int q = c1table * 256 + p;
        bs.put(huff_code[q], huff_len[q]);
        uint32_t code = 0;
        int cb = 0;
        if (v) { code = (uint32_t)sv; cb = 1; }
        if (w) { code = (code << 1) | (uint32_t)sw; cb += 1; }
        if (x) { code = (code << 1) | (uint32_t)sx; cb += 1; }
        if (y) { code = (code << 1) | (uint32_t)sy; cb += 1; }
        bs.put(code, cb);
      }

      // all-ones stuffing up to part2_3_length
      int64_t written = bs.bits_count() - before;
      int64_t stuff = gif(gr, ch, F_PART23) - gif(gr, ch, F_PART2) - written;
      if (stuff > 0) {
        for (int64_t k = 0; k < stuff / 32; ++k) bs.put(0xFFFFFFFFu, 32);
        int rem = (int)(stuff % 32);
        if (rem) bs.put((1u << rem) - 1u, rem);
      }
    }

  bs.fini();
  *cache = bs.cache;
  *cache_bits = bs.cache_bits;
  return bs.pos <= out_cap ? bs.pos : -1;
}

// Serialize a whole file's frames in one call (the search-plane encode path,
// models/encoder.py::_plane_finish): per-frame state comes as arrays with a
// leading frame axis, eliminating the per-frame Python marshalling loop.
// Returns total bytes written, or -1 on overflow.
int64_t mp3_format_frames(
    uint32_t* cache, int32_t* cache_bits, uint8_t* out, int64_t out_cap,
    int64_t num_frames,
    int32_t version, int32_t layer, int32_t crc,
    const int32_t* bitrate_indices,  // per frame (VBR; CBR passes a fill)
    int32_t sr_mod3, const int32_t* paddings, int32_t ext, int32_t mode,
    int32_t mode_ext, int32_t copyright, int32_t original, int32_t emphasis,
    int32_t private_bits, int32_t nch, int32_t granules,
    const int32_t* scfsi,          // [F][2][4]
    const int64_t* gi,             // [F][gr][ch][F_NFIELDS]
    const int32_t* table_select,   // [F][gr][ch][3]
    const int32_t* sfl,            // [F][gr][ch][22]
    const int32_t* slen1_tab, const int32_t* slen2_tab,
    const int32_t* l3_enc,         // [F][ch][2][576]
    const uint32_t* huff_code, const uint8_t* huff_len,
    const int32_t* huff_linbits, const int32_t* band) {
  int64_t total = 0;
  for (int64_t f = 0; f < num_frames; ++f) {
    int64_t w = mp3_format_frame(
        cache, cache_bits, out + total, out_cap - total,
        version, layer, crc, bitrate_indices[f], sr_mod3, paddings[f], ext,
        mode,
        mode_ext, copyright, original, emphasis, private_bits, nch, granules,
        scfsi + f * 8, gi + f * 2 * 2 * F_NFIELDS, table_select + f * 12,
        sfl + f * 2 * 2 * 22, slen1_tab, slen2_tab, l3_enc + f * 2 * 2 * 576,
        huff_code, huff_len, huff_linbits, band);
    if (w < 0) return -1;
    total += w;
  }
  return total;
}

}  // extern "C"
