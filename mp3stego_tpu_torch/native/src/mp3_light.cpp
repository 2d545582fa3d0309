// Native light parse: the frame walk of mp3_parse.cpp's mp3_parse (headers,
// side info, bit-reservoir splice, scalefactors) without the Huffman sample
// scan. In place of the (F, 2, 2, 576) sample plane it writes the scan's
// input in the layout of ops/huffman_device.py's pack: each frame's spliced
// main data once as big-endian 32-bit words (then pad_words zero words), and
// per lane (frame > gr > ch) 8 int32 fields in huffman_device.FIELDS order.
// csrc/huffman.cu (or its plain version) decodes the samples from them.
//
// Port-only source. The helpers below are copies of mp3_parse.cpp's
// (anonymous namespace there and here, so the two translation units link
// into one library without a clash); mp3_parse.cpp itself stays a byte
// copy of the JAX package's. Semantics are mp3_parse's, field for field:
// the side planes equal its own, and the lanes equal huffman_device.pack of
// bitstream/decoder_host.parse_mp3_light's descriptors.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumPrevFrames = 9;

// ---------------------------------------------------------------- bit reader

struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t nbytes;
  int64_t pos = 0;

  BitReader(const uint8_t* d, int64_t nb) : data(d), nbits(nb * 8), nbytes(nb) {}

  inline uint32_t get(int64_t p, int n) const {
    if (n == 0) return 0;
    int64_t byte = p >> 3;
    int off = int(p & 7);
    uint32_t w;
    if (byte + 4 <= nbytes) {
      std::memcpy(&w, data + byte, 4);
      w = __builtin_bswap32(w);
    } else {
      w = 0;
      for (int i = 0; i < 4; ++i) {
        uint32_t b = (byte + i >= 0 && byte + i < nbytes) ? data[byte + i] : 0;
        w = (w << 8) | b;
      }
    }
    return (w << off) >> (32 - n);
  }
  inline uint32_t get_truncated(int64_t p, int n) const {
    if (p + n <= nbits) return get(p, n);
    int64_t end = p + n;
    if (end > nbits) end = nbits;
    uint32_t v = 0;
    for (int64_t b = p; b < end; ++b)
      v = (v << 1) | ((data[b >> 3] >> (7 - (b & 7))) & 1u);
    return v;
  }
  inline uint32_t read(int n) {
    uint32_t v = get_truncated(pos, n);
    pos += n;
    return v;
  }
};

// ------------------------------------------------------------------- header

struct Header {
  int version_num = 1;
  int layer = 0;
  int crc = 0;
  int64_t bit_rate = 0;
  int64_t sampling_rate = 0;
  int padding = 0;
  int channel_mode = 0;
  int channels = 2;
  int mode_ext0 = 0;
  int mode_ext1 = 0;
  int sr_idx = 0;
  double mpeg_version = 1.0;
};

const int kL3Rates[14] = {32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320};
const int kL2Rates[14] = {32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384};
const int kL2LoRates[14] = {8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160};

bool parse_header(const uint8_t* b, Header* h) {
  bool v1 = b[1] & 0x10, v2 = b[1] & 0x08;
  if (v1 && v2) { h->mpeg_version = 1.0; }
  else if (v1) { h->mpeg_version = 2.0; }
  else if (v2) { h->mpeg_version = 0.0; }
  else { h->mpeg_version = 2.5; }
  h->version_num = int(h->mpeg_version);
  h->layer = 4 - (((b[1] << 5) & 0xFF) >> 6);
  h->crc = b[1] & 0x01;
  static const int rates[3][3] = {{44100, 48000, 32000},
                                  {22050, 24000, 16000},
                                  {11025, 12000, 8000}};
  int cv = (h->mpeg_version == 2.5) ? 3 : h->version_num;
  bool srb1 = b[2] & 0x08, srb2 = b[2] & 0x04;
  int row = cv - 1;
  if (row < 0) row = 2;
  if (!srb1 && !srb2) h->sampling_rate = rates[row][0];
  else if (!srb1 && srb2) h->sampling_rate = rates[row][1];
  else if (srb1 && !srb2) h->sampling_rate = rates[row][2];
  else h->sampling_rate = 0;
  h->channel_mode = (b[3] >> 6) & 0x03;
  h->channels = h->channel_mode == 3 ? 1 : 2;
  h->mode_ext0 = (h->layer == 3) ? (b[3] & 0x20) : 0;
  h->mode_ext1 = (h->layer == 3) ? (b[3] & 0x10) : 0;
  h->padding = (b[2] & 0x02) ? 1 : 0;
  int idx = ((b[2] >> 4) & 0x0F) - 1;
  if (idx < 0) idx = 13;
  if (idx > 13) idx = 13;
  h->bit_rate = 0;
  if (h->mpeg_version == 1.0) {
    if (h->layer == 1) h->bit_rate = int64_t(b[2]) * 32;
    else if (h->layer == 2) h->bit_rate = int64_t(kL2Rates[idx]) * 1000;
    else if (h->layer == 3) h->bit_rate = int64_t(kL3Rates[idx]) * 1000;
  } else {
    if (h->layer == 1) h->bit_rate = int64_t(kL3Rates[idx]) * 1000;
    else if (h->layer < 4) h->bit_rate = int64_t(kL2LoRates[idx]) * 1000;
  }
  if (h->sampling_rate == 44100) h->sr_idx = 0;
  else if (h->sampling_rate == 48000) h->sr_idx = 1;
  else if (h->sampling_rate == 32000) h->sr_idx = 2;
  else h->sr_idx = 0;
  return true;
}

int64_t frame_samples(const Header& h) {
  if (h.layer == 3) return h.mpeg_version == 1.0 ? 1152 : 576;
  if (h.layer == 2) return 1152;
  return 384;
}

int64_t frame_size_of(const Header& h) {
  if (h.sampling_rate == 0) return 0;
  int64_t size = int64_t((double(frame_samples(h)) / 8.0) * double(h.bit_rate) /
                         double(h.sampling_rate));
  if (h.padding) size += 1;
  return size;
}

// ----------------------------------------------------------------- side info

struct SideInfo {
  int main_data_begin = 0;
  int scfsi[2][4] = {};
  int part2_3_length[2][2] = {};
  int big_value[2][2] = {};
  int global_gain[2][2] = {};
  int scale_fac_compress[2][2] = {};
  int window_switching[2][2] = {};
  int block_type[2][2] = {};
  int mixed_block_flag[2][2] = {};
  int table_select[2][2][3] = {};
  int sub_block_gain[2][2][3] = {};
  int region0_count[2][2] = {};
  int region1_count[2][2] = {};
  int pre_flag[2][2] = {};
  int scale_fac_scale[2][2] = {};
  int count1table_select[2][2] = {};
  int scale_fac_l[2][2][22] = {};
  int scale_fac_s[2][2][3][13] = {};
};

void parse_side_info(const uint8_t* bytes, int64_t nbytes, const Header& h,
                     SideInfo* si) {
  BitReader br(bytes, nbytes);
  si->main_data_begin = br.read(9);
  br.pos += (h.channels == 1) ? 5 : 3;
  for (int ch = 0; ch < h.channels; ++ch)
    for (int band = 0; band < 4; ++band) si->scfsi[ch][band] = br.read(1);
  for (int gr = 0; gr < 2; ++gr) {
    for (int ch = 0; ch < h.channels; ++ch) {
      si->part2_3_length[gr][ch] = br.read(12);
      si->big_value[gr][ch] = br.read(9);
      si->global_gain[gr][ch] = br.read(8);
      si->scale_fac_compress[gr][ch] = br.read(4);
      si->window_switching[gr][ch] = br.read(1);
      if (si->window_switching[gr][ch]) {
        si->block_type[gr][ch] = br.read(2);
        si->mixed_block_flag[gr][ch] = br.read(1);
        si->region0_count[gr][ch] = si->block_type[gr][ch] == 2 ? 8 : 7;
        si->region1_count[gr][ch] = 20 - si->region0_count[gr][ch];
        for (int r = 0; r < 2; ++r) si->table_select[gr][ch][r] = br.read(5);
        for (int w = 0; w < 3; ++w) si->sub_block_gain[gr][ch][w] = br.read(3);
      } else {
        si->block_type[gr][ch] = 0;
        si->mixed_block_flag[gr][ch] = 0;
        for (int r = 0; r < 3; ++r) si->table_select[gr][ch][r] = br.read(5);
        si->region0_count[gr][ch] = br.read(4);
        si->region1_count[gr][ch] = br.read(3);
      }
      si->pre_flag[gr][ch] = br.read(1);
      si->scale_fac_scale[gr][ch] = br.read(1);
      si->count1table_select[gr][ch] = br.read(1);
    }
  }
}

// -------------------------------------------------------------- scalefactors

const int kSlen[16][2] = {{0, 0}, {0, 1}, {0, 2}, {0, 3}, {3, 0}, {1, 1},
                          {1, 2}, {1, 3}, {2, 1}, {2, 2}, {2, 3}, {3, 1},
                          {3, 2}, {3, 3}, {4, 2}, {4, 3}};

int64_t unpack_scale_factors(const uint8_t* md, int64_t md_len, SideInfo* si,
                             int gr, int ch, int64_t bit) {
  int sfc = si->scale_fac_compress[gr][ch];
  int sl0 = kSlen[sfc][0], sl1 = kSlen[sfc][1];
  BitReader br(md, md_len);
  if (si->block_type[gr][ch] == 2 && si->window_switching[gr][ch]) {
    if (si->mixed_block_flag[gr][ch] == 1) {
      for (int sfb = 0; sfb < 8; ++sfb) {
        si->scale_fac_l[gr][ch][sfb] = br.get(bit, sl0); bit += sl0;
      }
      for (int sfb = 3; sfb < 6; ++sfb)
        for (int w = 0; w < 3; ++w) {
          si->scale_fac_s[gr][ch][w][sfb] = br.get(bit, sl0); bit += sl0;
        }
    } else {
      for (int sfb = 0; sfb < 6; ++sfb)
        for (int w = 0; w < 3; ++w) {
          si->scale_fac_s[gr][ch][w][sfb] = br.get(bit, sl0); bit += sl0;
        }
    }
    for (int sfb = 6; sfb < 12; ++sfb)
      for (int w = 0; w < 3; ++w) {
        si->scale_fac_s[gr][ch][w][sfb] = br.get(bit, sl1); bit += sl1;
      }
    for (int w = 0; w < 3; ++w) si->scale_fac_s[gr][ch][w][12] = 0;
  } else {
    if (gr == 0) {
      for (int sfb = 0; sfb < 11; ++sfb) {
        si->scale_fac_l[gr][ch][sfb] = br.get(bit, sl0); bit += sl0;
      }
      for (int sfb = 11; sfb < 21; ++sfb) {
        si->scale_fac_l[gr][ch][sfb] = br.get(bit, sl1); bit += sl1;
      }
    } else {
      static const int kSB[4] = {6, 11, 16, 21};
      static const int kPrevSB[4] = {0, 6, 11, 16};
      for (int i = 0; i < 2; ++i)
        for (int sfb = kPrevSB[i]; sfb < kSB[i]; ++sfb) {
          if (si->scfsi[ch][i])
            si->scale_fac_l[1][ch][sfb] = si->scale_fac_l[0][ch][sfb];
          else { si->scale_fac_l[1][ch][sfb] = br.get(bit, sl0); bit += sl0; }
        }
      for (int i = 2; i < 4; ++i)
        for (int sfb = kPrevSB[i]; sfb < kSB[i]; ++sfb) {
          if (si->scfsi[ch][i])
            si->scale_fac_l[1][ch][sfb] = si->scale_fac_l[0][ch][sfb];
          else { si->scale_fac_l[1][ch][sfb] = br.get(bit, sl1); bit += sl1; }
        }
    }
    si->scale_fac_l[gr][ch][21] = 0;
  }
  return bit;
}

// ------------------------------------------------------------ main data splice

int64_t assemble_main_data(const uint8_t* file, int64_t n, int64_t curr_offset,
                           int64_t frame_size, const double* prev_sizes,
                           const SideInfo& si, const Header& h, uint8_t* out,
                           int64_t out_cap) {
  int constant = (h.channels == 1) ? 21 : 36;
  if (h.crc == 0) constant += 2;
  auto norm = [&](int64_t idx) -> int64_t {
    if (idx < 0) idx += n;
    if (idx < 0) idx = 0;
    if (idx > n) idx = n;
    return idx;
  };
  auto copy_range = [&](int64_t from, int64_t len, int64_t at) -> int64_t {
    if (len <= 0) return 0;
    int64_t s0 = norm(from);
    int64_t e0 = norm(from + len);
    int64_t m = e0 - s0;
    if (m < 0) m = 0;
    if (at + m > out_cap) m = out_cap - at;
    std::memcpy(out + at, file + s0, size_t(m));
    return m;
  };
  if (si.main_data_begin == 0) {
    return copy_range(curr_offset + constant, frame_size - constant, 0);
  }
  double bound = 0;
  for (int frame = 0; frame < kNumPrevFrames; ++frame) {
    bound += prev_sizes[frame] - constant;
    if (si.main_data_begin < bound) {
      double ptr_offset = si.main_data_begin + frame * constant;
      double part[kNumPrevFrames] = {};
      part[frame] = si.main_data_begin;
      for (int i = 0; i < frame; ++i) {
        part[i] = prev_sizes[i] - constant;
        part[frame] -= part[i];
      }
      int64_t written = 0;
      int64_t loc = curr_offset - int64_t(ptr_offset);
      written += copy_range(loc, int64_t(part[frame]), written);
      ptr_offset -= part[frame] + constant;
      for (int i = frame - 1; i >= 0; --i) {
        loc = curr_offset - int64_t(ptr_offset);
        written += copy_range(loc, int64_t(part[i]), written);
        ptr_offset -= part[i] + constant;
      }
      written += copy_range(curr_offset + constant, frame_size - constant,
                            written);
      return written;
    }
  }
  return 0;
}

inline bool is_metadata_trailer(const uint8_t* data, int64_t cur, int64_t n) {
  if (cur + 3 <= n && (std::memcmp(data + cur, "TAG", 3) == 0
                       || std::memcmp(data + cur, "ID3", 3) == 0))
    return true;
  return cur + 8 <= n && std::memcmp(data + cur, "APETAGEX", 8) == 0;
}

constexpr int kFields = 8;   // huffman_device.FIELDS

}  // namespace

extern "C" {

// The light parse. Every output but the lanes as mp3_parse's, for
// `max_frames` frames (mp3_count_frames'), in its argument order less the
// sample plane. `words` holds `words_cap` int32; `fields` (4 max_frames, 8).
// Writes `*words_used`, the words the stream needs (the frames' words and
// `pad_words` zero words): where it exceeds `words_cap`, no words past the
// cap are written, and the caller parses again with that many. Returns the
// frames parsed; header_out as mp3_parse's (its slot 6, the stale-PCM flag
// of this walk, as there).
int64_t mp3_parse_light(
    const uint8_t* data, int64_t n, int64_t offset,
    const int32_t* band_index_long,   // [3][23]
    int64_t max_frames,
    int32_t* header_out, int64_t* frame_sizes,
    int32_t* block_type, int32_t* mixed_block_flag, int32_t* window_switching,
    int32_t* global_gain, int32_t* scale_fac_scale, int32_t* pre_flag,
    int32_t* sub_block_gain, int32_t* scale_fac_l, int32_t* scale_fac_s,
    int32_t* table_select, uint8_t* ms_stereo,
    int32_t* words, int64_t words_cap, int64_t pad_words, int32_t* fields,
    int64_t* words_used) {
  int32_t dup = 0;
  *words_used = 0;
  if (offset + 1 >= n || data[offset] != 0xFF || data[offset + 1] < 0xE0)
    return 0;
  Header first_h;
  parse_header(data + offset, &first_h);

  double prev_hist[kNumPrevFrames] = {};
  int64_t frame_size = frame_size_of(first_h);
  if (frame_size <= 0) return 0;
  // the spliced main data, then 3 zero bytes for the last word's tail
  std::vector<uint8_t> md(65536 + 3);
  const int64_t md_cap = 65536;

  int64_t cur = offset;
  int64_t fi = 0;
  int64_t base = 0;   // the next frame's first word
  while (n > cur + 4 && fi < max_frames) {
    if (!(data[cur] == 0xFF && data[cur + 1] >= 0xE0)) {
      dup = (fi > 0 && !is_metadata_trailer(data, cur, n)) ? 1 : 0;
      break;
    }
    Header h;
    parse_header(data + cur, &h);
    for (int i = kNumPrevFrames - 1; i > 0; --i) prev_hist[i] = prev_hist[i - 1];
    prev_hist[0] = double(frame_size);
    frame_size = frame_size_of(h);
    if (frame_size <= 0) break;

    int start_si = (h.crc == 0) ? 6 : 4;
    SideInfo si;
    parse_side_info(data + cur + start_si,
                    (cur + frame_size <= n ? frame_size : n - cur) - start_si,
                    h, &si);

    int64_t md_len = assemble_main_data(data, n, cur, frame_size, prev_hist,
                                        si, h, md.data(), md_cap);
    // the frame's words, big-endian, zero past md_len
    const int64_t nwords = (md_len + 3) / 4;
    std::memset(md.data() + md_len, 0, 3);
    for (int64_t i = 0; i < nwords && base + i < words_cap; ++i) {
      uint32_t w;
      std::memcpy(&w, md.data() + 4 * i, 4);
      words[base + i] = int32_t(__builtin_bswap32(w));
    }

    const int32_t* long_win = band_index_long + h.sr_idx * 23;
    int64_t bit = 0;
    for (int gr = 0; gr < 2; ++gr)
      for (int ch = 0; ch < 2; ++ch) {
        int32_t* f = fields + ((fi * 2 + gr) * 2 + ch) * kFields;
        std::memset(f, 0, kFields * sizeof(int32_t));
        if (ch >= h.channels) continue;     // a mono stream's second channel
        int64_t max_bit = bit + si.part2_3_length[gr][ch];
        int64_t start = unpack_scale_factors(md.data(), md_len, &si, gr, ch,
                                             bit);
        int region0, region1;
        if (si.window_switching[gr][ch] && si.block_type[gr][ch] == 2) {
          region0 = 36; region1 = 576;
        } else {
          int r0c = si.region0_count[gr][ch];
          int r1c = si.region1_count[gr][ch];
          int i0 = r0c + 1; if (i0 > 22) i0 = 22;
          int i1 = r0c + 1 + r1c + 1; if (i1 > 22) i1 = 22;
          region0 = long_win[i0];
          region1 = long_win[i1];
        }
        int big2 = si.big_value[gr][ch] * 2;
        if (big2 > 576) big2 = 576;
        const int* ts = si.table_select[gr][ch];
        f[0] = nwords ? int32_t(base) : 0;
        f[1] = int32_t(nwords);
        f[2] = int32_t(start);
        f[3] = int32_t(max_bit);
        f[4] = region0;
        f[5] = region1;
        f[6] = big2;
        f[7] = ts[0] | ts[1] << 5 | ts[2] << 10
               | si.count1table_select[gr][ch] << 15;
        bit = max_bit;
      }
    base += nwords;

    frame_sizes[fi] = frame_size;
    for (int gr = 0; gr < 2; ++gr)
      for (int ch = 0; ch < 2; ++ch) {
        int64_t k = (fi * 2 + gr) * 2 + ch;
        block_type[k] = si.block_type[gr][ch];
        mixed_block_flag[k] = si.mixed_block_flag[gr][ch];
        window_switching[k] = si.window_switching[gr][ch];
        global_gain[k] = si.global_gain[gr][ch];
        scale_fac_scale[k] = si.scale_fac_scale[gr][ch];
        pre_flag[k] = si.pre_flag[gr][ch];
        for (int r = 0; r < 3; ++r) {
          sub_block_gain[k * 3 + r] = si.sub_block_gain[gr][ch][r];
          table_select[k * 3 + r] = si.table_select[gr][ch][r];
        }
        for (int s = 0; s < 22; ++s)
          scale_fac_l[k * 22 + s] = si.scale_fac_l[gr][ch][s];
        for (int w = 0; w < 3; ++w)
          for (int s = 0; s < 13; ++s)
            scale_fac_s[(k * 3 + w) * 13 + s] = si.scale_fac_s[gr][ch][w][s];
      }
    ms_stereo[fi] = uint8_t(((h.channel_mode == 1 && h.mode_ext0) ? 1 : 0)
                            | ((h.channel_mode == 1 && h.mode_ext1) ? 2 : 0));
    cur += frame_size;
    ++fi;
  }
  for (int64_t i = base; i < base + pad_words && i < words_cap; ++i)
    words[i] = 0;
  *words_used = base + pad_words;

  header_out[0] = first_h.sr_idx;
  header_out[1] = int32_t(first_h.bit_rate / 1000);
  header_out[2] = int32_t(first_h.sampling_rate);
  header_out[3] = first_h.channels;
  header_out[4] = first_h.channel_mode;
  header_out[5] = first_h.crc;
  header_out[6] = dup;
  header_out[7] = first_h.layer;
  return fi;
}

}  // extern "C"
