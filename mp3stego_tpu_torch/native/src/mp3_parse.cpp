// Native host bitstream core: MP3 frame walk, header/side-info parse, bit
// reservoir assembly, scalefactor + Huffman sample unpack into dense tensors.
//
// Behavioural reference (bit-for-bit): /root/reference/mp3stego/decoder/
//   MP3_Parser.py:21-85 (sync walk incl. stale-PCM duplication quirk),
//   FrameHeader.py:51-192, FrameSideInformation.py:39-137,
//   Frame.py:288-363 (frame size + reservoir, incl. doubled first-frame
//   history entry), Frame.py:365-559 (scalefactor + sample unpack: the
//   reference's hottest loop, here a flat-LUT O(1) symbol decode).
//
// This is the C++ twin of bitstream/decoder_host.py (which stays as the pure
// python fallback + oracle); outputs are identical arrays. Exposed via a C ABI
// for ctypes — no pybind11 dependency.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#if defined(__x86_64__)
#include <x86intrin.h>
#endif

namespace {

// MP3STEGO_TPU_PARSE_PROF=1: per-section cycle split to stderr (tuning aid)
inline uint64_t pprof_tsc() {
#if defined(__x86_64__)
  return __rdtsc();
#else
  return 0;
#endif
}
inline bool pprof_enabled() {
  static const bool on = [] {
    const char* e = std::getenv("MP3STEGO_TPU_PARSE_PROF");
    return e && e[0] == '1';
  }();
  return on;
}

constexpr int kNumPrevFrames = 9;
constexpr int kLutBits = 19;

// ---------------------------------------------------------------- bit reader

struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t nbytes;
  int64_t pos = 0;

  BitReader(const uint8_t* d, int64_t nb) : data(d), nbits(nb * 8), nbytes(nb) {}

  // MSB-first read of n bits; bits past the end read as zero (the reference
  // zero-pads, decoder/util.py:38-47 via _MainDataBits). One unaligned
  // 32-bit load in-bounds; the per-byte walk only near the buffer end.
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
  // Truncated-value read: only the available bits contribute (the reference's
  // side-info reader iterates a short slice, FrameSideInformation semantics —
  // e.g. 2 remaining bits read as a 5-bit field give 0b11, not 0b11000).
  inline uint32_t get_truncated(int64_t p, int n) const {
    if (p + n <= nbits) return get(p, n);  // fully in-bounds: same value
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

// fast path: up to 25 bits in one 32-bit load (still zero-padded past end).
// The common in-bounds case is a single unaligned big-endian load; the
// per-byte zero-padded walk only runs within 4 bytes of the buffer end.
inline uint32_t peek_fast(const uint8_t* data, int64_t nbytes, int64_t bitpos,
                          int n) {
  int64_t byte = bitpos >> 3;
  int off = int(bitpos & 7);
  uint32_t w;
  if (byte + 4 <= nbytes) {
    std::memcpy(&w, data + byte, 4);
    w = __builtin_bswap32(w);
  } else {
    w = 0;
    for (int i = 0; i < 4; ++i) {
      uint32_t b = (byte + i < nbytes) ? data[byte + i] : 0;
      w = (w << 8) | b;
    }
  }
  return (w << off) >> (32 - n);
}

// ------------------------------------------------------------------- header

struct Header {
  int version_num = 1;  // floor of mpeg version (1 for MPEG-1)
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
  h->version_num = int(h->mpeg_version);  // floor, like np.floor in reference
  h->layer = 4 - (((b[1] << 5) & 0xFF) >> 6);
  h->crc = b[1] & 0x01;
  static const int rates[3][3] = {{44100, 48000, 32000},
                                  {22050, 24000, 16000},
                                  {11025, 12000, 8000}};
  // ceil(mpeg_version) like the reference (FrameHeader.py:116-123):
  // 1 -> row 0, 2 -> row 1, 2.5 -> row 2 (and the reserved 0.0 wraps to -1)
  int cv = (h->mpeg_version == 2.5) ? 3 : h->version_num;
  bool srb1 = b[2] & 0x08, srb2 = b[2] & 0x04;
  int row = cv - 1;
  if (row < 0) row = 2;  // mirror python negative-index rates[-1]
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
  if (idx < 0) idx = 13;   // python's rates[-1] wraps to the last entry
  if (idx > 13) idx = 13;  // nibble 0xF -> idx 14: out of the 14-entry table;
                           // the reference would crash, we clamp
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

// --------------------------------------------------- scalefactors + samples

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

struct Luts {
  // Two-level Huffman LUT: l1 is [n_books][2^12] (16 KB/book — cache-hot;
  // the flat 2^19 tables were 2 MB/book and every lookup missed L2).
  // A non-negative l1 entry is the terminal packed symbol (code <= 12 bits,
  // the overwhelmingly common case); a negative entry -(blk+1) escapes to
  // the 2^7-entry block l2[blk] indexed by the next 7 bits (12+7 = 19, the
  // longest MP3 Huffman code).
  const int32_t* l1;             // [n_books][1<<12]
  const int32_t* l2;             // [n_blocks][1<<7], flat
  const int32_t* book_of;        // [32] table id -> row in l1
  const int32_t* linbits;        // [32]
  const int32_t* maxval;         // [32]
  const int32_t* quad_lut;       // [64] packed (p<<5)|len
  const int32_t* band_index_long;  // [3][23]
};

void unpack_samples(const uint8_t* md, int64_t md_len, const SideInfo* si,
                    int sr_idx, int gr, int ch, int64_t bit, int64_t max_bit,
                    const Luts& L, int32_t* out) {
  std::memset(out, 0, 576 * sizeof(int32_t));
  const int32_t* long_win = L.band_index_long + sr_idx * 23;

  int region0, region1;
  if (si->window_switching[gr][ch] && si->block_type[gr][ch] == 2) {
    region0 = 36; region1 = 576;
  } else {
    // clamp: corrupt side info can push r0c+r1c+2 past the 23-entry band
    // table (the reference crashes here; we stop cleanly)
    int r0c = si->region0_count[gr][ch];
    int r1c = si->region1_count[gr][ch];
    int i0 = r0c + 1; if (i0 > 22) i0 = 22;
    int i1 = r0c + 1 + r1c + 1; if (i1 > 22) i1 = 22;
    region0 = long_win[i0];
    region1 = long_win[i1];
  }

  const int* ts = si->table_select[gr][ch];
  int big = si->big_value[gr][ch] * 2;
  if (big > 576) big = 576;  // corrupt big_value: reference overruns, we stop
  int sample = 0;
  // Three region sub-loops (the region of a pair is chosen by its START
  // index, identical to the per-pair `sample < regionN` selection): table,
  // codebook, linbits and the LUT base hoist out of the pair loop.
  const int ends[3] = {region0 < big ? region0 : big,
                       region1 < big ? region1 : big, big};
  for (int rgn = 0; rgn < 3; ++rgn) {
    const int end = ends[rgn];
    if (sample >= end) continue;
    const int table_num = ts[rgn];
    const int book = table_num ? L.book_of[table_num] : -1;
    if (book < 0) {  // table 0 or unused codebook (ids 4/14): skip pairs
      sample += ((end - sample + 1) >> 1) << 1;
      continue;
    }
    const int linbits = L.linbits[table_num];
    const int maxv = L.maxval[table_num];
    const int32_t* l1 = L.l1 + (int64_t(book) << 12);
    while (sample < end) {
      // NOTE: a one-64-bit-window-per-symbol variant (single bswap64 load
      // serving code+linbits+signs) measured ~20% SLOWER here — the
      // successive variable shifts serialize the symbol's dependency
      // chain, while independent 32-bit peeks overlap across fields.
      int32_t packed = l1[peek_fast(md, md_len, bit, 12)];
      if (packed < 0)
        packed = L.l2[(int64_t(-packed - 1) << 7)
                      | peek_fast(md, md_len, bit + 12, 7)];
      const int size = packed & 31;
      if (size == 0) { sample += 2; continue; }  // corrupt: ref advances
      bit += size;
      int values[2] = {packed >> 9, (packed >> 5) & 15};
      for (int i = 0; i < 2; ++i) {
        int v = values[i];
        if (linbits != 0 && v == maxv - 1) {   // escape: rare, hoisted-gated
          v += int(peek_fast(md, md_len, bit, linbits));
          bit += linbits;
        }
        // branchless sign: the bit is peeked unconditionally (pure) and
        // consumed iff the value is nonzero — the data-dependent sign
        // branch was ~50/50 and cost a mispredict per sample
        const int take = values[i] > 0;
        const int neg = take & int(peek_fast(md, md_len, bit, 1));
        bit += take;
        out[sample + i] = neg ? -v : v;
      }
      sample += 2;
    }
  }

  const bool quad_b = si->count1table_select[gr][ch] == 1;  // hoisted
  while (bit < max_bit && sample + 4 < 576) {
    int values[4];
    if (quad_b) {
      uint32_t bs = peek_fast(md, md_len, bit, 4);
      bit += 4;
      values[0] = (bs & 0x08) ? 0 : 1;
      values[1] = (bs & 0x04) ? 0 : 1;
      values[2] = (bs & 0x02) ? 0 : 1;
      values[3] = (bs & 0x01) ? 0 : 1;
    } else {
      int32_t packed = L.quad_lut[peek_fast(md, md_len, bit, 6)];
      int size = packed & 31;
      int p = packed >> 5;
      bit += size;
      values[0] = (p >> 3) & 1; values[1] = (p >> 2) & 1;
      values[2] = (p >> 1) & 1; values[3] = p & 1;
    }
    for (int i = 0; i < 4; ++i) {
      // branchless sign consume, as in the pair loop
      const int take = values[i] > 0;
      const int neg = take & int(peek_fast(md, md_len, bit, 1));
      bit += take;
      out[sample + i] = neg ? -values[i] : values[i];
    }
    sample += 4;
  }
}

// ------------------------------------------------------------ main data splice

int64_t assemble_main_data(const uint8_t* file, int64_t n, int64_t curr_offset,
                           int64_t frame_size, const double* prev_sizes,
                           const SideInfo& si, const Header& h, uint8_t* out,
                           int64_t out_cap) {
  int constant = (h.channels == 1) ? 21 : 36;
  if (h.crc == 0) constant += 2;
  // mirrors python slice semantics file[loc:loc+len] exactly, including the
  // negative-index wrap a corrupt main_data_begin triggers (the reference
  // reads from the file TAIL in that case — bug-compatible)
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

}  // namespace

// ------------------------------------------------------------------- C ABI

extern "C" {

// Count frames from `offset` (sync walk only). Returns frame count; sets

// Known metadata trailers end the stream cleanly instead of triggering the
// stale-PCM duplication quirk (ID3v1 "TAG", APEv2 "APETAGEX", ID3v2 footer)
// — mirrors decoder_host.walk_frames; validated vs libmpg123.
static inline bool is_metadata_trailer(const uint8_t* data, int64_t cur,
                                       int64_t n) {
  if (cur + 3 <= n && (std::memcmp(data + cur, "TAG", 3) == 0
                       || std::memcmp(data + cur, "ID3", 3) == 0))
    return true;
  return cur + 8 <= n && std::memcmp(data + cur, "APETAGEX", 8) == 0;
}

// *duplicate_last to the stale-PCM quirk flag (MP3_Parser.py:79).
int64_t mp3_count_frames(const uint8_t* data, int64_t n, int64_t offset,
                         int32_t* duplicate_last) {
  *duplicate_last = 0;
  if (offset + 1 >= n || data[offset] != 0xFF || data[offset + 1] < 0xE0)
    return 0;
  Header h;
  parse_header(data + offset, &h);
  int64_t frame_size = frame_size_of(h);
  int64_t cur = offset;
  int64_t count = 0;
  while (n > cur + 4) {
    if (data[cur] == 0xFF && data[cur + 1] >= 0xE0) {
      parse_header(data + cur, &h);
      frame_size = frame_size_of(h);
      if (frame_size <= 0) return count;  // malformed header: stop cleanly
      ++count;
      cur += frame_size;
    } else {
      *duplicate_last =
          (count > 0 && !is_metadata_trailer(data, cur, n)) ? 1 : 0;
      break;
    }
  }
  return count;
}

// Full parse. All output arrays must be preallocated for `max_frames` frames.
// Returns number of frames parsed, or -1 on error.
int64_t mp3_parse(
    const uint8_t* data, int64_t n, int64_t offset,
    // LUTs
    const int32_t* dec_l1, const int32_t* dec_l2, const int32_t* book_of,
    const int32_t* linbits, const int32_t* maxval, const int32_t* quad_lut,
    const int32_t* band_index_long,
    // outputs
    int64_t max_frames,
    int32_t* header_out,       // [8]: sr_idx, bitrate_kbps_x1000? see python
    int64_t* frame_sizes,      // [F]
    int32_t* raw,              // [F,2,2,576]
    int32_t* block_type,       // [F,2,2] each
    int32_t* mixed_block_flag, int32_t* window_switching, int32_t* global_gain,
    int32_t* scale_fac_scale, int32_t* pre_flag,
    int32_t* sub_block_gain,   // [F,2,2,3]
    int32_t* scale_fac_l,      // [F,2,2,22]
    int32_t* scale_fac_s,      // [F,2,2,3,13]
    int32_t* table_select,     // [F,2,2,3]
    uint8_t* ms_stereo) {      // [F]: bit0 = MS, bit1 = intensity
  int32_t dup = 0;
  if (offset + 1 >= n || data[offset] != 0xFF || data[offset + 1] < 0xE0)
    return 0;
  Header first_h;
  parse_header(data + offset, &first_h);

  Luts L{dec_l1, dec_l2, book_of, linbits, maxval, quad_lut,
         band_index_long};

  double prev_hist[kNumPrevFrames] = {};
  int64_t frame_size = frame_size_of(first_h);
  if (frame_size <= 0) return 0;
  std::vector<uint8_t> md(65536);

  int64_t cur = offset;
  int64_t fi = 0;
  const bool pprof = pprof_enabled();
  uint64_t c_hdr = 0, c_asm = 0, c_sf = 0, c_smp = 0, c_out = 0;
  uint64_t pt0 = 0, pt1 = 0;
  while (n > cur + 4 && fi < max_frames) {
    if (pprof) pt0 = pprof_tsc();
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

    if (pprof) { pt1 = pprof_tsc(); c_hdr += pt1 - pt0; pt0 = pt1; }
    int64_t md_len = assemble_main_data(data, n, cur, frame_size, prev_hist,
                                        si, h, md.data(), int64_t(md.size()));
    if (pprof) { pt1 = pprof_tsc(); c_asm += pt1 - pt0; pt0 = pt1; }
    int64_t bit = 0;
    for (int gr = 0; gr < 2; ++gr)
      for (int ch = 0; ch < h.channels; ++ch) {
        int64_t max_bit = bit + si.part2_3_length[gr][ch];
        if (pprof) pt0 = pprof_tsc();
        bit = unpack_scale_factors(md.data(), md_len, &si, gr, ch, bit);
        if (pprof) { pt1 = pprof_tsc(); c_sf += pt1 - pt0; pt0 = pt1; }
        unpack_samples(md.data(), md_len, &si, h.sr_idx, gr, ch, bit, max_bit,
                       L, raw + ((fi * 2 + gr) * 2 + ch) * 576);
        if (pprof) { pt1 = pprof_tsc(); c_smp += pt1 - pt0; pt0 = pt1; }
        bit = max_bit;
      }

    if (pprof) pt0 = pprof_tsc();
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
    if (pprof) { pt1 = pprof_tsc(); c_out += pt1 - pt0; }
    cur += frame_size;
    ++fi;
  }
  if (pprof && fi > 0) {
    std::fprintf(stderr,
                 "[parse_prof] F=%lld cyc/frame: hdr+side=%.0f asm=%.0f "
                 "scalefac=%.0f samples=%.0f out=%.0f total=%.0f\n",
                 (long long)fi, double(c_hdr) / fi, double(c_asm) / fi,
                 double(c_sf) / fi, double(c_smp) / fi, double(c_out) / fi,
                 double(c_hdr + c_asm + c_sf + c_smp + c_out) / fi);
  }

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
