"""Constant tables for the PyTorch MP3 codec / steganography port.

All spec data (ISO/IEC 11172-3 Annex B Huffman codebooks, scalefactor band
partitions, analysis/synthesis windows, region subdivision) lives in the packed
``iso_tables.npz`` generated by ``tools/gen_tables.py``. The port keeps its
own copy of the pack beside this module (byte for byte the JAX package's,
held equal by tests/test_torch_import.py), so it needs no file outside its
own directory.

This module loads the pack once and derives the runtime LUT forms:

* ``HUFF_CODE/HUFF_LEN``          (34,16,16) encoder-side codeword tables
* ``DEC_LUT19``                   flat 2^19-entry decode LUTs for the 15 distinct
                                  big-values codebooks (O(1) symbol decode; replaces
                                  the reference's O(rows*cols) linear scan,
                                  decoder/Frame.py:489-518)
* ``QUAD_LUT``                    2^6-entry decode LUT for the count1 quad table
* scalefactor-band maps, windows, fixed-point filterbank/MDCT coefficient
  matrices (generated from the spec formulas, MP3_Encoder.py:528-579 /
  decoder/Frame.py:16-62 are the behavioural reference)
"""

import math
import os

import numpy as np

_PACK_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "iso_tables.npz")
_PACK = np.load(_PACK_PATH)

# ----------------------------------------------------------------- raw spec data
HUFF_CODE = _PACK["huff_code"]            # (34,16,16) uint32
HUFF_LEN = _PACK["huff_len"]              # (34,16,16) uint8
HUFF_XLEN = _PACK["huff_xlen"]            # (34,) int32
HUFF_YLEN = _PACK["huff_ylen"]
HUFF_LINBITS = _PACK["huff_linbits"]
HUFF_LINMAX = _PACK["huff_linmax"]
DEC_MAXVAL = _PACK["dec_maxval"]          # (32,) decode grid dimension per table id

BAND_INDEX_LONG = _PACK["band_index_long"]    # (3,23) by samplerate idx 0=44.1,1=48,2=32
BAND_INDEX_SHORT = _PACK["band_index_short"]  # (3,14)
BAND_WIDTH_LONG = _PACK["band_width_long"]    # (3,21)
BAND_WIDTH_SHORT = _PACK["band_width_short"]  # (3,12)
SCALE_FACT_BAND_INDEX = _PACK["scale_fact_band_index"]  # (9,23) encoder-side

# Spec-correct band tables for all 9 rates (ISO 11172-3 B.8 / 13818-3 B.2;
# cross-verified against the system libmpg123's embedded tables by
# tools/verify_bands_mpg123.py). SCALE_FACT_BAND_INDEX above is the
# reference's byte-exact copy — its 16 kHz row carries two typos (45 for 54,
# 248 for 284) and is kept only for reference-layout encode byte-identity.
BAND_INDEX_ISO = _PACK["band_index_iso"]            # (9,23)
BAND_WIDTH_SHORT_ISO = _PACK["band_width_short_iso"]  # (9,13)

# Both table families stacked: rows 0-8 are the reference's (encode
# byte-identity), rows 9-17 the ISO/ecosystem rows (spec-correct decode and
# the compliant LSF writer). Encode engines index this with a `band_row`
# that is samplerate_index (+9 when the compliant LSF writer is active), so
# one parameter selects the family without forking the engine signatures.
BAND_ALL = np.concatenate([SCALE_FACT_BAND_INDEX, BAND_INDEX_ISO], axis=0)

SLEN = _PACK["slen"]                      # (16,2) decoder scalefactor lengths
PRE_TAB = _PACK["pre_tab"]                # (21,)
SLEN1_TAB = _PACK["slen1_tab"]            # (16,)
SLEN2_TAB = _PACK["slen2_tab"]
SUBDV_TABLE = _PACK["subdv_table"]        # (23,2) region subdivision
SYNTH_WINDOW = _PACK["synth_window"]      # (512,) float64 (ISO Table B.3 "D" window)
ENWINDOW = _PACK["enwindow"].astype(np.int64)  # (512,) fixed-point analysis window

GRANULE_SIZE = 576
SB_LIMIT = 32
HAN_SIZE = 512

# Samplerate order used by SCALE_FACT_BAND_INDEX / BAND_* tables.
SAMPLERATE_INDEX = {44100: 0, 48000: 1, 32000: 2}

# Steganography Huffman-pair maps (the paper's table transformation; verified
# inverse-consistent: every (t,0) image is in H0, every (t,1) image is not).
# Reference: decoder/util.py:3 and encoder/MP3_Encoder.py:419-449.
H0 = frozenset({3, 6, 8, 11, 12, 15, 17, 19, 21, 23, 24, 26, 28, 30})

_PAIR = {
    1: (3, 1), 2: (3, 2), 3: (3, 2), 5: (6, 5), 6: (6, 5), 7: (8, 7), 8: (8, 7),
    9: (8, 9), 10: (11, 10), 11: (11, 10), 12: (12, 10), 13: (15, 13), 15: (15, 13),
    16: (17, 16), 17: (17, 18), 18: (19, 18), 19: (19, 20), 20: (21, 20),
    21: (21, 22), 22: (23, 22), 23: (23, 31), 24: (24, 25), 25: (26, 25),
    26: (26, 27), 27: (28, 27), 28: (28, 29), 29: (30, 29), 30: (30, 31),
    31: (23, 31),
}
# TRANSFORM_HUF[t, bit] -> emitted table (0 where t unused: 0, 4, 14)
TRANSFORM_HUF = np.zeros((32, 2), dtype=np.int32)
for _t, (_b0, _b1) in _PAIR.items():
    TRANSFORM_HUF[_t, 0] = _b0
    TRANSFORM_HUF[_t, 1] = _b1
assert all(int(TRANSFORM_HUF[t, 0]) in H0 for t in _PAIR)
assert all(int(TRANSFORM_HUF[t, 1]) not in H0 for t in _PAIR)

# ------------------------------------------------------ decode LUTs (big values)
# Distinct codebooks among table ids 0..31 (ids 16..23 share one codebook with
# varying linbits; 24..31 share another).
DEC_CODEBOOK_OF = np.array(
    [0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 12, 13, 0, 15] + [16] * 8 + [24] * 8,
    dtype=np.int32,
)
DEC_LINBITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 6, 8, 10, 13,
     4, 5, 6, 7, 8, 9, 11, 13],
    dtype=np.int32,
)

LUT_BITS = 19  # max big-values codeword length


def _build_dec_lut(book: int) -> np.ndarray:
    """Flat 2^19 LUT: index = next 19 bits -> packed (x<<9)|(y<<5)|len."""
    lut = np.zeros(1 << LUT_BITS, dtype=np.int32)
    n = int(DEC_MAXVAL[book])
    for x in range(n):
        for y in range(n):
            ln = int(HUFF_LEN[book, x, y])
            if ln == 0 and not (x == y == 0):
                continue
            code = int(HUFF_CODE[book, x, y])
            lo = code << (LUT_BITS - ln)
            hi = (code + 1) << (LUT_BITS - ln)
            lut[lo:hi] = (x << 9) | (y << 5) | ln
    return lut


_DEC_LUTS: dict = {}


def dec_lut(book: int) -> np.ndarray:
    if book not in _DEC_LUTS:
        _DEC_LUTS[book] = _build_dec_lut(book)
    return _DEC_LUTS[book]


def _build_quad_lut() -> np.ndarray:
    """2^6 LUT for the count1 quad codebook (table 32): packed (p<<5)|len."""
    lut = np.zeros(1 << 6, dtype=np.int32)
    for p in range(16):
        ln = int(HUFF_LEN[32, 0, p])
        code = int(HUFF_CODE[32, 0, p])
        lo = code << (6 - ln)
        hi = (code + 1) << (6 - ln)
        lut[lo:hi] = (p << 5) | ln
    return lut


QUAD_LUT = _build_quad_lut()

# --------------------------------------------------- generated numeric constants


def synth_filter_matrix() -> np.ndarray:
    """(64,32) synthesis cosine matrix N[i,j]=cos((16+i)(2j+1)pi/64).

    Behavioural reference: decoder/Frame.py:16-29."""
    i = np.arange(64)[:, None].astype(np.float64)
    j = np.arange(32)[None, :].astype(np.float64)
    return np.cos((16.0 + i) * (2.0 * j + 1.0) * (math.pi / 64.0))


def ref_start_window() -> bool:
    """True when MP3STEGO_TPU_REF_START_WINDOW=1 selects the reference's
    (non-ISO) start-window shape; engine-level caches key on this."""
    return os.environ.get("MP3STEGO_TPU_REF_START_WINDOW", "0") == "1"


def ref_pcm_wrap() -> bool:
    """True when MP3STEGO_TPU_REF_PCM_WRAP=1 restores the reference's int16
    PCM conversion: (pcm*32767).astype(int16), which WRAPS mod 2^16 on
    clipping peaks — an overshooting transient becomes a full-scale sign
    flip (measured ~16 dB SNR vs libmpg123 on clipping streams; ~42 dB
    saturated). Default saturates to [-32768, 32767] like every production
    decoder. The reference's own fixture never clips, so no golden depends
    on the wrap."""
    return os.environ.get("MP3STEGO_TPU_REF_PCM_WRAP", "0") == "1"


def ref_short_bands() -> bool:
    """True when MP3STEGO_TPU_REF_SHORT_BANDS=1 restores the reference's
    12-band short-block requantize walk + reorder for MPEG-1 streams (it
    drops the 13th short band — output samples past the 12-band coverage
    are zero-filled and the top of the spectrum is lost; Frame.py:574-602).
    Default is the ISO 13-band behavior. LSF rows are always ISO (the
    reference cannot decode LSF at all)."""
    return os.environ.get("MP3STEGO_TPU_REF_SHORT_BANDS", "0") == "1"


def ref_mixed() -> bool:
    """True when MP3STEGO_TPU_REF_MIXED=1 restores the reference's
    mixed-block decode for block-type-2 granules with mixed_block_flag set:
    its requantize walk treats the whole granule as short (Frame.py:186
    short-circuits on block_type == 2, so the long region's scalefactors
    and band widths are never used), the reorder scrambles the long region
    (Frame.py:277-278 reorders from sample 0), alias reduction is skipped
    (its 2-subband mixed path at Frame.py:613 is unreachable), and the
    IMDCT short-windows the long subbands. Default is the ecosystem decode:
    long bands 0..7 (MPEG-1) / 0..5 (LSF) requantized with the long walk,
    the first 2 polyphase subbands long-windowed with 1 alias butterfly,
    short bands from band 3 reordered above the boundary (at 8 kHz the
    72-sample walk boundary leaves samples 36..71 unreordered under short
    windows — decode_plane._mix_geometry) — validated against libmpg123
    and libavcodec on crafted streams (tests/test_mixed_blocks.py). Only meaningful when the ISO band tables
    are active (MP3STEGO_TPU_REF_SHORT_BANDS=1 implies the reference walk
    for MPEG-1 rows)."""
    return os.environ.get("MP3STEGO_TPU_REF_MIXED", "0") == "1"


def lsf_is_illegal_mode() -> str:
    """LSF intensity-stereo illegal-position convention,
    MP3STEGO_TPU_LSF_IS_ILLEGAL in {"iso", "mpg123", "ffmpeg"}.

    The ecosystem splits three ways on which transmitted is_pos disables
    intensity for an LSF band (measured on crafted streams,
    tests/test_intensity.py::TestLsfIllegalConventions):
      iso     (default) pos == (1<<slen)-1 for the band's slen group
              (ISO 13818-3's rule; what this decoder follows)
      mpg123  pos == 7 regardless of slen (libmpg123's constant check)
      ffmpeg  nothing is illegal (libavcodec's sf_max=16 for LSF)
    All three coincide on every legal position below min(7, (1<<slen)-1);
    MPEG-1 streams are unaffected (everyone uses 7 there)."""
    v = os.environ.get("MP3STEGO_TPU_LSF_IS_ILLEGAL", "iso")
    if v not in ("iso", "mpg123", "ffmpeg"):
        raise ValueError(f"MP3STEGO_TPU_LSF_IS_ILLEGAL={v!r} "
                         "(want iso|mpg123|ffmpeg)")
    return v


def sine_block() -> np.ndarray:
    """(4,36) IMDCT window shapes per block type (decoder/Frame.py:32-62).

    DELIBERATE DEVIATION: the reference's start window (block type 1) fills
    taps 30..35 with 1.0 where ISO 11172-3 (and every production decoder,
    e.g. libmpg123) has 0.0 — every start-block granule it decodes leaks a
    wrong overlap tail into the next granule (measured ~11 dB SNR vs mpg123
    on transient streams; ~81 dB with the fix). The reference's own tests
    never exercise it (its encoder and fixture are long-block-only), so no
    golden depends on the bug. ISO-correct is the default here;
    MP3STEGO_TPU_REF_START_WINDOW=1 restores the reference's window for
    bit-parity against reference decodes of third-party streams."""
    sb = np.zeros((4, 36))
    i = np.arange(36)
    sb[0] = np.sin(math.pi / 36.0 * (i + 0.5))
    sb[1, :18] = np.sin(math.pi / 36.0 * (i[:18] + 0.5))
    sb[1, 18:24] = 1.0
    sb[1, 24:30] = np.sin(math.pi / 12.0 * (i[24:30] - 18.0 + 0.5))
    if ref_start_window():
        sb[1, 30:36] = 1.0
    sb[2, :12] = np.sin(math.pi / 12.0 * (i[:12] + 0.5))
    sb[3, :6] = 0.0
    sb[3, 6:12] = np.sin(math.pi / 12.0 * (i[6:12] - 6.0 + 0.5))
    sb[3, 12:18] = 1.0
    sb[3, 18:36] = np.sin(math.pi / 36.0 * (i[18:36] + 0.5))
    return sb


def imdct_long_cos() -> np.ndarray:
    """(36,18) long-block IMDCT basis C[i,k]=cos(pi/72 (2i+1+18)(2k+1))."""
    i = np.arange(36)[:, None].astype(np.float64)
    k = np.arange(18)[None, :].astype(np.float64)
    return np.cos(math.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))


def imdct_short_cos() -> np.ndarray:
    """(12,6) short-block IMDCT basis C[i,k]=cos(pi/24 (2i+1+6)(2k+1))."""
    i = np.arange(12)[:, None].astype(np.float64)
    k = np.arange(6)[None, :].astype(np.float64)
    return np.cos(math.pi / 24.0 * (2 * i + 1 + 6) * (2 * k + 1))


# Alias-reduction coefficients (ISO Table B.9), float (decoder) form
ALIAS_CS = np.array([.8574929257, .8817419973, .9496286491, .9833145925,
                     .9955178161, .9991605582, .9998991952, .9999931551])
ALIAS_CA = np.array([-.5144957554, -.4717319686, -.3133774542, -.1819131996,
                     -.0945741925, -.0409655829, -.0141985686, -.0036999747])

# Fixed-point (encoder, Q31) alias coefficients from the B.9 c_i constants
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
MDCT_CA_FIX = (_CI / np.sqrt(1.0 + _CI * _CI) * 0x7FFFFFFF).astype(np.int64).astype(np.int32)
MDCT_CS_FIX = (1.0 / np.sqrt(1.0 + _CI * _CI) * 0x7FFFFFFF).astype(np.int64).astype(np.int32)


def subband_filter_fixed() -> np.ndarray:
    """(32,64) fixed-point analysis filterbank matrix (MP3_Encoder.py:528-544)."""
    fl = np.zeros((SB_LIMIT, 64), dtype=np.int32)
    for i in range(SB_LIMIT):
        for j in range(64):
            filt = 1e9 * math.cos((2 * i + 1) * (16 - j) * 0.049087385212)
            if filt >= 0:
                filt = math.modf(filt + 0.5)[1]
            else:
                filt = math.modf(filt - 0.5)[1]
            fl[i, j] = np.int32(filt * 0x7FFFFFFF * 1e-9)
    return fl


def mdct_cos_fixed() -> np.ndarray:
    """(18,36) fixed-point forward-MDCT basis (MP3_Encoder.py:546-556)."""
    cos_l = np.zeros((18, 36), dtype=np.int32)
    for m in range(18):
        for k in range(36):
            cos_l[m, k] = np.int32(
                math.sin(0.087266462599717 * (k + 0.5))
                * math.cos((math.pi / 72) * (2 * k + 19) * (2 * m + 1))
                * 0x7FFFFFFF)
    return cos_l


def loop_tables():
    """steptab / steptabi / int2idx quantizer LUTs (MP3_Encoder.py:558-579)."""
    steptab = np.zeros(128, dtype=np.float64)
    steptabi = np.zeros(128, dtype=np.int32)
    for i in range(128):
        steptab[i] = 2.0 ** ((127 - i) / 4)
        if steptab[i] * 2 > 0x7FFFFFFF:
            steptabi[i] = 0x7FFFFFFF
        else:
            steptabi[i] = np.int32(steptab[i] * 2 + 0.5)
    i = np.arange(10000, dtype=np.float64)
    int2idx = (np.sqrt(np.sqrt(i) * i) - 0.0946 + 0.5).astype(np.int32)
    return steptab, steptabi, int2idx


# Encoder framing constants (encoder/util.py:24-68)
BIT_RATES = np.array([
    (-1, -1, -1, -1), (8, -1, 8, 32), (16, -1, 16, 40), (24, -1, 24, 48),
    (32, -1, 32, 56), (40, -1, 40, 64), (48, -1, 48, 80), (56, -1, 56, 96),
    (64, -1, 64, 112), (-1, -1, 80, 128), (-1, -1, 96, 160), (-1, -1, 112, 192),
    (-1, -1, 128, 224), (-1, -1, 144, 256), (-1, -1, 160, 320), (-1, -1, -1, -1),
], dtype=np.int32)
SAMPLE_RATES = np.array([44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000],
                        dtype=np.int32)
GRANULES_PER_FRAME = [1, -1, 1, 2]  # indexed by mpeg version code (0,1,2,3)
