"""Host-plane MP3 parsing: sync walk, headers, side info, bit reservoir, scalefactor
and Huffman-sample unpacking into dense batched tensors for the device plane.

Behavioural reference (bit-for-bit): the reference's mp3stego/decoder/
  MP3_Parser.py:21-85 (sync walk + frame loop, incl. the stale-PCM-duplication quirk
  on a mid-file bad sync), FrameHeader.py:51-192, FrameSideInformation.py:39-137,
  Frame.py:288-363 (frame size + reservoir assembly, incl. the doubled first-frame
  entry in the previous-size history), Frame.py:365-559 (scalefactor + sample unpack).

Deliberate deviations from reference crashes on malformed input (both this
oracle and the C++ twin stop cleanly instead; differential-fuzzed to agree):
reserved samplerate/bitrate header values, big_value > 288 pairs, and
region counts past the band table.

Everything here is sequential/irregular and stays on host; the output is a
``ParsedMP3`` whose arrays are ready for the batched device numeric plane.
"""

import functools
from dataclasses import dataclass, field

import numpy as np

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.utils.profiling import count, span

HEADER_SIZE = 4
NUM_PREV_FRAMES = 9


# --------------------------------------------------------------------- header


@dataclass
class FrameHeader:
    mpeg_version: float = 0.0
    layer: int = 0
    crc: int = 0
    bit_rate: int = 0
    sampling_rate: int = 0
    padding: bool = False
    channel_mode: int = 0          # 0 stereo, 1 joint, 2 dual, 3 mono
    channels: int = 2
    mode_ext: tuple = (0, 0)
    sr_idx: int = 0                # 0=44.1k, 1=48k, 2=32k (MPEG-1)
    # secondary fields (FrameHeader.py:100-110): no decode effect, parsed for
    # header-object parity with the reference
    emphasis: int = 0              # 0 none, 1 50/15us, 2 reserved, 3 CCITT
    info: tuple = (False, False, False)  # (private, copyright, original)
    free_format: bool = False      # bitrate index 0 ("free"); size from sync
    #                                spacing (walk_frames), not the rate table

    @property
    def frame_samples(self) -> int:
        if self.layer == 3:
            return 1152 if self.mpeg_version == 1 else 576
        if self.layer == 2:
            return 1152
        return 384


_L3_RATES = [32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]
_L2_RATES = [32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384]
_L2LO_RATES = [8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]


# samplerate -> band-table row for all 9 rates (SCALE_FACT_BAND_INDEX order;
# rows 0-2 equal the MPEG-1 decoder tables, tables/__init__.py)
_SR_IDX_ALL = {int(r): i for i, r in enumerate(T.SAMPLE_RATES)}


def parse_header(b0: int, b1: int, b2: int, b3: int) -> FrameHeader:
    h = FrameHeader()
    v_bits = (bool(b1 & 0x10), bool(b1 & 0x08))
    h.mpeg_version = {(True, True): 1, (True, False): 2,
                      (False, True): 0, (False, False): 2.5}[v_bits]
    h.layer = 4 - (((b1 << 5) & 0xFF) >> 6)
    h.crc = b1 & 0x01
    rates = [[44100, 48000, 32000], [22050, 24000, 16000], [11025, 12000, 8000]]
    cv = int(np.ceil(h.mpeg_version))   # 2.5 -> row 3 (FrameHeader.py:116-123)
    sr_b = (bool(b2 & 0x08), bool(b2 & 0x04))
    if sr_b == (False, False):
        h.sampling_rate = rates[cv - 1][0]
    elif sr_b == (False, True):
        h.sampling_rate = rates[cv - 1][1]
    elif sr_b == (True, False):
        h.sampling_rate = rates[cv - 1][2]
    h.channel_mode = (b3 >> 6) & 0xFF
    h.channels = 1 if h.channel_mode == 3 else 2
    if h.layer == 3:
        h.mode_ext = (b3 & 0x20, b3 & 0x10)
    h.padding = bool(b2 & 0x02)
    # clamp the bitrate index like the native parser: nibble 0xF is out of
    # the 14-entry table (the reference crashes); -1 wraps like python's [-1]
    idx = ((b2 >> 4) & 0x0F) - 1
    h.free_format = idx < 0 and h.layer == 3
    idx = 13 if (idx < 0 or idx > 13) else idx
    if h.mpeg_version == 1:
        if h.layer == 1:
            h.bit_rate = b2 * 32
        elif h.layer == 2:
            h.bit_rate = _L2_RATES[idx] * 1000
        elif h.layer == 3:
            h.bit_rate = _L3_RATES[idx] * 1000
    else:
        if h.layer == 1:
            h.bit_rate = _L3_RATES[idx] * 1000
        elif h.layer < 4:
            h.bit_rate = _L2LO_RATES[idx] * 1000
    h.sr_idx = _SR_IDX_ALL.get(h.sampling_rate, 0)
    h.emphasis = b3 & 0x03
    h.info = (bool(b2 & 0x01), bool(b3 & 0x08), bool(b3 & 0x04))
    return h


def frame_size_of(h: FrameHeader, free_base: int = 0) -> int:
    if h.sampling_rate == 0:   # reserved samplerate bits: stop cleanly
        return 0               # (the reference divides by zero here)
    if h.free_format and free_base > 0:
        # free-format frames share one constant slot count discovered from
        # the sync spacing (ISO 11172-3: "free" bitrate index); only the
        # padding slot varies per frame. Active only when the stream's FIRST
        # frame is free-format (walk_frames measured a stride) — an isolated
        # corrupt nibble mid-stream keeps the reference's table-wrap size,
        # matching the C++ twin (differential fuzz contract).
        return free_base + (1 if h.padding else 0)
    size = int(((h.frame_samples / 8) * h.bit_rate) / h.sampling_rate)
    if h.padding:
        size += 1
    return size


def _free_format_base(file_data: bytes, offset: int, h: FrameHeader) -> int:
    """Constant free-format frame size (without the padding slot), measured
    from the spacing of the first sync words: scan for the next header with
    the same version/layer/samplerate bits and confirm a third sync at the
    implied stride. 0 when no consistent spacing is found.

    DELIBERATE DEVIATION: the reference wraps the 'free' bitrate nibble to
    the 320 kbps table row (FrameHeader.py's rates[index-1]) and desyncs
    immediately; free-format streams (e.g. LAME --freeformat) are decoded
    here and validated against libmpg123 (tests/test_interop.py)."""
    n = len(file_data)
    b1, b2 = file_data[offset + 1], file_data[offset + 2]
    for i in range(offset + 4, min(offset + 8192, n - 4)):
        if (file_data[i] == 0xFF and file_data[i + 1] == b1
                and (file_data[i + 2] & 0x0C) == (b2 & 0x0C)
                and ((file_data[i + 2] >> 4) & 0x0F) == 0):
            base = (i - offset) - (1 if h.padding else 0)
            if base <= 0:
                return 0
            # confirm the stride with a third frame (or EOF inside frame 2)
            h2 = parse_header(*file_data[i:i + 4])
            j = i + base + (1 if h2.padding else 0)
            if j + 1 >= n or (file_data[j] == 0xFF
                              and file_data[j + 1] == b1):
                return base
    return 0


def walk_frames(file_data: bytes, offset: int):
    """The frame sync walk shared by the python parser and the streaming
    decoder (MP3_Parser.py:21-52 semantics): returns (frames, end_byte,
    first_header, duplicate_last_pcm) where frames entries are
    (byte_offset, header, size, prev_sizes snapshot). Stops cleanly on
    truncation (< 4 header bytes), malformed sizes, or a bad sync (which
    sets the reference's stale-PCM duplication quirk)."""
    n = len(file_data)
    if (offset + HEADER_SIZE > n or file_data[offset] != 0xFF
            or file_data[offset + 1] < 0xE0):
        return [], offset, None, False
    first_h = parse_header(*file_data[offset:offset + 4])
    free_base = 0
    if first_h.free_format:
        free_base = _free_format_base(file_data, offset, first_h)
        if free_base <= 0:
            return [], offset, first_h, False
        # derived rate, rounded to the nearest standard rate so the facade's
        # hide/clear re-encode gets a valid target
        bps = free_base * 8.0 * first_h.sampling_rate / first_h.frame_samples
        rates = _L3_RATES if first_h.mpeg_version == 1 else _L2LO_RATES
        first_h.bit_rate = min(rates, key=lambda r: abs(r * 1000 - bps)) * 1000
    frames = []
    # pre-loop set_frame_size (MP3_Parser.py:42) seeds the history with fs0
    # twice
    prev_hist = [0.0] * NUM_PREV_FRAMES
    frame_size = frame_size_of(first_h, free_base)
    cur = offset
    dup = False
    while n > cur + HEADER_SIZE:
        if file_data[cur] == 0xFF and file_data[cur + 1] >= 0xE0:
            h = parse_header(*file_data[cur:cur + 4])
            prev_hist = [frame_size] + prev_hist[:-1]
            frame_size = frame_size_of(h, free_base)
            if frame_size <= 0:    # malformed header: stop (matches native)
                break
            if h.free_format:
                h.bit_rate = first_h.bit_rate
            frames.append((cur, h, frame_size, list(prev_hist)))
            cur += frame_size
        else:
            # MP3_Parser.py:79 appends the stale previous frame's PCM again
            # on a bad sync — except for known metadata TRAILERS (ID3v1
            # "TAG", APEv2 "APETAGEX", or an ID3v2 footer), which real-world
            # files routinely carry; those end the stream cleanly like every
            # production decoder (deviation validated vs libmpg123,
            # tests/test_interop.py). Mid-file garbage keeps the quirk.
            tail = file_data[cur:cur + 8]
            dup = len(frames) > 0 and not (
                tail[:3] == b"TAG" or tail[:8] == b"APETAGEX"
                or tail[:3] == b"ID3")
            break
    return frames, cur, first_h, dup


# ------------------------------------------------------------------- side info


@dataclass
class SideInfo:
    main_data_begin: int = 0
    scfsi: np.ndarray = None                 # (2,4)
    part2_3_length: np.ndarray = None        # (2,2) [gr][ch]
    big_value: np.ndarray = None
    global_gain: np.ndarray = None
    scale_fac_compress: np.ndarray = None
    window_switching: np.ndarray = None
    block_type: np.ndarray = None
    mixed_block_flag: np.ndarray = None
    table_select: np.ndarray = None          # (2,2,3)
    sub_block_gain: np.ndarray = None        # (2,2,3)
    region0_count: np.ndarray = None
    region1_count: np.ndarray = None
    pre_flag: np.ndarray = None
    scale_fac_scale: np.ndarray = None
    count1table_select: np.ndarray = None
    scale_fac_l: np.ndarray = None           # (2,2,22)
    scale_fac_s: np.ndarray = None           # (2,2,3,13)

    def __post_init__(self):
        z = lambda *s: np.zeros(s, dtype=np.int32)  # noqa: E731
        self.scfsi = z(2, 4)
        for f in ("part2_3_length", "big_value", "global_gain", "scale_fac_compress",
                  "window_switching", "block_type", "mixed_block_flag",
                  "region0_count", "region1_count", "pre_flag", "scale_fac_scale",
                  "count1table_select"):
            setattr(self, f, z(2, 2))
        self.table_select = z(2, 2, 3)
        self.sub_block_gain = z(2, 2, 3)
        self.scale_fac_l = z(2, 2, 22)
        self.scale_fac_s = z(2, 2, 3, 13)


def parse_side_info(bits: np.ndarray, h: FrameHeader) -> SideInfo:
    """``bits``: unpacked bit array starting at the side-info byte."""
    si = SideInfo()
    pos = 0

    def rd(n):
        nonlocal pos
        v = 0
        for b in bits[pos:pos + n]:
            v = (v << 1) | int(b)
        pos += n
        return v

    si.main_data_begin = rd(9)
    pos += 5 if h.channels == 1 else 3
    for ch in range(h.channels):
        for band in range(4):
            si.scfsi[ch][band] = rd(1)
    for gr in range(2):
        for ch in range(h.channels):
            si.part2_3_length[gr][ch] = rd(12)
            si.big_value[gr][ch] = rd(9)
            si.global_gain[gr][ch] = rd(8)
            si.scale_fac_compress[gr][ch] = rd(4)
            si.window_switching[gr][ch] = rd(1)
            if si.window_switching[gr][ch]:
                si.block_type[gr][ch] = rd(2)
                si.mixed_block_flag[gr][ch] = rd(1)
                si.region0_count[gr][ch] = 8 if si.block_type[gr][ch] == 2 else 7
                si.region1_count[gr][ch] = 20 - si.region0_count[gr][ch]
                for region in range(2):
                    si.table_select[gr][ch][region] = rd(5)
                for window in range(3):
                    si.sub_block_gain[gr][ch][window] = rd(3)
            else:
                si.block_type[gr][ch] = 0
                si.mixed_block_flag[gr][ch] = 0
                for region in range(3):
                    si.table_select[gr][ch][region] = rd(5)
                si.region0_count[gr][ch] = rd(4)
                si.region1_count[gr][ch] = rd(3)
            si.pre_flag[gr][ch] = rd(1)
            si.scale_fac_scale[gr][ch] = rd(1)
            si.count1table_select[gr][ch] = rd(1)
    return si


def parse_side_info_lsf(bits: np.ndarray, h: FrameHeader) -> SideInfo:
    """MPEG-2/2.5 (LSF) side info, ISO 13818-3: 8-bit main_data_begin,
    1/2 private bits, NO scfsi, ONE granule with a 9-bit scalefac_compress
    and no preflag bit (preflag derives from the scalefac_compress class).

    This is BEYOND reference parity: the reference decoder is MPEG-1-only
    (FrameSideInformation.py:39-137) and cannot read the MPEG-2/2.5 streams
    its own encoder emits; here the framework decodes its own output."""
    si = SideInfo()
    pos = 0

    def rd(n):
        nonlocal pos
        v = 0
        for b in bits[pos:pos + n]:
            v = (v << 1) | int(b)
        pos += n
        return v

    si.main_data_begin = rd(8)
    pos += 1 if h.channels == 1 else 2
    gr = 0
    for ch in range(h.channels):
        si.part2_3_length[gr][ch] = rd(12)
        si.big_value[gr][ch] = rd(9)
        si.global_gain[gr][ch] = rd(8)
        si.scale_fac_compress[gr][ch] = rd(9)
        si.window_switching[gr][ch] = rd(1)
        if si.window_switching[gr][ch]:
            si.block_type[gr][ch] = rd(2)
            si.mixed_block_flag[gr][ch] = rd(1)
            si.region0_count[gr][ch] = 8 if si.block_type[gr][ch] == 2 else 7
            si.region1_count[gr][ch] = 20 - si.region0_count[gr][ch]
            for region in range(2):
                si.table_select[gr][ch][region] = rd(5)
            for window in range(3):
                si.sub_block_gain[gr][ch][window] = rd(3)
        else:
            si.block_type[gr][ch] = 0
            si.mixed_block_flag[gr][ch] = 0
            for region in range(3):
                si.table_select[gr][ch][region] = rd(5)
            si.region0_count[gr][ch] = rd(4)
            si.region1_count[gr][ch] = rd(3)
        si.scale_fac_scale[gr][ch] = rd(1)
        si.count1table_select[gr][ch] = rd(1)
    return si


# LSF scalefactor partitions (ISO 13818-3, intensity stereo off), indexed by
# scalefac_compress class; each row = number of scalefactors per slen group.
_LSF_NR_LONG = ((6, 5, 5, 5), (6, 5, 7, 3), (11, 10, 0, 0))
_LSF_NR_SHORT = ((9, 9, 9, 9), (9, 9, 12, 6), (18, 18, 0, 0))
_LSF_NR_MIXED = ((6, 9, 9, 9), (6, 9, 12, 6), (15, 18, 0, 0))
# ... and the intensity-stereo variants (ISO 13818-3 "intensity_stereo"
# scalefactor classes): the RIGHT channel of an IS-flagged LSF granule uses
# scalefac_compress>>1 to pick slen (the LSB is intensity_scale) and these
# band partitions. Validated against BOTH libmpg123 and libavcodec on
# crafted streams (tests/test_intensity.py).
_LSF_NR_LONG_IS = ((7, 7, 7, 0), (6, 6, 6, 3), (8, 8, 5, 0))
_LSF_NR_SHORT_IS = ((12, 12, 12, 0), (12, 9, 9, 6), (15, 12, 9, 0))
_LSF_NR_MIXED_IS = ((6, 15, 12, 0), (6, 12, 9, 6), (6, 18, 9, 0))


def _lsf_slen(sfc: int):
    """scalefac_compress (9 bits) -> (slen[4], class, preflag)."""
    if sfc < 400:
        return ((sfc >> 4) // 5, (sfc >> 4) % 5, (sfc & 15) >> 2, sfc & 3), \
            0, 0
    if sfc < 500:
        s = sfc - 400
        return ((s >> 2) // 5, (s >> 2) % 5, s & 3, 0), 1, 0
    s = sfc - 500
    return (s // 3, s % 3, 0, 0), 2, 1


def _lsf_slen_is(sfc: int):
    """scalefac_compress (9 bits) -> (slen[4], class) for the intensity
    channel: int_sfc = sfc >> 1 picks one of three layouts (ISO 13818-3;
    intensity_scale = sfc & 1 is consumed by the coefficient tables)."""
    s = sfc >> 1
    if s < 180:
        return (s // 36, (s % 36) // 6, s % 6, 0), 0
    if s < 244:
        s -= 180
        return ((s >> 4) & 3, (s >> 2) & 3, s & 3, 0), 1
    s -= 244
    return (s // 3, s % 3, 0, 0), 2


def unpack_scale_factors_lsf(md: "_MainDataBits", si: SideInfo, ch: int,
                             bit: int, i_stereo: bool = False):
    """LSF scalefactor unpack for one channel (gr 0). Sets scale_fac_l /
    scale_fac_s and the derived pre_flag; returns (bit, illegal) where
    illegal is None, or — for the intensity channel (``i_stereo=True``,
    the right channel of an IS-flagged granule) — a (3,22) int8 array of
    per-band illegal-position sentinels ((1<<slen)-1 for the band's slen
    group; a transmitted position equal to it turns intensity off for the
    band)."""
    gr = 0
    sfc = int(si.scale_fac_compress[gr][ch])
    if i_stereo:
        slen, cls = _lsf_slen_is(sfc)
        pre = 0
    else:
        slen, cls, pre = _lsf_slen(sfc)
    si.pre_flag[gr][ch] = pre
    short = si.window_switching[gr][ch] and si.block_type[gr][ch] == 2
    mixed = short and si.mixed_block_flag[gr][ch]
    illegal = None
    if i_stereo:
        illegal = np.full((3, 22), -1, np.int8)
        ill_of = [(1 << s) - 1 for s in slen]
        if short:
            nr = _LSF_NR_MIXED_IS[cls] if mixed else _LSF_NR_SHORT_IS[cls]
            # group of each (sfb, window) fill slot; long prefix if mixed
            k = 0
            bounds = np.cumsum(nr)
            n_long = 6 if mixed else 0
            for sfb in range(n_long):
                illegal[:, sfb] = ill_of[int(np.searchsorted(
                    bounds, k, side="right"))]
                k += 1
            for sfb in range(3 if mixed else 0, 12):
                for win in range(3):
                    illegal[win, sfb] = ill_of[int(np.searchsorted(
                        bounds, k, side="right"))]
                    k += 1
            illegal[:, 12] = illegal[:, 11]   # inherits band 11's position
        else:
            nr = _LSF_NR_LONG_IS[cls]
            bounds = np.cumsum(nr)
            for sfb in range(21):
                illegal[:, sfb] = ill_of[int(np.searchsorted(
                    bounds, sfb, side="right"))]
            illegal[:, 21] = illegal[:, 20]   # inherits band 20's position
    if short:
        if i_stereo:
            nr = _LSF_NR_MIXED_IS[cls] if mixed else _LSF_NR_SHORT_IS[cls]
        else:
            nr = _LSF_NR_MIXED[cls] if mixed else _LSF_NR_SHORT[cls]
        # fill order: [long sfbs if mixed] then short (sfb, window)-major
        vals = []
        for g_i in range(4):
            for _ in range(nr[g_i]):
                vals.append(md.get(bit, slen[g_i]))
                bit += slen[g_i]
        k = 0
        if mixed:
            for sfb in range(6):
                si.scale_fac_l[gr][ch][sfb] = vals[k]
                k += 1
            first_s = 3
        else:
            first_s = 0
        sfb = first_s
        while k < len(vals):
            for window in range(3):
                si.scale_fac_s[gr][ch][window][sfb] = vals[k]
                k += 1
            sfb += 1
    else:
        nr = _LSF_NR_LONG_IS[cls] if i_stereo else _LSF_NR_LONG[cls]
        sfb = 0
        for g_i in range(4):
            for _ in range(nr[g_i]):
                si.scale_fac_l[gr][ch][sfb] = md.get(bit, slen[g_i])
                bit += slen[g_i]
                sfb += 1
    return bit, illegal


# ------------------------------------------------------- main data / reservoir


def assemble_main_data(file_data: bytes, curr_offset: int, frame_size: int,
                       prev_sizes: list, si: SideInfo, h: FrameHeader) -> bytes:
    """Splice the frame's main data across the bit reservoir (Frame.py:318-356).
    LSF side info is 9/17 bytes (vs MPEG-1's 17/32), so the skip constant is
    13/21 including the 4 header bytes."""
    if h.mpeg_version == 1:
        constant = 21 if h.channels == 1 else 36
    else:
        constant = 13 if h.channels == 1 else 21
    if h.crc == 0:
        constant += 2
    buf = file_data[curr_offset:curr_offset + frame_size]
    if si.main_data_begin == 0:
        return bytes(buf[constant:frame_size])
    bound = 0
    for frame in range(NUM_PREV_FRAMES):
        bound += prev_sizes[frame] - constant
        if si.main_data_begin < bound:
            ptr_offset = si.main_data_begin + frame * constant
            part = [0] * NUM_PREV_FRAMES
            part[frame] = si.main_data_begin
            for i in range(frame):
                part[i] = prev_sizes[i] - constant
                part[frame] -= part[i]
            loc = int(curr_offset - ptr_offset)
            out = bytearray(file_data[loc:loc + int(part[frame])])
            ptr_offset -= part[frame] + constant
            for i in range(frame - 1, -1, -1):
                loc = int(curr_offset - ptr_offset)
                out.extend(file_data[loc:loc + int(part[i])])
                ptr_offset -= part[i] + constant
            out.extend(buf[constant:frame_size])
            return bytes(out)
    return b""


# ------------------------------------------------- scalefactors + huffman unpack


class _MainDataBits:
    """Fast MSB-first reads over a granule's main data (zero-padded)."""

    __slots__ = ("bits", "n")

    def __init__(self, data: bytes):
        arr = np.frombuffer(data, dtype=np.uint8)
        self.bits = np.unpackbits(np.concatenate([arr, np.zeros(8, np.uint8)]))
        self.n = len(self.bits)

    def get(self, pos: int, n: int) -> int:
        if n == 0:
            return 0
        end = pos + n
        if end > self.n:
            sl = np.zeros(n, dtype=np.uint8)
            avail = self.bits[pos:self.n]
            sl[:len(avail)] = avail
        else:
            sl = self.bits[pos:end]
        v = 0
        for b in sl:
            v = (v << 1) | int(b)
        return v


def unpack_scale_factors(md: _MainDataBits, si: SideInfo, gr: int, ch: int,
                         bit: int) -> int:
    """Frame.py:365-441, including gr==1 scfsi reuse."""
    sfc = int(si.scale_fac_compress[gr][ch])
    sl0, sl1 = int(T.SLEN[sfc][0]), int(T.SLEN[sfc][1])

    if si.block_type[gr][ch] == 2 and si.window_switching[gr][ch]:
        if si.mixed_block_flag[gr][ch] == 1:
            for sfb in range(8):
                si.scale_fac_l[gr][ch][sfb] = md.get(bit, sl0)
                bit += sl0
            for sfb in range(3, 6):
                for window in range(3):
                    si.scale_fac_s[gr][ch][window][sfb] = md.get(bit, sl0)
                    bit += sl0
        else:
            for sfb in range(6):
                for window in range(3):
                    si.scale_fac_s[gr][ch][window][sfb] = md.get(bit, sl0)
                    bit += sl0
        for sfb in range(6, 12):
            for window in range(3):
                si.scale_fac_s[gr][ch][window][sfb] = md.get(bit, sl1)
                bit += sl1
        for window in range(3):
            si.scale_fac_s[gr][ch][window][12] = 0
    else:
        if gr == 0:
            for sfb in range(11):
                si.scale_fac_l[gr][ch][sfb] = md.get(bit, sl0)
                bit += sl0
            for sfb in range(11, 21):
                si.scale_fac_l[gr][ch][sfb] = md.get(bit, sl1)
                bit += sl1
        else:
            SB = [6, 11, 16, 21]
            PREV_SB = [0, 6, 11, 16]
            for i in range(2):
                for sfb in range(PREV_SB[i], SB[i]):
                    if si.scfsi[ch][i]:
                        si.scale_fac_l[gr][ch][sfb] = si.scale_fac_l[0][ch][sfb]
                    else:
                        si.scale_fac_l[gr][ch][sfb] = md.get(bit, sl0)
                        bit += sl0
            for i in range(2, 4):
                for sfb in range(PREV_SB[i], SB[i]):
                    if si.scfsi[ch][i]:
                        si.scale_fac_l[gr][ch][sfb] = si.scale_fac_l[0][ch][sfb]
                    else:
                        si.scale_fac_l[gr][ch][sfb] = md.get(bit, sl1)
                        bit += sl1
        si.scale_fac_l[gr][ch][21] = 0
    return bit


def unpack_samples(md: _MainDataBits, si: SideInfo, h: FrameHeader, gr: int, ch: int,
                   bit: int, max_bit: int, out: np.ndarray):
    """Huffman-sample unpack (Frame.py:443-559) with O(1) LUT symbol decode."""
    out[:] = 0.0
    # MPEG-1 rows: reference table (== BAND_INDEX_LONG). LSF rows: the ISO/
    # ecosystem table — third-party LSF streams (and this framework's
    # compliant LSF writer) place the region boundaries by it, and at 16/24
    # kHz the reference's copy deviates (see tables.BAND_INDEX_ISO).
    long_win = (T.BAND_INDEX_ISO[h.sr_idx] if h.sr_idx >= 3
                else T.SCALE_FACT_BAND_INDEX[h.sr_idx])

    if si.window_switching[gr][ch] and si.block_type[gr][ch] == 2:
        # Short-block big-values regions split after the first 3 short
        # bands (3 windows each): 36 samples at every rate except 8 kHz,
        # whose wide 8-sample bands put it at 72 — the LAME/mpg123
        # ecosystem convention, pinned by the interop SNR tests (8 kHz
        # decodes at ~5 dB with 36, ~81 dB with 72). Identical to the
        # reference's constant 36 for all MPEG-1 rates.
        region0 = int(3 * T.BAND_WIDTH_SHORT_ISO[h.sr_idx][:3].sum())
        region1 = 576
    else:
        # clamped: corrupt side info can push the band index past 22 and
        # big_value*2 past 576 (the reference crashes on both; we stop cleanly)
        r0c = int(si.region0_count[gr][ch])
        r1c = int(si.region1_count[gr][ch])
        region0 = int(long_win[min(r0c + 1, 22)])
        region1 = int(long_win[min(r0c + 1 + r1c + 1, 22)])

    ts = si.table_select[gr][ch]
    big = min(int(si.big_value[gr][ch]) * 2, 576)
    sample = 0
    while sample < big:
        if sample < region0:
            table_num = int(ts[0])
        elif sample < region1:
            table_num = int(ts[1])
        else:
            table_num = int(ts[2])

        if table_num == 0:
            sample += 2
            continue

        book = int(T.DEC_CODEBOOK_OF[table_num])
        linbits = int(T.DEC_LINBITS[table_num])
        maxval = int(T.DEC_MAXVAL[table_num])
        packed = int(T.dec_lut(book)[md.get(bit, T.LUT_BITS)])
        size = packed & 31
        if size == 0:
            # no codeword matched (corrupt stream): reference scans all rows,
            # finds nothing, and advances the sample pair without consuming bits
            sample += 2
            continue
        bit += size
        values = (packed >> 9, (packed >> 5) & 15)
        for i in range(2):
            linbit = 0
            if linbits != 0 and values[i] == maxval - 1:
                linbit = md.get(bit, linbits)
                bit += linbits
            sign = 1
            if values[i] > 0:
                sign = -1 if md.get(bit, 1) > 0 else 1
                bit += 1
            out[sample + i] = float(sign * (values[i] + linbit))
        sample += 2

    # count1 / quadruples region
    while bit < max_bit and sample + 4 < 576:
        values = [0, 0, 0, 0]
        if si.count1table_select[gr][ch] == 1:
            bs = md.get(bit, 4)
            bit += 4
            values[0] = 0 if (bs & 0x08) > 0 else 1
            values[1] = 0 if (bs & 0x04) > 0 else 1
            values[2] = 0 if (bs & 0x02) > 0 else 1
            values[3] = 0 if (bs & 0x01) > 0 else 1
        else:
            packed = int(T.QUAD_LUT[md.get(bit, 6)])
            size = packed & 31
            p = packed >> 5
            bit += size
            values = [(p >> 3) & 1, (p >> 2) & 1, (p >> 1) & 1, p & 1]
        for i in range(4):
            if values[i] > 0:
                if md.get(bit, 1) == 1:
                    values[i] = -values[i]
                bit += 1
        for i in range(4):
            out[sample + i] = values[i]
        sample += 4


# --------------------------------------------------------------- whole-file parse


@dataclass
class ParsedMP3:
    """Dense batched host-plane output ready for the device numeric plane."""
    num_frames: int = 0
    header: FrameHeader = None                    # first frame's header
    frame_sizes: np.ndarray = None                # (F,)
    raw_samples: np.ndarray = None                # (F,2,2,576) int32; may
    #   be deferred (``defer_samples``): filled at its first read
    # per-(frame,gr,ch) parameters for the numeric plane:
    block_type: np.ndarray = None                 # (F,2,2) int32
    mixed_block_flag: np.ndarray = None
    window_switching: np.ndarray = None
    global_gain: np.ndarray = None
    scale_fac_scale: np.ndarray = None
    pre_flag: np.ndarray = None
    sub_block_gain: np.ndarray = None             # (F,2,2,3)
    scale_fac_l: np.ndarray = None                # (F,2,2,22)
    scale_fac_s: np.ndarray = None                # (F,2,2,3,13)
    table_select: np.ndarray = None               # (F,2,2,3)
    ms_stereo: np.ndarray = None                  # (2F,) bool, per granule
    is_stereo: np.ndarray = None                  # (2F,) bool, per granule
    #   (joint stereo with the intensity mode_ext bit; reference ignores it)
    duplicate_last_pcm: bool = False
    # MPEG-2/2.5 (LSF): real single-granule frames are packed two-per-
    # virtual-frame into the (F,2,2,...) layout; lsf_granules = the real
    # frame count (0 = MPEG-1 stream). PCM consumers trim to
    # lsf_granules*576 samples and the duplication quirk appends 576.
    lsf_granules: int = 0
    # LSF intensity stereo (ISO 13818-3): per-REAL-FRAME illegal-position
    # sentinels (2F,3,22) int8 and intensity_scale = scalefac_compress & 1
    # (2F,) int8 (-1 where the granule is not IS-flagged); None on MPEG-1
    # streams (whose illegal position is the constant 7).
    lsf_is_illegal: np.ndarray = None
    lsf_is_scale: np.ndarray = None
    side_infos: list = field(default_factory=list)
    # Xing/Info/VBRI tag frame (bitstream/vbr.py): the tag's stream stats,
    # and whether PCM consumers should drop frame 0's silence (default when
    # a tag is present; MP3STEGO_TPU_KEEP_TAG_FRAME=1 keeps reference
    # behavior). The tag frame stays in the parse: it seeds the bit
    # reservoir and the synthesis carries exactly like any first frame.
    vbr_tag: object = None
    skip_first_pcm: bool = False
    # the native light parse's input to the card's sample scan
    # (``ops/huffman_device``'s layout): (words (W,) int32, fields (4F, 8)
    # int32), or None
    lanes: tuple = None

    def defer_samples(self, fill) -> None:
        """Leave ``raw_samples`` to ``fill()``, which returns the plane: it
        runs at the first read, under the span ``parse.fill`` (count
        ``frames``)."""
        vars(self)["_raw"], vars(self)["_fill"] = None, fill

    @property
    def samples_pending(self) -> bool:
        """Whether ``raw_samples`` is deferred and not yet filled."""
        return vars(self).get("_fill") is not None


def _raw_samples(p: ParsedMP3):
    fill = vars(p).get("_fill")
    if fill is not None:
        with span("parse.fill", frames=p.num_frames):
            raw = fill()
        vars(p)["_raw"], vars(p)["_fill"] = raw, None
    return vars(p).get("_raw")


def _set_raw_samples(p: ParsedMP3, raw) -> None:
    vars(p)["_raw"], vars(p)["_fill"] = raw, None


ParsedMP3.raw_samples = property(_raw_samples, _set_raw_samples,
                                 doc="(F,2,2,576) int32 Huffman samples; a "
                                     "deferred plane is filled here")


@functools.lru_cache(maxsize=1)
def _native_luts():
    """Two-level packed Huffman decode LUTs for the native parser.

    The flat 2^19 tables (2 MB/book) made every symbol lookup an L2 miss —
    98% of parse time. Level 1 is 2^12 entries/book (16 KB, cache-hot): a
    non-negative entry is the terminal packed symbol (code <= 12 bits, the
    overwhelmingly common case); ``-(blk+1)`` escapes to the 2^7-entry
    level-2 block ``blk`` indexed by the next 7 bits (12+7 = LUT_BITS)."""
    assert T.LUT_BITS == 19
    books = sorted({int(b) for b in T.DEC_CODEBOOK_OF if b != 0})
    row_of = {b: i for i, b in enumerate(books)}
    l1 = np.zeros((len(books), 1 << 12), dtype=np.int32)
    l2_blocks = []
    for b in books:
        blocks = T.dec_lut(b).reshape(1 << 12, 1 << 7)
        same = (blocks == blocks[:, :1]).all(axis=1)
        row = blocks[:, 0].copy()
        for p_ in np.flatnonzero(~same):
            row[p_] = -(len(l2_blocks) + 1)
            l2_blocks.append(blocks[p_])
        l1[row_of[b]] = row
    l2 = (np.concatenate(l2_blocks) if l2_blocks
          else np.zeros(1 << 7, np.int32))
    # tables with codebook 0 (ids 0/4/14) are unused: sentinel -1 makes the
    # native decoder skip the pair, like the reference's empty-table scan
    book_row = np.array([row_of.get(int(b), -1) for b in T.DEC_CODEBOOK_OF],
                        dtype=np.int32)
    return (np.ascontiguousarray(l1.reshape(-1)),
            np.ascontiguousarray(l2.astype(np.int32)), book_row,
            np.ascontiguousarray(T.DEC_LINBITS.astype(np.int32)),
            np.ascontiguousarray(T.DEC_MAXVAL.astype(np.int32)),
            np.ascontiguousarray(T.QUAD_LUT.astype(np.int32)),
            np.ascontiguousarray(T.BAND_INDEX_LONG.astype(np.int32).reshape(-1)))


# the (F, 2, 2, ...) int32 side planes the native walks write, in their
# C argument order, with each plane's trailing shape
_SIDE_PLANES = (("block_type", ()), ("mixed_block_flag", ()),
                ("window_switching", ()), ("global_gain", ()),
                ("scale_fac_scale", ()), ("pre_flag", ()),
                ("sub_block_gain", (3,)), ("scale_fac_l", (22,)),
                ("scale_fac_s", (3, 13)), ("table_select", (3,)))


def _side_planes(F: int) -> dict:
    return {name: np.zeros((F, 2, 2) + tail, dtype=np.int32)
            for name, tail in _SIDE_PLANES}


def _mp3_parse(lib, data: np.ndarray, offset: int, F: int, planes: dict,
               raw: np.ndarray, header_out: np.ndarray,
               frame_sizes: np.ndarray, ms: np.ndarray) -> int:
    """One ``mp3_parse`` call (the full fill) into the given arrays."""
    l1, l2, book_row, linbits, maxval, quad_lut, bil = _native_luts()
    return int(lib.mp3_parse(
        data, len(data), offset,
        l1, l2, book_row, linbits, maxval, quad_lut, bil,
        F, header_out, frame_sizes, raw.reshape(-1),
        *(planes[name].reshape(-1) for name, _ in _SIDE_PLANES), ms))


def _native_walk(file_data: bytes, offset: int, light: bool):
    """The native parse of ``parse_mp3_native`` (``light`` False) or
    ``parse_mp3_light_native`` (True); None when the library is
    unavailable or the walk is inconsistent."""
    from mp3stego_tpu_torch import native
    lib = native.get_lib()
    if lib is None:
        return None

    data = np.frombuffer(bytes(file_data), dtype=np.uint8)
    n = len(data)
    dup = np.zeros(1, dtype=np.int32)
    with span("parse.walk"):
        fcount = int(lib.mp3_count_frames(data, n, offset, dup))
    p = ParsedMP3()
    if fcount == 0:
        p.num_frames = 0
        if (offset + HEADER_SIZE <= n and data[offset] == 0xFF
                and data[offset + 1] >= 0xE0):
            p.header = parse_header(*file_data[offset:offset + 4])
        return p

    F = fcount
    with span("parse.planes"):
        header_out = np.zeros(8, dtype=np.int32)
        p.frame_sizes = np.zeros(F, dtype=np.int64)
        planes = _side_planes(F)
        ms = np.zeros(F, dtype=np.uint8)
        if light:
            # a frame's main data is at most its bytes and a 511-byte
            # reservoir; a stream that needs more is parsed again
            cap = n // 4 + 129 * F + LIGHT_PAD_WORDS
            words = np.empty(cap, dtype=np.int32)
            fields = np.empty((4 * F, 8), dtype=np.int32)
        else:
            p.raw_samples = np.zeros((F, 2, 2, 576), dtype=np.int32)

    with span("parse.native"):
        if light:
            used = np.zeros(1, dtype=np.int64)
            args = (data, n, offset, _native_luts()[6], F, header_out,
                    p.frame_sizes,
                    *(planes[name].reshape(-1) for name, _ in _SIDE_PLANES),
                    ms)
            got = int(lib.mp3_parse_light(*args, words, cap, LIGHT_PAD_WORDS,
                                          fields, used))
            if int(used[0]) > cap:
                cap = int(used[0])
                words = np.empty(cap, dtype=np.int32)
                got = int(lib.mp3_parse_light(*args, words, cap,
                                              LIGHT_PAD_WORDS, fields, used))
        else:
            got = _mp3_parse(lib, data, offset, F, planes, p.raw_samples,
                             header_out, p.frame_sizes, ms)
    if got != F:
        return None  # inconsistent walk; caller falls back to python
    for name, a in planes.items():
        setattr(p, name, a)
    p.num_frames = F
    p.header = parse_header(*file_data[offset:offset + 4])
    p.ms_stereo = np.repeat((ms & 1).astype(bool), 2)
    p.is_stereo = np.repeat((ms & 2).astype(bool), 2)
    # the fill loop exits on the frame-count cap before re-checking sync, so
    # the stale-PCM quirk flag comes from the counting pass
    p.duplicate_last_pcm = bool(dup[0])
    if light:
        p.lanes = (words[:int(used[0])], fields)
        p.defer_samples(functools.partial(fill_samples, file_data, offset,
                                          F))
    return p


def parse_mp3_native(file_data: bytes, offset: int = 0):
    """Native-parser path: same ParsedMP3 (without the per-frame ``side_infos``
    list, which only golden tests consume). Returns None when the native
    library is unavailable."""
    return _native_walk(file_data, offset, light=False)


# zero words after the last frame's in the light parse's ``lanes``
# (``ops/huffman_device.PAD_WORDS``)
LIGHT_PAD_WORDS = 4


def parse_mp3_light_native(file_data: bytes, offset: int = 0):
    """The native light parse (``native/src/mp3_light.cpp``): every plane
    ``parse_mp3_native`` writes, and each equal to its, except the samples.
    In their place ``lanes``, the card's scan input, equal to
    ``ops/huffman_device.pack`` of ``parse_mp3_light``'s descriptors; and
    ``raw_samples`` is deferred to ``fill_samples`` (the full fill) at
    its first read. None for a stream the native walk does not read (an
    LSF or free-format head: ``native_reads``), when the library is
    unavailable or when the walk is inconsistent."""
    if not native_reads(file_data, offset):
        return None
    return _native_walk(file_data, offset, light=True)


def fill_samples(file_data: bytes, offset: int, frames: int) -> np.ndarray:
    """The sample plane (F, 2, 2, 576) int32 of the full parse of the
    stream, without spans of its own: the native fill (``mp3_parse``) where
    it reads the stream, else the Python parse. Raises ValueError when its
    frame count is not ``frames``, the light parse's."""
    from mp3stego_tpu_torch import native
    lib = native.get_lib()
    raw = None
    if lib is not None and native_reads(file_data, offset):
        data = np.frombuffer(bytes(file_data), dtype=np.uint8)
        raw = np.zeros((frames, 2, 2, 576), dtype=np.int32)
        got = _mp3_parse(lib, data, offset, frames, _side_planes(frames),
                         raw, np.zeros(8, np.int32),
                         np.zeros(frames, np.int64),
                         np.zeros(frames, np.uint8))
        if got != frames:
            raw = None
    if raw is None:
        raw = _parse_mp3_python(file_data, offset).raw_samples
    if len(raw) != frames:
        raise ValueError(f"the full parse read {len(raw)} frames where the "
                         f"light parse read {frames}")
    return raw


def native_reads(file_data: bytes, offset: int) -> bool:
    """Whether the native walk reads the stream from ``offset``: False for
    an MPEG-2/2.5 (LSF) or free-format head, which the Python parser
    reads."""
    if (offset + HEADER_SIZE > len(file_data) or file_data[offset] != 0xFF
            or file_data[offset + 1] < 0xE0):
        return True
    h = parse_header(*file_data[offset:offset + HEADER_SIZE])
    return h.mpeg_version == 1 and not h.free_format


def parse_mp3(file_data: bytes, offset: int = 0,
              backend: str = "auto", progress_cb=None,
              defer_samples: bool = True) -> ParsedMP3:
    """Full host pass: walk frames, parse side info, unpack scalefactors + samples.

    ``backend``: "auto" uses the native C++ parser when available (≈100x the
    python path on the reference's hottest loop), "python" forces the NumPy
    fallback/oracle, "native" requires the native library.
    ``progress_cb(n_bytes)``: byte-progress hook (the reference's tqdm bar over
    bytes decoded, MP3_Parser.py:67); the native parser reports once at the end.

    Under "auto", on a stream the native walk reads (MPEG-1, not
    free-format), the parse is the native light parse
    (``parse_mp3_light_native``): the samples are left to the card's scan,
    which ``ops/decode_plane.decode_pcm_i16`` and ``decode_pcm`` run from
    its ``lanes`` (``decode_plane.scan_lanes`` decides), and ``raw_samples``
    is filled by the full native fill only when something reads it.
    ``defer_samples=False`` fills the samples here, as the other backends
    do; so does a stream the light parse does not read, and a process
    without the native library (the Python full parse).

    Recorded as the span ``parse_mp3`` (counts ``bytes``, ``frames`` and
    those of ``stream_counts``), with the native path's children
    ``parse.walk`` (the frame count), ``parse.planes`` (the output planes),
    ``parse.native`` (the fill, or the light parse) and ``parse.tag`` (the
    VBR tag); a deferred fill is the span ``parse.fill`` where it runs.
    """
    with span("parse_mp3", bytes=len(file_data)) as s:
        p = _parse_mp3_engine(file_data, offset, backend, progress_cb,
                              defer_samples)
        count("frames", p.num_frames)
        with span("parse.tag"):
            p = _attach_vbr_tag(p, file_data, offset)
        if s is not None:
            for name, n in stream_counts(p, file_data, offset).items():
                count(name, n)
        return p


def stream_counts(p: "ParsedMP3", file_data: bytes, offset: int = 0) -> dict:
    """What a parse met, from its planes: ``short_granules`` (the (channel,
    granule)s of block type 2), ``ms_frames`` (frames with the mid/side
    bit), ``reservoir_frames`` (frames whose ``main_data_begin``, read at
    each frame's side information, is above 0) and ``tag_frames`` (a
    Xing/Info/VBRI frame at the head)."""
    F = p.num_frames
    if not F:
        return dict(short_granules=0, ms_frames=0, reservoir_frames=0,
                    tag_frames=0)
    data = np.frombuffer(bytes(file_data), dtype=np.uint8)
    sizes = np.asarray(p.frame_sizes, dtype=np.int64)
    at = offset + np.concatenate([[0], np.cumsum(sizes)[:-1]]) + HEADER_SIZE \
        + (2 if p.header.crc == 0 else 0)
    at = at[at + 1 < len(data)]
    if p.header.mpeg_version == 1:     # 9 bits; 8 in an LSF frame
        mdb = (data[at].astype(np.int32) << 1) | (data[at + 1] >> 7)
    else:
        mdb = data[at]
    return dict(
        short_granules=int(np.count_nonzero(p.block_type == 2)),
        ms_frames=int(np.count_nonzero(
            np.asarray(p.ms_stereo).reshape(F, -1)[:, 0])),
        reservoir_frames=int(np.count_nonzero(mdb)),
        tag_frames=int(p.vbr_tag is not None))


def _attach_vbr_tag(p: "ParsedMP3", file_data: bytes, offset: int):
    """Detect a Xing/Info/VBRI tag frame at the stream head and mark the
    parse (bitstream/vbr.py). The tag frame stays in the parse planes; PCM
    consumers (_finish_inter) drop its silence unless the keep flag is set."""
    if p.num_frames > 0:
        from mp3stego_tpu_torch.bitstream import vbr
        tag = vbr.parse_vbr_tag(file_data, offset)
        if tag is not None:
            p.vbr_tag = tag
            p.skip_first_pcm = not vbr.keep_tag_frame()
    return p


def _parse_mp3_engine(file_data: bytes, offset: int, backend, progress_cb,
                      light: bool) -> "ParsedMP3":
    if backend in ("auto", "native"):
        # LSF streams ride the python parser: the C++ twin is MPEG-1-layout
        if not native_reads(file_data, offset):
            return _parse_mp3_python(file_data, offset,
                                     progress_cb=progress_cb)
        p = None
        if backend == "auto" and light:
            p = parse_mp3_light_native(file_data, offset)
        if p is None:
            p = parse_mp3_native(file_data, offset)
        if p is not None:
            if progress_cb is not None:
                progress_cb(int(p.frame_sizes.sum()) if p.num_frames else 0)
            return p
        if backend == "native":
            from mp3stego_tpu_torch import native
            if native.get_lib() is None:
                raise RuntimeError(
                    "native parser unavailable (g++ build failed?)")
            raise RuntimeError(
                "native parser returned an inconsistent frame walk (fill "
                "pass disagreed with the counting pass) — file truncated "
                "mid-frame or parser bug; use backend='python' to decode")
    return _parse_mp3_python(file_data, offset, progress_cb)


def _parse_mp3_python(file_data: bytes, offset: int = 0,
                      progress_cb=None) -> ParsedMP3:
    """Pure-python host pass (fallback + golden-test oracle)."""
    p = ParsedMP3()
    frames, _, first_h, dup = walk_frames(file_data, offset)
    p.header = first_h
    p.duplicate_last_pcm = dup
    if first_h is None:
        p.num_frames = 0
        return p

    F = len(frames)
    if F and first_h.mpeg_version != 1:
        return _parse_frames_lsf(p, file_data, frames, progress_cb)
    p.num_frames = F
    if F == 0:
        return p
    z = lambda *s: np.zeros(s, dtype=np.int32)  # noqa: E731
    p.frame_sizes = np.array([f[2] for f in frames], dtype=np.int64)
    p.raw_samples = np.zeros((F, 2, 2, 576), dtype=np.int32)
    for name in ("block_type", "mixed_block_flag", "window_switching", "global_gain",
                 "scale_fac_scale", "pre_flag"):
        setattr(p, name, z(F, 2, 2))
    p.sub_block_gain = z(F, 2, 2, 3)
    p.scale_fac_l = z(F, 2, 2, 22)
    p.scale_fac_s = z(F, 2, 2, 3, 13)
    p.table_select = z(F, 2, 2, 3)
    p.ms_stereo = np.zeros(2 * F, dtype=bool)
    p.is_stereo = np.zeros(2 * F, dtype=bool)

    for fi, (foff, h, fsize, prev_sizes) in enumerate(frames):
        start_si = 6 if h.crc == 0 else 4
        si_bytes = file_data[foff + start_si:foff + fsize]
        si_bits = np.unpackbits(np.frombuffer(si_bytes, dtype=np.uint8))
        si = parse_side_info(si_bits, h)
        md = _MainDataBits(
            assemble_main_data(file_data, foff, fsize, prev_sizes, si, h))
        bit = 0
        for gr in range(2):
            for ch in range(h.channels):
                max_bit = int(bit + si.part2_3_length[gr][ch])
                bit = unpack_scale_factors(md, si, gr, ch, bit)
                unpack_samples(md, si, h, gr, ch, bit, max_bit,
                               p.raw_samples[fi, gr, ch])
                bit = max_bit
        if progress_cb is not None:
            progress_cb(fsize)
        p.side_infos.append(si)
        p.block_type[fi] = si.block_type
        p.mixed_block_flag[fi] = si.mixed_block_flag
        p.window_switching[fi] = si.window_switching
        p.global_gain[fi] = si.global_gain
        p.scale_fac_scale[fi] = si.scale_fac_scale
        p.pre_flag[fi] = si.pre_flag
        p.sub_block_gain[fi] = si.sub_block_gain
        p.scale_fac_l[fi] = si.scale_fac_l
        p.scale_fac_s[fi] = si.scale_fac_s
        p.table_select[fi] = si.table_select
        p.ms_stereo[2 * fi:2 * fi + 2] = (
            h.channel_mode == 1) and bool(h.mode_ext[0])
        p.is_stereo[2 * fi:2 * fi + 2] = (
            h.channel_mode == 1) and bool(h.mode_ext[1])

    return p


def _parse_frames_lsf(p: ParsedMP3, file_data: bytes, frames: list,
                      progress_cb=None) -> ParsedMP3:
    """MPEG-2/2.5 frame loop: one granule per frame, LSF side info and
    scalefactors, with pairs of real frames packed into the (F',2,2,...)
    virtual-frame layout (gr = frame parity) so every downstream engine —
    the C++ f64 plane, the NumPy oracle, the batched device plane, the
    streaming decoder — consumes LSF streams unchanged. Time order is
    preserved (granule flatten order is frame-major, gr-within-frame).
    Long, short, start, stop AND mixed blocks all decode (ISO band
    tables, validated against libmpg123 on LAME streams —
    tests/test_interop.py — and against libmpg123/libavcodec on crafted
    mixed-block streams, tests/test_mixed_blocks.py)."""
    F = len(frames)
    stream_len = len(file_data) - frames[0][0]
    if p.duplicate_last_pcm and F <= 2 and stream_len > 4 * frames[0][2]:
        # the signature of the reference-parity LSF writer: frames after the
        # first land at half-byte offsets (its side info omits the 2
        # scale_fac_scale/count1table_select bits per granule), so the sync
        # walk dies after 1-2 frames in a many-frame file. Such streams are
        # ambiguous (the count1 table choice is not in the stream) — fail
        # loudly instead of returning a near-empty decode.
        raise ValueError(
            "unreadable LSF stream: frames are half-byte-misaligned (the "
            "reference encoder's MPEG-2/2.5 side-info layout omits the "
            "scale_fac_scale/count1table_select bits). Re-encode with "
            "lsf_compliant=True / MP3STEGO_TPU_LSF_COMPLIANT=1 to produce "
            "spec-valid LSF streams this decoder reads.")
    fv = (F + 1) // 2
    p.num_frames = fv
    p.lsf_granules = F
    z = lambda *s: np.zeros(s, dtype=np.int32)  # noqa: E731
    p.frame_sizes = np.array([f[2] for f in frames], dtype=np.int64)
    p.raw_samples = np.zeros((fv, 2, 2, 576), dtype=np.int32)
    for name in ("block_type", "mixed_block_flag", "window_switching",
                 "global_gain", "scale_fac_scale", "pre_flag"):
        setattr(p, name, z(fv, 2, 2))
    p.sub_block_gain = z(fv, 2, 2, 3)
    p.scale_fac_l = z(fv, 2, 2, 22)
    p.scale_fac_s = z(fv, 2, 2, 3, 13)
    p.table_select = z(fv, 2, 2, 3)
    p.ms_stereo = np.zeros(2 * fv, dtype=bool)
    p.is_stereo = np.zeros(2 * fv, dtype=bool)
    p.lsf_is_illegal = np.full((2 * fv, 3, 22), -1, dtype=np.int8)
    p.lsf_is_scale = np.full(2 * fv, -1, dtype=np.int8)

    raw = np.zeros(576, dtype=np.float64)
    for fi, (foff, h, fsize, prev_sizes) in enumerate(frames):
        start_si = 6 if h.crc == 0 else 4
        si_bytes = file_data[foff + start_si:foff + fsize]
        si_bits = np.unpackbits(np.frombuffer(si_bytes, dtype=np.uint8))
        si = parse_side_info_lsf(si_bits, h)
        is_gr = (h.channel_mode == 1) and bool(h.mode_ext[1])
        md = _MainDataBits(
            assemble_main_data(file_data, foff, fsize, prev_sizes, si, h))
        vf, gr = fi // 2, fi & 1
        bit = 0
        for ch in range(h.channels):
            max_bit = int(bit + si.part2_3_length[0][ch])
            bit, illegal = unpack_scale_factors_lsf(
                md, si, ch, bit, i_stereo=is_gr and ch == 1)
            if illegal is not None:
                p.lsf_is_illegal[fi] = illegal
                p.lsf_is_scale[fi] = si.scale_fac_compress[0][ch] & 1
            unpack_samples(md, si, h, 0, ch, bit, max_bit, raw)
            p.raw_samples[vf, gr, ch] = raw.astype(np.int32)
            bit = max_bit
        if progress_cb is not None:
            progress_cb(fsize)
        p.side_infos.append(si)
        p.block_type[vf, gr] = si.block_type[0]
        p.mixed_block_flag[vf, gr] = si.mixed_block_flag[0]
        p.window_switching[vf, gr] = si.window_switching[0]
        p.global_gain[vf, gr] = si.global_gain[0]
        p.scale_fac_scale[vf, gr] = si.scale_fac_scale[0]
        p.pre_flag[vf, gr] = si.pre_flag[0]
        p.sub_block_gain[vf, gr] = si.sub_block_gain[0]
        p.scale_fac_l[vf, gr] = si.scale_fac_l[0]
        p.scale_fac_s[vf, gr] = si.scale_fac_s[0]
        p.table_select[vf, gr] = si.table_select[0]
        # MS stereo is per REAL frame (= per granule of the virtual-frame
        # layout); real LSF encoders (LAME) freely alternate MS/LR per frame
        p.ms_stereo[fi] = (h.channel_mode == 1) and bool(h.mode_ext[0])
        p.is_stereo[fi] = is_gr
    return p


def parse_mp3_light(file_data: bytes, offset: int = 0):
    """Host pass of the device Huffman decode (``ops/huffman_device``) in
    Python, the oracle the tests hold the native light parse to (with
    ``huffman_device.pack``): everything _parse_mp3_python does EXCEPT the
    per-sample symbol scan.
    MPEG-1 only (LSF raises ValueError). Returns
    (ParsedMP3 with raw_samples zeroed, per-granule bit-scan descriptors):

    descriptors: list over (frame, gr, ch) parse order of dicts with
      md (bytes, the frame's reservoir-spliced main data), start_bit, max_bit,
      region0, region1, big2, ts (3,), c1sel. Inactive (mono ch=1) slots have
      big2 = 0 and max_bit = start_bit.
    """
    p = ParsedMP3()
    n = len(file_data)
    if (offset + HEADER_SIZE > n or file_data[offset] != 0xFF
            or file_data[offset + 1] < 0xE0):
        p.num_frames = 0
        return p, []

    if parse_header(*file_data[offset:offset + 4]).mpeg_version != 1:
        raise ValueError("the device Huffman scan is MPEG-1-only; LSF "
                         "streams decode through the host parse path")
    # the host parse's own sync walk: a free-format stream's frames take
    # the stride measured from its first sync words
    frames, _, p.header, p.duplicate_last_pcm = walk_frames(file_data,
                                                            offset)
    F = len(frames)
    p.num_frames = F
    if F == 0:
        return p, []
    _attach_vbr_tag(p, file_data, offset)
    z = lambda *s: np.zeros(s, dtype=np.int32)  # noqa: E731
    p.frame_sizes = np.array([f[2] for f in frames], dtype=np.int64)
    p.raw_samples = np.zeros((F, 2, 2, 576), dtype=np.int32)
    for name in ("block_type", "mixed_block_flag", "window_switching",
                 "global_gain", "scale_fac_scale", "pre_flag"):
        setattr(p, name, z(F, 2, 2))
    p.sub_block_gain = z(F, 2, 2, 3)
    p.scale_fac_l = z(F, 2, 2, 22)
    p.scale_fac_s = z(F, 2, 2, 3, 13)
    p.table_select = z(F, 2, 2, 3)
    p.ms_stereo = np.zeros(2 * F, dtype=bool)
    p.is_stereo = np.zeros(2 * F, dtype=bool)

    descriptors = []
    for fi, (foff, h, fsize, prev_sizes) in enumerate(frames):
        start_si = 6 if h.crc == 0 else 4
        si_bytes = file_data[foff + start_si:foff + fsize]
        si_bits = np.unpackbits(np.frombuffer(si_bytes, dtype=np.uint8))
        si = parse_side_info(si_bits, h)
        md = assemble_main_data(file_data, foff, fsize, prev_sizes, si, h)
        mdb = _MainDataBits(md)
        long_win = T.BAND_INDEX_LONG[h.sr_idx]
        bit = 0
        for gr in range(2):
            for ch in range(2):
                if ch < h.channels:
                    max_bit = int(bit + si.part2_3_length[gr][ch])
                    start = unpack_scale_factors(mdb, si, gr, ch, bit)
                    if si.window_switching[gr][ch] and si.block_type[gr][ch] == 2:
                        region0, region1 = 36, 576
                    else:
                        r0c = int(si.region0_count[gr][ch])
                        r1c = int(si.region1_count[gr][ch])
                        region0 = int(long_win[min(r0c + 1, 22)])
                        region1 = int(long_win[min(r0c + 1 + r1c + 1, 22)])
                    descriptors.append(dict(
                        md=md, start_bit=start, max_bit=max_bit,
                        region0=region0, region1=region1,
                        big2=min(int(si.big_value[gr][ch]) * 2, 576),
                        ts=np.array(si.table_select[gr][ch], dtype=np.int32),
                        c1sel=int(si.count1table_select[gr][ch])))
                    bit = max_bit
                else:
                    descriptors.append(dict(
                        md=b"", start_bit=0, max_bit=0, region0=0, region1=0,
                        big2=0, ts=np.zeros(3, np.int32), c1sel=0))
        p.side_infos.append(si)
        p.block_type[fi] = si.block_type
        p.mixed_block_flag[fi] = si.mixed_block_flag
        p.window_switching[fi] = si.window_switching
        p.global_gain[fi] = si.global_gain
        p.scale_fac_scale[fi] = si.scale_fac_scale
        p.pre_flag[fi] = si.pre_flag
        p.sub_block_gain[fi] = si.sub_block_gain
        p.scale_fac_l[fi] = si.scale_fac_l
        p.scale_fac_s[fi] = si.scale_fac_s
        p.table_select[fi] = si.table_select
        p.ms_stereo[2 * fi:2 * fi + 2] = (
            h.channel_mode == 1) and bool(h.mode_ext[0])
        p.is_stereo[2 * fi:2 * fi + 2] = (
            h.channel_mode == 1) and bool(h.mode_ext[1])
    return p, descriptors


def stego_bits(p: ParsedMP3) -> str:
    """table_select -> hidden bit string, ch-major within frame, skipping table 0
    (decoder/util.py:67-81 + Frame.py:676-685 flatten order)."""
    if p.num_frames == 0:
        return ""
    if p.lsf_granules:
        # one granule per real frame: natural (vframe, gr=frame parity, ch,
        # region) order IS temporal frame order; pad granules are all-zero
        ts = p.table_select.reshape(-1)
    else:
        ts = p.table_select.transpose(0, 2, 1, 3).reshape(-1)  # f, ch, gr, region
    ts = ts[ts != 0]
    bits = np.where(np.isin(ts, np.array(sorted(T.H0))), ord("0"), ord("1"))
    return bits.astype(np.uint8).tobytes().decode()
