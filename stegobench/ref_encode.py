"""The plain reference encode, frame by frame: plain NumPy and Python.

It encodes one frame of a CBR MPEG-1 Layer III file from the PCM, given
the state the frame starts from, in the arithmetic of the upstream encoder
that the configurations name (tomershay100/mp3-steganography-lib,
encoder/MP3_Encoder.py, a port of shine): the Q31 polyphase analysis, MDCT
and alias butterflies; the scalefactor-select information; per granule the
binary search of the quantizer step and the inner loop, with the hide's
pair transform of each region's table at the message cursor; the drain of
the reservoir into stuffing bits; and the side information and Huffman
data, written bit for bit.

The upstream encoder never lets its reservoir carry bits from one frame
to the next (its maximum stays 0), so a frame depends on the frames before
it only through ``State``: the message cursor, and each (granule, channel)
slot's quantizer step and region addresses, which the upstream encoder
leaves stale from the slot's last search. ``State()`` is a file's start.

Frozen copies at commit e1ac834 of ``mp3stego_tpu/ops/quant.py`` (the
rate-control primitives), of ``mp3stego_tpu/ops/encode_plane.py``'s Q31
analysis (written in NumPy), of ``mp3stego_tpu/tables`` (the Q31 tables and
the pair transform), and of the sequential frame loop of
``mp3stego_tpu/models/encoder.py`` (its host oracle path), without their
native and device twins. It imports nothing of the program.
"""

import math
from dataclasses import dataclass, field

import numpy as np

from mp3gen import _T, HUFF_LEN, HUFF_LINBITS, HUFF_LINMAX, HUFF_XLEN

SR = 44100
MAX_QUANTIZE_STEP = 8192
MAX_BITS_ALLOWANCE = 4095
SIDE_INFO_BITS = 8 * (4 + 32)          # header and stereo side information
_PAST = 480                            # the analysis window's lookback
ENWINDOW = _T["enwindow"].astype(np.int64).reshape(8, 64)
SUBDV_TABLE = _T["subdv_table"].astype(np.int64)
BAND = _T["scale_fact_band_index"].astype(np.int64).reshape(-1)  # flattened
HUFF_CODE = _T["huff_code"].astype(np.int64)
_HLEN = HUFF_LEN.astype(np.int64)
_QLEN0, _QLEN1 = _HLEN[32, 0, :16], _HLEN[33, 0, :16]
_LN2 = 0.69314718                     # the upstream constant, not log(2)
_EN_TOT_KRIT, _EN_DIF_KRIT = 10, 100
_EN_SCFSI_BAND_KRIT, _XM_SCFSI_BAND_KRIT = 10, 10
_SCFSI_BAND_LONG = (0, 6, 11, 16, 21)
# the hide's pair transform: each table and message bit to the table that
# carries the bit (its image for bit 0 lies in H0, for bit 1 outside it)
H0 = frozenset({3, 6, 8, 11, 12, 15, 17, 19, 21, 23, 24, 26, 28, 30})
_PAIR = {
    1: (3, 1), 2: (3, 2), 3: (3, 2), 5: (6, 5), 6: (6, 5), 7: (8, 7),
    8: (8, 7), 9: (8, 9), 10: (11, 10), 11: (11, 10), 12: (12, 10),
    13: (15, 13), 15: (15, 13), 16: (17, 16), 17: (17, 18), 18: (19, 18),
    19: (19, 20), 20: (21, 20), 21: (21, 22), 22: (23, 22), 23: (23, 31),
    24: (24, 25), 25: (26, 25), 26: (26, 27), 27: (28, 27), 28: (28, 29),
    29: (30, 29), 30: (30, 31), 31: (23, 31)}


def _q31_tables():
    fl = np.zeros((32, 64), dtype=np.int64)
    for i in range(32):
        for j in range(64):
            filt = 1e9 * math.cos((2 * i + 1) * (16 - j) * 0.049087385212)
            filt = math.modf(filt + 0.5)[1] if filt >= 0 \
                else math.modf(filt - 0.5)[1]
            fl[i, j] = np.int32(filt * 0x7FFFFFFF * 1e-9)
    cos_l = np.zeros((18, 36), dtype=np.int64)
    for m in range(18):
        for k in range(36):
            cos_l[m, k] = np.int32(
                math.sin(0.087266462599717 * (k + 0.5))
                * math.cos((math.pi / 72) * (2 * k + 19) * (2 * m + 1))
                * 0x7FFFFFFF)
    ci = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142,
                   -0.0037])
    ca = (ci / np.sqrt(1.0 + ci * ci) * 0x7FFFFFFF).astype(np.int64) \
        .astype(np.int32).astype(np.int64)
    cs = (1.0 / np.sqrt(1.0 + ci * ci) * 0x7FFFFFFF).astype(np.int64) \
        .astype(np.int32).astype(np.int64)
    steptab = np.array([2.0 ** ((127 - i) / 4) for i in range(128)])
    steptabi = np.array([0x7FFFFFFF if s * 2 > 0x7FFFFFFF
                         else int(np.int32(s * 2 + 0.5)) for s in steptab],
                        dtype=np.int64)
    i = np.arange(10000, dtype=np.float64)
    int2idx = (np.sqrt(np.sqrt(i) * i) - 0.0946 + 0.5).astype(np.int32)
    return fl, cos_l, cs, ca, steptab, steptabi, int2idx


FL, COS_L, MDCT_CS, MDCT_CA, STEPTAB, STEPTABI, INT2IDX = _q31_tables()


def _wrap32(x: np.ndarray) -> np.ndarray:
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int64)


def _mul(a, b):
    return (a * b) >> 32


def analysis(streams: np.ndarray, g0: int, g1: int) -> np.ndarray:
    """The Q31 spectra (2, g1 - g0, 576) int32 of granules [g0, g1) of the
    channel streams (2, N) int16 (zero past their end), each granule's MDCT
    over its subband samples and the granule's before."""
    first = max(g0 - 1, 0)
    a = first * 576                       # padded coordinates: +_PAST
    b = g1 * 576 + _PAST
    pcm = np.zeros((2, b - a), dtype=np.int64)
    lo, hi = max(a - _PAST, 0), min(b - _PAST, streams.shape[1])
    if hi > lo:
        pcm[:, lo - (a - _PAST):hi - (a - _PAST)] = streams[:, lo:hi]
    pcm <<= 16
    ts = (g1 - first) * 18
    win = np.stack([pcm[:, 32 * t:32 * t + 512] for t in range(ts)], 1)
    v = win[..., ::-1].reshape(2, ts, 8, 64)
    tmp = _wrap32(_mul(v, ENWINDOW).sum(2))                  # (2, ts, 64)
    sb = _wrap32(_mul(FL[None, None], tmp[:, :, None, :]).sum(-1))
    step = (np.arange(ts) + first * 18) % 18
    inv = np.where((step[:, None] % 2 == 1) & (np.arange(32)[None] % 2 == 1),
                   -1, 1)
    sb = _wrap32(sb * inv[None])
    sbg = sb.reshape(2, g1 - first, 18, 32)
    prev = np.concatenate([np.zeros_like(sbg[:, :1]), sbg[:, :-1]], 1)
    if first < g0:
        prev, sbg = prev[:, 1:], sbg[:, 1:]
    mdct_in = np.concatenate([prev, sbg], 2).transpose(0, 1, 3, 2)
    freq = _wrap32(_mul(mdct_in[:, :, :, None, :],
                        COS_L[None, None, None]).sum(-1))   # (2, g, 32, 18)
    up = freq[:, :, 1:, :8].copy()
    dn = freq[:, :, :-1, 17:9:-1].copy()
    bu = ((up * MDCT_CS - dn * MDCT_CA) >> 31).astype(np.int32)
    bd = ((up * MDCT_CA + dn * MDCT_CS) >> 31).astype(np.int32)
    freq[:, :, 1:, :8] = bu
    freq[:, :, :-1, 17:9:-1] = bd
    return freq.reshape(2, g1 - g0, 576).astype(np.int32)


@dataclass
class GrInfo:
    """A (granule, channel) slot's coding state; the addresses and the
    quantizer step persist from the slot's last search, as upstream."""
    table_select: list = field(default_factory=lambda: [0, 0, 0])
    part2_3_length: int = 0
    big_values: int = 0
    count1: int = 0
    global_gain: int = 0
    region0_count: int = 0
    region1_count: int = 0
    count1table_select: int = 0
    address1: int = 0
    address2: int = 0
    address3: int = 0
    quantizerStepSize: int = 0


@dataclass
class State:
    """What a frame starts from: the message cursor and, per slot [gr][ch],
    the stale quantizer step and addresses."""
    cursor: int = 0
    slots: list = field(default_factory=lambda: [[GrInfo(), GrInfo()],
                                                 [GrInfo(), GrInfo()]])


def _mulr(a: int, b: int) -> int:
    v = (int(a) * int(b) + 2147483648) >> 32
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def quantize(xr, xrabs, xrmax: int, step: int):
    scalei = int(STEPTABI[step + 127])
    if _mulr(xrmax, scalei) > 165140:
        return None, 16384
    ln = ((np.abs(xr.astype(np.int64)) * scalei + 2147483648) >> 32) \
        .astype(np.int32)
    small = ln < 10000
    ix = np.empty(576, dtype=np.int32)
    ix[small] = INT2IDX[ln[small]]
    if not small.all():
        dbl = xrabs[~small].astype(np.float64) * STEPTAB[step + 127] \
            * 4.656612875e-10
        ix[~small] = (np.sqrt(np.sqrt(dbl) * dbl)).astype(np.int32)
    return ix, int(max(0, ix.max()))


def _run_len(ix, gi: GrInfo):
    nz = np.flatnonzero(ix)
    i = 0 if nz.size == 0 else int(nz[-1]) + 1
    i += i & 1
    gt1 = np.flatnonzero(ix[:i] > 1)
    lim = int(gt1[-1]) + 1 if gt1.size else 0
    k = max(0, min((i - lim) // 4, i // 4))
    gi.count1 = k
    gi.big_values = (i - 4 * k) >> 1


def _count1_bits(ix, gi: GrInfo) -> int:
    start = gi.big_values << 1
    q = ix[start:start + 4 * gi.count1].reshape(-1, 4).astype(np.int64)
    p = q[:, 0] + (q[:, 1] << 1) + (q[:, 2] << 2) + (q[:, 3] << 3)
    signs = int((q != 0).sum())
    s0, s1 = signs + int(_QLEN0[p].sum()), signs + int(_QLEN1[p].sum())
    if s0 < s1:
        gi.count1table_select = 0
        return s0
    gi.count1table_select = 1
    return s1


def _count_bit(ix, start: int, end: int, table: int) -> int:
    if table == 0:
        return 0
    x = ix[start:end:2].astype(np.int64)
    y = ix[start + 1:end:2].astype(np.int64)
    s = 0
    if table > 15:
        s += int(HUFF_LINBITS[table]) * int((x > 14).sum() + (y > 14).sum())
        x, y = np.minimum(x, 15), np.minimum(y, 15)
    return s + int(_HLEN[table][x, y].sum()) + int((x != 0).sum()
                                                    + (y != 0).sum())


def _subdivide(gi: GrInfo):
    if gi.big_values == 0:
        gi.region0_count = gi.region1_count = 0
        return                               # the addresses stay stale
    band = BAND
    big = 2 * gi.big_values
    anz = 0
    while band[anz] < big:
        anz += 1
    n = int(SUBDV_TABLE[anz][0])
    while n > 0 and band[n + 1] > big:
        n -= 1
    gi.region0_count = n
    gi.address1 = int(band[n + 1])
    band = band[n + 1:]
    n = int(SUBDV_TABLE[anz][1])
    while n > 0 and band[n + 1] > big:
        n -= 1
    gi.region1_count = n
    gi.address2 = int(band[n + 1])
    gi.address3 = big


def _choose_table(ix, begin: int, end: int) -> int:
    ix_max = int(ix[begin:end].max()) if end > begin else 0
    if ix_max == 0:
        return 0
    if ix_max < 15:
        choice = next(i for i in range(13, -1, -1) if HUFF_XLEN[i] > ix_max)
        s0 = _count_bit(ix, begin, end, choice)
        for alt in {2: (3,), 5: (6,), 7: (8, 9), 10: (11, 12),
                    13: (15,)}.get(choice, ()):
            if _count_bit(ix, begin, end, alt) <= s0:
                choice = alt
        return choice
    ix_max -= 15
    c0 = next((i for i in range(15, 24) if HUFF_LINMAX[i] >= ix_max), 0)
    c1 = next((i for i in range(24, 32) if HUFF_LINMAX[i] >= ix_max), 0)
    return c1 if _count_bit(ix, begin, end, c1) \
        < _count_bit(ix, begin, end, c0) else c0


class FrameEncoder:
    """A file's frames: ``encode(f, state)`` returns frame f's bytes and the
    state after it. ``pcm`` is the (n, 2) int16 PCM; ``bits`` the hide's
    message bits as a str of '0' and '1' ('' for a clear encode)."""

    def __init__(self, pcm: np.ndarray, kbps: int, bits: str = ""):
        self.streams = np.ascontiguousarray(pcm.T[:2], dtype=np.int16)
        n = pcm.shape[0] * 2
        self.frames = n // 2304 + (1 if n % 2304 else 0)
        self.kbps, self.bits = kbps, bits
        avg = (2 * 576.0 / SR) * (1000.0 * kbps / 8)
        whole, frac = int(avg), avg - int(avg)
        lag, self.padding = -frac, np.zeros(self.frames, dtype=np.int64)
        for f in range(self.frames):
            if frac:
                pad = 1 if lag <= frac - 1.0 else 0
                lag += pad - frac
                self.padding[f] = pad
        self.frame_bits = 8 * (whole + self.padding)
        self.bitrate_index = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160,
                              192, 224, 256, 320).index(kbps)

    def starts(self) -> np.ndarray:
        """Each frame's first byte in the file."""
        return np.concatenate([[0], np.cumsum(self.frame_bits // 8)[:-1]])

    # -------------------------------------------------------- the search

    def _choose(self, ix, begin, end, idx):
        choice = _choose_table(ix, begin, end)
        if self.bits and idx < len(self.bits):
            return _PAIR[choice][int(self.bits[idx])] if choice else 0
        return choice

    def _eval(self, ix, gi: GrInfo, cursor: int) -> int:
        _run_len(ix, gi)
        bits = _count1_bits(ix, gi)
        _subdivide(gi)
        idx = cursor
        gi.table_select[0] = 0 if gi.address1 <= 0 else \
            self._choose(ix, 0, gi.address1, cursor)
        idx += gi.table_select[0] > 0
        gi.table_select[1] = 0 if gi.address2 <= gi.address1 else \
            self._choose(ix, gi.address1, gi.address2, idx)
        idx += gi.table_select[1] > 0
        gi.table_select[2] = 0 if (gi.big_values << 1) <= gi.address2 else \
            self._choose(ix, gi.address2, gi.big_values << 1, idx)
        ts = gi.table_select
        if ts[0]:
            bits += _count_bit(ix, 0, gi.address1, ts[0])
        if ts[1]:
            bits += _count_bit(ix, gi.address1, gi.address2, ts[1])
        if ts[2]:
            bits += _count_bit(ix, gi.address2, gi.address3, ts[2])
        return bits

    def _granule(self, xr, gi: GrInfo, max_bits: int, cursor: int):
        """The upstream outer loop: the binary search, then the inner loop;
        returns the granule's quantized values."""
        xrabs = np.abs(xr)
        xrmax = int(max(0, xrabs.max()))
        gi.part2_3_length = gi.big_values = gi.count1 = 0
        gi.table_select = [0, 0, 0]
        gi.region0_count = gi.region1_count = gi.count1table_select = 0
        ix = None
        if xrmax:
            nxt, count = -120, 120
            while True:
                half = count // 2
                q, q_max = quantize(xr, xrabs, xrmax, nxt + half)
                if q_max > MAX_QUANTIZE_STEP:
                    bit = 100000
                else:
                    ix = q
                    bit = self._eval(ix, gi, cursor)
                if bit < max_bits:
                    count = half
                else:
                    nxt += half
                    count -= half
                if count <= 1:
                    break
            gi.quantizerStepSize = nxt
            while True:
                while True:
                    q, q_max = quantize(xr, xrabs, xrmax,
                                        gi.quantizerStepSize + 1)
                    if q is not None:
                        ix = q
                    if q_max <= MAX_QUANTIZE_STEP:
                        break
                    gi.quantizerStepSize += 1
                gi.quantizerStepSize += 1
                bits = self._eval(ix, gi, cursor)
                if bits <= max_bits:
                    break
            gi.part2_3_length = bits
        gi.global_gain = gi.quantizerStepSize + 210
        return ix

    def _scfsi(self, xr, xrmax, gr, en_tot, en, xrmaxl, scfsi):
        terms = (((xr.astype(np.int64) * xr.astype(np.int64)) + 1073741824)
                 >> 31).astype(np.int32) >> 10
        xrmaxl[gr] = xrmax
        with np.errstate(all="ignore"):
            temp = int(terms.sum(dtype=np.int32))
            en_tot[gr] = np.float64(np.log(np.float64(
                temp * 4.768371584e-7)) / _LN2) if temp else 0
            for sfb in range(20, -1, -1):
                t = int(terms[int(BAND[sfb]):int(BAND[sfb + 1])]
                        .sum(dtype=np.int32))
                en[gr][sfb] = np.float64(np.log(np.float64(
                    t * 4.768371584e-7)) / _LN2) if t else 0
        if gr == 1:
            cond = 2 + int(xrmaxl[0] != 0) + int(xrmaxl[1] != 0)
            if abs(int(en_tot[0]) - int(en_tot[1])) < _EN_TOT_KRIT:
                cond += 1
            if int(np.abs(en[0] - en[1]).sum()) < _EN_DIF_KRIT:
                cond += 1
            if cond == 6:
                for b in range(4):
                    s0 = int(np.abs(en[0][_SCFSI_BAND_LONG[b]:
                                          _SCFSI_BAND_LONG[b + 1]]
                                    - en[1][_SCFSI_BAND_LONG[b]:
                                            _SCFSI_BAND_LONG[b + 1]]).sum())
                    scfsi[b] = int(s0 < _EN_SCFSI_BAND_KRIT
                                   and 0 < _XM_SCFSI_BAND_KRIT)
            else:
                scfsi[:] = [0, 0, 0, 0]

    def encode(self, f: int, state: State) -> tuple:
        """Frame f's bytes, the state after it, and its (gr, ch) big values
        and table selections."""
        xr_all = analysis(self.streams, 2 * f, 2 * f + 2)      # (2, 2, 576)
        mean_bits = int((int(self.frame_bits[f]) - SIDE_INFO_BITS) / 2)
        max_bits = min(mean_bits // 2, MAX_BITS_ALLOWANCE)
        cursor = state.cursor
        slots = state.slots
        l3 = [[None, None], [None, None]]
        scfsi = [[0] * 4, [0] * 4]
        en_tot = np.zeros(2, np.int32)
        en = np.zeros((2, 21), np.int32)
        xrmaxl = np.zeros(2, np.int32)
        resv = 0.0
        for ch in range(2):
            for gr in range(2):
                xr = xr_all[ch, gr]
                xrmax = int(max(0, np.abs(xr).max()))
                self._scfsi(xr, xrmax, gr, en_tot, en, xrmaxl, scfsi[ch])
                gi = slots[gr][ch]
                l3[gr][ch] = self._granule(xr, gi, max_bits, cursor)
                if xrmax:
                    cursor += sum(t > 0 for t in gi.table_select)
                resv += (mean_bits / 2) - gi.part2_3_length
        # the reservoir's drain: every bit left over is stuffing
        if mean_bits & 1:
            resv += 1
        stuffing = max(0.0, resv)
        resv -= stuffing
        over = resv % 8
        if over:
            stuffing += over
        if stuffing:
            gi = slots[0][0]
            if gi.part2_3_length + stuffing < MAX_BITS_ALLOWANCE:
                gi.part2_3_length += stuffing
            else:
                for gr in range(2):
                    for ch in range(2):
                        gi = slots[gr][ch]
                        if not stuffing:
                            break
                        extra = min(MAX_BITS_ALLOWANCE - gi.part2_3_length,
                                    stuffing)
                        gi.part2_3_length += extra
                        stuffing -= extra
        out = self._write(f, slots, l3, scfsi, xr_all)
        return out, State(cursor=cursor, slots=slots)

    # ------------------------------------------------------ serialization

    def _write(self, f, slots, l3, scfsi, xr_all) -> bytes:
        bw = _Bits()
        bw.put(0x7FF, 11)
        bw.put(3, 2)                     # MPEG-1
        bw.put(1, 2)                     # Layer III
        bw.put(1, 1)                     # no CRC
        bw.put(self.bitrate_index, 4)
        bw.put(0, 2)                     # 44.1 kHz
        bw.put(int(self.padding[f]), 1)
        bw.put(0, 1)
        bw.put(0, 2)                     # stereo
        bw.put(0, 2)
        bw.put(0, 1)
        bw.put(1, 1)                     # original
        bw.put(0, 2)
        bw.put(0, 9)                     # main_data_begin
        bw.put(0, 3)                     # private bits
        for ch in range(2):
            for b in range(4):
                bw.put(scfsi[ch][b], 1)
        for gr in range(2):
            for ch in range(2):
                gi = slots[gr][ch]
                bw.put(int(gi.part2_3_length), 12)
                bw.put(gi.big_values, 9)
                bw.put(gi.global_gain, 8)
                bw.put(0, 4)             # scalefac_compress
                bw.put(0, 1)             # window switching
                for r in range(3):
                    bw.put(gi.table_select[r], 5)
                bw.put(gi.region0_count, 4)
                bw.put(gi.region1_count, 3)
                bw.put(0, 1)             # preflag
                bw.put(0, 1)             # scalefac_scale
                bw.put(gi.count1table_select, 1)
        for gr in range(2):
            for ch in range(2):
                gi = slots[gr][ch]
                ix = l3[gr][ch]
                start = bw.n
                if ix is not None:
                    enc = np.where(xr_all[ch, gr] < 0, -ix, ix)
                    self._huffman(bw, gi, enc)
                stuff = int(gi.part2_3_length - (bw.n - start))
                for _ in range(stuff // 32):
                    bw.put(0xFFFFFFFF, 32)
                if stuff % 32:
                    bw.put((1 << (stuff % 32)) - 1, stuff % 32)
        return bw.bytes()

    def _huffman(self, bw, gi: GrInfo, enc):
        big = gi.big_values << 1
        r1, r2 = int(BAND[gi.region0_count + 1]), \
            int(BAND[gi.region0_count + gi.region1_count + 2])
        for i in range(0, big, 2):
            t = gi.table_select[(i >= r1) + (i >= r2)]
            if t:
                _pair(bw, t, int(enc[i]), int(enc[i + 1]))
        table = 32 + gi.count1table_select
        for i in range(big, big + 4 * gi.count1, 4):
            v, w, x, y = (int(a) for a in enc[i:i + 4])
            p = abs(v) + (abs(w) << 1) + (abs(x) << 2) + (abs(y) << 3)
            bw.put(int(HUFF_CODE[table, 0, p]), int(_HLEN[table, 0, p]))
            for a in (v, w, x, y):
                if a:
                    bw.put(int(a < 0), 1)


def _pair(bw, table: int, x: int, y: int):
    sx, sy = int(x < 0), int(y < 0)
    x, y = abs(x), abs(y)
    if table > 15:
        lin = int(HUFF_LINBITS[table])
        lx, ly = max(x - 15, 0), max(y - 15, 0)
        cx, cy = min(x, 15), min(y, 15)
        bw.put(int(HUFF_CODE[table, cx, cy]), int(_HLEN[table, cx, cy]))
        if x > 14:
            bw.put(lx, lin)
        if x:
            bw.put(sx, 1)
        if y > 14:
            bw.put(ly, lin)
        if y:
            bw.put(sy, 1)
    else:
        bw.put(int(HUFF_CODE[table, x, y]), int(_HLEN[table, x, y]))
        if x:
            bw.put(sx, 1)
        if y:
            bw.put(sy, 1)


class _Bits:
    """An MSB-first bit string."""

    def __init__(self):
        self.parts, self.n = [], 0

    def put(self, value: int, n: int):
        if n:
            self.parts.append(format(int(value) & ((1 << n) - 1), f"0{n}b"))
            self.n += n

    def bytes(self) -> bytes:
        s = "".join(self.parts)
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


# ------------------------------------------------------ reading a stream


def side_info(data: bytes, starts: np.ndarray) -> dict:
    """Per frame and (gr, ch) of a CBR MPEG-1 stereo stream whose frames
    begin at ``starts``: global gain, big values, region counts and table
    selections, read from each frame's side information."""
    nf = len(starts)
    out = {k: np.zeros((nf, 2, 2), np.int64) for k in
           ("global_gain", "big_values", "region0_count", "region1_count")}
    out["table_select"] = np.zeros((nf, 2, 2, 3), np.int64)
    for f, s in enumerate(starts):
        chunk = data[int(s) + 4:int(s) + 36]
        if len(chunk) < 32:
            raise ValueError(f"frame {f} is cut short")
        v = int.from_bytes(chunk, "big")
        pos = 256 - 20                      # past begin, private, scfsi
        for gr in range(2):
            for ch in range(2):
                g = v >> (pos - 59) & ((1 << 59) - 1)
                pos -= 59
                out["big_values"][f, gr, ch] = g >> 38 & 511
                out["global_gain"][f, gr, ch] = g >> 30 & 255
                for r in range(3):
                    out["table_select"][f, gr, ch, r] = \
                        g >> (20 - 5 * r) & 31
                out["region0_count"][f, gr, ch] = g >> 6 & 15
                out["region1_count"][f, gr, ch] = g >> 3 & 7
    return out


def stego_bits(si: dict) -> str:
    """The hidden bits a stream carries: one a nonzero table selection, in
    the order frame, channel, granule, region; 0 where the table lies in
    H0."""
    ts = si["table_select"].transpose(0, 2, 1, 3).reshape(-1)
    ts = ts[ts != 0]
    return "".join("0" if t in H0 else "1" for t in ts)


def state_at(si: dict, f: int) -> State:
    """The state frame f starts from, read from the stream's frames before
    it: the cursor (the nonzero selections before it) and each slot's
    quantizer step and addresses as the slot's last frame left them. None
    when a slot's addresses cannot be read there (its last frame had no big
    values)."""
    ts = si["table_select"][:f]
    state = State(cursor=int((ts != 0).sum()))
    if f == 0:
        return state
    for gr in range(2):
        for ch in range(2):
            bv = int(si["big_values"][f - 1, gr, ch])
            if bv == 0:
                return None
            r0 = int(si["region0_count"][f - 1, gr, ch])
            r1 = int(si["region1_count"][f - 1, gr, ch])
            gi = state.slots[gr][ch]
            gi.quantizerStepSize = int(si["global_gain"][f - 1, gr, ch]) - 210
            gi.address1 = int(BAND[r0 + 1])
            gi.address2 = int(BAND[r0 + 1 + r1 + 1])
            gi.address3 = 2 * bv
    return state
