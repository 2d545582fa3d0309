"""Exact vectorized rate-control primitives for the MP3 encoder.

Behavioural reference (bit-for-bit): the reference's mp3stego/encoder/MP3_Encoder.py
  quantize (373-415), calc_run_len (266-291), count1_bit_count (171-211),
  count_bit (214-263), __subdivide (998-1036), __new_choose_table (1170-1264).

The reference evaluates these as per-sample numba loops inside a sequential
binary search. Here each primitive is one dense NumPy/array evaluation over the
full 576-sample granule; the torch search plane (ops/search_plane.py) lifts the
same arithmetic to all granules at once. A copy of the JAX package's module
(JAX-free host code). All fixed-point
semantics (Q31 rounding, int32 wraparound, the int2idx LUT vs float fallback
split) are preserved exactly.
"""

from dataclasses import dataclass, field

import numpy as np

from mp3stego_tpu_torch import tables as T

GRANULE_SIZE = 576
MAX_QUANTIZE_STEP = 8192
MAX_BITS_ALLOWANCE = 4095

STEPTAB, STEPTABI, INT2IDX = T.loop_tables()

# h_len grids as int32 for gather sums
_HLEN = T.HUFF_LEN.astype(np.int32)          # (34,16,16)
_XLEN = T.HUFF_XLEN                           # (34,)
_LINBITS = T.HUFF_LINBITS
_LINMAX = T.HUFF_LINMAX
_QLEN0 = _HLEN[32, 0, :16]
_QLEN1 = _HLEN[33, 0, :16]


@dataclass
class GrInfo:
    """Persistent per-(gr,ch) coding state. Fields deliberately persist across
    frames exactly like the reference's GrInfo objects (MP3_Encoder.py:80-103):
    address1..3 and quantizerStepSize are NOT reset between granules, and stale
    values are read when big_values==0 mid-search (reference quirk)."""
    table_select: np.ndarray = field(default_factory=lambda: np.zeros(3, np.int32))
    s_len: np.ndarray = field(default_factory=lambda: np.zeros(4, np.int32))
    part2_3_length: float = 0
    big_values: int = 0
    count1: int = 0
    global_gain: int = 0
    scale_fac_compress: int = 0
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scale_fac_scale: int = 0
    count1table_select: int = 0
    part2_length: int = 0
    sfb_lmax: int = 0
    address1: int = 0
    address2: int = 0
    address3: int = 0
    quantizerStepSize: int = 0


def mulr_scalar(a: int, b: int) -> int:
    """Rounded Q(32) multiply on scalars (encoder/util.py:131-134)."""
    v = (int(a) * int(b) + 2147483648) >> 32
    return ((v + 2**31) % 2**32) - 2**31


def quantize(xr: np.ndarray, xrabs: np.ndarray, xrmax: int, step_size: int):
    """One full-granule quantization at ``step_size`` (MP3_Encoder.py:373-415).

    Returns (ix, ix_max); ix is None on the early bail (reference leaves the ix
    buffer stale in that case, and no caller consumes it before re-quantizing).
    ``xr`` is the int32 mdct vector (used via labs with int64 width, matching
    util.labs's np.long), ``xrabs`` the int32-wrapped precomputed |xr| used by
    the float fallback path.
    """
    scalei = int(STEPTABI[step_size + 127])
    if mulr_scalar(xrmax, scalei) > 165140:  # 8192**(4/3)
        return None, 16384

    labs64 = np.abs(xr.astype(np.int64))
    ln = ((labs64 * scalei + 2147483648) >> 32).astype(np.int32)
    small = ln < 10000
    ix = np.empty(GRANULE_SIZE, dtype=np.int32)
    ix[small] = INT2IDX[ln[small]]
    if not small.all():
        scale = STEPTAB[step_size + 127]
        dbl = xrabs[~small].astype(np.float64) * scale * 4.656612875e-10
        ix[~small] = (np.sqrt(np.sqrt(dbl) * dbl)).astype(np.int32)
    return ix, int(max(0, ix.max()))


def calc_run_len(ix: np.ndarray, cod_info: GrInfo):
    """Partition ix into big-values / count1 / zero runs (MP3_Encoder.py:266-291)."""
    nz = np.flatnonzero(ix)
    if nz.size == 0:
        i = 0
    else:
        i = int(nz[-1]) + 1
        i += i & 1  # pair scan lands on even boundaries
    gt1 = np.flatnonzero(ix[:i] > 1)
    lim = int(gt1[-1]) + 1 if gt1.size else 0
    k = max(0, min((i - lim) // 4, i // 4))
    cod_info.count1 = k
    i -= 4 * k
    cod_info.big_values = i >> 1


def count1_bit_count(ix: np.ndarray, cod_info: GrInfo) -> int:
    """Bits for the quadruples region; selects count1table (MP3_Encoder.py:171-211)."""
    start = cod_info.big_values << 1
    quads = ix[start:start + 4 * cod_info.count1].reshape(-1, 4).astype(np.int64)
    v, w, x, y = quads[:, 0], quads[:, 1], quads[:, 2], quads[:, 3]
    p = v + (w << 1) + (x << 2) + (y << 3)
    sign_bits = int((quads != 0).sum())
    sum0 = sign_bits + int(_QLEN0[p].sum())
    sum1 = sign_bits + int(_QLEN1[p].sum())
    if sum0 < sum1:
        cod_info.count1table_select = 0
        return sum0
    cod_info.count1table_select = 1
    return sum1


def count_bit(ix: np.ndarray, start: int, end: int, table: int) -> int:
    """Huffman bit cost of ix[start:end) under ``table`` (MP3_Encoder.py:214-263)."""
    if table == 0:
        return 0
    x = ix[start:end:2].astype(np.int64)
    y = ix[start + 1:end:2].astype(np.int64)
    h_sum = 0
    if table > 15:
        lin_bits = int(_LINBITS[table])
        h_sum += lin_bits * int((x > 14).sum() + (y > 14).sum())
        x = np.minimum(x, 15)
        y = np.minimum(y, 15)
    h_sum += int(_HLEN[table][x, y].sum())
    h_sum += int((x != 0).sum() + (y != 0).sum())
    return h_sum


def subdivide(cod_info: GrInfo, sr_idx: int):
    """Big-values region subdivision (MP3_Encoder.py:998-1036). Mirrors the
    reference's flatten-then-slice of scale_fact_band_index."""
    if cod_info.big_values == 0:
        cod_info.region0_count = 0
        cod_info.region1_count = 0
        # address1..3 intentionally left stale (reference behaviour)
        return
    band = T.BAND_ALL.reshape(-1)[sr_idx * T.BAND_ALL.shape[1]:]
    big_values_region = 2 * cod_info.big_values

    scfb_anz = 0
    while band[scfb_anz] < big_values_region:
        scfb_anz += 1

    this_count = int(T.SUBDV_TABLE[scfb_anz][0])
    while this_count > 0:
        if band[this_count + 1] <= big_values_region:
            break
        this_count -= 1
    cod_info.region0_count = this_count
    cod_info.address1 = int(band[this_count + 1])

    band = band[this_count + 1:]
    this_count = int(T.SUBDV_TABLE[scfb_anz][1])
    while this_count > 0:
        if band[this_count + 1] <= big_values_region:
            break
        this_count -= 1
    cod_info.region1_count = this_count
    cod_info.address2 = int(band[this_count + 1])
    cod_info.address3 = big_values_region


def choose_table(ix: np.ndarray, begin: int, end: int) -> int:
    """Pick the cheapest Huffman table for ix[begin:end) — exact replay of
    __new_choose_table's selection logic (MP3_Encoder.py:1170-1255), including
    the descending no-linbits scan that lands on table 13 first (so small-value
    regions only ever choose 13 or 15, a reference quirk kept for parity).

    The steganographic pair transform is applied by the caller."""
    ix_max = int(ix[begin:end].max()) if end > begin else 0
    if ix_max == 0:
        return 0

    if ix_max < 15:
        choice0 = 0
        for i in range(13, -1, -1):
            if _XLEN[i] > ix_max:
                choice0 = i
                break
        sum0 = count_bit(ix, begin, end, choice0)
        # each alternate is compared against the ORIGINAL sum0 (the reference
        # never updates ix_sum[0] when it accepts an alternate), and the last
        # winning alternate sticks (MP3_Encoder.py:1199-1231)
        alternates = {2: (3,), 5: (6,), 7: (8, 9), 10: (11, 12), 13: (15,)}
        for alt in alternates.get(choice0, ()):
            if count_bit(ix, begin, end, alt) <= sum0:
                choice0 = alt
        return choice0

    ix_max -= 15
    choice0 = 0
    for i in range(15, 24):
        if _LINMAX[i] >= ix_max:
            choice0 = i
            break
    choice1 = 0
    for i in range(24, 32):
        if _LINMAX[i] >= ix_max:
            choice1 = i
            break
    sum0 = count_bit(ix, begin, end, choice0)
    sum1 = count_bit(ix, begin, end, choice1)
    if sum1 < sum0:
        choice0 = choice1
    return choice0


def big_v_bit_count(ix: np.ndarray, cod_info: GrInfo) -> int:
    """Bits for the big-values region under the chosen tables
    (MP3_Encoder.py:294-318)."""
    bits = 0
    if cod_info.table_select[0]:
        bits += count_bit(ix, 0, cod_info.address1, int(cod_info.table_select[0]))
    if cod_info.table_select[1]:
        bits += count_bit(ix, cod_info.address1, cod_info.address2,
                          int(cod_info.table_select[1]))
    if cod_info.table_select[2]:
        bits += count_bit(ix, cod_info.address2, cod_info.address3,
                          int(cod_info.table_select[2]))
    return bits
