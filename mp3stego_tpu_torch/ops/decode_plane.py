"""Batched decode numeric plane: host preparation + the torch device plane.

The reference decodes granule-by-granule with carried state
(decoder/Frame.py:65-218: requantize, IMDCT + overlap-add, synthesis FIFO).
Here the whole file is one dense batch of granules:

* requantize     — sign * pow43[|ix|] * 2^(q/4): per-band exponents are
                   computed on a compact 61-slot grid from side-info fields
                   and gathered out to the 576 samples through static slot
                   maps; pow43 rows are read from the exact 8207-entry table.
                   float32 builds 2^(q/4) from exponent bits; float64
                   multiplies by the reference's two exponent tables
                   (e1lut, e2lut) in its order.
* MS stereo      — masked vector op; intensity stereo as a masked overlay.
* reorder        — static permutation (with the reference's zero-filled tail for
                   short blocks, Frame.py:574-602).
* alias          — static butterfly index arrays.
* IMDCT          — 18->36 against the cosine basis, windowed, in both
                   dtypes as the reference's ascending sum
                   (``synth.ascending_matmul``), so a row rounds alike in
                   any batch.
* synthesis      — from the IMDCT blocks, one fused kernel per row of
                   (file, channel) (ops/synth.py, a hand-written CUDA kernel
                   on the card): overlap-add (out_t = blk_t[:18] +
                   blk_{t-1}[18:]), frequency inversion, V_t = N @ s_t and the
                   16-tap FIR PCM_t[n] = sum_{j<16} D[32j+n] *
                   V_{t-j}[(j%2)*32+n], both sums in the reference's
                   ascending order, then float PCM or interleaved int16.

The host half (walk tables, ``host_prepare``, the float64 NumPy and native
planes) is the JAX package's, unchanged: its input dict (``ALL_KEYS``) feeds
both packages. The torch plane (``granule_blocks``, ``synth_from_blocks``,
``decode_granules``) runs in float32 or float64 on a CUDA device or the CPU.
In float64 it follows ``decode_granules_np`` operation for operation, so on
every device it gives the host plane's PCM bit for bit.

The granule half is kernel K2:

* ``granule_blocks`` — the wrapper every decode goes through. A CPU prep
  takes the plain version; a CUDA prep launches ``csrc/granule.cu`` (one
  launch over every granule: persistent CTAs, as many as ``occupancy``
  fits, each a contiguous run of granule indices; it replaces the JAX
  package's XLA program ``mp3stego_tpu/ops/decode_plane.py::
  granule_blocks``) or raises. There is no fallback from the card to the
  plain version.
* ``granule_blocks_torch`` — the plain PyTorch version, the four stages as
  eager ops on any device. The kernel equals it bit for bit in both dtypes.
* ``launches`` — how many times the kernel was launched in this process.
"""

import ctypes
import functools
import math
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.ops.synth import MAX_ROWS as MAX_SYNTH_ROWS
from mp3stego_tpu_torch.ops.synth import (ascending_matmul, overlap_freqinv,
                                          synth_fused)
from mp3stego_tpu_torch.utils.profiling import count, span
from mp3stego_tpu_torch.utils.transfer import (fetch_pieces, put_tree,
                                               resolve_device)

SQRT2 = math.sqrt(2)
DTYPES = {"float32": torch.float32, "float64": torch.float64}

launches = 0

_SIGNATURES = {
    name: (ctypes.c_int, (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p))
    for name in ("granule_blocks_f32", "granule_blocks_f64")}
_SIGNATURES["granule_occupancy"] = (ctypes.c_int, (
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p))
_ENTRY = {torch.float32: "granule_blocks_f32",
          torch.float64: "granule_blocks_f64"}

# ------------------------------------------------------------------ host maps

_EXP1_OFF = 266          # exp1 in [-266, 45]
_EXP2X2_MAX = 64


@functools.lru_cache(maxsize=None)
def _requant_walk(sr_idx: int, bt2: bool, mixed: bool, iso: bool = True):
    """Replicates the sfb/window walk of re_quantize (Frame.py:176-208) for a
    whole granule, returning static per-sample maps (is_short, sfb, window).

    ``iso=True`` (default) uses the spec-correct band tables
    (T.BAND_INDEX_ISO / T.BAND_WIDTH_SHORT_ISO, 13 short bands covering all
    576 samples — cross-verified against libmpg123). ``iso=False``
    reproduces the reference's walk: 12-band short tables whose sfb counter
    runs past the table end for the top of the spectrum
    (MP3STEGO_TPU_REF_SHORT_BANDS=1; only meaningful for MPEG-1 rows —
    LSF rows are always ISO since the reference cannot decode LSF)."""
    if iso:
        long_win = T.BAND_INDEX_ISO[sr_idx]
        short_win = T.BAND_WIDTH_SHORT_ISO[sr_idx]      # 13 bands, sum 192
    else:
        long_win = T.SCALE_FACT_BAND_INDEX[sr_idx]
        short_win = (T.BAND_WIDTH_SHORT[sr_idx] if sr_idx < 3
                     else np.zeros(12, np.int32))
    is_short = np.zeros(576, dtype=bool)
    sfb_map = np.zeros(576, dtype=np.int32)
    win_map = np.zeros(576, dtype=np.int32)
    window = 0
    sfb = 0
    i = 0
    for sample in range(576):
        if bt2 or (mixed and sfb >= 8):
            swv = short_win[sfb] if sfb < len(short_win) else 0
            if i == swv:
                i = 0
                if window == 2:
                    window = 0
                    sfb += 1
                else:
                    window += 1
            is_short[sample] = True
            # non-ISO walk: the reference's sfb counter runs past the 12-band
            # table for the top of the spectrum and its njit requantize reads
            # scale_fac_s out of bounds there — those samples are then
            # DROPPED by its 12-band reorder, so the net output is a zero
            # tail regardless of the garbage exponent. Clamp to keep the
            # gather in bounds; the 12-band reorder_perm still zero-fills,
            # so the net output matches the reference exactly.
            sfb_map[sample] = min(sfb, 12)
            win_map[sample] = window
        else:
            if sample == long_win[sfb + 1]:
                sfb += 1
            sfb_map[sample] = sfb
        i += 1
    return is_short, sfb_map, win_map


def _mix_geometry(sr_idx: int):
    """(boundary_sample S, n_long_window_subbands K) for ISO mixed blocks.

    S — the requantize/reorder boundary: the long-walk region covers
    scalefactor bands 0..7 (MPEG-1) / 0..5 (LSF, ISO 13818-3 partitions),
    and at every one of the 9 samplerates that boundary
    S = BAND_INDEX_ISO[n_long] equals 3*sum(short bands 0..2) — 36
    everywhere except 8 kHz, where both are 72 — so the short region
    starts exactly at short scalefactor band 3 with reorder output
    offset S.

    K — the hybrid-stage long count: exactly 2 polyphase subbands are
    decoded with long (block_type 0) windows and ONE alias butterfly,
    at every samplerate. This matches libmpg123 and libavcodec (which
    agree with each other at ~79 dB on crafted 8 kHz mixed streams,
    tests/test_mixed_blocks.py): both hard-code 2 long subbands / 1
    butterfly for mixed blocks independent of the scalefactor-band
    boundary. At 8 kHz this means subbands 2-3 (samples 36..71) carry
    long-walk, UNREORDERED spectrum under short windows — a spec-side
    oddity, but the ecosystem behavior. (An earlier revision derived
    K = S//18 = 4 at 8 kHz, long-windowing all 72 samples; it measured
    2.6 dB vs both oracles.)"""
    n_long = 8 if sr_idx < 3 else 6
    s = int(T.BAND_INDEX_ISO[sr_idx][n_long])
    assert s == 3 * int(T.BAND_WIDTH_SHORT_ISO[sr_idx][:3].sum()) \
        and s % 18 == 0, (sr_idx, s)
    return s, 2


@functools.lru_cache(maxsize=None)
def _requant_walk_mixed_iso(sr_idx: int):
    """ISO-correct requantize walk for mixed blocks (ISO 11172-3 2.4.3.4.6 /
    13818-3): long bands 0..7 (MPEG-1) or 0..5 (LSF) for the first S
    samples, then the short (sfb, window) walk STARTING at short band 3.
    The reference instead keeps running its long sfb counter into the
    short-width table (Frame.py:186, ``sfb >= 8`` with ``short_win[sfb]``),
    which reads the wrong widths and the wrong scalefactors — that walk is
    preserved as mode 2 for MP3STEGO_TPU_REF_MIXED=1."""
    long_win = T.BAND_INDEX_ISO[sr_idx]
    short_win = T.BAND_WIDTH_SHORT_ISO[sr_idx]
    s_mix, _ = _mix_geometry(sr_idx)
    is_short = np.zeros(576, dtype=bool)
    sfb_map = np.zeros(576, dtype=np.int32)
    win_map = np.zeros(576, dtype=np.int32)
    sfb = 0
    for sample in range(s_mix):
        if sample == long_win[sfb + 1]:
            sfb += 1
        sfb_map[sample] = sfb
    sfb, window, i = 3, 0, 0
    for sample in range(s_mix, 576):
        swv = int(short_win[sfb]) if sfb < len(short_win) else 0
        if i == swv:
            i = 0
            if window == 2:
                window = 0
                sfb += 1
            else:
                window += 1
        is_short[sample] = True
        sfb_map[sample] = min(sfb, 12)
        win_map[sample] = window
        i += 1
    return is_short, sfb_map, win_map


@functools.lru_cache(maxsize=None)
def _reorder_perm(sr_idx: int, iso: bool = True):
    """Static permutation for short-block reorder (Frame.py:574-602).

    ``iso=True`` (default) walks all 13 short bands — every one of the 576
    outputs is written (ISO behavior, matches libmpg123). ``iso=False``
    reproduces the reference's 12-band walk: outputs past the 12-band
    coverage are never written and stay 0 (the top short band of the
    spectrum is silently dropped)."""
    short_win = (T.BAND_WIDTH_SHORT_ISO[sr_idx] if iso
                 else (T.BAND_WIDTH_SHORT[sr_idx] if sr_idx < 3
                       else np.zeros(12, np.int32)))
    perm = np.full(576, -1, dtype=np.int32)
    total = start = block = 0
    for sb in range(len(short_win)):
        w = int(short_win[sb])
        for ss in range(w):
            perm[start + block + 0] = total + ss + w * 0
            perm[start + block + 6] = total + ss + w * 1
            perm[start + block + 12] = total + ss + w * 2
            if block != 0 and block % 5 == 0:
                start += 18
                block = 0
            else:
                block += 1
        total += w * 3
    return perm


@functools.lru_cache(maxsize=None)
def _alias_indices():
    sb = np.arange(1, 32)[:, None]
    s = np.arange(8)[None, :]
    off1 = (18 * sb - s - 1).reshape(-1)
    off2 = (18 * sb + s).reshape(-1)
    cs = np.tile(T.ALIAS_CS, 31)
    ca = np.tile(T.ALIAS_CA, 31)
    return off1, off2, cs, ca


@functools.lru_cache(maxsize=None)
def _freq_inv_mask():
    m = np.ones((32, 18))
    band = np.arange(32)[:, None]
    t = np.arange(18)[None, :]
    m[(band % 2 == 1) & (t % 2 == 1)] = -1.0
    return m.reshape(576)


@functools.lru_cache(maxsize=None)
def _walk_maps(sr_idx: int, iso: bool = True):
    """(4,576) per-mode walk tables + pre_tab. Rows: 0 long, 1 short,
    2 reference-mixed (Frame.py:186 — the walk kept for
    MP3STEGO_TPU_REF_MIXED=1 and for mixed flags on non-short block types),
    3 ISO mixed (long prefix + short from band 3)."""
    rows = [_requant_walk(sr_idx, m == 1, m == 2, iso) for m in range(3)]
    # mode 3 exists only when the ISO band tables are active (_iso_mixed_on
    # requires _iso_bands); under the reference band emulation duplicate
    # row 2 instead of mixing table families in one walk array
    rows.append(_requant_walk_mixed_iso(sr_idx) if iso else rows[2])
    maps = [np.stack([r[k] for r in rows]) for k in range(3)]
    pre_ext = np.concatenate([T.PRE_TAB, [0]]).astype(np.int32)
    return (maps[0].astype(np.int32), maps[1].astype(np.int32),
            maps[2].astype(np.int32), pre_ext)


def _slot_maps(walk_is_short, walk_sfb, walk_win):
    """Static sample->slot maps for the expansion of per-band values.

    The device plane computes per-band quantities on a compact slot grid and
    gathers them out to the 576-sample axis through these maps (the JAX
    package expands them with a one-hot matmul). Two grids:

    * exponent grid (61 slots): long sfb 0..21 read ``sfl`` (+preemphasis);
      short (win, sfb) slots 22 + win*13 + sfb read ``sfs`` — mirroring the
      index arithmetic of ``exponent_indices`` exactly.
    * intensity grid (88 slots): win*22 + sfb over the (T,4,22) ``is_pos``
      layout, window = walk window for short samples, row 3 for long ones.
    """
    short = walk_is_short.astype(bool)
    sfb_c = np.minimum(walk_sfb, 21)
    slot_exp = np.where(short, 22 + walk_win * 13 + walk_sfb,
                        sfb_c).astype(np.int16)
    slot_is = (np.where(short, walk_win, 3) * 22 + sfb_c).astype(np.int16)
    return slot_exp, slot_is


def _iso_bands(sr_idx: int) -> bool:
    """Band-table mode for a decode: LSF rows are always ISO; MPEG-1 rows
    are ISO unless MP3STEGO_TPU_REF_SHORT_BANDS=1 restores the reference's
    12-band short walk/reorder."""
    return sr_idx >= 3 or not T.ref_short_bands()


def _iso_mixed_on(sr_idx: int) -> bool:
    """True when bt==2 + mixed_block_flag granules take the ISO mixed
    decode (mode 3). Off under MP3STEGO_TPU_REF_MIXED=1 and under the
    reference band emulation (REF_SHORT_BANDS), whose walk tables encode
    the reference's all-short treatment."""
    return _iso_bands(sr_idx) and not T.ref_mixed()


@functools.lru_cache(maxsize=1)
def _is_coef():
    """(6,2,16) float64 intensity-stereo coefficient tables, [row][A/B][pos]:
    L' = x*A[p], R' = x*B[p] applied to the post-MS left channel. Rows
    (mpg123's tabs[lsf + (sfc & lsf)][ms_stereo] layout, fitted exactly on
    crafted streams — tests/test_intensity.py):

      0  MPEG-1 (ISO 11172-3 2.4.3.4.9.3): ratio tan(p*pi/12), p=0..6
         (p=6 is the +90-degree edge, A=1/B=0; p=7 is the illegal-position
         sentinel, pre-marked -1 by _intensity_positions)
      1  MPEG-1 when the granule is also MS (mode_ext=3): row 0 * sqrt(2)
      2  LSF (ISO 13818-3), intensity_scale=0: base=2^-1/4; p odd ->
         A=base^((p+1)/2), B=1; p even -> A=1, B=base^(p/2); p=0 -> A=B=1
      3  row 2 * sqrt(2) (LSF + MS)
      4  LSF, intensity_scale=1: base=2^-1/2
      5  row 4 * sqrt(2)
    """
    out = np.zeros((6, 2, 16))
    for p in range(7):
        if p == 6:
            out[0, 0, p], out[0, 1, p] = 1.0, 0.0
        else:
            t = math.tan(p * math.pi / 12.0)
            out[0, 0, p] = t / (1.0 + t)
            out[0, 1, p] = 1.0 / (1.0 + t)
    for j in range(2):
        base = 2.0 ** (-0.25 * (j + 1.0))
        for p in range(16):
            a = b = 1.0
            if p > 0:
                if p & 1:
                    a = base ** ((p + 1.0) * 0.5)
                else:
                    b = base ** (p * 0.5)
            out[2 + 2 * j, 0, p] = a
            out[2 + 2 * j, 1, p] = b
    out[1] = math.sqrt(2.0) * out[0]
    out[3] = math.sqrt(2.0) * out[2]
    out[5] = math.sqrt(2.0) * out[4]
    return out


def _intensity_positions(p, bt_ct, mixed_ct):
    """(T,4,22) int8 intensity positions for IS-flagged granules (-1 = band
    not intensity-processed), the (T,) flag mask, and the (T,) int8
    coefficient-table row (_is_coef first axis) per granule. Rows 0..2 are
    the short windows; row 3 carries long-band positions (whole-granule
    long blocks, and the long prefix of mixed blocks) — the planes index
    the row with the walk's window for short samples and 3 for long ones,
    so mixed granules can carry independent long- and short-band
    positions without aliasing.

    Semantics (validated against libmpg123 on hand-crafted streams,
    tests/test_intensity.py): intensity applies to the scalefactor bands at
    and above the RIGHT channel's zero part (the bands from the band holding
    the last nonzero right-channel sample upward are NOT processed — only
    fully-zero bands are); the intensity position is the right channel's
    scalefactor for that band; the top band (21 long / 12 short), which has
    no transmitted scalefactor, reuses the previous band's position. A
    position equal to the illegal sentinel — 7 for MPEG-1, and for LSF the
    MP3STEGO_TPU_LSF_IS_ILLEGAL convention (iso: (1<<slen)-1 per band group
    via ParsedMP3.lsf_is_illegal; mpg123: constant 7; ffmpeg: never — see
    tables.lsf_is_illegal_mode) — leaves the band on the MS/LR path;
    illegal bands are pre-marked -1 here so the planes apply coefficients
    unconditionally wherever pos >= 0 (but they do NOT bound the IS region:
    only bands with content do)."""
    Tn = 2 * p.num_frames
    isg = np.zeros(Tn, bool) if p.is_stereo is None \
        else np.asarray(p.is_stereo, bool).copy()
    out = np.full((Tn, 4, 22), -1, np.int8)
    tab = np.zeros(Tn, np.int8)
    if not isg.any():
        return out, isg, tab
    lsf = bool(p.lsf_granules) and p.lsf_is_scale is not None
    ms = np.asarray(p.ms_stereo, bool).astype(np.int8)
    if lsf:
        tab = np.where(isg, 2 + 2 * np.maximum(p.lsf_is_scale, 0) + ms,
                       0).astype(np.int8)
    else:
        tab = np.where(isg, ms, 0).astype(np.int8)
    sr = p.header.sr_idx
    long_win = T.BAND_INDEX_ISO[sr]
    width_s = T.BAND_WIDTH_SHORT_ISO[sr]
    sfl = p.scale_fac_l      # (F,2,2,22)
    sfs = p.scale_fac_s      # (F,2,2,3,13)
    ill_mode = T.lsf_is_illegal_mode() if lsf else "iso"
    for t in np.flatnonzero(isg):
        f, gr = divmod(int(t), 2)
        right = p.raw_samples[f, gr, 1]
        short = bt_ct[1, t] == 2
        if not lsf:
            illegal = np.full((3, 22), 7, np.int8)
        elif ill_mode == "iso":
            illegal = p.lsf_is_illegal[t]
        elif ill_mode == "mpg123":
            illegal = np.full((3, 22), 7, np.int8)
        else:                       # ffmpeg: nothing illegal
            illegal = np.full((3, 22), -2, np.int8)
        if short and mixed_ct[1, t]:
            # mixed blocks: per-window zero tails over the short bands
            # (3..12, starting at the walk boundary S) + long-prefix bands
            # that sit above the WHOLE right spectrum's last content
            # (validated vs mpg123/avcodec on crafted IS+mixed streams,
            # tests/test_mixed_blocks.py::test_is_mixed*)
            s_mix, _ = _mix_geometry(sr)
            n_long = 6 if lsf else 8
            zero = np.zeros((3, 13), bool)
            pos = s_mix
            for sfb in range(3, 13):
                w = int(width_s[sfb])
                for win in range(3):
                    zero[win, sfb] = not right[
                        pos + win * w: pos + (win + 1) * w].any()
                pos += 3 * w
            for win in range(3):
                for sfb in range(3, 13):
                    if zero[win, sfb]:
                        ip = int(sfs[f, gr, 1, win, sfb]) if sfb < 12 \
                            else int(sfs[f, gr, 1, win, 11])
                        if ip != int(illegal[win, sfb]):
                            out[t, win, sfb] = ip
                blocked = False
                for sfb in range(12, 2, -1):
                    if not zero[win, sfb]:
                        blocked = True
                    elif blocked:
                        out[t, win, sfb] = -1
            nz = np.flatnonzero(right)
            rz = int(nz[-1]) + 1 if len(nz) else 0
            for sfb in range(n_long):
                if int(long_win[sfb]) >= rz:
                    ip = int(sfl[f, gr, 1, sfb])
                    if ip != int(illegal[0, sfb]):
                        out[t, 3, sfb] = ip
            continue
        if short:
            zero = np.zeros((3, 13), bool)
            pos = 0
            for sfb in range(13):
                w = int(width_s[sfb])
                for win in range(3):
                    zero[win, sfb] = not right[
                        pos + win * w: pos + (win + 1) * w].any()
                pos += 3 * w
            for win in range(3):
                for sfb in range(13):
                    if zero[win, sfb]:
                        ip = int(sfs[f, gr, 1, win, sfb]) if sfb < 12 \
                            else int(sfs[f, gr, 1, win, 11])
                        if ip != int(illegal[win, sfb]):
                            out[t, win, sfb] = ip
            # a window's IS region must be a contiguous tail: zero bands
            # that sit below a band with content stay on the MS/LR path
            # (illegal-position bands above the bound don't re-block it)
            for win in range(3):
                blocked = False
                for sfb in range(12, -1, -1):
                    if not zero[win, sfb]:
                        blocked = True
                    elif blocked:
                        out[t, win, sfb] = -1
        else:
            nz = np.flatnonzero(right)
            rz = int(nz[-1]) + 1 if len(nz) else 0
            for sfb in range(22):
                if int(long_win[sfb]) >= rz:
                    ip = (int(sfl[f, gr, 1, sfb]) if sfb < 21
                          else int(sfl[f, gr, 1, 20]))
                    if ip != int(illegal[0, sfb]):
                        out[t, 3, sfb] = ip
    return out, isg, tab


def _pack_raw_native(raw_samples: np.ndarray, F: int):
    """C++ int8 sample-plane pack (native/src/raw_pack.cpp); None -> NumPy."""
    from mp3stego_tpu_torch import native
    lib = native.get_lib()
    if lib is None or F == 0:
        return None
    raw = np.ascontiguousarray(raw_samples, dtype=np.int32)
    out = np.empty((2, 2 * F, 576), np.int8)
    cap = 4096
    while True:
        exc_t = np.empty(cap, np.int32)
        exc_ch = np.empty(cap, np.int8)
        exc_s = np.empty(cap, np.int16)
        exc_val = np.empty(cap, np.int16)
        n = int(lib.pack_raw_plane(raw.reshape(-1), F, out.reshape(-1),
                                   exc_t, exc_ch, exc_s, exc_val, cap))
        if n <= cap:
            return (out, exc_t[:n], exc_ch[:n], exc_s[:n], exc_val[:n])
        cap = n  # rare: many linbits samples; retry with the exact count


def host_prepare(p, native_pack: bool = True, raw: bool = True) -> dict:
    """Turn a ParsedMP3 into the device-plane input dict.

    Only per-granule side-info fields cross to the device (a few hundred bytes
    per granule); the per-sample exponent maps are reconstructed on the
    device from static walk tables — host->device traffic is dominated by the
    int8 Huffman sample plane.

    The int8 sample-plane packing (the only pass over the ~full-file int32
    tensor) runs in C++ when the native library is loadable (one fused pass vs
    three NumPy passes); ``native_pack=False``
    forces the NumPy oracle. Exception list order differs between the two
    (t-major vs ch-major) — downstream is a scatter, so order is free.
    ``raw=False`` leaves the sample plane out (``RAW_KEYS``): the device
    Huffman decode (``ops/huffman_device``) supplies it on the device as
    ``raw_dense``.

    Its two passes are the spans ``prepare.pack`` (the sample plane) and
    ``prepare.tables`` (the per-granule fields and the walk tables; counts
    ``short_granules``, the (channel, granule)s of block type 2, and
    ``ms_granules``, the mid/side granules)."""
    F = p.num_frames
    sr = p.header.sr_idx
    G = F * 2  # time-ordered granules

    # (F,2,2,...) -> (2ch, T=2F, ...) time order = frame-major, gr-within-frame
    def to_ct(a):
        return np.ascontiguousarray(np.moveaxis(a, 2, 0).reshape((2, G) + a.shape[3:]))

    # Huffman sample plane as int8 + sparse int16 escapes: almost all values
    # are |x| <= 15; only linbits samples exceed int8. This halves (vs int16)
    # the dominant host->device transfer.
    with span("prepare.pack"):
        packed = _pack_raw_native(p.raw_samples, F) \
            if raw and native_pack else None
        if packed is not None:
            raw_i8, exc_t, exc_ch, exc_s, exc_val = packed
        elif raw:
            r = to_ct(p.raw_samples)                # (2, T, 576) int32
            exc_ch, exc_t, exc_s = np.nonzero((r > 127) | (r < -128))
            exc_val = r[exc_ch, exc_t, exc_s].astype(np.int16)
            raw_i8 = np.clip(r, -128, 127).astype(np.int8)

    with span("prepare.tables") as sp:
        bt = to_ct(p.block_type)                    # (2, T)
        mixed = to_ct(p.mixed_block_flag).astype(bool)

        # per-granule walk mode: 0 long, 1 short (bt==2), 2 the reference's
        # mixed walk (kept for REF_MIXED=1 and for mixed flags on non-short
        # block types, where the reference's sfb>=8 branch is what executes),
        # 3 ISO mixed (bt==2 + mixed_block_flag, the default decode)
        mode = np.where(bt == 2, 1, np.where(mixed, 2, 0)).astype(np.int8)
        if _iso_mixed_on(sr):
            mode = np.where((bt == 2) & mixed, 3, mode).astype(np.int8)
        walk_is_short, walk_sfb, walk_win, pre_ext = _walk_maps(
            sr, _iso_bands(sr))
        slot_exp, slot_is = _slot_maps(walk_is_short, walk_sfb, walk_win)
        is_pos, is_mask, is_tab = _intensity_positions(p, bt, mixed)
        s_mix, k_mix = _mix_geometry(sr)
        col = np.arange(576)
        if sp is not None:
            count("short_granules", int(np.count_nonzero(bt == 2)))
            count("ms_granules", int(np.count_nonzero(p.ms_stereo)))

        planes = {} if not raw else dict(
            raw_i8=raw_i8,
            exc_t=exc_t.astype(np.int32),
            exc_ch=exc_ch.astype(np.int8),
            exc_s=exc_s.astype(np.int16),
            exc_val=exc_val)
        return dict(
            is_pos=is_pos,                               # (T,4,22) int8
            is_mask=is_mask,                             # (T,) bool
            is_tab=is_tab,                               # (T,) int8 coef row
            **planes,
            mode=mode,
            gg=to_ct(p.global_gain).astype(np.int16),
            sfscale=to_ct(p.scale_fac_scale).astype(np.int8),
            pre=to_ct(p.pre_flag).astype(np.int8),
            sbg=to_ct(p.sub_block_gain).astype(np.int8),     # (2, T, 3)
            sfl=to_ct(p.scale_fac_l).astype(np.int8),        # (2, T, 22)
            sfs=np.ascontiguousarray(
                to_ct(p.scale_fac_s).reshape(2, G, 39)).astype(np.int8),
            reorder_mask=((bt == 2) | mixed),            # (2,T)
            ms_mask=np.asarray(p.ms_stereo, bool),       # (T,) per granule
            # sine_block row: block_type, except ISO-mixed granules whose long
            # subbands window with block_type 0 (the long-path result is only
            # consumed for those subbands; pure short granules never read it)
            win_row=np.where(mode == 3, 0, bt).astype(np.int8),
            is_short_blk=(bt == 2),
            reorder_perm=_reorder_perm(sr, _iso_bands(sr)),
            walk_is_short=walk_is_short,                 # (4,576)
            walk_sfb=walk_sfb,
            walk_win=walk_win,
            pre_ext=pre_ext,
            slot_exp=slot_exp,                           # (4,576) int16
            slot_is=slot_is,                             # (4,576) int16
            # ISO-mixed statics: the short/reordered region (col >= S); the
            # columns whose full-alias result must revert to the raw spectrum
            # (boundary K's lower butterfly half, 18K-8..18K-1 — only
            # butterflies 1..K-1 apply to mixed blocks); the 8 kHz-only
            # unreordered middle (cols 18K..S-1, strided short-window read —
            # see granule_blocks); and the subbands decoded with long windows
            # (band < K)
            mix_short_cols=(col >= s_mix),               # (576,)
            mix_raw_cols=((col >= 18 * k_mix - 8) & (col < 18 * k_mix)),
            mix_lin_cols=((col >= 18 * k_mix) & (col < s_mix)),
            mix_long_band=(np.arange(32) < k_mix),       # (32,)
        )


def exponent_indices(prep, xp=np):
    """Per-sample requantize exponent indices from per-granule fields
    (re_quantize's exp1/exp2 walk, Frame.py:176-208), for the NumPy parity
    plane. Inputs are narrow ints; everything upcasts to int32 before
    arithmetic."""
    mode = prep["mode"].astype(xp.int32)
    is_short = prep["walk_is_short"][mode].astype(bool)     # (2,T,576)
    sfb = prep["walk_sfb"][mode].astype(xp.int32)
    win = prep["walk_win"][mode].astype(xp.int32)

    sbg_s = xp.take_along_axis(prep["sbg"].astype(xp.int32), win, axis=2)
    exp1 = prep["gg"].astype(xp.int32)[..., None] - 210 \
        - xp.where(is_short, 8 * sbg_s, 0)

    sf_short = xp.take_along_axis(prep["sfs"].astype(xp.int32),
                                  win * 13 + sfb, axis=2)
    sfb_c = xp.minimum(sfb, 21)
    sf_long = xp.take_along_axis(prep["sfl"].astype(xp.int32), sfb_c, axis=2) \
        + prep["pre"].astype(xp.int32)[..., None] \
        * prep["pre_ext"].astype(xp.int32)[sfb_c]
    mult2 = xp.where(prep["sfscale"].astype(xp.int32) == 0, 1, 2)[..., None]
    exp2x2 = mult2 * xp.where(is_short, sf_short, sf_long)
    return (exp1 + _EXP1_OFF).astype(xp.int32), exp2x2.astype(xp.int32)


# input dict key groups (the host_prepare schema shared with the JAX package)
T_AXIS1_KEYS = ("raw_i8", "mode", "gg", "sfscale", "pre", "sbg", "sfl", "sfs",
                "reorder_mask", "win_row", "is_short_blk")
T_AXIS0_KEYS = ("ms_mask", "is_mask", "is_pos", "is_tab")
# sparse int16 escape values for the rare |sample| > 127 (linbits) entries;
# padded entries use an out-of-bounds index and are dropped by the scatter
EXC_KEYS = ("exc_t", "exc_ch", "exc_s", "exc_val")
# the sample plane; a prep without it carries "raw_dense" (2, T, 576) int32
# on the device instead (ops/huffman_device)
RAW_KEYS = ("raw_i8",) + EXC_KEYS
CONST_KEYS = ("reorder_perm", "walk_is_short", "walk_sfb", "walk_win",
              "pre_ext", "slot_exp", "slot_is", "mix_short_cols",
              "mix_raw_cols", "mix_lin_cols", "mix_long_band")
ALL_KEYS = T_AXIS1_KEYS + T_AXIS0_KEYS + EXC_KEYS + CONST_KEYS
# a torch prep (``prep_to_torch``) adds the escapes' granule index
# (``index_escapes``) to the host schema
TORCH_KEYS = ALL_KEYS + ("exc_start",)


def dense_raw(prep) -> np.ndarray:
    """Reconstruct the dense int32 Huffman sample tensor from the int8 plane +
    sparse int16 exceptions."""
    raw = prep["raw_i8"].astype(np.int32)
    ch, tt = raw.shape[0], raw.shape[1]
    flat = raw.reshape(-1)
    idx = ((prep["exc_ch"].astype(np.int64) * tt
            + prep["exc_t"].astype(np.int64)) * 576
           + prep["exc_s"].astype(np.int64))
    ok = prep["exc_t"] < tt
    flat[idx[ok]] = prep["exc_val"][ok].astype(np.int32)
    return flat.reshape(ch, tt, 576)


# ------------------------------------------------------------------ torch plane


def index_escapes(prep: dict) -> dict:
    """``prep`` with its linbits escapes in granule order (stable), those at
    ``exc_t >= T`` (a concat batch's padding) dropped, and ``exc_start``
    (T + 1,) int32: granule t's escapes are ``exc_*[exc_start[t]:
    exc_start[t + 1]]``, the range each CTA of ``csrc/granule.cu`` reads. A
    prep without the int8 plane comes back as it is."""
    if "raw_i8" not in prep:
        return prep
    tt = prep["raw_i8"].shape[1]
    exc_t = np.asarray(prep["exc_t"])
    order = np.argsort(exc_t, kind="stable")
    order = order[exc_t[order] < tt]
    out = dict(prep)
    for k in EXC_KEYS:
        out[k] = np.ascontiguousarray(np.asarray(prep[k])[order])
    out["exc_start"] = np.searchsorted(
        out["exc_t"], np.arange(tt + 1)).astype(np.int32)
    return out


def prep_to_torch(prep: dict, device, lanes: tuple = None) -> dict:
    """``host_prepare``'s numpy dict -> tensors on ``device``, keyed by
    ``TORCH_KEYS``.

    Takes the dict that ``host_prepare`` (of either package) returns, keyed
    by ``ALL_KEYS`` (less ``RAW_KEYS`` for ``raw=False``), and indexes its
    escapes by granule (``index_escapes``); the narrow int8/int16 planes and
    bool masks cross as they are, on the card in one staged copy
    (``utils.transfer.put_tree``). ``lanes``, a parse's (words, fields) for
    the card's sample scan, cross in the same copy as ``"words"`` and
    ``"fields"`` (``scan_samples`` takes them)."""
    prep = index_escapes(prep)
    tree = {k: prep[k] for k in TORCH_KEYS if k in prep}
    if lanes is not None:
        tree["words"], tree["fields"] = lanes
    return put_tree(tree, device)


def scan_lanes(p, device) -> tuple:
    """The parse's ``lanes`` where its samples are to be scanned on
    ``device``: a CUDA device and a parse whose samples the native light
    parse left to the card (``ParsedMP3.samples_pending``); else None, and
    the host's sample plane is read."""
    if (torch.device(device).type == "cuda" and p.lanes is not None
            and p.samples_pending):
        return p.lanes
    return None


def scan_samples(prep: dict, frames: int) -> dict:
    """``prep`` (``prep_to_torch`` with lanes) with its ``words`` and
    ``fields`` replaced by the sample plane they scan to, ``raw_dense``
    (``ops/huffman_device.decode_samples``: ``csrc/huffman.cu`` on the
    card). Recorded as the span ``samples.device`` (count ``frames``)."""
    from mp3stego_tpu_torch.ops import huffman_device as hd
    with span("samples.device", frames=frames):
        prep["raw_dense"] = hd.decode_samples(prep.pop("words"),
                                              prep.pop("fields"))
    return prep


def imdct_symmetric(c_long_t: torch.Tensor, c_short_t: torch.Tensor) -> bool:
    """Whether the IMDCT cosines, ``c_long_t`` (18, 36) and ``c_short_t``
    (6, 12) indexed [k][n], are exactly antisymmetric and symmetric as the
    float kernel computes them (csrc/granule.cu ``Layout``): C[k][17 - n] ==
    -C[k][n] for n < 9 and C[k][53 - n] == C[k][n] for 18 <= n < 27;
    S[k][5 - m] == -S[k][m] for m < 3 and S[k][17 - m] == S[k][m] for 6 <= m
    < 9. So the kernel computes 18 long and 6 short sums and mirrors the
    rest."""
    n = torch.arange(9, device=c_long_t.device)
    m = torch.arange(3, device=c_short_t.device)
    return (torch.equal(c_long_t[:, 17 - n], -c_long_t[:, n])
            and torch.equal(c_long_t[:, 35 - n], c_long_t[:, 18 + n])
            and torch.equal(c_short_t[:, 5 - m], -c_short_t[:, m])
            and torch.equal(c_short_t[:, 11 - m], c_short_t[:, 6 + m]))


@functools.lru_cache(maxsize=None)
def _consts(dtype: torch.dtype, device: torch.device, ref_start_window: bool):
    """Constant tables of the torch plane in ``dtype`` on ``device``, keyed
    on the start-window mode so MP3STEGO_TPU_REF_START_WINDOW flips are
    never served stale. The power tables are built on the host with
    Python's ``**`` (as ``decode_granules_np``) and copied over, never
    computed on the device. Raises if the float32 cosines lack the symmetry
    the kernel's float IMDCT relies on (:func:`imdct_symmetric`)."""
    f = functools.partial(torch.as_tensor, dtype=dtype, device=device)
    off1, off2, cs, ca = _alias_indices()
    c_long_t = f(T.imdct_long_cos().T.copy())                 # (18,36)
    c_short_t = f(T.imdct_short_cos().T.copy())               # (6,12)
    if dtype == torch.float32 and not imdct_symmetric(c_long_t, c_short_t):
        raise RuntimeError("the float32 IMDCT cosines are not exactly "
                           "symmetric; csrc/granule.cu's float IMDCT "
                           "relies on it")
    return SimpleNamespace(
        pow43=f([float(i) ** (4.0 / 3.0) for i in range(8207)]),
        # 2^(frac/4), frac in 0..3: the quarter-power factor of 2^(q/4)
        quarter=f([1.0, 2.0 ** 0.25, 2.0 ** 0.5, 2.0 ** 0.75]),
        # float64's exponent tables, decode_granules_np's e1lut and e2lut
        e1lut=f([2.0 ** ((i - _EXP1_OFF) / 4.0) for i in range(512)]),
        e2lut=f([2.0 ** (-(i / 2.0)) for i in range(_EXP2X2_MAX)]),
        # a 0-dim device tensor, not a Python float: CUDA turns division by
        # a host scalar into a multiply by its reciprocal, which is not the
        # reference's rounding
        sqrt2=f(SQRT2),
        zero=f(0.0),
        is_coef=f(_is_coef()),                                # (6,2,16)
        off1=torch.as_tensor(off1, dtype=torch.int64, device=device),
        off2=torch.as_tensor(off2, dtype=torch.int64, device=device),
        cs=f(cs), ca=f(ca),
        c_long_t=c_long_t, c_short_t=c_short_t,
        sine=f(T.sine_block()),                               # (4,36)
    )


def _c(dtype, device):
    return _consts(dtype, torch.device(device), T.ref_start_window())


def _pow2_int(e: torch.Tensor, dtype) -> torch.Tensor:
    """Exact 2**e for integer e within the normal range of ``dtype``, built
    by writing the exponent bits directly (f32: e in [-126, 127])."""
    if dtype == torch.float64:
        return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _capture(stages, name, x):
    if stages is not None:
        stages[name] = x.clone()


def _plane_device(prep: dict) -> torch.device:
    """The device of a prep's sample plane (``raw_i8`` or ``raw_dense``)."""
    return (prep["raw_dense"] if "raw_dense" in prep else prep["raw_i8"]).device


# what K2 reads besides the sample plane, in csrc/granule.cu's order: the
# per-granule side information and the static maps with the types and
# shapes host_prepare gives them ("T": the granule count), then the plane's
# tables (``_consts`` fields) in the kernel's dtype with their sizes
_SIDE = (
    ("mode", torch.int8, (2, "T")),
    ("gg", torch.int16, (2, "T")),
    ("sfscale", torch.int8, (2, "T")),
    ("pre", torch.int8, (2, "T")),
    ("sbg", torch.int8, (2, "T", 3)),
    ("sfl", torch.int8, (2, "T", 22)),
    ("sfs", torch.int8, (2, "T", 39)),
    ("win_row", torch.int8, (2, "T")),
    ("is_short_blk", torch.bool, (2, "T")),
    ("reorder_mask", torch.bool, (2, "T")),
    ("ms_mask", torch.bool, ("T",)),
    ("is_mask", torch.bool, ("T",)),
    ("is_pos", torch.int8, ("T", 4, 22)),
    ("is_tab", torch.int8, ("T",)),
    ("slot_exp", torch.int16, (4, 576)),
    ("slot_is", torch.int16, (4, 576)),
    ("reorder_perm", torch.int32, (576,)),
    ("pre_ext", torch.int32, (22,)),
    ("mix_short_cols", torch.bool, (576,)),
    ("mix_raw_cols", torch.bool, (576,)),
    ("mix_lin_cols", torch.bool, (576,)),
    ("mix_long_band", torch.bool, (32,)),
)
_TABLES = (("pow43", 8207), ("e1lut", 512), ("e2lut", 64), ("quarter", 4),
           ("is_coef", 192), ("cs", 248), ("ca", 248), ("c_long_t", 648),
           ("c_short_t", 72), ("sine", 144), ("sqrt2", 1))


# the int8 plane's escapes as csrc/granule.cu reads them ("N": their count)
_ESCAPES = (
    ("exc_start", torch.int32, ("T+1",)),
    ("exc_t", torch.int32, ("N",)),
    ("exc_ch", torch.int8, ("N",)),
    ("exc_s", torch.int16, ("N",)),
    ("exc_val", torch.int16, ("N",)),
)


def _check_prep(prep: dict, dtype) -> torch.Tensor:
    """What ``granule_blocks`` takes, on any device: float32 or float64, a
    sample plane (2, T, 576) (``raw_dense`` int32, or ``raw_i8`` int8 with
    its escapes and their index, ``_ESCAPES``), every side key of ``_SIDE``
    with its type and shape, all C-contiguous on the plane's device, which is
    the CPU or a CUDA card. Returns the plane."""
    if dtype not in _ENTRY:
        raise ValueError(f"granule_blocks takes float32 or float64, got "
                         f"{dtype}")
    if "raw_dense" in prep:
        plane, want, keys = prep["raw_dense"], torch.int32, _SIDE
    elif "raw_i8" in prep:
        plane, want, keys = prep["raw_i8"], torch.int8, _ESCAPES + _SIDE
        missing = [k for k, _, _ in _ESCAPES if k not in prep]
        if missing:
            raise ValueError(f"the raw_i8 plane comes without {missing} "
                             f"(prep_to_torch adds exc_start)")
    else:
        raise ValueError("the prep has no sample plane (raw_i8 or raw_dense)")
    if plane.dtype != want or plane.dim() != 3 or plane.shape[0] != 2 \
            or plane.shape[2] != 576:
        raise ValueError(f"the sample plane must be (2, T, 576) {want}, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    dev = plane.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"granule_blocks runs on CPU or CUDA tensors, got "
                         f"{dev}")
    tt = plane.shape[1]
    sizes = {"T": tt, "T+1": tt + 1,
             "N": prep["exc_t"].numel() if "exc_t" in prep else 0}
    for key, kind, shape in (("raw", want, (2, tt, 576)),) + keys:
        v = plane if key == "raw" else prep.get(key)
        if v is None:
            raise ValueError(f"the prep has no {key}")
        shape = tuple(sizes.get(s, s) for s in shape)
        if v.dtype != kind or tuple(v.shape) != shape:
            raise ValueError(f"{key} must be {shape} {kind}, got "
                             f"{tuple(v.shape)} {v.dtype}")
        if v.device != dev:
            raise ValueError(f"{key} lies on {v.device}, the plane on {dev}")
        if not v.is_contiguous():
            raise ValueError(f"granule_blocks takes C-contiguous tensors; "
                             f"{key} is not")
    return plane


def _kernel_tables(dtype, device) -> tuple:
    """The plane's tables in ``_TABLES`` order, ``_consts`` fields as they
    are (one C-contiguous tensor each in ``dtype`` on ``device``)."""
    c = _c(dtype, device)
    return tuple(getattr(c, name) for name, _ in _TABLES)


def kernel_inputs(prep: dict, dtype) -> list:
    """What ``csrc/granule.cu`` reads, in its order: the sample plane, the
    escapes with their index (five ``None`` for the int32 plane, which has
    none), the side information and the tables. A checked prep."""
    plane = prep["raw_dense"] if "raw_dense" in prep else prep["raw_i8"]
    escapes = [None] * len(_ESCAPES) if plane.dtype == torch.int32 \
        else [prep[k] for k, _, _ in _ESCAPES]
    return [plane] + escapes + [prep[k] for k, _, _ in _SIDE] \
        + list(_kernel_tables(dtype, plane.device))


def granule_blocks(prep: dict, dtype, stages: dict = None) -> torch.Tensor:
    """Granule-local half of the decode plane: requantize -> MS/intensity
    stereo -> reorder/alias -> windowed IMDCT blocks. Returns (2, T, 32, 36)
    in ``dtype`` on the prep's device.

    A CUDA prep launches the hand-written kernel ``csrc/granule.cu`` once on
    the current stream, after ``_check_prep`` (a fault raises; nothing falls
    back); the kernel reads the int8 plane and its escapes, or the int32
    ``raw_dense`` plane, as they are. ``stages`` (a dict) is then filled by
    the plain stages run beside it, and the blocks returned are the
    kernel's. A CPU prep takes :func:`granule_blocks_torch`."""
    global launches
    plane = _check_prep(prep, dtype)
    if plane.device.type == "cpu":
        return granule_blocks_torch(prep, dtype, stages)
    if stages is not None:
        granule_blocks_torch(prep, dtype, stages)
    tt = plane.shape[1]
    if tt == 0:
        return torch.empty((2, 0, 32, 36), dtype=dtype, device=plane.device)
    out = _launch(prep, dtype, plane)
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def occupancy(device: torch.device, dtype, wide: bool) -> dict:
    """What the runtime gives the kernel's instantiation for ``dtype`` and
    the sample plane (``wide``: int32, else int8) on ``device``: the CTAs
    an SM holds (``ctas``, at its registers and shared memory), its warps a
    CTA (``warps``) and its bytes of dynamic shared memory a CTA
    (``smem``). Builds the kernel; raises on a CUDA error."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("granule", _SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = lib.granule_occupancy(int(dtype == torch.float64), int(wide),
                                   *(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"granule occupancy query failed: CUDA error {rc}")
    ctas, warps, smem = (v.value for v in out)
    if ctas < 1:
        raise RuntimeError("granule_kernel fits no CTA on an SM")
    return dict(ctas=ctas, warps=warps, smem=smem)


@functools.lru_cache(maxsize=None)
def _grid_cap(device: torch.device, dtype, wide: bool) -> int:
    """The persistent grid: every SM full of CTAs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * occupancy(device, dtype, wide)["ctas"]


def _launch(prep: dict, dtype, plane: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/granule.cu`` on the current stream for a checked
    prep of T >= 1 granules: at most ``_grid_cap`` persistent CTAs, each a
    contiguous run of granule indices. Returns the (2, T, 32, 36) blocks;
    raises if the launch fails."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("granule", _SIGNATURES)
    tt = plane.shape[1]
    out = torch.empty((2, tt, 32, 36), dtype=dtype, device=plane.device)
    inputs = kernel_inputs(prep, dtype)
    if inputs[0].data_ptr() % 16:        # the kernel copies 16-byte chunks
        inputs[0] = inputs[0].clone()
    wide = plane.dtype == torch.int32
    n_exc = 0 if wide else prep["exc_t"].numel()
    ptrs = (ctypes.c_void_p * len(inputs))(
        *[None if t is None else t.data_ptr() for t in inputs])
    blocks = min(tt, _grid_cap(plane.device, dtype, wide))
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    with torch.cuda.device(plane.device), record_function("granule"):
        rc = getattr(lib, _ENTRY[dtype])(ptrs, len(inputs), tt, int(wide),
                                         n_exc, blocks, out.data_ptr(),
                                         stream)
    if rc != 0:
        raise RuntimeError(f"granule_blocks kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def granule_blocks_torch(prep: dict, dtype, stages: dict = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`granule_blocks` on the prep's device:
    the four stages as eager ops. Returns (2, T, 32, 36).

    Each stage runs under a ``torch.profiler.record_function`` named like the
    JAX package's ``jax.named_scope`` (requantize, stereo, reorder_alias,
    imdct), so the two packages' traces line up. ``stages`` (a dict) captures
    ``requant`` and ``pre_imdct`` as in ``decode_granules_np``."""
    x = _requantize_stage(prep, dtype)
    _capture(stages, "requant", x)
    x = _stereo_stage(prep, x, dtype)
    x = _reorder_alias_stage(prep, x, dtype)
    _capture(stages, "pre_imdct", x)
    return _imdct_stage(prep, x, dtype)


def _requantize_stage(prep, dtype):
    # Frame.py:157-218: sign * |x|^(4/3) * 2^(exp1/4 - exp2x2/2). The
    # per-band exponents are formed on the 61-slot grid (22 long sfb + 3x13
    # short) and gathered out to samples by slot_exp. float32: 2^(q/4) for
    # q = exp1 - 2*exp2x2 as 2^(q>>2) * 2^((q&3)/4), both factors exact.
    # float64: decode_granules_np's ((sign*pow43) * e1lut) * e2lut.
    with record_function("requantize"):
        c = _c(dtype, _plane_device(prep))
        if "raw_dense" in prep:
            # the device Huffman decode's int32 plane: exact table rows
            r = prep["raw_dense"]                            # (2,T,576)
            a = c.pow43[r.abs().long()]
        else:
            r = prep["raw_i8"].to(torch.int32)               # (2,T,576)
            ch_, tt_ = r.shape[0], r.shape[1]
            # |x| <= 128 on the int8 plane (the sign survives the clip);
            # the linbits escapes overwrite their samples with exact rows
            a = c.pow43[r.abs().long()]
            exc_t = prep["exc_t"].long()
            ok = exc_t < tt_
            idx = ((prep["exc_ch"].long() * tt_ + exc_t) * 576
                   + prep["exc_s"].long())
            a.view(-1)[idx[ok]] = c.pow43[prep["exc_val"].long().abs()[ok]]

        gg = prep["gg"].to(torch.int32)                      # (2,T)
        sbg = prep["sbg"].to(torch.int32)                    # (2,T,3)
        pre_l = (prep["pre"].to(torch.int32)[..., None]
                 * prep["pre_ext"].to(torch.int32)[:22])
        sf_long = prep["sfl"].to(torch.int32) + pre_l        # (2,T,22)
        mult2 = torch.where(prep["sfscale"] == 0, 1, 2).to(torch.int32)
        exp1_slot = torch.cat(
            [(gg - 210)[..., None].expand(gg.shape + (22,)),
             (gg[..., None] - 210 - 8 * sbg).repeat_interleave(13, dim=-1)],
            dim=-1)                                          # (2,T,61)
        val_slot = torch.cat([sf_long, prep["sfs"].to(torch.int32)], dim=-1)
        exp1_idx = (exp1_slot + _EXP1_OFF).clamp(0, 511)
        exp2x2 = (mult2[..., None] * val_slot).clamp(0, _EXP2X2_MAX - 1)
        slot = prep["slot_exp"].long()[prep["mode"].long()]  # (2,T,576)
        signed = torch.where(r < 0, -a, a)
        if dtype == torch.float64:
            e1 = torch.gather(c.e1lut[exp1_idx.long()], 2, slot)
            e2 = torch.gather(c.e2lut[exp2x2.long()], 2, slot)
            return (signed * e1) * e2
        q_slot = exp1_idx - _EXP1_OFF - 2 * exp2x2
        q = torch.gather(q_slot, 2, slot)
        scale = c.quarter[(q & 3).long()] * _pow2_int(q >> 2, dtype)
        return signed * scale


def _stereo_stage(prep, x, dtype):
    with record_function("stereo"):
        c = _c(dtype, x.device)
        # ---- MS stereo (Frame.py:561-572): a true division by sqrt(2)
        mid, side = x[0], x[1]
        l = (mid + side) / c.sqrt2
        r = (mid - side) / c.sqrt2
        x = torch.where(prep["ms_mask"][None, :, None], torch.stack([l, r]), x)

        # ---- intensity stereo overlay (beyond-reference; validated vs
        # mpg123): flagged bands replace BOTH channels from the left
        # spectrum, L' = L*A[pos], R' = L*B[pos]; other samples keep the
        # MS/LR result bit for bit. Positions sit on the (4,22)=88-slot grid
        # (window rows 0..2 short, row 3 long), gathered out by slot_is.
        if not bool(prep["is_mask"].any()):
            return x
        mode1 = prep["mode"][1].long()
        tt1 = mode1.shape[0]
        pos = torch.gather(prep["is_pos"].long().reshape(tt1, 88), 1,
                           prep["slot_is"].long()[mode1])    # (T,576)
        active = (pos >= 0) & prep["is_mask"][:, None]
        row = prep["is_tab"].long()[:, None]
        pc = pos.clamp(0, 15)
        left0 = x[0]
        lr = torch.stack([left0 * c.is_coef[row, 0, pc],
                          left0 * c.is_coef[row, 1, pc]])
        return torch.where(active[None], lr, x)


def _reorder_alias_stage(prep, x, dtype):
    # ---- reorder (short) / alias reduction (long) / ISO-mixed blend.
    # Mixed (mode 3) granules take a 3-way column split: the short region
    # (col >= S) reorders exactly like a pure short granule (geometry note
    # in _mix_geometry); cols below 18K-8 take the full-alias result; cols
    # 18K-8..S-1 revert to the raw spectrum (no butterfly at or above
    # boundary K, and at 8 kHz the unreordered long-walk samples 36..71
    # feed short windows raw — the mpg123/ffmpeg behavior).
    with record_function("reorder_alias"):
        c = _c(dtype, x.device)
        perm = prep["reorder_perm"].long()
        reord = torch.where(perm >= 0, x[..., perm.clamp(min=0)], c.zero)
        # both butterfly inputs are gathered copies, read before either write
        s1 = x[..., c.off1]
        s2 = x[..., c.off2]
        aliased = x.clone()
        aliased[..., c.off1] = s1 * c.cs - s2 * c.ca
        aliased[..., c.off2] = s2 * c.cs + s1 * c.ca
        m3 = (prep["mode"] == 3)[..., None]                  # (2,T,1)
        sel_reord = torch.where(m3, prep["mix_short_cols"][None, None],
                                prep["reorder_mask"][..., None])
        out = torch.where(sel_reord, reord, aliased)
        # 8 kHz-only middle (cols 18K..S-1 = 36..71): long-walk, UNREORDERED
        # spectrum under short windows — a per-18-chunk transpose in this
        # plane's window-major layout. mix_lin_cols is empty at every other
        # samplerate.
        nch0, nt0 = x.shape[0], x.shape[1]
        mid = x[..., 36:72].reshape(nch0, nt0, 2, 6, 3).transpose(-1, -2)
        mid_full = torch.cat(
            [x[..., :36], mid.reshape(nch0, nt0, 36), x[..., 72:]], dim=-1)
        out = torch.where(m3 & prep["mix_lin_cols"][None, None], mid_full, out)
        return torch.where(m3 & prep["mix_raw_cols"][None, None], x, out)


def _imdct_stage(prep, x, dtype):
    # ---- IMDCT + windowing (Frame.py:106-154); x layout is [band*18 + k]
    with record_function("imdct"):
        c = _c(dtype, x.device)
        ch, tt = x.shape[0], x.shape[1]
        s = x.reshape(ch, tt, 32, 18)
        # sums in the reference's ascending k (Frame.py:126-130), in both
        # dtypes: the kernel's order, and a row's result is the same in any
        # batch
        xi_long = ascending_matmul(s, c.c_long_t)            # (ch,T,32,36)
        win_long = c.sine[prep["win_row"].long().clamp(0, 3)]  # (2,T,36)
        blk_long = xi_long * win_long[:, :, None, :]

        # short path: 3 windows of 6 inputs -> 12 outputs each, merged
        xi_s = ascending_matmul(s.reshape(ch, tt, 32, 3, 6), c.c_short_t)
        xi_s = xi_s * c.sine[2, :12]                         # (ch,T,32,3,12)
        z6 = x.new_zeros((ch, tt, 32, 6))
        blk_short = torch.cat([
            z6,
            xi_s[..., 0, 0:6],
            xi_s[..., 0, 6:12] + xi_s[..., 1, 0:6],
            xi_s[..., 1, 6:12] + xi_s[..., 2, 0:6],
            xi_s[..., 2, 6:12],
            z6,
        ], dim=-1)

        # ISO-mixed granules keep long (block_type 0) windows on the first K
        # subbands; win_row is already 0 for them (host_prepare)
        m3 = (prep["mode"] == 3)[..., None]
        short_band = prep["is_short_blk"][..., None] \
            & ~(m3 & prep["mix_long_band"][None, None])       # (2,T,32)
        return torch.where(short_band[..., None], blk_short, blk_long)


def synth_from_blocks(blk: torch.Tensor, stages: dict = None,
                      out: str = "float", channels: int = 1,
                      halo: torch.Tensor = None) -> torch.Tensor:
    """Sequential half of the decode plane: IMDCT overlap-add -> frequency
    inversion -> polyphase synthesis, one fused kernel over the rows of
    ``blk`` (rows, T, 32, 36) in its dtype (``ops.synth.synth_fused``), from
    stream start, or after ``halo`` (rows, 2, 32, 36), the blocks of the
    two granules before granule 0 of each row (``parallel.frame_shard``).

    ``stages`` captures ``post_imdct`` and ``pre_synth`` as in
    ``decode_granules_np`` (computed beside the kernel, which keeps them in
    shared memory). Returns float PCM (rows, T, 576), or int16 (rows /
    channels, T * 576, channels) with ``out="int16"``."""
    if stages is not None:
        post, pre = overlap_freqinv(blk, halo)
        rows, tt = blk.shape[0], blk.shape[1]
        stages["post_imdct"] = post.reshape(rows, tt, 576).clone()
        stages["pre_synth"] = pre.reshape(rows, tt, 576).clone()
    with record_function("synth"):
        return synth_fused(blk, out, channels, halo)


def decode_granules(prep: dict, dtype=torch.float32, stages: dict = None,
                    files: int = 1, channels: int = 2,
                    out: str = "float") -> torch.Tensor:
    """Input dict (``prep_to_torch``) -> PCM in ``dtype`` (float32 or
    float64), on the prep's device: float (files * channels, T / files,
    576), file major, or with ``out="int16"`` the WAV samples (files,
    T / files * 576, channels), interleaved, converted by the synthesis
    kernel.

    ``files`` > 1 takes a concat batch (``parallel.batch_decode``: file i's
    granules start at ``i * T / files``): the granule half runs over the
    whole axis, synthesis on one row per (file, channel), so the kernel
    launches once and no IMDCT tail or V history reaches the next file.
    ``channels=1`` keeps channel 0 only."""
    rows = files * channels
    if _plane_device(prep).type == "cuda" and rows > MAX_SYNTH_ROWS:
        raise ValueError(f"{rows} (file, channel) rows exceed the synthesis "
                         f"kernel's {MAX_SYNTH_ROWS}")
    blk = granule_blocks(prep, dtype, stages)
    t = blk.shape[1] // files
    blk = blk[:channels].reshape(channels, files, t, 32, 36) \
        .transpose(0, 1).reshape(rows, t, 32, 36)
    return synth_from_blocks(blk, stages, out, channels)


def decode_granules_i16(prep: dict, dtype=torch.float32, files: int = 1,
                        channels: int = 2) -> torch.Tensor:
    """``decode_granules`` with the WAV int16 conversion and the channel
    interleave fused into the synthesis kernel: (files, T / files * 576,
    channels) int16."""
    return decode_granules(prep, dtype, files=files, channels=channels,
                           out="int16")


def decode_granules_np(prep: dict, stages: dict = None) -> np.ndarray:
    """Bit-exact float64 parity path: the same batched pipeline as
    ``decode_granules`` evaluated with NumPy on host.

    The IMDCT and synthesis sums accumulate in the reference's ascending
    order with separate mul/add roundings (Frame.py:65-218), so this path
    reproduces the reference float-for-float; library matmuls sum in another
    order. Pass ``stages={}`` to capture per-stage tensors for golden
    tests."""
    raw = dense_raw(prep)
    pow43 = np.array([float(i) ** (4.0 / 3.0) for i in range(8207)])
    e1lut = np.array([2.0 ** ((i - _EXP1_OFF) / 4.0) for i in range(512)])
    e2lut = np.array([2.0 ** (-(i / 2.0)) for i in range(_EXP2X2_MAX)])

    # requantize
    exp1_idx, exp2x2 = exponent_indices(prep, xp=np)
    ix = raw.astype(np.int64)
    sign = np.where(raw < 0, -1.0, 1.0)
    x = ((sign * pow43[np.abs(ix)])
         * e1lut[np.clip(exp1_idx, 0, 511)]) \
        * e2lut[np.clip(exp2x2, 0, _EXP2X2_MAX - 1)]
    if stages is not None:
        stages["requant"] = x.copy()

    # MS stereo
    l = (x[0] + x[1]) / SQRT2
    r = (x[0] - x[1]) / SQRT2
    ms = prep["ms_mask"][None, :, None]
    x = np.where(ms, np.stack([l, r]), x)

    # intensity stereo overlay (beyond-reference; validated vs mpg123):
    # flagged bands replace both channels from the left spectrum; other
    # samples keep the MS/LR result bit-for-bit
    if prep["is_mask"].any():
        mode1 = prep["mode"].astype(np.int32)[1]
        sfb_r = prep["walk_sfb"][mode1]                              # (T,576)
        win_r = np.where(prep["walk_is_short"][mode1].astype(bool),
                         prep["walk_win"][mode1], 3)
        tix = np.arange(sfb_r.shape[0])[:, None]
        pos = prep["is_pos"].astype(np.int32)[tix, win_r, sfb_r]
        active = (pos >= 0) & prep["is_mask"][:, None]
        coef = _is_coef()
        msr = prep["is_tab"].astype(np.int32)[:, None]    # (T,1) table row
        pc = np.clip(pos, 0, 15)
        cl = coef[msr, 0, pc]
        cr = coef[msr, 1, pc]
        left0 = x[0]
        x = np.where(active[None], np.stack([left0 * cl, left0 * cr]), x)

    # reorder / alias / ISO-mixed blend (same 3-way split as granule_blocks)
    perm = prep["reorder_perm"]
    reord = np.where(perm[None, None, :] >= 0,
                     np.take(x, np.maximum(perm, 0), axis=2), 0.0)
    off1, off2, cs, ca = _alias_indices()
    s1 = x[..., off1].copy()
    s2 = x[..., off2].copy()
    aliased = x.copy()
    aliased[..., off1] = s1 * cs - s2 * ca
    aliased[..., off2] = s2 * cs + s1 * ca
    m3 = (prep["mode"] == 3)
    sel_reord = np.where(m3[..., None], prep["mix_short_cols"][None, None],
                         prep["reorder_mask"][..., None])
    out = np.where(sel_reord, reord, aliased)
    # 8 kHz-only unreordered middle under short windows (see granule_blocks)
    nch0, nt0 = x.shape[0], x.shape[1]
    mid = np.swapaxes(x[..., 36:72].reshape(nch0, nt0, 2, 6, 3), -1, -2)
    mid_full = np.concatenate(
        [x[..., :36], mid.reshape(nch0, nt0, 36), x[..., 72:]], axis=-1)
    out = np.where(m3[..., None] & prep["mix_lin_cols"][None, None],
                   mid_full, out)
    x = np.where(m3[..., None] & prep["mix_raw_cols"][None, None], x, out)
    if stages is not None:
        stages["pre_imdct"] = x.copy()

    # IMDCT (ascending-k accumulation, Frame.py:126-130)
    nch, tt = x.shape[0], x.shape[1]
    s = x.reshape(nch, tt, 32, 18)
    c_long = T.imdct_long_cos()
    c_short = T.imdct_short_cos()
    sine = T.sine_block()
    xi_long = np.zeros(s.shape[:3] + (36,))
    for k in range(18):
        xi_long += s[..., k, None] * c_long[None, None, None, :, k]
    win_long = sine[np.clip(prep["win_row"], 0, 3)]
    blk_long = xi_long * win_long[:, :, None, :]

    s3 = s.reshape(nch, tt, 32, 3, 6)
    xi_s = np.zeros(s3.shape[:4] + (12,))
    for k in range(6):
        xi_s += s3[..., k, None] * c_short[None, None, None, None, :, k]
    xi_s = xi_s * sine[2][:12]
    z6 = np.zeros(xi_s.shape[:3] + (6,))
    blk_short = np.concatenate([
        z6, xi_s[..., 0, 0:6], xi_s[..., 0, 6:12] + xi_s[..., 1, 0:6],
        xi_s[..., 1, 6:12] + xi_s[..., 2, 0:6], xi_s[..., 2, 6:12], z6,
    ], axis=-1)
    short_band = prep["is_short_blk"][..., None] \
        & ~(m3[..., None] & prep["mix_long_band"][None, None])
    blk = np.where(short_band[..., None], blk_short, blk_long)

    head = blk[..., :18]
    tail = blk[..., 18:]
    prev = np.concatenate([np.zeros_like(tail[:, :1]), tail[:, :-1]], axis=1)
    y = head + prev
    if stages is not None:
        stages["post_imdct"] = y.reshape(nch, tt, 576).copy()

    y = y * _freq_inv_mask().reshape(32, 18)
    if stages is not None:
        stages["pre_synth"] = y.reshape(nch, tt, 576).copy()

    # synthesis: V matmul (ascending-j) + 16-tap FIR (ascending-j)
    n_mat = T.synth_filter_matrix()
    st = y.transpose(0, 1, 3, 2).reshape(nch, tt * 18, 32)
    v = np.zeros((nch, tt * 18, 64))
    for j in range(32):
        v += st[..., j, None] * n_mat[None, None, :, j]
    va_p = np.concatenate([np.zeros((nch, 15, 32)), v[..., :32]], axis=1)
    vb_p = np.concatenate([np.zeros((nch, 15, 32)), v[..., 32:]], axis=1)
    d_win = T.SYNTH_WINDOW.reshape(16, 32)
    ts_total = tt * 18
    pcm_steps = np.zeros((nch, ts_total, 32))
    for j in range(16):
        src = va_p if j % 2 == 0 else vb_p
        pcm_steps += src[:, 15 - j:15 - j + ts_total] * d_win[j]
    return pcm_steps.reshape(nch, tt, 576)


def _f64_tables():
    """C-contiguous float64 constant tables for the native f64 plane, keyed
    on the start-window mode so tests can flip
    MP3STEGO_TPU_REF_START_WINDOW without stale tables."""
    return _f64_tables_impl(T.ref_start_window())


@functools.lru_cache(maxsize=2)
def _f64_tables_impl(ref_start_window: bool):
    pow43 = np.array([float(i) ** (4.0 / 3.0) for i in range(8207)])
    e1lut = np.array([2.0 ** ((i - _EXP1_OFF) / 4.0) for i in range(512)])
    e2lut = np.array([2.0 ** (-(i / 2.0)) for i in range(_EXP2X2_MAX)])
    cc = lambda a: np.ascontiguousarray(a, np.float64)
    return (cc(pow43), cc(e1lut), cc(e2lut),
            cc(T.ALIAS_CS), cc(T.ALIAS_CA),
            cc(T.imdct_long_cos()), cc(T.imdct_short_cos()),
            cc(T.sine_block()), cc(T.synth_filter_matrix()),
            cc(T.SYNTH_WINDOW.reshape(16, 32)))


def _native_plane_args(p):
    """(lib, marshalled argument tuple) for the native f64/i16 decode plane,
    or None when the native library is unavailable."""
    from mp3stego_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "decode_plane_f64"):
        return None
    sr = p.header.sr_idx
    walk_is_short, walk_sfb, walk_win, pre_ext = _walk_maps(sr, _iso_bands(sr))
    bt_ct = np.moveaxis(p.block_type, 2, 0).reshape(2, -1)
    mixed_ct = np.moveaxis(p.mixed_block_flag, 2, 0).reshape(2, -1) != 0
    is_pos, is_mask, is_tab = _intensity_positions(p, bt_ct, mixed_ct)
    c32 = lambda a: np.ascontiguousarray(a, np.int32)
    return lib, (
        p.num_frames,
        c32(p.raw_samples), c32(p.block_type), c32(p.mixed_block_flag),
        c32(p.global_gain), c32(p.scale_fac_scale), c32(p.pre_flag),
        c32(p.sub_block_gain), c32(p.scale_fac_l), c32(p.scale_fac_s),
        np.ascontiguousarray(p.ms_stereo, np.uint8),
        np.ascontiguousarray(is_mask, np.uint8),
        np.ascontiguousarray(is_pos, np.int8),
        np.ascontiguousarray(is_tab, np.int8),
        np.ascontiguousarray(_is_coef().reshape(-1), np.float64),
        c32(walk_is_short), c32(walk_sfb), c32(walk_win), c32(pre_ext),
        c32(_reorder_perm(sr, _iso_bands(sr))),
        *_f64_tables(),
        _mix_geometry(sr)[1] if _iso_mixed_on(sr) else 0,
        _mix_geometry(sr)[0])


def decode_granules_f64_native(p) -> "np.ndarray | None":
    """Fused native float64 decode plane (native/src/decode_plane_f64.cpp):
    float-for-float identical to ``decode_granules_np`` (pinned by
    test_native_f64_plane_matches_numpy), one pass per granule instead of ~40
    full-array NumPy passes. Returns None when the native library is
    unavailable (callers fall back to the NumPy oracle). Consumes the
    ParsedMP3 (F,2,2,...) layout directly — no host transpose."""
    la = _native_plane_args(p)
    if la is None:
        return None
    lib, args = la
    out = np.empty((2, 2 * p.num_frames, 576), np.float64)
    lib.decode_plane_f64(*args, out)
    return out


def _finish_inter(p, inter: np.ndarray) -> np.ndarray:
    """Trim virtual-frame padding (LSF), apply the stale-PCM duplication
    quirk (MP3_Parser.py:79; one real frame = 576 samples for LSF), and drop
    a Xing/Info/VBRI tag frame's silence (bitstream/vbr.py) — the single
    finishing step shared by every PCM producer."""
    spf = 576 if p.lsf_granules else 1152
    if p.lsf_granules:
        inter = inter[:p.lsf_granules * 576]
    if p.duplicate_last_pcm:
        inter = np.concatenate([inter, inter[-spf:]], axis=0)
    if p.skip_first_pcm:
        inter = inter[spf:]
    return inter


def decode_pcm_i16_host(p) -> "np.ndarray | None":
    """ParsedMP3 -> interleaved int16 PCM (samples, channels) straight from
    the native f64 plane — byte-identical to
    ``(decode_pcm(p, "float64") * 32767).astype(int16)`` without ever
    materializing the float64 PCM on the Python side (the host is
    page-fault-bandwidth-bound, so skipping the transpose/scale/cast numpy
    passes is ~2x end-to-end on long files). None when native is unavailable."""
    if p.num_frames == 0:
        return np.zeros((0, 2), np.int16)
    la = _native_plane_args(p)
    if la is None:
        return None
    lib, args = la
    ch = p.header.channels
    out = np.empty((2 * p.num_frames * 576, ch), np.int16)
    lib.decode_plane_i16(*args, out, ch, 1 if T.ref_pcm_wrap() else 0)
    return _finish_inter(p, out)


def decode_pcm(p, dtype: str = "float64", device=None) -> np.ndarray:
    """ParsedMP3 -> interleaved PCM (samples, channels) float array, including the
    reference's stale-frame duplication quirk (MP3_Parser.py:79).

    The torch plane on ``device`` (CUDA when None) in ``dtype``; "float64"
    on the CPU is the host plane (fused C++ when available, the
    float-for-float NumPy twin otherwise), whose PCM the torch float64
    plane equals bit for bit. On CUDA a parse that left its samples to the
    card (``scan_lanes``) has them scanned there."""
    if p.num_frames == 0:
        return np.zeros((0, 2))
    dev = resolve_device(device)
    if dtype == "float64" and dev.type == "cpu":
        pcm = decode_granules_f64_native(p)
        if pcm is None:
            pcm = decode_granules_np(host_prepare(p))
        return _interleave(p, pcm)
    lanes = scan_lanes(p, dev)
    prep = prep_to_torch(host_prepare(p, raw=lanes is None), dev, lanes)
    if lanes is not None:
        prep = scan_samples(prep, p.num_frames)
    return _interleave(p, fetch_pieces([decode_granules(prep,
                                                        DTYPES[dtype])])[0])


def _interleave(p, pcm: np.ndarray) -> np.ndarray:
    """(2, T, 576) PCM -> the finished interleaved (samples, channels)."""
    ch = p.header.channels
    t = pcm.shape[1]
    inter = pcm[:ch].transpose(1, 2, 0).reshape(t * 576, ch)
    return _finish_inter(p, inter)


def pcm_to_i16(pcm: np.ndarray) -> np.ndarray:
    """float PCM -> int16 WAV samples on host: saturating by default,
    or the reference's truncate+wrap when MP3STEGO_TPU_REF_PCM_WRAP=1."""
    x = pcm * 32767.0
    if not T.ref_pcm_wrap():
        x = np.clip(x, -32768.0, 32767.0)
    return x.astype(np.int16)


def decode_pcm_i16(p, device, dtype: str = "float32",
                   timer=None) -> np.ndarray:
    """ParsedMP3 -> interleaved int16 PCM (samples, channels): the torch
    plane in ``dtype`` on ``device``, with the WAV conversion and the
    channel interleave fused into its synthesis kernel, fetched as int16
    (a quarter of the bytes of float64 PCM). In float64 the bytes equal the
    host plane's (``decode_pcm_i16_host``).

    On CUDA a parse that left its samples to the card (``scan_lanes``) has
    them scanned there: its lanes cross with the prep, and
    ``csrc/huffman.cu`` writes the int32 plane K2 reads (``raw_dense``).

    ``timer`` (a ``utils.profiling.StageTimer``) splits the time into
    host_prepare, h2d, device plane (the scan, span ``samples.device``, and
    K2 and K1) and d2h."""
    if p.num_frames == 0:
        return np.zeros((0, 2), np.int16)
    return _torch_pcm_i16(p, device, dtype, timer, scan_lanes(p, device))


def _torch_pcm_i16(p, device, dtype: str, timer, lanes) -> np.ndarray:
    """``decode_pcm_i16``'s body; the samples scanned on ``device`` from
    ``lanes`` where given, else the host's plane."""
    from mp3stego_tpu_torch.utils.profiling import StageTimer
    timer = timer or StageTimer(enabled=False)
    ch = p.header.channels
    with timer.stage("host_prepare"):
        prep = host_prepare(p, raw=lanes is None)
    with timer.stage("h2d"):
        prep = prep_to_torch(prep, device, lanes)
    with timer.stage("device plane"):
        if lanes is not None:
            prep = scan_samples(prep, p.num_frames)
        inter = decode_granules_i16(prep, DTYPES[dtype], channels=ch)[0]
    with timer.stage("d2h"):
        inter = fetch_pieces([inter])[0]
    with span("finish_inter"):
        return _finish_inter(p, inter)
