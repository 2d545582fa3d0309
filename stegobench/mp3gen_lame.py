"""Songs as LAME 3.100 writes them with its defaults (``lame in.wav
out.mp3``): an MPEG-1 Layer III CBR writer at 128 kbps, in plain PyTorch
(float64) on any device, for the ``lame128`` configuration.

Nothing here imports the program. It reuses ``mp3gen``'s PCM, tables,
Huffman cost and bit packing, and writes what ``mp3gen`` leaves out, each
by a stated rule that LAME's behaviour bears out:

* joint stereo (header mode 1): a frame is mid/side (``mode_extension``
  2) where the side's energy is below ``MS_SIDE_SHARE`` of the mid's and
  side's together over the frame's spectra, as LAME's ``ms_ener_ratio``
  test; otherwise left/right. No intensity stereo (LAME writes none).
* window switching: a granule is short (block type 2, in both channels)
  where a 192-sample sub-block of its high-passed PCM (the first
  difference) holds ``ATTACK_RATIO`` times the energy of the sub-block
  before it and more than ``ATTACK_FLOOR``. A single long granule between
  two short ones goes short too; a start window (1) comes before every run
  of short granules and a stop window (3) after it. No mixed blocks.
* scalefactors in every granule: a band (a window's band in a short
  granule) whose quantized peak, |xr| ** 3/4, lies more than
  ``SF_HEADROOM`` below the granule's highest band peak is raised by
  scalefactor steps until it lies within that factor or its field is full;
  ``scalefac_scale`` 1 (steps of 2 ** 0.75 instead of 2 ** 0.375) where a
  band would need more steps than its field holds; ``preflag`` where every
  band 11-20 of a long granule has at least the pre-emphasis table's
  steps, which are then taken off (LAME's rule); ``scfsi`` in granule 1
  for each band group whose scalefactors equal granule 0's, where both
  granules are long. In a short granule a window whose peak lies more than
  ``SBG_HEADROOM`` below the loudest window's is raised by
  ``subblock_gain`` steps of 2 ** 1.5 while it stays that far below.
* the bit reservoir: a granule's bits follow its demand, in proportion to
  the log of its energy (``demand``), frames borrow up to 511 bytes of
  earlier frames' unused main data (``main_data_begin``), and bytes past
  a full reservoir are stuffing. The global gain of each granule is
  bisected to the largest Huffman cost within its share.
* an "Info" tag frame first (LAME's CBR tag: frame count, byte count, a
  100-point seek table, a quality word and the "LAME3.100" extension;
  its two CRC fields are left 0). The first audio frame borrows nothing.
* the low-pass LAME sets at 128 kbps, 17 kHz: the lines above it are 0.

The PCM is ``mp3gen.song_pcm``'s with its channels remixed
(``lame_pcm``): its left channel panned centre, its right (a delayed copy
with noise) spread to the sides by a width that swells and fades over
tens of seconds. ``mp3gen``'s own stereo image is too wide for the mid/side
rule to choose mid/side in most frames.

``encode`` returns the file's bytes and its ``LameTruth``: everything the
plain reference (``reference_lame.py``) needs to decode the audio frames on
its own, and the counts of what the file holds.
"""

import math
import struct
from dataclasses import dataclass

import numpy as np
import torch

import mp3gen
from mp3gen import (ALIAS_CA, ALIAS_CS, BAND_LONG, BITRATES, MAX_IX, SR,
                    SR_IDX, _Books, _fields_pack, _layout, _pair_bits,
                    _quantize, frame_bytes)

# the standard's 44.1 kHz short bands (ISO/IEC 11172-3 Table B.8), the
# pre-emphasis table and the scalefactor lengths of scalefac_compress
SHORT_WIDTHS = np.array([4, 4, 4, 4, 6, 8, 10, 12, 14, 18, 22, 30, 56])
SHORT_START = np.concatenate([[0], np.cumsum(SHORT_WIDTHS)[:-1]])
PRETAB = np.array([0] * 11 + [1, 1, 1, 1, 2, 2, 3, 3, 3, 2])
SLEN = ((0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
        (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3))
# scfsi band groups (long bands)
SCFSI_GROUPS = ((0, 6), (6, 11), (11, 16), (16, 21))

KBPS = 128
LOWPASS_HZ = 17000
TOP_LONG = int(LOWPASS_HZ * 576 // (SR // 2))      # 444: lines >= are 0
TOP_SHORT = int(LOWPASS_HZ * 192 // (SR // 2))     # 148
MS_SIDE_SHARE = 0.35
ATTACK_RATIO = 4.4
ATTACK_FLOOR = 192 * 1e-6        # (1e-3 full scale rms) ** 2 a sample
# the analysis filterbank centres a subband sample 225 PCM samples before
# its newest; one sub-block more puts an attack in the span of a short
# granule's windows (subband samples -12 to 12 of the granule)
ATTACK_SHIFT = 225 + 192
SF_HEADROOM = 4.0
SBG_HEADROOM = 1.0
RESERVOIR_MAX = 511
# a granule's demand: 1 + DEMAND_SLOPE x (log2 of its energy less the
# file's median), within [DEMAND_MIN, DEMAND_MAX], times the mean share
DEMAND_SLOPE, DEMAND_MIN, DEMAND_MAX = 0.25, 0.5, 2.0
PART23_MAX = 4095
# the regions of the big values of a window-switched granule: region0
# ends at sample 36 and region 1 runs to the end (ISO 2.4.2.7)
SWITCHED_PAIRS = (18, 288)


@dataclass
class LameTruth:
    """What a file's audio frames carry, per channel and granule (T = 2 x
    ``frames``): ``ix`` (2, T, 576) int16, the signed quantized spectra in
    bitstream order (a short granule's band-major, window-minor); ``gg``
    (2, T) global gains; ``block_type``, ``sf_scale``, ``preflag`` (2, T);
    ``sbg`` (2, T, 3) subblock gains; ``sfl`` (2, T, 22) long scalefactors
    (band 21 is 0); ``sfs`` (2, T, 3, 13) short scalefactors [window][band]
    (band 12 is 0); ``ms`` (T,) whether the granule's frame is mid/side.
    The counts: ``escapes`` (values above 15), ``tag_frames``,
    ``short_granules`` ((channel, granule)s of block type 2),
    ``ms_frames`` and ``reservoir_frames`` (frames whose
    ``main_data_begin`` is above 0)."""
    ix: np.ndarray
    gg: np.ndarray
    block_type: np.ndarray
    sf_scale: np.ndarray
    preflag: np.ndarray
    sbg: np.ndarray
    sfl: np.ndarray
    sfs: np.ndarray
    ms: np.ndarray
    frames: int
    escapes: int
    tag_frames: int
    short_granules: int
    ms_frames: int
    reservoir_frames: int
    scfsi_groups: int

    @property
    def audio_s(self) -> float:
        return self.frames * 1152 / SR

    @property
    def ms_granules(self) -> int:
        return 2 * self.ms_frames


def lame_pcm(seconds: float, seed: int, device) -> torch.Tensor:
    """(n, 2) int16 stereo PCM at 44.1 kHz: ``mp3gen.song_pcm``'s left
    channel c panned centre and its right channel d spread by a width w(t)
    that swells and fades over 20-40 s (seeded): L = 0.6 (c + 1.2 w d),
    R = 0.6 (c - 1.2 w d)."""
    base = mp3gen.song_pcm(seconds, seed, device).to(torch.float64)
    n = base.shape[0]
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + 0x5A17) % (1 << 63))
    u = torch.rand(2, generator=g, dtype=torch.float64, device=device)
    t = torch.arange(n, dtype=torch.float64, device=device) / SR
    period = 20.0 + 20.0 * u[0]
    w = 0.5 * (1.0 - torch.cos(2 * math.pi * t / period + 2 * math.pi * u[1]))
    c, d = base[:, 0], base[:, 1]
    pcm = torch.stack([c + 1.2 * w * d, c - 1.2 * w * d], 1) * 0.6
    return pcm.clamp(-32768, 32767).to(torch.int16)


def _windows(device) -> tuple:
    """The encoder's long windows by block type (4, 36) and the short
    window (12,), ISO 11172-3 2.4.3.4.10.3."""
    i = np.arange(36)
    w = np.zeros((4, 36))
    w[0] = np.sin(math.pi / 36 * (i + 0.5))
    w[1, :18] = w[0, :18]
    w[1, 18:24] = 1.0
    w[1, 24:30] = np.sin(math.pi / 12 * (i[24:30] - 18 + 0.5))
    w[3, 6:12] = np.sin(math.pi / 12 * (i[6:12] - 6 + 0.5))
    w[3, 12:18] = 1.0
    w[3, 18:] = w[0, 18:]
    w[2, :12] = np.sin(math.pi / 12 * (i[:12] + 0.5))
    f64 = dict(dtype=torch.float64, device=device)
    return torch.as_tensor(w, **f64), torch.as_tensor(w[2, :12], **f64)


def short_order() -> np.ndarray:
    """(576,) for each bitstream position of a short granule, its index in
    the window-major spectrum (3, 192): band-major, window-minor."""
    out = np.empty(576, dtype=np.int64)
    for sfb in range(13):
        w_ = int(SHORT_WIDTHS[sfb])
        for win in range(3):
            at = 3 * int(SHORT_START[sfb]) + win * w_
            out[at:at + w_] = win * 192 + SHORT_START[sfb] + np.arange(w_)
    return out


def short_groups() -> np.ndarray:
    """(576,) the (band, window) group, band x 3 + window, of each
    bitstream position of a short granule."""
    g = np.empty(576, dtype=np.int64)
    for sfb in range(13):
        w_ = int(SHORT_WIDTHS[sfb])
        for win in range(3):
            at = 3 * int(SHORT_START[sfb]) + win * w_
            g[at:at + w_] = sfb * 3 + win
    return g


def long_bands() -> np.ndarray:
    """(576,) the long scalefactor band (0-21) of each line."""
    return np.searchsorted(BAND_LONG, np.arange(576), side="right") - 1


def _subbands(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(2, n) float PCM -> (2, 2F, 32, 18) subband samples, the odd
    subbands' odd samples negated: ``mp3gen._analysis``'s filterbank."""
    dev = x.device
    f64 = dict(dtype=torch.float64, device=dev)
    steps = frames * 36
    need = 480 + 32 * steps
    xp = torch.zeros((2, need + 32), **f64)
    m = min(x.shape[1], need - 480)
    xp[:, 480:480 + m] = x[:, :m]
    win = xp.unfold(1, 512, 32)[:, :steps].flip(-1)
    c = torch.as_tensor(mp3gen.SYNTH_WINDOW / 32.0, **f64)
    y = (win * c).reshape(2, steps, 8, 64).sum(2)
    del win
    k = torch.arange(32, **f64)[:, None]
    i = torch.arange(64, **f64)[None, :]
    mat = torch.cos((2 * k + 1) * (i - 16) * math.pi / 64)
    sub = (y @ mat.T).reshape(2, 2 * frames, 18, 32).permute(0, 1, 3, 2)
    odd = torch.ones(32, 18, **f64)
    odd[1::2, 1::2] = -1.0
    return sub * odd


def attacks(x: torch.Tensor, granules: int) -> torch.Tensor:
    """(T,) bool: the granules that hold an attack (module docstring), from
    both channels' first differences in sub-blocks of 192 samples, the PCM
    delayed by ``ATTACK_SHIFT`` samples so that a granule's sub-blocks are
    those its short windows span."""
    n = 576 * granules
    xp = torch.zeros((2, n + 1), dtype=torch.float64, device=x.device)
    m = min(x.shape[1], n - ATTACK_SHIFT)
    xp[:, 1 + ATTACK_SHIFT:1 + ATTACK_SHIFT + m] = x[:, :m]
    hp = xp[:, 1:] - xp[:, :-1]
    e = (hp * hp).reshape(2, 3 * granules, 192).sum(-1).sum(0)
    prev = torch.cat([e[:1], e[:-1]])
    hit = (e > ATTACK_RATIO * prev) & (e > ATTACK_FLOOR)
    return hit.reshape(granules, 3).any(1)


def block_types(short: torch.Tensor) -> torch.Tensor:
    """(T,) block types from the short flags: the first granule long, a
    lone long granule between short ones short, a start window before a
    short run and a stop window after it."""
    s = short.clone()
    s[0] = False
    gap = torch.zeros_like(s)
    gap[1:-1] = s[:-2] & s[2:] & ~s[1:-1]
    s = s | gap
    nxt = torch.cat([s[1:], s.new_zeros(1)])
    prv = torch.cat([s.new_zeros(1), s[:-1]])
    bt = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
    bt = torch.where(prv & ~s, 3, bt)
    bt = torch.where(nxt & ~s, 1, bt)
    return torch.where(s, 2, bt)


def _mdct(sub: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """(2, T, 32, 18) subband samples and (T,) block types -> (2, T, 576)
    spectra in bitstream order: a long, start or stop granule's 18-point
    MDCT over two granules under its window, then the alias butterflies; a
    short granule's three 6-point MDCTs (at 6, 12 and 18 of the 36),
    reordered band-major."""
    dev = sub.device
    f64 = dict(dtype=torch.float64, device=dev)
    prev = torch.cat([torch.zeros_like(sub[:, :1]), sub[:, :-1]], 1)
    z = torch.cat([prev, sub], -1)                           # (2, T, 32, 36)
    del prev
    wl, ws = _windows(dev)
    n36 = torch.arange(36, **f64)
    k18 = torch.arange(18, **f64)
    cl = torch.cos(math.pi / 72 * (2 * n36[:, None] + 1 + 18)
                   * (2 * k18[None, :] + 1))
    win = wl[bt.clamp(0, 3)][None, :, None, :]               # (1, T, 1, 36)
    xr = ((z * win) @ cl) / 9.0                              # (2, T, 32, 18)
    cs = torch.as_tensor(ALIAS_CS, **f64)
    ca = torch.as_tensor(ALIAS_CA, **f64)
    lo = xr[:, :, :-1, 17 - torch.arange(8, device=dev)].clone()
    hi = xr[:, :, 1:, :8].clone()
    xr[:, :, :-1, 17 - torch.arange(8, device=dev)] = lo * cs + hi * ca
    xr[:, :, 1:, :8] = hi * cs - lo * ca
    xr = xr.reshape(2, -1, 576)
    xr[..., TOP_LONG:] = 0.0
    short = bt == 2
    if bool(short.any()):
        n12 = torch.arange(12, **f64)
        k6 = torch.arange(6, **f64)
        cs12 = torch.cos(math.pi / 24 * (2 * n12[:, None] + 1 + 6)
                         * (2 * k6[None, :] + 1))
        zs = z[:, short]                                     # (2, S, 32, 36)
        xs = torch.stack([((zs[..., 6 + 6 * w:18 + 6 * w] * ws) @ cs12) / 3.0
                          for w in range(3)], 2)             # (2, S, 3, 32, 6)
        xs = xs.reshape(2, -1, 3, 192)
        xs[..., TOP_SHORT:] = 0.0
        order = torch.as_tensor(short_order(), device=dev)
        xr[:, short] = xs.reshape(2, -1, 576)[..., order]
    return xr


def _ms(xr: torch.Tensor) -> tuple:
    """(2, T, 576) left/right spectra -> (coded spectra, (T,) mid/side
    flags): a frame is mid/side where the side holds less than
    ``MS_SIDE_SHARE`` of the mid's and side's energy over its two
    granules."""
    mid = (xr[0] + xr[1]) / math.sqrt(2.0)
    side = (xr[0] - xr[1]) / math.sqrt(2.0)
    em = (mid * mid).sum(-1).reshape(-1, 2).sum(1)
    es = (side * side).sum(-1).reshape(-1, 2).sum(1)
    tot = em + es
    ms_f = (tot > 0) & (es < MS_SIDE_SHARE * tot)
    ms = ms_f.repeat_interleave(2)
    coded = torch.where(ms[None, :, None], torch.stack([mid, side]), xr)
    return coded, ms


def _ceil_steps(need: torch.Tensor, step: float) -> torch.Tensor:
    return torch.ceil(need / step - 1e-9).clamp(min=0).long()


def _scalefactors(mag34: torch.Tensor, bt: torch.Tensor) -> dict:
    """The scalefactor fields of each lane (L = 2T lanes, channel-major)
    and the per-sample amplification of |xr| ** 3/4 they give, by the
    rules of the module docstring."""
    dev = mag34.device
    L = mag34.shape[0]
    short = bt == 2
    lband = torch.as_tensor(long_bands(), device=dev)
    sgrp = torch.as_tensor(short_groups(), device=dev)
    zero = torch.zeros(L, dtype=torch.int64, device=dev)
    sf_scale, pre = zero.clone(), zero.clone()
    sbg = torch.zeros((L, 3), dtype=torch.int64, device=dev)
    sfl = torch.zeros((L, 22), dtype=torch.int64, device=dev)
    sfs = torch.zeros((L, 13, 3), dtype=torch.int64, device=dev)   # [b][w]
    tiny = 2.0 ** -30

    def raise_to_top(peak, limit):
        """Steps that bring each band within SF_HEADROOM of the lanes'
        top; (steps, scalefac_scale)."""
        top = peak.amax(1, keepdim=True)
        live = peak > top * tiny
        need = torch.where(live, torch.log2(
            top / (SF_HEADROOM * peak.clamp(min=1e-300))), 0.0).clamp(min=0)
        n0 = _ceil_steps(need, 0.375)
        scale1 = (n0 > limit).any(1)
        n1 = _ceil_steps(need, 0.75)
        n = torch.where(scale1[:, None], n1, n0)
        return torch.minimum(n, limit), scale1.long()

    amp = torch.zeros_like(mag34)
    lo = ~short
    if bool(lo.any()):
        a = mag34[lo]
        peak = torch.zeros((a.shape[0], 22), dtype=a.dtype, device=dev)
        peak.scatter_reduce_(1, lband.expand_as(a), a, "amax")
        limit = torch.as_tensor([15] * 11 + [7] * 10, device=dev)
        n, s1 = raise_to_top(peak[:, :21], limit)
        pt = torch.as_tensor(PRETAB, device=dev)
        p = (n[:, 11:] >= pt[11:]).all(1)
        n = n - p[:, None].long() * pt
        sfl[lo, :21], sf_scale[lo], pre[lo] = n, s1, p.long()
        eff = n + p[:, None].long() * pt
        eff = torch.cat([eff, eff.new_zeros(eff.shape[0], 1)], 1)
        mult = torch.where(s1 == 1, 0.75, 0.375).to(a.dtype)
        amp[lo] = eff[:, lband].to(a.dtype) * mult[:, None]
    if bool(short.any()):
        a = mag34[short]
        peak = torch.zeros((a.shape[0], 39), dtype=a.dtype, device=dev)
        peak.scatter_reduce_(1, sgrp.expand_as(a), a, "amax")
        peak = peak.reshape(-1, 13, 3)
        pw = peak.amax(1)                                     # (S, 3)
        pmax = pw.amax(1, keepdim=True)
        g = torch.where(pw > pmax * tiny, torch.floor(
            (torch.log2(pmax / pw.clamp(min=1e-300))
             - math.log2(SBG_HEADROOM)) / 1.5), 0.0).clamp(0, 7).long()
        adj = peak[:, :12] * torch.pow(2.0, 1.5 * g)[:, None, :]
        limit = torch.as_tensor([15] * 6 + [7] * 6, device=dev)
        n, s1 = raise_to_top(adj.reshape(-1, 36),
                             limit.repeat_interleave(3))
        n = n.reshape(-1, 12, 3)
        sfs[short, :12], sf_scale[short], sbg[short] = n, s1, g
        eff = torch.cat([n, n.new_zeros(n.shape[0], 1, 3)], 1).reshape(-1, 39)
        mult = torch.where(s1 == 1, 0.75, 0.375).to(a.dtype)
        win = sgrp % 3
        amp[short] = eff[:, sgrp].to(a.dtype) * mult[:, None] \
            + 1.5 * g[:, win].to(a.dtype)
    return dict(sf_scale=sf_scale, pre=pre, sbg=sbg, sfl=sfl, sfs=sfs,
                amp=amp)


def _scfsi(sfl: torch.Tensor, bt: torch.Tensor, frames: int):
    """(2, F, 4) scfsi bits: granule 1 of a channel reuses a band group of
    granule 0 where both granules are long and the group's scalefactors
    are equal."""
    s = sfl.reshape(2, frames, 2, 22)
    both_long = (bt.reshape(frames, 2) != 2).all(1)
    bits = torch.stack([(s[:, :, 0, a:b] == s[:, :, 1, a:b]).all(-1)
                        for a, b in SCFSI_GROUPS], -1)
    return bits & both_long[None, :, None]


def _slen(sfl, sfs, short: torch.Tensor):
    """Each lane's scalefac_compress: of the 16 (slen1, slen2) pairs, the
    one of fewest bits whose fields hold the lane's scalefactors."""
    dev = sfl.device
    lo_max = torch.where(short, sfs[:, :6].amax((1, 2)), sfl[:, :11].amax(1))
    hi_max = torch.where(short, sfs[:, 6:12].amax((1, 2)),
                         sfl[:, 11:21].amax(1))
    sl = torch.as_tensor(SLEN, device=dev)                  # (16, 2)
    fits = ((lo_max[:, None] < (1 << sl[:, 0])) &
            (hi_max[:, None] < (1 << sl[:, 1])))
    n1 = torch.where(short, 18, 11)[:, None]
    n2 = torch.where(short, 18, 10)[:, None]
    cost = torch.where(fits, n1 * sl[:, 0] + n2 * sl[:, 1], 1 << 20)
    return cost.argmin(1)


def _part2(sfc, short, scfsi_lane):
    """(L, 36) scalefactor field lengths in the order they are written: a
    long lane's bands 0-20 (those of a reused group 0 long), a short
    lane's (band, window) 0-11 x 3."""
    dev = sfc.device
    sl = torch.as_tensor(SLEN, device=dev)[sfc]               # (L, 2)
    j = torch.arange(36, device=dev)
    long_len = torch.where(j < 11, sl[:, :1], sl[:, 1:]) * (j < 21)
    grp = torch.bucketize(j, torch.as_tensor([6, 11, 16], device=dev),
                          right=True).clamp(max=3)
    reused = torch.gather(scfsi_lane, 1, grp[None].expand(len(sfc), 36))
    long_len = long_len * ~reused
    short_len = torch.where(j < 18, sl[:, :1], sl[:, 1:])
    return torch.where(short[:, None], short_len, long_len)


def _regions(r0p, r1p) -> torch.Tensor:
    """(L, 288) the big-values region (0-2) of each pair of each lane."""
    j = torch.arange(288, device=r0p.device)[None]
    return (j >= r0p[:, None]).long() + (j >= r1p[:, None]).long()


def _choose(books, a, bv, count1, r0p, r1p):
    """``mp3gen._choose`` with each lane's own region boundaries (pairs):
    (bits, tables (L, 3), count1 table (L,))."""
    dev = a.device
    x, y = a[:, 0::2], a[:, 1::2]
    j = torch.arange(288, device=dev)
    region = _regions(r0p, r1p)
    inside = j[None, :] < bv[:, None]
    big = torch.maximum(x, y) * inside
    onehot = [region == r for r in range(3)]
    rmax = torch.stack([torch.where(o, big, 0).amax(1) for o in onehot], 1)
    inf = torch.iinfo(torch.int64).max // 4
    best = torch.where(rmax == 0, 0, inf)
    tables = torch.zeros_like(rmax)
    for t in range(1, 32):
        if mp3gen.HUFF_XLEN[t] == 0:
            continue
        ok = (rmax < mp3gen.HUFF_XLEN[t]) if t < 16 \
            else (rmax - 15 <= mp3gen.HUFF_LINMAX[t])
        pb = _pair_bits(books, x, y, t) * inside
        cost = torch.stack([(pb * o).sum(1) for o in onehot], 1)
        better = ok & (rmax > 0) & (cost < best)
        best = torch.where(better, cost, best)
        tables = torch.where(better, t, tables)
    q = torch.arange(144, device=dev)
    qidx = (2 * bv[:, None] + 4 * q[None, :]).clamp(max=572)
    inq = q[None, :] < count1[:, None]
    quads = torch.stack([torch.gather(a, 1, qidx + d) for d in range(4)], -1)
    p = 8 * quads[..., 0] + 4 * quads[..., 1] + 2 * quads[..., 2] \
        + quads[..., 3]
    signs = (quads > 0).sum(-1)
    c1a = ((books.len[32][p] + signs) * inq).sum(1)
    c1b = ((4 + signs) * inq).sum(1)
    c1t = (c1b < c1a).long()
    return best.sum(1) + torch.minimum(c1a, c1b), tables, c1t


def demand(xr: torch.Tensor) -> torch.Tensor:
    """(L,) each lane's demand as a multiple of the mean share: 1 +
    ``DEMAND_SLOPE`` x (log2 of its energy less the median over the lanes
    that have any), within [``DEMAND_MIN``, ``DEMAND_MAX``]."""
    e = (xr * xr).sum(-1)
    live = e > 0
    le = torch.log2(e.clamp(min=1e-300))
    med = le[live].median() if bool(live.any()) else le.new_zeros(())
    d = (1.0 + DEMAND_SLOPE * (le - med)).clamp(DEMAND_MIN, DEMAND_MAX)
    return torch.where(live, d, torch.full_like(d, DEMAND_MIN))


def plan(dem: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """(F, 4) each lane's bits (part 2 and 3) from its demand (F, 4) and
    the frames' main-data bytes (F,): a frame has its own bytes and the
    reservoir's, the reservoir starts empty and holds at most 511 bytes,
    and a lane at most ``PART23_MAX`` bits."""
    share = 8.0 * float(slot.mean()) / 4
    out = np.zeros(dem.shape, dtype=np.int64)
    res = 0
    for f in range(len(slot)):
        avail = 8 * (res + int(slot[f]))
        want = dem[f] * share
        scale = min(1.0, avail / max(float(want.sum()), 1.0))
        t = np.minimum(np.floor(want * scale).astype(np.int64), PART23_MAX)
        out[f] = t
        used = -(-int(t.sum()) // 8)
        res = min(RESERVOIR_MAX, res + int(slot[f]) - used)
    return out


def _reservoir(p23: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """(F,) ``main_data_begin`` of each frame from its lanes' bits (F, 4)."""
    mdb = np.zeros(len(slot), dtype=np.int64)
    res = 0
    for f in range(len(slot)):
        mdb[f] = res
        used = -(-int(p23[f].sum()) // 8)
        res = min(RESERVOIR_MAX, res + int(slot[f]) - used)
        if res < 0:
            raise ValueError(f"frame {f} takes more than it has")
    return mdb


def encode(pcm: torch.Tensor, kbps: int = KBPS) -> tuple:
    """(n, 2) int16 PCM on a device -> (MP3 bytes, ``LameTruth``): an Info
    tag frame, then the CBR joint-stereo frames at ``kbps``."""
    dev = pcm.device
    n = pcm.shape[0]
    frames = -(-n // 1152)
    tg = 2 * frames
    x = pcm.T.to(torch.float64) / 32768.0
    bt = block_types(attacks(x, tg))
    xr = _mdct(_subbands(x, frames), bt)
    del x
    xr, ms = _ms(xr)
    lanes = xr.reshape(2 * tg, 576)                  # lane = ch * T + t
    del xr
    bt_l = bt.repeat(2)
    short = bt_l == 2
    mag34 = lanes.abs() ** 0.75
    sf = _scalefactors(mag34, bt_l)
    mag34 = mag34 * torch.pow(2.0, sf["amp"])
    del sf["amp"]
    sfs_wb = sf["sfs"]                                   # (L, 13, 3)
    scfsi = _scfsi(sf["sfl"], bt, frames)                # (2, F, 4)
    scfsi_lane = torch.zeros((2, tg, 4), dtype=torch.bool, device=dev)
    scfsi_lane[:, 1::2] = scfsi
    scfsi_lane = scfsi_lane.reshape(2 * tg, 4)
    sfc = _slen(sf["sfl"], sfs_wb, short)
    p2len = _part2(sfc, short, scfsi_lane)
    part2 = p2len.sum(1)

    fb_all = frame_bytes(frames + 1, kbps)
    tag_bytes, fb = int(fb_all[0]), fb_all[1:]
    slot = fb - 36
    # lanes in stream order: frame f, granule gr, channel ch
    f_ = torch.arange(frames, device=dev)
    order = torch.stack([torch.stack([c * tg + 2 * f_ + gr for c in (0, 1)],
                                     1) for gr in (0, 1)], 1).reshape(-1)
    dem = demand(lanes)[order].reshape(frames, 4).cpu().numpy()
    target = torch.as_tensor(plan(dem, slot).reshape(-1), device=dev)
    budget = torch.empty_like(target)
    budget[order] = target
    budget = budget - part2

    books = _Books(dev)
    r0p = torch.where(bt_l == 0, mp3gen.REGION_PAIRS[0], SWITCHED_PAIRS[0])
    r1p = torch.where(bt_l == 0, mp3gen.REGION_PAIRS[1], SWITCHED_PAIRS[1])
    lo = torch.full((2 * tg,), -1, dtype=torch.int64, device=dev)
    hi = torch.full((2 * tg,), 255, dtype=torch.int64, device=dev)
    for _ in range(8):
        mid = (lo + hi) // 2
        a = _quantize(mag34, mid)
        bv, c1 = _layout(a)
        bits = _choose(books, a, bv, c1, r0p, r1p)[0]
        ok = (bits <= budget) & (a.amax(1) <= MAX_IX)
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid)
    gg = hi
    a = _quantize(mag34, gg)
    del mag34
    bv, c1 = _layout(a)
    bits, tables, c1t = _choose(books, a, bv, c1, r0p, r1p)
    if bool(((bits > budget) | (a.amax(1) > MAX_IX)).any()):
        raise ValueError("a granule does not fit its share of the frame")
    ix = torch.where(lanes < 0, -a, a)
    p23 = (bits + part2)[order].reshape(frames, 4).cpu().numpy()
    mdb = _reservoir(p23, slot)

    sfl = sf["sfl"]
    truth = LameTruth(
        ix=ix.reshape(2, tg, 576).to(torch.int16).cpu().numpy(),
        gg=gg.reshape(2, tg).cpu().numpy().astype(np.int16),
        block_type=bt_l.reshape(2, tg).cpu().numpy().astype(np.int8),
        sf_scale=sf["sf_scale"].reshape(2, tg).cpu().numpy().astype(np.int8),
        preflag=sf["pre"].reshape(2, tg).cpu().numpy().astype(np.int8),
        sbg=sf["sbg"].reshape(2, tg, 3).cpu().numpy().astype(np.int8),
        sfl=sfl.reshape(2, tg, 22).cpu().numpy().astype(np.int8),
        sfs=sfs_wb.transpose(1, 2).reshape(2, tg, 3, 13).cpu().numpy()
        .astype(np.int8),
        ms=ms.cpu().numpy(), frames=frames,
        escapes=int((a > 15).sum()), tag_frames=1,
        short_granules=int(short.sum()), ms_frames=int(ms[::2].sum()),
        reservoir_frames=int((mdb > 0).sum()),
        scfsi_groups=int(scfsi.sum()))
    audio = _bitstream(books, a, ix, gg, bv, c1, tables, c1t, bits, dict(
        bt=bt_l, sfc=sfc, p2len=p2len, part2=part2, sf=sf, scfsi=scfsi,
        ms=ms, r0p=r0p, order=order), fb, mdb, kbps)
    tag = info_frame(tag_bytes, frames, len(audio) + tag_bytes, kbps,
                     fb.cumsum())
    return tag + audio, truth


def _header(pad, ms, kbps):
    """32-bit headers: MPEG-1 Layer III, no CRC, 44.1 kHz, joint stereo
    (mode 1) with the mid/side bit of ``mode_extension`` where ``ms``."""
    head = (0x7FF << 21) | (3 << 19) | (1 << 17) | (1 << 16) \
        | (BITRATES.index(kbps) << 12) | (SR_IDX << 10) | (1 << 6) | (1 << 2)
    return head | (pad << 9) | (ms.long() << 5)


def _bitstream(books, a, ix, gg, bv, c1, tables, c1t, bits, side, fb, mdb,
               kbps):
    """The audio frames' bytes: each frame's header and side information
    in its first 36 bytes, and the main data as one stream over the
    frames' remaining bytes, each frame's from ``main_data_begin`` bytes
    before its own."""
    dev = a.device
    frames = len(fb)
    order = side["order"]
    slot = fb - 36
    cum = np.concatenate([[0], np.cumsum(slot)[:-1]])
    # header and side information: 36 bytes a frame
    hs = []
    base = torch.arange(frames, device=dev) * 288
    pad = torch.as_tensor(fb - fb.min(), device=dev)
    hs.append((_header(pad, side["ms"][::2], kbps),
               torch.full_like(pad, 32), base))
    scf = side["scfsi"]                                     # (2, F, 4)
    scf_bits = sum(scf[c, :, k].long() << (7 - 4 * c - k)
                   for c in (0, 1) for k in range(4))
    hs.append(((torch.as_tensor(mdb, device=dev) << 11) | scf_bits,
               torch.full_like(pad, 20), base + 32))
    p23 = (bits + side["part2"])[order]
    si = base.repeat_interleave(4) + 52 \
        + 59 * torch.arange(4, device=dev).repeat(frames)
    hs.append(((p23 << 17) | (bv[order] << 8) | gg[order],
               torch.full_like(p23, 29), si))
    bt, sfc = side["bt"][order], side["sfc"][order]
    tb = tables[order]
    sf = side["sf"]
    pre, sfs_, sbg = sf["pre"][order], sf["sf_scale"][order], sf["sbg"][order]
    tail = (pre << 2) | (sfs_ << 1) | c1t[order]
    plain = (sfc << 26) | (tb[:, 0] << 20) | (tb[:, 1] << 15) \
        | (tb[:, 2] << 10) | (mp3gen.REGION0_COUNT << 6) \
        | (mp3gen.REGION1_COUNT << 3) | tail
    switched = (sfc << 26) | (1 << 25) | (bt << 23) | (tb[:, 0] << 17) \
        | (tb[:, 1] << 12) | (sbg[:, 0] << 9) | (sbg[:, 1] << 6) \
        | (sbg[:, 2] << 3) | tail
    hs.append((torch.where(bt == 0, plain, switched),
               torch.full_like(p23, 30), si + 29))
    head = np.frombuffer(_fields_pack(frames * 288, hs, dev), np.uint8)

    # main data: lanes in stream order from their frame's start
    start = torch.as_tensor(8 * (cum - mdb), device=dev)
    lane0 = start.repeat_interleave(4) + (
        torch.cumsum(p23.reshape(frames, 4), 1)
        - p23.reshape(frames, 4)).reshape(-1)
    fields = []
    # part 2: the scalefactors
    p2len = side["p2len"][order]                             # (L, 36)
    sfl = sf["sfl"][order]
    sfs = sf["sfs"][order]                                    # (L, 13, 3)
    long_v = torch.cat([sfl[:, :21], sfl.new_zeros(len(sfl), 15)], 1)
    short_v = sfs[:, :12].reshape(-1, 36)
    v = torch.where((bt == 2)[:, None], short_v, long_v)
    pos = lane0[:, None] + torch.cumsum(p2len, 1) - p2len
    fields.append((v.reshape(-1), p2len.reshape(-1), pos.reshape(-1)))
    # part 3: the Huffman code
    md = lane0 + side["part2"][order]
    fields += _huffman_fields(books, a[order], ix[order] < 0, bv[order],
                              c1[order], tb, c1t[order],
                              side["r0p"][order],
                              torch.where(bt == 0, mp3gen.REGION_PAIRS[1],
                                          SWITCHED_PAIRS[1]), md)
    main = np.frombuffer(_fields_pack(int(slot.sum()) * 8, fields, dev),
                         np.uint8)
    out = np.empty(int(fb.sum()), dtype=np.uint8)
    is_head = np.zeros(len(out), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(fb)[:-1]])
    is_head[(starts[:, None] + np.arange(36)[None]).reshape(-1)] = True
    out[is_head] = head
    out[~is_head] = main
    return out.tobytes()


def _huffman_fields(books, al, sx, bv, c1, tb, c1t, r0p, r1p, md):
    """The (value, length, position) fields of each lane's big values and
    count1 quads from bit ``md``: ``mp3gen._bitstream``'s, with each lane's
    own region boundaries."""
    dev = al.device
    x, y = al[:, 0::2], al[:, 1::2]
    sxx, syy = sx[:, 0::2].long(), sx[:, 1::2].long()
    j = torch.arange(288, device=dev)
    region = _regions(r0p, r1p)
    tab = torch.gather(tb, 1, region)
    inside = (j[None, :] < bv[:, None]) & (tab > 0)
    cx, cy = x.clamp(max=15), y.clamp(max=15)
    cell = cx * 16 + cy
    code = books.code[tab, cell]
    clen = books.len[tab, cell]
    lin = books.linbits[tab]
    esc = tab >= 16
    nx, ny = (x > 0).long(), (y > 0).long()
    small_v = (((code << nx) | (sxx * nx)) << ny) | (syy * ny)
    small_n = clen + nx + ny
    xl = torch.where(x >= 15, lin, 0)
    yl = torch.where(y >= 15, lin, 0)
    ext_v = (((((x - 15).clamp(min=0) << nx) | (sxx * nx)) << yl)
             | (y - 15).clamp(min=0)) << ny | (syy * ny)
    ext_v = torch.where(esc, ext_v, 0)
    ext_n = torch.where(esc, xl + nx + yl + ny, 0)
    head_v = torch.where(esc, code, small_v)
    head_n = torch.where(esc, clen, small_n)
    pbits = (head_n + ext_n) * inside
    ppos = md[:, None] + torch.cumsum(pbits, 1) - pbits
    keep = inside.reshape(-1)
    out = [(head_v.reshape(-1)[keep], head_n.reshape(-1)[keep],
            ppos.reshape(-1)[keep]),
           (ext_v.reshape(-1)[keep], ext_n.reshape(-1)[keep],
            (ppos + head_n).reshape(-1)[keep])]
    q = torch.arange(144, device=dev)
    qidx = (2 * bv[:, None] + 4 * q[None, :]).clamp(max=572)
    inq = q[None, :] < c1[:, None]
    quads = torch.stack([torch.gather(al, 1, qidx + d) for d in range(4)], -1)
    qs = torch.stack([torch.gather(sx.long(), 1, qidx + d)
                      for d in range(4)], -1)
    pq = 8 * quads[..., 0] + 4 * quads[..., 1] + 2 * quads[..., 2] \
        + quads[..., 3]
    qcode = torch.where(c1t[:, None] == 1, books.code[33][pq],
                        books.code[32][pq])
    qlen = torch.where(c1t[:, None] == 1, books.len[33][pq],
                       books.len[32][pq])
    for d in range(4):
        nz = quads[..., d]
        qcode = (qcode << nz) | (qs[..., d] * nz)
        qlen = qlen + nz
    qlen = qlen * inq
    qpos = (md + pbits.sum(1))[:, None] + torch.cumsum(qlen, 1) - qlen
    keepq = inq.reshape(-1)
    out.append((qcode.reshape(-1)[keepq], qlen.reshape(-1)[keepq],
                qpos.reshape(-1)[keepq]))
    return out


def info_frame(size: int, frames: int, stream_bytes: int, kbps: int,
               ends: np.ndarray) -> bytes:
    """LAME's CBR tag frame of ``size`` bytes: a silent frame (side
    information all 0) whose main data holds "Info", the flags (frames,
    bytes, seek table, quality), the audio frames' count, the stream's
    bytes, a 100-point seek table of the audio frames' byte ``ends``, the
    quality word and the "LAME3.100" extension (encoder delay 576, the
    padding of the last frame, low-pass 17 kHz; its CRCs 0)."""
    head = ((0x7FF << 21) | (3 << 19) | (1 << 17) | (1 << 16)
            | (BITRATES.index(kbps) << 12) | (SR_IDX << 10) | (1 << 6)
            | (1 << 2))
    toc = bytes(int(min(255, 256 * ends[min(frames - 1, frames * i // 100)]
                        // max(1, int(ends[-1]))))
                for i in range(100))
    body = b"Info" + struct.pack(">III", 0xF, frames, stream_bytes) + toc \
        + struct.pack(">I", 57)
    delay, padding = 576, 0
    ext = b"LAME3.100" + bytes([0x00, LOWPASS_HZ // 100]) + bytes(8) \
        + bytes([0x00, kbps]) \
        + bytes([delay >> 4, ((delay & 15) << 4) | (padding >> 8),
                 padding & 255]) + bytes(4) \
        + struct.pack(">I", stream_bytes) + bytes(4)
    out = struct.pack(">I", head) + bytes(32) + body + ext
    return out + bytes(size - len(out))
