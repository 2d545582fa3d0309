"""The plain reference decode of the ``lame128`` files: plain PyTorch in
float64 on any device.

It decodes what ``mp3gen_lame.encode`` put in a file's audio frames
(``mp3gen_lame.LameTruth``) to interleaved int16 PCM, in the arithmetic of
the upstream decoder that ``reference.py`` follows (every product and sum
rounded on its own, sums in ascending order), extended to what that
decoder's long-block files never hold:

* requantize: ((sign x |ix| ** 4/3) x 2 ** ((gain - 210 - 8 x
  subblock_gain) / 4)) x 2 ** (-m x (scalefactor + preflag x pretab) / 2),
  m = 1 + scalefac_scale, the subblock gain on short granules only;
* mid/side: L = (M + S) / sqrt 2, R = (M - S) / sqrt 2, a division each;
* a short granule's reorder to the window-major layout, over the
  standard's 13 short bands;
* the alias butterflies on long, start and stop granules only;
* the long IMDCT (18 -> 36) under the window of the block type, or three
  short IMDCTs (6 -> 12) under the short window, overlapped at 6, 12 and
  18 of the 36 (a sum of two window products each);
* the overlap with the granule before, the frequency inversion, the
  synthesis and the int16 conversion, as ``reference.py``.

Departures from ISO/IEC 11172-3 that the decoder makes, kept here:
mid/side divides by sqrt 2 where the standard multiplies by 1/sqrt 2, and
the int16 conversion is x * 32767 saturated then truncated where the
standard leaves the output's scaling to the decoder.

The work goes in blocks of ``BLOCK`` granules, carrying the overlap and the
synthesis history across block edges, so that a song of 278 s fits a card
beside the program's own memory. It imports nothing of the program and
takes nothing it made: the tables are the standard's, worked out here or
read from ``mp3gen``'s frozen ``iso_tables.npz``.
"""

import math

import numpy as np
import torch

import mp3gen_lame as lame
from mp3gen import ALIAS_CA, ALIAS_CS, SYNTH_WINDOW

BLOCK = 2048
_EXP_OFF = 266


def _tables():
    """The constants as the upstream decoder works them out (Python's
    power, NumPy's sines and cosines, each expression in its order)."""
    pow43 = np.array([float(i) ** (4.0 / 3.0) for i in range(8207)])
    exp1 = np.array([2.0 ** ((i - _EXP_OFF) / 4.0) for i in range(512)])
    exp2 = np.array([2.0 ** (-(i / 2.0)) for i in range(64)])
    i = np.arange(36)[:, None].astype(np.float64)
    k = np.arange(18)[None, :].astype(np.float64)
    c_long = np.cos(math.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
    i = np.arange(12)[:, None].astype(np.float64)
    k = np.arange(6)[None, :].astype(np.float64)
    c_short = np.cos(math.pi / 24.0 * (2 * i + 1 + 6) * (2 * k + 1))
    sb = np.zeros((4, 36))
    i = np.arange(36)
    sb[0] = np.sin(math.pi / 36.0 * (i + 0.5))
    sb[1, :18] = np.sin(math.pi / 36.0 * (i[:18] + 0.5))
    sb[1, 18:24] = 1.0
    sb[1, 24:30] = np.sin(math.pi / 12.0 * (i[24:30] - 18.0 + 0.5))
    sb[2, :12] = np.sin(math.pi / 12.0 * (i[:12] + 0.5))
    sb[3, :6] = 0.0
    sb[3, 6:12] = np.sin(math.pi / 12.0 * (i[6:12] - 6.0 + 0.5))
    sb[3, 12:18] = 1.0
    sb[3, 18:36] = np.sin(math.pi / 36.0 * (i[18:36] + 0.5))
    i = np.arange(64)[:, None].astype(np.float64)
    j = np.arange(32)[None, :].astype(np.float64)
    n_mat = np.cos((16.0 + i) * (2.0 * j + 1.0) * (math.pi / 64.0))
    inv = np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    return dict(pow43=pow43, exp1=exp1, exp2=exp2, c_long=c_long,
                c_short=c_short, win=sb, n_mat=n_mat, inv=inv.reshape(576),
                d_win=SYNTH_WINDOW.reshape(16, 32),
                cs=np.tile(ALIAS_CS, 31), ca=np.tile(ALIAS_CA, 31))


def _maps():
    """Per bitstream position: the long band (576,); for a short granule
    its (band, window) and where the reorder puts it."""
    lband = lame.long_bands()
    grp = lame.short_groups()
    sfb, win = grp // 3, grp % 3
    line = np.empty(576, dtype=np.int64)
    for s in range(576):
        b, w = sfb[s], win[s]
        first = 3 * lame.SHORT_START[b] + w * lame.SHORT_WIDTHS[b]
        line[s] = lame.SHORT_START[b] + s - first
    dst = 18 * (line // 6) + 6 * win + line % 6
    return lband, sfb, win, dst


def _requantize(truth, sl, t, dev):
    """(2, G, 576) float64 spectra of the granules ``sl``."""
    raw = torch.as_tensor(truth.ix[:, sl], device=dev).to(torch.int64)
    gg = torch.as_tensor(truth.gg[:, sl], device=dev).to(torch.int64)
    bt = torch.as_tensor(truth.block_type[:, sl], device=dev).to(torch.int64)
    mult = 1 + torch.as_tensor(truth.sf_scale[:, sl], device=dev).long()
    pre = torch.as_tensor(truth.preflag[:, sl], device=dev).long()
    sbg = torch.as_tensor(truth.sbg[:, sl], device=dev).long()
    sfl = torch.as_tensor(truth.sfl[:, sl], device=dev).long()
    sfs = torch.as_tensor(truth.sfs[:, sl], device=dev).long()
    lband, sfb, win, _ = (torch.as_tensor(a, device=dev) for a in _maps())
    pretab = torch.as_tensor(np.concatenate([lame.PRETAB, [0]]), device=dev)
    short = (bt == 2)[..., None]
    e1_long = gg[..., None] - 210 + _EXP_OFF + 0 * lband
    e1_short = gg[..., None] - 210 - 8 * sbg[..., win] + _EXP_OFF
    e1 = torch.where(short, e1_short, e1_long)
    sf_long = sfl[..., lband] + pre[..., None] * pretab[lband]
    sf_short = sfs[..., win, sfb]
    e2 = mult[..., None] * torch.where(short, sf_short, sf_long)
    sign = torch.where(raw < 0, -1.0, 1.0).to(torch.float64)
    return ((sign * t["pow43"][raw.abs()]) * t["exp1"][e1]) * t["exp2"][e2]


def _hybrid(x, bt, tail, t, dev):
    """Requantized (2, G, 576) spectra after stereo -> (2, G, 576) rows of
    the synthesis (overlapped and inverted), and the new tail (2, 32, 18)."""
    nch, g = x.shape[:2]
    short = (bt == 2)[..., None]
    _, _, _, dst = _maps()
    reordered = torch.zeros_like(x)
    reordered[..., torch.as_tensor(dst, device=dev)] = x
    sb = torch.arange(1, 32, device=dev)[:, None]
    s = torch.arange(8, device=dev)[None, :]
    lo_i = (18 * sb - s - 1).reshape(-1)
    hi_i = (18 * sb + s).reshape(-1)
    lo, hi = x[..., lo_i], x[..., hi_i]
    aliased = x.clone()
    aliased[..., lo_i] = lo * t["cs"] - hi * t["ca"]
    aliased[..., hi_i] = hi * t["cs"] + lo * t["ca"]
    w = torch.where(short, reordered, aliased).reshape(nch, g, 32, 18)
    del reordered, aliased

    xi = torch.zeros((nch, g, 32, 36), dtype=torch.float64, device=dev)
    for k in range(18):
        xi = xi + w[..., k, None] * t["c_long"][:, k]
    blk_long = xi * t["win"][bt.clamp(0, 3)][:, :, None, :]
    del xi
    xs = []
    for wn in range(3):
        acc = torch.zeros((nch, g, 32, 12), dtype=torch.float64, device=dev)
        for k in range(6):
            acc = acc + w[..., 6 * wn + k, None] * t["c_short"][:, k]
        xs.append(acc * t["win"][2, :12])
    z6 = torch.zeros_like(xs[0][..., :6])
    blk_short = torch.cat([z6, xs[0][..., :6], xs[0][..., 6:] + xs[1][..., :6],
                           xs[1][..., 6:] + xs[2][..., :6], xs[2][..., 6:],
                           z6], -1)
    blk = torch.where((bt == 2)[..., None, None], blk_short, blk_long)
    del blk_short, blk_long, xs
    prev = torch.cat([tail[:, None], blk[:, :-1, :, 18:]], 1)
    y = (blk[..., :18] + prev).reshape(nch, g, 576) * t["inv"]
    return y, blk[:, -1, :, 18:].clone()


def _synthesis(y, hist, t, dev):
    """(2, G, 576) rows -> (2, G * 576) float64 PCM, with the 15 V rows of
    history (2, 15, 64) before them; returns (PCM, the new history)."""
    nch, g = y.shape[:2]
    steps = g * 18
    st = y.reshape(nch, g, 32, 18).transpose(2, 3).reshape(nch, steps, 32)
    v = torch.zeros((nch, steps, 64), dtype=torch.float64, device=dev)
    for j in range(32):
        v = v + st[..., j, None] * t["n_mat"][:, j]
    vv = torch.cat([hist, v], 1)
    halves = (vv[..., :32], vv[..., 32:])
    pcm = torch.zeros((nch, steps, 32), dtype=torch.float64, device=dev)
    for j in range(16):
        pcm = pcm + halves[j % 2][:, 15 - j:15 - j + steps] * t["d_win"][j]
    return pcm.reshape(nch, steps * 32), vv[:, -15:].clone()


def decode(truth, device) -> np.ndarray:
    """``truth``'s audio frames -> (T * 576, 2) interleaved int16 PCM, in
    float64, the precision the configuration states. Every state starts
    from zeros."""
    dev = torch.device(device)
    t = {name: torch.as_tensor(v, dtype=torch.float64, device=dev)
         for name, v in _tables().items()}
    nch, tt = truth.ix.shape[:2]
    tail = torch.zeros((nch, 32, 18), dtype=torch.float64, device=dev)
    hist = torch.zeros((nch, 15, 64), dtype=torch.float64, device=dev)
    ms_all = torch.as_tensor(truth.ms, device=dev)
    out = []
    for g0 in range(0, tt, BLOCK):
        sl = slice(g0, min(tt, g0 + BLOCK))
        x = _requantize(truth, sl, t, dev)
        ms = ms_all[sl][:, None]
        mid, side = x[0], x[1]
        rt2 = math.sqrt(2.0)
        x = torch.stack([torch.where(ms, (mid + side) / rt2, mid),
                         torch.where(ms, (mid - side) / rt2, side)])
        bt = torch.as_tensor(truth.block_type[:, sl], device=dev).long()
        y, tail = _hybrid(x, bt, tail, t, dev)
        pcm, hist = _synthesis(y, hist, t, dev)
        q = (pcm * 32767.0).clamp(-32768.0, 32767.0).to(torch.int16)
        out.append(q.T.contiguous().cpu())
        del x, y, pcm
    return torch.cat(out).numpy()
