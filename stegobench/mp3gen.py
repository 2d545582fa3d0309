"""The benchmark's own inputs: seeded music-like PCM and an MPEG-1 Layer III
CBR writer for it, in plain PyTorch (float64) on any device.

Nothing here imports the program. The writer is a plain encoder of the
ISO/IEC 11172-3 Layer III bitstream: the polyphase analysis filterbank, the
long-block MDCT with the alias butterflies, left/right stereo (mode 0, as
the upstream library's ``encode_wav_to_mp3`` writes its files), no
low-pass, one global gain a granule found by bisection so that its Huffman
bits fill the granule's share of the frame, the region, table and count1
choices of least bits, and no bit reservoir (``main_data_begin`` 0, the rest
of each frame's main data zero). Scalefactors are all zero
(``scalefac_compress`` 0), every block is long (no window switching).

``encode`` returns the file's bytes and its ``Truth``: the quantized
spectra and the global gains that the bytes carry, which the plain
reference (``reference.py``) decodes on its own.

The synthesis window and the Huffman tables in ``iso_tables.npz`` are the
standard's (Table B.3, the Annex B code tables and the 44.1 kHz long-band
boundaries), copied frozen from ``mp3stego_tpu_torch/tables/iso_tables.npz``
at commit e1ac834. The PCM generator extends ``chip_smoke.seeded_song`` (same
commit): a drifting tone with overtones, noise under a slow envelope,
seeded percussive transients and half a second of silence every 20 s.
"""

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 44100
SR_IDX = 0
_T = np.load(os.path.join(HERE, "iso_tables.npz"))
HUFF_CODE = _T["huff_code"].astype(np.int64)       # (34, 16, 16)
HUFF_LEN = _T["huff_len"].astype(np.int64)         # (34, 16, 16)
HUFF_XLEN = _T["huff_xlen"].astype(np.int64)       # (34,)
HUFF_LINBITS = _T["huff_linbits"].astype(np.int64)
HUFF_LINMAX = _T["huff_linmax"].astype(np.int64)
BAND_LONG = _T["scale_fact_band_index"][SR_IDX].astype(np.int64)   # (23,)
SYNTH_WINDOW = _T["synth_window"].astype(np.float64)               # (512,)
BITRATES = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320)
# the regions of the big values: region0_count 7 and region1_count 7 put
# the boundaries at the long bands 8 and 16 (samples 36 and 162 at 44.1 kHz)
REGION0_COUNT, REGION1_COUNT = 7, 7
REGION_PAIRS = (int(BAND_LONG[REGION0_COUNT + 1]) // 2,
                int(BAND_LONG[REGION0_COUNT + REGION1_COUNT + 2]) // 2)
MAX_IX = 15 + 8191                # the largest value table 23 or 31 codes
ALIAS_CS = (.8574929257, .8817419973, .9496286491, .9833145925,
            .9955178161, .9991605582, .9998991952, .9999931551)
ALIAS_CA = (-.5144957554, -.4717319686, -.3133774542, -.1819131996,
            -.0945741925, -.0409655829, -.0141985686, -.0036999747)


@dataclass
class Truth:
    """What a file carries: ``ix`` (2, T, 576) int16, the signed quantized
    spectra of each channel's T granules, ``gg`` (2, T) its global
    gains, ``frames`` and ``escapes`` (values above 15, which take linbits)."""
    ix: np.ndarray
    gg: np.ndarray
    frames: int
    escapes: int

    @property
    def audio_s(self) -> float:
        return self.frames * 1152 / SR


def song_pcm(seconds: float, seed: int, device) -> torch.Tensor:
    """(n, 2) int16 stereo PCM at 44.1 kHz, made on ``device`` from ``seed``
    in a few large calls: nothing of it repeats, and the same seed gives the
    same samples on the same device."""
    n = int(round(seconds * SR))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.rand(8, generator=g, **f64)
    noise = torch.randn(3, n, generator=g, **f64)
    t = torch.arange(n, **f64) / SR
    base = 110.0 * 2.0 ** (2.0 * u[0])
    drift = 2.0 ** ((1.0 + u[1]) * torch.sin(t / (4.0 + 4.0 * u[2])))
    phase = 2 * math.pi * torch.cumsum(base * drift, 0) / SR
    env = torch.sin(2 * math.pi * t / (7.0 + 8.0 * u[3])) ** 2
    # percussive transients: about 2 a second, each a burst of noise that
    # decays over some 60 ms from its onset
    onset = torch.rand(n, generator=g, **f64) < 2.0 / SR
    idx = torch.arange(n, device=device)
    last = torch.cummax(torch.where(onset, idx, torch.zeros_like(idx)), 0)[0]
    hit = torch.cumsum(onset.to(torch.int64), 0) > 0
    burst = torch.where(hit, torch.exp(-(idx - last).to(torch.float64)
                                       / (0.06 * SR)), 0.0)
    sig = (0.30 * torch.sin(phase) + 0.12 * torch.sin(3.01 * phase)
           + 0.06 * torch.sin(5.03 * phase)
           + 0.15 * env * noise[0] + 0.45 * burst * noise[1])
    sig = torch.where(torch.remainder(t, 20.0) < 0.5, 0.0, sig)
    right = 0.8 * torch.roll(sig, 999) + 0.05 * noise[2]
    pcm = torch.stack([sig, right], 1) * 30000.0
    return pcm.clamp(-32768, 32767).to(torch.int16)


def frame_bytes(frames: int, kbps: int) -> np.ndarray:
    """Each frame's length in bytes at ``kbps``: 144 * rate / 44100 and a
    padding byte where the running total passes the next whole byte."""
    exact = 144 * kbps * 1000
    ends = (np.arange(1, frames + 1, dtype=np.int64) * exact) // SR
    return np.diff(np.concatenate([[0], ends]))


def _analysis(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(2, n) float PCM in [-1, 1) -> (2, 2F, 576) spectra: the polyphase
    filterbank (ISO 11172-3 2.4.3.2, the analysis window C = D / 32), the
    18-point MDCT of each subband over two granules under the sine window,
    with the odd subbands' odd samples negated, then the alias butterflies."""
    dev = x.device
    f64 = dict(dtype=torch.float64, device=dev)
    steps = frames * 36
    need = 480 + 32 * steps
    xp = torch.zeros((2, need + 32), **f64)
    m = min(x.shape[1], need - 480)
    xp[:, 480:480 + m] = x[:, :m]
    win = xp.unfold(1, 512, 32)[:, :steps].flip(-1)         # X[i], newest 0
    c = torch.as_tensor(SYNTH_WINDOW / 32.0, **f64)
    y = (win * c).reshape(2, steps, 8, 64).sum(2)
    k = torch.arange(32, **f64)[:, None]
    i = torch.arange(64, **f64)[None, :]
    mat = torch.cos((2 * k + 1) * (i - 16) * math.pi / 64)
    sub = y @ mat.T                                           # (2, steps, 32)
    sub = sub.reshape(2, 2 * frames, 18, 32).permute(0, 1, 3, 2)
    odd = torch.ones(32, 18, **f64)
    odd[1::2, 1::2] = -1.0
    sub = sub * odd
    prev = torch.cat([torch.zeros_like(sub[:, :1]), sub[:, :-1]], 1)
    z = torch.cat([prev, sub], -1)                            # (2, T, 32, 36)
    n36 = torch.arange(36, **f64)
    sine = torch.sin(math.pi / 36 * (n36 + 0.5))
    kk = torch.arange(18, **f64)
    cmat = torch.cos(math.pi / 72 * (2 * n36[:, None] + 1 + 18)
                     * (2 * kk[None, :] + 1))                  # (36, 18)
    xr = ((z * sine) @ cmat) / 9.0                            # (2, T, 32, 18)
    cs = torch.as_tensor(ALIAS_CS, **f64)
    ca = torch.as_tensor(ALIAS_CA, **f64)
    lo = xr[:, :, :-1, 17 - torch.arange(8, device=dev)].clone()
    hi = xr[:, :, 1:, :8].clone()
    xr[:, :, :-1, 17 - torch.arange(8, device=dev)] = lo * cs + hi * ca
    xr[:, :, 1:, :8] = hi * cs - lo * ca
    return xr.reshape(2, 2 * frames, 576)


class _Books:
    """The Huffman tables as tensors on one device."""

    def __init__(self, device):
        t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        self.code = t(HUFF_CODE.reshape(34, 256))
        self.len = t(HUFF_LEN.reshape(34, 256))
        self.linbits = t(HUFF_LINBITS)


def _layout(a: torch.Tensor):
    """|ix| (L, 576) -> (big_values, count1) a lane, as an encoder splits
    the spectrum: the trailing zero pairs dropped, then quads of values of
    at most 1 taken from the top while they last."""
    dev = a.device
    pos = torch.arange(1, 577, device=dev)
    last = torch.where(a > 0, pos, 0).amax(1)
    top = last + (last & 1)
    small = a <= 1
    count1 = torch.zeros_like(top)
    for al in (0, 2):
        q = (576 - al) // 4
        sq = small[:, al:al + 4 * q].reshape(-1, q, 4).all(-1)
        qi = torch.arange(1, q + 1, device=dev)
        last_false = torch.cummax(torch.where(sq, 0, qi), 1)[0]
        run = qi - last_false                      # small quads ending at q
        at = (top - al) // 4 - 1
        pick = torch.gather(run, 1, at.clamp(0, q - 1)[:, None])[:, 0]
        use = (top % 4 == al) & (at >= 0)
        count1 = torch.where(use, pick, count1)
    return (top - 4 * count1) // 2, count1


def _pair_bits(books: _Books, x, y, table: int):
    """Bits of the pairs (x, y) >= 0 under ``table``."""
    cx, cy = x.clamp(max=15), y.clamp(max=15)
    bits = books.len[table][cx * 16 + cy] + (x > 0) + (y > 0)
    if table >= 16:
        bits = bits + HUFF_LINBITS[table] * ((x >= 15).long()
                                             + (y >= 15).long())
    return bits


def _choose(books: _Books, a: torch.Tensor, bv: torch.Tensor,
            count1: torch.Tensor):
    """The table of least bits in each region and the count1 table of
    least bits; returns (bits, tables (L, 3), count1 table (L,))."""
    dev = a.device
    x, y = a[:, 0::2], a[:, 1::2]                             # (L, 288)
    j = torch.arange(288, device=dev)
    region = (j >= REGION_PAIRS[0]).long() + (j >= REGION_PAIRS[1]).long()
    inside = j[None, :] < bv[:, None]
    big = torch.maximum(x, y) * inside
    rmax = torch.stack([torch.where(region == r, big, 0).amax(1)
                        for r in range(3)], 1)                 # (L, 3)
    inf = torch.iinfo(torch.int64).max // 4
    best = torch.where(rmax == 0, 0, inf)
    tables = torch.zeros_like(rmax)
    onehot = torch.stack([(region == r) for r in range(3)], 0)  # (3, 288)
    for t in range(1, 32):
        if HUFF_XLEN[t] == 0:
            continue
        ok = (rmax < HUFF_XLEN[t]) if t < 16 \
            else (rmax - 15 <= HUFF_LINMAX[t])
        pb = _pair_bits(books, x, y, t) * inside
        cost = torch.stack([(pb * onehot[r]).sum(1) for r in range(3)], 1)
        better = ok & (rmax > 0) & (cost < best)
        best = torch.where(better, cost, best)
        tables = torch.where(better, t, tables)
    q = torch.arange(144, device=dev)
    start = 2 * bv
    # the quads start at 2 * bv, which need not be a multiple of 4
    qidx = (start[:, None] + 4 * q[None, :]).clamp(max=572)
    inq = q[None, :] < count1[:, None]
    quads = torch.stack([torch.gather(a, 1, qidx + d) for d in range(4)], -1)
    p = 8 * quads[..., 0] + 4 * quads[..., 1] + 2 * quads[..., 2] \
        + quads[..., 3]
    signs = (quads > 0).sum(-1)
    c1a = ((books.len[32][p] + signs) * inq).sum(1)
    c1b = ((4 + signs) * inq).sum(1)
    c1t = (c1b < c1a).long()
    bits = best.sum(1) + torch.minimum(c1a, c1b)
    return bits, tables, c1t, rmax


def _quantize(mag34: torch.Tensor, gg: torch.Tensor) -> torch.Tensor:
    """|ix| at global gain ``gg`` (L,) of the spectra's |xr| ** 0.75."""
    scale = torch.pow(2.0, -0.1875 * (gg.to(torch.float64) - 210.0))
    return torch.floor(mag34 * scale[:, None] + 0.4054).clamp(max=1 << 20) \
        .long()


def _fields_pack(total_bits: int, fields: list, device) -> bytes:
    """Write (value, length, bit position) fields, each at most 32 bits
    long and none overlapping, into a zeroed big-endian byte string of
    ``total_bits`` bits."""
    words = torch.zeros(total_bits // 32 + 2, dtype=torch.int64,
                        device=device)
    mask = (1 << 32) - 1
    for v, n, p in fields:
        keep = n > 0
        v, n, p = v[keep], n[keep], p[keep]
        w, o = p >> 5, p & 31
        end = o + n
        one = end <= 32
        words.index_add_(0, w[one], v[one] << (32 - end[one]))
        two = ~one
        words.index_add_(0, w[two], v[two] >> (end[two] - 32))
        words.index_add_(0, w[two] + 1,
                         (v[two] << (64 - end[two])) & mask)
    b = torch.stack([(words >> s) & 255 for s in (24, 16, 8, 0)], 1)
    return bytes(b.reshape(-1)[:total_bits // 8].to(torch.uint8).cpu()
                 .numpy())


# the writer codes the lines below this one (21.7 kHz) and leaves the top
# 8 zero
TOP_LINE = 568


def encode(pcm: torch.Tensor, kbps: int) -> tuple:
    """(n, 2) int16 PCM on a device -> (MP3 bytes, ``Truth``), one CBR
    stereo (mode 0) MPEG-1 Layer III file at ``kbps``."""
    dev = pcm.device
    n = pcm.shape[0]
    frames = -(-n // 1152)
    x = pcm.T.to(torch.float64) / 32768.0
    xr = _analysis(x, frames)
    xr[..., TOP_LINE:] = 0.0
    tg = 2 * frames
    lanes = xr.reshape(2 * tg, 576)            # lane = ch * T + granule
    mag34 = lanes.abs() ** 0.75
    fb = frame_bytes(frames, kbps)
    budget_f = (8 * (fb - 36)) // 4                          # a lane's bits
    budget = torch.as_tensor(np.tile(np.repeat(budget_f, 2), 2),
                             device=dev)
    books = _Books(dev)
    lo = torch.full((2 * tg,), -1, dtype=torch.int64, device=dev)
    hi = torch.full((2 * tg,), 255, dtype=torch.int64, device=dev)
    for _ in range(8):
        mid = (lo + hi) // 2
        a = _quantize(mag34, mid)
        bv, c1 = _layout(a)
        bits = _choose(books, a, bv, c1)[0]
        ok = (bits <= budget) & (a.amax(1) <= MAX_IX)
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid)
    gg = hi
    a = _quantize(mag34, gg)
    bv, c1 = _layout(a)
    bits, tables, c1t, _ = _choose(books, a, bv, c1)
    if bool(((bits > budget) | (a.amax(1) > MAX_IX)).any()):
        raise ValueError("a granule does not fit its share of the frame")
    ix = torch.where(lanes < 0, -a, a)
    truth = Truth(ix=ix.reshape(2, tg, 576).to(torch.int16).cpu().numpy(),
                  gg=gg.reshape(2, tg).cpu().numpy().astype(np.int16),
                  frames=frames, escapes=int((a > 15).sum()))
    data = _bitstream(books, a, ix, gg, bv, c1, bits, tables, c1t, fb,
                      kbps)
    return data, truth


def _bitstream(books, a, ix, gg, bv, c1, bits, tables, c1t, fb, kbps):
    """The frames' bytes: header, side information and the four granules'
    Huffman data in the order (gr0 ch0, gr0 ch1, gr1 ch0, gr1 ch1)."""
    dev = a.device
    frames = len(fb)
    tg = 2 * frames
    starts = np.concatenate([[0], np.cumsum(fb)[:-1]]) * 8
    start_t = torch.as_tensor(starts, device=dev)
    fields = []
    # header: sync, MPEG-1, Layer III, no CRC, rate, 44.1 kHz, padding,
    # stereo (mode 0, no mode extension), original
    pad = torch.as_tensor(fb - fb.min(), device=dev)
    head = (0x7FF << 21) | (3 << 19) | (1 << 17) | (1 << 16) \
        | (BITRATES.index(kbps) << 12) | (SR_IDX << 10) | (1 << 2)
    fields.append((head | (pad << 9), torch.full_like(pad, 32), start_t))
    # lanes in stream order: frame f, granule gr, channel ch
    f = torch.arange(frames, device=dev)
    order = torch.stack([torch.stack([c * tg + 2 * f + gr for c in (0, 1)],
                                     1) for gr in (0, 1)], 1).reshape(-1)
    p23 = bits[order]
    si = start_t.repeat_interleave(4) + 32 + 20 \
        + 59 * torch.arange(4, device=dev).repeat(frames)
    fields.append(((p23 << 17) | (bv[order] << 8) | gg[order],
                   torch.full_like(p23, 29), si))
    tb = tables[order]
    second = (tb[:, 0] << 20) | (tb[:, 1] << 15) | (tb[:, 2] << 10) \
        | (REGION0_COUNT << 6) | (REGION1_COUNT << 3) | c1t[order]
    fields.append((second, torch.full_like(p23, 30), si + 29))
    # main data: each lane's bits from 288 past its frame's start
    md = start_t.repeat_interleave(4) + 288 \
        + (torch.cumsum(p23.reshape(frames, 4), 1) - p23.reshape(frames, 4)) \
        .reshape(-1)
    al, sx = a[order], ix[order] < 0
    bvo, c1o, c1to = bv[order], c1[order], c1t[order]
    x, y = al[:, 0::2], al[:, 1::2]
    sxx, syy = sx[:, 0::2].long(), sx[:, 1::2].long()
    j = torch.arange(288, device=dev)
    region = (j >= REGION_PAIRS[0]).long() + (j >= REGION_PAIRS[1]).long()
    tab = torch.gather(tb, 1, region[None, :].expand(tb.shape[0], 288))
    inside = (j[None, :] < bvo[:, None]) & (tab > 0)
    cx, cy = x.clamp(max=15), y.clamp(max=15)
    cell = cx * 16 + cy
    code = books.code[tab, cell]
    clen = books.len[tab, cell]
    lin = books.linbits[tab]
    esc = tab >= 16
    # tables 1..15: code, sign x, sign y
    nx, ny = (x > 0).long(), (y > 0).long()
    small_v = (((code << nx) | (sxx * nx)) << ny) | (syy * ny)
    small_n = clen + nx + ny
    # tables 16..31: code, then x's linbits and sign, then y's
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
    fields.append((head_v.reshape(-1)[keep], head_n.reshape(-1)[keep],
                   ppos.reshape(-1)[keep]))
    fields.append((ext_v.reshape(-1)[keep], ext_n.reshape(-1)[keep],
                   (ppos + head_n).reshape(-1)[keep]))
    # count1 quads after the big values
    q = torch.arange(144, device=dev)
    qidx = (2 * bvo[:, None] + 4 * q[None, :]).clamp(max=572)
    inq = q[None, :] < c1o[:, None]
    quads = torch.stack([torch.gather(al, 1, qidx + d) for d in range(4)], -1)
    qs = torch.stack([torch.gather(sx.long(), 1, qidx + d)
                      for d in range(4)], -1)
    pq = 8 * quads[..., 0] + 4 * quads[..., 1] + 2 * quads[..., 2] \
        + quads[..., 3]
    qcode = torch.where(c1to[:, None] == 1, books.code[33][pq],
                        books.code[32][pq])
    qlen = torch.where(c1to[:, None] == 1, books.len[33][pq],
                       books.len[32][pq])
    for d in range(4):
        nz = quads[..., d]
        qcode = (qcode << nz) | (qs[..., d] * nz)
        qlen = qlen + nz
    qlen = qlen * inq
    qpos = (md + pbits.sum(1))[:, None] + torch.cumsum(qlen, 1) - qlen
    keepq = inq.reshape(-1)
    fields.append((qcode.reshape(-1)[keepq], qlen.reshape(-1)[keepq],
                   qpos.reshape(-1)[keepq]))
    return _fields_pack(int(fb.sum()) * 8, fields, dev)
