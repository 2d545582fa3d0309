"""The plain reference decode: plain PyTorch in float64 on any device.

It decodes what ``mp3gen.encode`` put in a file (``mp3gen.Truth``: the
quantized spectra and global gains of a stereo file) to interleaved int16
PCM, in
the arithmetic of the upstream decoder that the configurations name
(tomershay100/mp3-steganography-lib, decoder/Frame.py): the requantize as
(sign x |ix| ** 4/3) x 2 ** ((gain - 210) / 4), the alias butterflies, the long IMDCT and the synthesis matrix and
window as sums in ascending order with every product and sum rounded on
its own, and the int16 conversion as x * 32767 saturated, then truncated.

It imports nothing of the program and takes nothing it made: the tables
are the standard's, worked out here or read from the frozen
``iso_tables.npz`` beside this file.
"""

import math

import numpy as np
import torch

from mp3gen import ALIAS_CA, ALIAS_CS, SYNTH_WINDOW, Truth

_EXP_OFF = 266          # the requantize's exponent table starts at 2 ** -66.5


def _tables():
    """The constants, each worked out on the host as the upstream decoder
    does (Python's power for x ** 4/3 and 2 ** e/4, NumPy's cosines)."""
    pow43 = np.array([float(i) ** (4.0 / 3.0) for i in range(8207)])
    exp1 = np.array([2.0 ** ((i - _EXP_OFF) / 4.0) for i in range(512)])
    i = np.arange(36)[:, None].astype(np.float64)
    k = np.arange(18)[None, :].astype(np.float64)
    c_long = np.cos(math.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
    n = np.arange(36)
    sine = np.sin(math.pi / 36.0 * (n + 0.5))
    i = np.arange(64)[:, None].astype(np.float64)
    j = np.arange(32)[None, :].astype(np.float64)
    n_mat = np.cos((16.0 + i) * (2.0 * j + 1.0) * (math.pi / 64.0))
    inv = np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    return dict(pow43=pow43, exp1=exp1, c_long=c_long, sine=sine,
                n_mat=n_mat, inv=inv.reshape(576),
                d_win=SYNTH_WINDOW.reshape(16, 32),
                cs=np.tile(ALIAS_CS, 31), ca=np.tile(ALIAS_CA, 31))


def decode(truth: Truth, device) -> np.ndarray:
    """``truth``'s file -> (T * 576, 2) interleaved int16 PCM, in float64,
    the precision the configurations state. Every state starts from
    zeros."""
    precision = torch.float64
    t = {name: torch.as_tensor(v, dtype=precision, device=device)
         for name, v in _tables().items()}
    raw = torch.as_tensor(truth.ix, device=device).to(torch.int64)
    gg = torch.as_tensor(truth.gg, device=device).to(torch.int64)
    nch, tt = raw.shape[0], raw.shape[1]

    # requantize
    sign = torch.where(raw < 0, -1.0, 1.0).to(precision)
    x = (sign * t["pow43"][raw.abs()]) * t["exp1"][gg - 210 + _EXP_OFF][
        ..., None]

    # alias butterflies between neighbouring subbands
    sb = torch.arange(1, 32, device=device)[:, None]
    s = torch.arange(8, device=device)[None, :]
    lo_i = (18 * sb - s - 1).reshape(-1)
    hi_i = (18 * sb + s).reshape(-1)
    lo, hi = x[..., lo_i], x[..., hi_i]
    x = x.clone()
    x[..., lo_i] = lo * t["cs"] - hi * t["ca"]
    x[..., hi_i] = hi * t["cs"] + lo * t["ca"]

    # IMDCT, sine window, overlap with the granule before
    s18 = x.reshape(nch, tt, 32, 18)
    xi = torch.zeros((nch, tt, 32, 36), dtype=precision, device=device)
    for k in range(18):
        xi = xi + s18[..., k, None] * t["c_long"][:, k]
    blk = xi * t["sine"]
    prev = torch.cat([torch.zeros_like(blk[:, :1, :, 18:]),
                      blk[:, :-1, :, 18:]], 1)
    y = (blk[..., :18] + prev).reshape(nch, tt, 576) * t["inv"]
    del xi, blk, prev, x

    # synthesis: V = N st, then the 16 taps of the window D
    st = y.reshape(nch, tt, 32, 18).transpose(2, 3).reshape(nch, tt * 18, 32)
    v = torch.zeros((nch, tt * 18, 64), dtype=precision, device=device)
    for j in range(32):
        v = v + st[..., j, None] * t["n_mat"][:, j]
    pad = torch.zeros((nch, 15, 32), dtype=precision, device=device)
    halves = (torch.cat([pad, v[..., :32]], 1), torch.cat([pad, v[..., 32:]],
                                                          1))
    steps = tt * 18
    pcm = torch.zeros((nch, steps, 32), dtype=precision, device=device)
    for j in range(16):
        pcm = pcm + halves[j % 2][:, 15 - j:15 - j + steps] * t["d_win"][j]
    del v, halves
    out = (pcm.reshape(nch, tt * 576) * 32767.0).clamp(-32768.0, 32767.0)
    return out.to(torch.int16).T.contiguous().cpu().numpy()
