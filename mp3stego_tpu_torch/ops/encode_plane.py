"""Encode numeric plane in torch: polyphase analysis filterbank, forward MDCT
and alias butterflies, in exact Q31 fixed point.

The reference feeds a 512-sample ring buffer 32 samples at a time
(MP3_Encoder.py:321-370, 751-758); the ring arithmetic reduces to a sliding
window over each channel's PCM stream:

    tmp_t[i]  = sum_k mul(s[32t + 31 - i - 64k], enwindow[i + 64k])   k<8, i<64
    sb_t[b]   = sum_j mul(fl[b][j], tmp_t[j])                          j<64

The MDCT input of granule g is [subband(g-1) ; subband(g)] per band
(MP3_Encoder.py:681-701), and the alias butterflies (MP3_Encoder.py:703-744)
read only unmodified MDCT outputs, so the whole file is dense elementwise
products and reductions. Every product is int64 shifted and narrowed to int32
(``ops/fixedpoint``); every sum wraps mod 2^32, so any reduction order is
bit-exact against the sequential reference and against the host C++ twin
(``run_analysis_native``, ``mp3stego_tpu/native/src/encode_plane.cpp``).

* ``analysis_stream`` — the wrapper every caller goes through. A CPU tensor
  takes the plain version; a CUDA tensor launches ``csrc/analysis.cu`` (one
  launch over the whole stream; it replaces the JAX package's XLA program
  ``mp3stego_tpu/ops/encode_plane.py::analysis_mdct``) or raises. There is
  no fallback from the card to the plain version.
* ``analysis_stream_torch`` — the plain PyTorch version over
  :func:`analysis_mdct`. A whole song does not fit its int64 product tensors
  at once (the filter step alone is (ch, steps, 32, 64) int64), so it runs in
  granule chunks, each with one granule of MDCT context and 480 samples of
  filterbank history in front. The kernel equals it bit for bit.
* ``launches`` — how many times the kernel was launched in this process.
"""

import ctypes
import functools

import numpy as np
import torch

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.ops import fixedpoint as fx

_PAST = 480          # deepest lookback of the window: 31 - 63 - 448 = -480
CHUNK_G = 1024       # granules per chunk of analysis_stream_torch

launches = 0

_P = ctypes.c_void_p
_SIGNATURES = {
    "analysis_mdct": (ctypes.c_int, (
        _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,    # pcm .. skip
        _P, _P, _P, _P, _P,                                   # tables
        _P, _P)),                                             # out, stream
    "analysis_tile": (ctypes.c_int, (_P, _P)),
}


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(window (8, 64), filter (32, 64), MDCT cosines (18, 36), alias cs
    (8,), alias ca (8,)), int64 on ``device``."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64),  # noqa: E731
                                  device=device)
    return (t(T.ENWINDOW.reshape(8, 64)), t(T.subband_filter_fixed()),
            t(T.mdct_cos_fixed()), t(T.MDCT_CS_FIX), t(T.MDCT_CA_FIX))


def analysis_mdct(pcm: torch.Tensor) -> torch.Tensor:
    """PCM (ch, N) int32 (already << 16) -> mdct_freq (ch, Tg, 576) int32.

    ``pcm`` carries 480 samples of history in front (zeros at the start of
    a file); N - 480 must be a multiple of 576 (18 steps of 32), and
    Tg = (N - 480) // 576. Granule 0's MDCT reads a zero previous granule.
    """
    win, fl, cos_l, cs, ca = _tables(pcm.device)
    ch, n = pcm.shape
    ts = (n - _PAST) // 32                     # window steps
    tg = ts // 18                              # granules

    # window: W[t, j] = pcm[32t + j] (j < 512) from 16 shifted slices; the
    # sample for (k, i) is pcm[32t + 511 - i - 64k], so reversing W and
    # reshaping to (8, 64) lines it up with the window table
    z = pcm.reshape(ch, n // 32, 32)
    w = torch.cat([z[:, r:r + ts] for r in range(16)], dim=2)    # (ch,ts,512)
    v = w.flip(-1).reshape(ch, ts, 8, 64)
    tmp = fx.mul(v, win).sum(dim=2, dtype=torch.int32)           # (ch,ts,64)

    # 32-band filter, then the analysis inversion (odd step, odd band)
    sb = fx.mul(fl, tmp[:, :, None, :]).sum(dim=-1, dtype=torch.int32)
    odd = torch.arange(ts, device=pcm.device) % 18 % 2 == 1
    band_odd = torch.arange(32, device=pcm.device) % 2 == 1
    sb = torch.where(odd[:, None] & band_odd[None], -sb, sb)     # (ch,ts,32)
    sbg = sb.reshape(ch, tg, 18, 32)

    # MDCT over [previous granule ; this granule] per band
    prev = torch.cat([torch.zeros_like(sbg[:, :1]), sbg[:, :-1]], dim=1)
    mdct_in = torch.cat([prev, sbg], dim=2).transpose(2, 3)      # (ch,tg,32,36)
    freq = fx.mul(mdct_in[:, :, :, None, :], cos_l).sum(
        dim=-1, dtype=torch.int32)                               # (ch,tg,32,18)

    # alias butterflies: band b slot i ("bu") with band b-1 slot 17-i ("bd")
    up = freq[:, :, 1:, :8]
    dn = freq[:, :, :-1, 10:18].flip(-1)
    bu, bd = fx.cmuls(up, dn, cs, ca)
    freq[:, :, 1:, :8] = bu
    freq[:, :, :-1, 10:18] = bd.flip(-1)
    return freq.reshape(ch, tg, 576)


def _padded_streams(pcm_i16: np.ndarray, num_granules: int) -> np.ndarray:
    """(ch, n) int16 -> (ch, 480 + Tg*576) int16: zero history in front,
    cut or zero-filled to whole granules behind."""
    ch, n = pcm_i16.shape
    need = num_granules * 576
    full = np.zeros((ch, _PAST + need), np.int16)
    full[:, _PAST:_PAST + min(n, need)] = pcm_i16[:, :need]
    return full


def run_analysis_device(pcm_i16: np.ndarray, num_granules: int, device,
                        chunk_g: int = CHUNK_G) -> torch.Tensor:
    """Raw int16 streams (ch, n) -> resident (ch, Tg, 576) int32 spectra on
    ``device``.

    The int16 PCM crosses to the device once and is upshifted there, by the
    kernel on the card (``chunk_g`` bounds only the plain version's memory
    on the CPU)."""
    full = torch.from_numpy(_padded_streams(pcm_i16, num_granules)).to(device)
    return analysis_stream(full, chunk_g)


def analysis_stream_torch(full: torch.Tensor, chunk_g: int = CHUNK_G,
                          skip: int = 0) -> torch.Tensor:
    """Plain version of :func:`analysis_stream` on ``full``'s device: the
    eager plane in chunks of ``chunk_g`` granules, each reading one granule
    of MDCT context and 480 samples of history before it, so the result is
    the same for every chunk size."""
    num_granules = (full.shape[1] - _PAST) // 576
    parts = []
    a = skip
    while a < num_granules:
        s = max(0, a - 1)                      # 1 granule of MDCT context
        e = min(num_granules, s + chunk_g + 1)
        sl = full[:, s * 576: e * 576 + _PAST].to(torch.int32) << 16
        parts.append(analysis_mdct(sl)[:, a - s:])
        a = e
    if not parts:
        return torch.zeros((full.shape[0], 0, 576), dtype=torch.int32,
                           device=full.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _check(full: torch.Tensor, skip: int):
    """What the wrapper takes: int16 streams (ch, 480 + Tg * 576), skip >=
    0, on the CPU or the card (there C-contiguous)."""
    if full.dim() != 2 or full.dtype != torch.int16 or full.shape[0] < 1:
        raise ValueError(f"the analysis wants int16 streams (ch, 480 + Tg * "
                         f"576), got {tuple(full.shape)} {full.dtype}")
    if full.shape[1] < _PAST or (full.shape[1] - _PAST) % 576:
        raise ValueError(f"a stream of {full.shape[1]} samples is not 480 + "
                         f"Tg * 576")
    if skip < 0:
        raise ValueError(f"skip must be >= 0, got {skip}")
    if full.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the analysis runs on CPU or CUDA tensors, got "
                         f"{full.device}")
    if full.device.type == "cuda" and not full.is_contiguous():
        raise ValueError("the CUDA analysis takes C-contiguous streams")


@functools.lru_cache(maxsize=None)
def _kernel_tables(device: torch.device) -> tuple:
    """The kernel's tables: the window (512,) and the filter (32, 64) int32
    on ``device``, the MDCT cosines (18, 36) and the alias coefficients
    (8,) int32 on the host (the launch copies them into its parameters).
    Raises if the window does not fit int32 (the kernel's products are
    int32 x int32)."""
    win = np.asarray(T.ENWINDOW, np.int64)
    if not np.array_equal(win, win.astype(np.int32)):
        raise ValueError("the analysis window does not fit int32")
    _, fl, cos_l, cs, ca = _native_tables()
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dev(win.astype(np.int32)), dev(fl), cos_l, cs, ca


def tile() -> tuple:
    """(output granules, dynamic shared memory bytes) per CTA of the
    kernel; builds it on first use."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("analysis", _SIGNATURES)
    g, smem = ctypes.c_int(), ctypes.c_int()
    lib.analysis_tile(ctypes.byref(g), ctypes.byref(smem))
    return g.value, smem.value


def analysis_stream(full: torch.Tensor, chunk_g: int = CHUNK_G,
                    skip: int = 0) -> torch.Tensor:
    """Resident int16 streams (ch, 480 + Tg * 576), their 480 samples of
    filterbank history in front, -> (ch, Tg - skip, 576) int32 spectra of
    granules ``skip`` onward. Granule 0 reads a zero previous granule, every
    other one the granule before it.

    A window of a longer stream (``models/streaming``) passes its slice with
    the history before it and ``skip=1``: its first granule is the MDCT
    context of the next, so the window's spectra equal the same granules of
    the whole stream's.

    On a CUDA tensor this launches the hand-written kernel once on the
    current stream (none when no granule is asked for); a build or launch
    fault raises. A CPU tensor takes :func:`analysis_stream_torch`, whose
    memory ``chunk_g`` bounds."""
    global launches
    _check(full, skip)
    if full.device.type == "cpu":
        return analysis_stream_torch(full, chunk_g, skip)
    ch = full.shape[0]
    tg = (full.shape[1] - _PAST) // 576
    out = torch.empty((ch, max(0, tg - skip), 576), dtype=torch.int32,
                      device=full.device)
    if tg <= skip:
        return out
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("analysis", _SIGNATURES)
    win, fl, cos_l, cs, ca = _kernel_tables(full.device)
    stream = torch.cuda.current_stream(full.device).cuda_stream
    with torch.cuda.device(full.device):
        rc = lib.analysis_mdct(
            full.data_ptr(), ch, tg, skip, win.data_ptr(), fl.data_ptr(),
            cos_l.ctypes.data, cs.ctypes.data, ca.ctypes.data,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"analysis_mdct kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out


@functools.lru_cache(maxsize=1)
def _native_tables():
    cc = lambda a, d: np.ascontiguousarray(a, d)  # noqa: E731
    return (cc(T.ENWINDOW, np.int64),
            cc(T.subband_filter_fixed(), np.int32),
            cc(T.mdct_cos_fixed(), np.int32),
            cc(T.MDCT_CS_FIX, np.int32), cc(T.MDCT_CA_FIX, np.int32))


def run_analysis_native(pcm_i16: np.ndarray, num_granules: int):
    """Host C++ twin of :func:`analysis_mdct` (``encode_analysis`` of the
    native library): raw int16 streams -> (ch, Tg, 576) int32 spectra,
    bit-identical to the torch plane. None when the library is missing."""
    from mp3stego_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    full = _padded_streams(pcm_i16, num_granules)
    out = np.empty((full.shape[0], num_granules, 576), np.int32)
    lib.encode_analysis(full, full.shape[0], num_granules,
                        *_native_tables(), out)
    return out
