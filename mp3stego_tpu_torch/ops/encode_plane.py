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
* ``analysis_interleaved`` — the same spectra from the WAV's interleaved
  int16 buffer as the host holds it (channel c at c + nch * t); on the card
  the kernel reads the buffer itself, so no channel stream is built on the
  host. Its plain version ``analysis_interleaved_torch`` builds the padded
  streams in torch and calls ``analysis_stream_torch``.
* ``launches`` — how many times the kernel was launched in this process.
"""

import ctypes
import functools

import numpy as np
import torch

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.ops import fixedpoint as fx
from mp3stego_tpu_torch.utils.transfer import put_pieces

_PAST = 480          # deepest lookback of the window: 31 - 63 - 448 = -480
CHUNK_G = 1024       # granules per chunk of analysis_stream_torch

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "analysis_mdct": (_I, (
        _P, _I, ctypes.c_longlong, _I,                        # pcm .. skip
        _I, ctypes.c_longlong,                                # interleaved
        _I, _I, _I,                                           # g, run, grid
        _P, _P, _P, _P, _P,                                   # tables
        _P, _P)),                                             # out, stream
    "analysis_occupancy": (_I, (_P, _P, _P, _P)),
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
    full = put_pieces(_padded_streams(pcm_i16, num_granules), device)
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
    """The kernel's tables: the window (512,) and the filter transposed (64,
    32) int32 on ``device``, the MDCT cosines (18, 36) and the alias
    coefficients (8,) int32 on the host (the launch copies them into its
    parameters).
    Raises if the window does not fit int32 (the kernel's products are
    int32 x int32)."""
    win = np.asarray(T.ENWINDOW, np.int64)
    if not np.array_equal(win, win.astype(np.int32)):
        raise ValueError("the analysis window does not fit int32")
    _, fl, cos_l, cs, ca = _native_tables()
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (dev(win.astype(np.int32)), dev(np.ascontiguousarray(fl.T)),
            cos_l, cs, ca)


@functools.lru_cache(maxsize=None)
def occupancy(device: torch.device) -> dict:
    """What the runtime gives the kernel on ``device``: the CTAs an SM
    holds (``ctas``, at the kernel's registers and dynamic shared memory),
    its warps a CTA (``warps``), its bytes of shared memory a CTA
    (``smem``) and the most output granules a tile (``granules``). Builds
    the kernel; raises on a CUDA error."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("analysis", _SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        rc = lib.analysis_occupancy(*(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"analysis occupancy query failed: CUDA error "
                           f"{rc}")
    ctas, warps, smem, granules = (v.value for v in out)
    if ctas < 1:
        raise RuntimeError("analysis_kernel fits no CTA on an SM")
    return dict(ctas=ctas, warps=warps, smem=smem, granules=granules)


@functools.lru_cache(maxsize=None)
def _grid_cap(device: torch.device) -> int:
    """The persistent grid: every SM full of CTAs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * occupancy(device)["ctas"]


def schedule(ch: int, n_out: int, grid: int, max_g: int = 8) -> tuple:
    """(granules a tile, tiles a run, runs) for ``n_out`` output granules of
    ``ch`` channels on ``grid`` persistent CTAs, each CTA taking whole runs
    of one channel's tiles: the tiling whose busiest CTA takes the fewest
    granules, a tile's fixed cost (its barriers, its copy's wait, the
    MDCT's idle warps) counted as one granule more; the larger tile on a
    tie. A long stream gets full tiles in runs of about ch * n_out / (8 *
    grid); a 7-frame window one granule a tile, a CTA each."""
    best = None
    g = max_g
    while g >= 1:
        tiles = -(-n_out // g)
        run = -(-ch * tiles // grid)
        items = ch * -(-tiles // run)
        cost = -(-items // grid) * run * (g + 1)
        if best is None or cost < best[0]:
            best = (cost, g, run, items)
        g //= 2
    return best[1:]


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
    tg = (full.shape[1] - _PAST) // 576
    if tg <= skip:
        return torch.empty((full.shape[0], 0, 576), dtype=torch.int32,
                           device=full.device)
    out = _launch(full, full.shape[0], tg, skip)
    launches += 1
    return out


def _launch(src: torch.Tensor, ch: int, tg: int, skip: int,
            interleaved: bool = False) -> torch.Tensor:
    """One launch of the kernel on the current stream, skip < tg: ``src``
    is the checked streams (ch, 480 + tg * 576) or, ``interleaved``, the
    WAV's samples (n,) of ``ch`` channels. The tiling comes from
    :func:`schedule`, the grid is persistent. Returns the (ch, tg - skip,
    576) int32 spectra; raises if the launch fails."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("analysis", _SIGNATURES)
    if src.data_ptr() % 16:                    # the kernel copies 16 B chunks
        src = src.clone()
    out = torch.empty((ch, tg - skip, 576), dtype=torch.int32,
                      device=src.device)
    win, fl, cos_l, cs, ca = _kernel_tables(src.device)
    cap = _grid_cap(src.device)
    g, run, items = schedule(ch, tg - skip, cap,
                             occupancy(src.device)["granules"])
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        rc = lib.analysis_mdct(
            src.data_ptr(), ch, tg, skip, int(interleaved),
            src.shape[0] if interleaved else 0, g, run, min(cap, items),
            win.data_ptr(), fl.data_ptr(), cos_l.ctypes.data,
            cs.ctypes.data, ca.ctypes.data, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"analysis_mdct kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def _check_interleaved(buffer: torch.Tensor, nch: int, tg: int, skip: int):
    """What the interleaved entry takes: int16 samples (n,) of 1 or 2
    channels, tg >= 0 granules, skip >= 0, on the CPU or the card (there
    C-contiguous)."""
    if buffer.dim() != 1 or buffer.dtype != torch.int16:
        raise ValueError(f"the interleaved analysis wants the WAV's int16 "
                         f"samples (n,), got {tuple(buffer.shape)} "
                         f"{buffer.dtype}")
    if nch not in (1, 2):
        raise ValueError(f"the interleaved analysis takes 1 or 2 channels, "
                         f"got {nch}")
    if tg < 0 or skip < 0:
        raise ValueError(f"granules and skip must be >= 0, got {tg}, "
                         f"{skip}")
    if buffer.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the analysis runs on CPU or CUDA tensors, got "
                         f"{buffer.device}")
    if buffer.device.type == "cuda" and not buffer.is_contiguous():
        raise ValueError("the CUDA analysis takes C-contiguous samples")


def analysis_interleaved_torch(buffer: torch.Tensor, nch: int, tg: int,
                               skip: int = 0,
                               chunk_g: int = CHUNK_G) -> torch.Tensor:
    """Plain version of :func:`analysis_interleaved` on ``buffer``'s device:
    the padded streams built in torch (channel c's samples c, c + nch, ...
    up to tg * 576 of them, zero past the buffer's end, 480 zeros of
    history in front), then :func:`analysis_stream_torch`."""
    full = torch.zeros((nch, _PAST + tg * 576), dtype=torch.int16,
                       device=buffer.device)
    for c in range(nch):
        s = buffer[c::nch][:tg * 576]
        full[c, _PAST:_PAST + s.shape[0]] = s
    return analysis_stream_torch(full, chunk_g, skip)


def analysis_interleaved(buffer: torch.Tensor, nch: int, tg: int,
                         skip: int = 0,
                         chunk_g: int = CHUNK_G) -> torch.Tensor:
    """The WAV's interleaved int16 samples (n,) of ``nch`` channels ->
    (nch, tg - skip, 576) int32 spectra of granules ``skip`` onward: what
    :func:`analysis_stream` gives on the padded streams of channel c's
    samples ``buffer[c + nch * t]``, t < tg * 576, zero past the buffer's
    end (``MP3Encoder._channel_streams_i16``; mono at stride 1).

    On a CUDA tensor this launches the hand-written kernel once on the
    current stream, reading the buffer as the host holds it (none when no
    granule is asked for); a build or launch fault raises. A CPU tensor
    takes :func:`analysis_interleaved_torch`, whose memory ``chunk_g``
    bounds."""
    global launches
    _check_interleaved(buffer, nch, tg, skip)
    if buffer.device.type == "cpu":
        return analysis_interleaved_torch(buffer, nch, tg, skip, chunk_g)
    if tg <= skip:
        return torch.empty((nch, 0, 576), dtype=torch.int32,
                           device=buffer.device)
    if not buffer.numel():                     # all zeros; the kernel wants
        buffer = buffer.new_zeros(1)           # a buffer to point at
    out = _launch(buffer, nch, tg, skip, interleaved=True)
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
