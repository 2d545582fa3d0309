"""Bounded-memory streaming decode and encode for long files.

The decode runs each window through the float64 decode plane on ``device``
(CUDA by default; the host C++ plane under ``device="cpu"``). The encode runs
each window through the torch planes on ``device`` (CUDA by default): the
Q31 analysis, the rate search and, for a hide, the eight-window pass and
host scan of ``MP3Encoder._encode_hide``; ``device_search=False`` runs the
JAX package's host engine instead, the native Q31 analysis and the
sequential ``rate_search_file`` chain. Their outputs are byte-identical to
the whole-file paths (``Decoder`` with precision "float64", ``MP3Encoder``).

The whole-file decode holds the full parsed stream (its side info, and
either its Huffman samples, ``raw_samples`` (F, 2, 2, 576) int32, or on the
card the light parse's lanes) before its numeric plane runs. The format's
carries are all short-range, so a windowed decode is exact:

* bit reservoir: a granule's main data reaches back at most 9 frames
  (``NUM_PREV_FRAMES``, decoder/Frame.py:9,306-356);
* numeric plane: granule G's PCM needs the IMDCT overlap tail of G-1 and the
  synthesis FIR's 15 V sub-steps, which reach into G-2's raw samples;
* scfsi: scalefactor reuse is gr0 -> gr1 within one frame.

So each window of frames is parsed and decoded with ``_WARMUP`` leading
frames whose output is dropped. MPEG-2/2.5 (LSF) streams count windows in
real frames (576 samples each); every window re-derives its own virtual
frames.

The encode's cross-frame couplings are small explicit state: the analysis
reads 480 samples of filterbank history and one granule of MDCT context;
the rate search carries each (gr, ch) slot's step seed and stale addresses
(on the encoder, ``MP3Encoder._slot_carry``; the host chain also its ix
buffer, through ``rate_search_file``'s chain arrays); the reservoir,
padding slot lag, scfsi, stego cursor and the serializer's 32-bit cache
persist on the encoder between chunks. On the card only one window's
tensors are alive at a time.

The inputs ride an mmap (decode) or a memmap (encode), and the pages a
window has passed are dropped with ``madvise``.
"""

import mmap

import numpy as np
import torch

from mp3stego_tpu_torch import native
from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.bitstream import vbr
from mp3stego_tpu_torch.bitstream.id3 import parse_id3
from mp3stego_tpu_torch.models import encoder as enc_mod
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.ops import encode_plane as EP
from mp3stego_tpu_torch.utils.profiling import StageTimer
from mp3stego_tpu_torch.utils.transfer import resolve_device
from mp3stego_tpu_torch.utils.wav import read_wav, wav_header

# 9 reservoir frames + 1 frame (2 granules) for the plane's overlap/V carries
_WARMUP = dh.NUM_PREV_FRAMES + 1


def decode_file_streaming(file_path: str, wav_path: str,
                          chunk_frames: int = 1024,
                          progress_cb=None, device=None) -> dict:
    """Decode an MP3 file to WAV in O(chunk) memory; the bytes equal the
    whole-file float64 decode's.

    :param chunk_frames: frames decoded per window.
    :param progress_cb: optional ``cb(frames_done, frames_total)``.
    :param device: the float64 plane's device; None means CUDA (a missing
        card raises), "cpu" the host C++ plane.
    :return: dict with ``bitrate`` (kbps), ``num_frames`` and
        ``stego_bits`` (the hidden-bit string, so a reveal needs no second
        pass).
    """
    dev = resolve_device(device)
    with open(file_path, "rb") as f:
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):   # empty file or odd fs: read fully
            data = f.read()
    try:
        return _decode_windows(data, file_path, wav_path, chunk_frames,
                               progress_cb, dev)
    finally:
        if isinstance(data, mmap.mmap):
            data.close()


def _decode_windows(data, file_path, wav_path, chunk_frames, progress_cb,
                    dev):
    # the skip offset comes from the fixed-position syncsafe size fields, so
    # a bounded prefix is enough (the tag-frame walk is only for METADATA)
    id3 = parse_id3(bytes(data[:min(len(data), 1 << 20)]))
    offset = id3.offset if id3.is_valid else 0

    frames, end_byte, first_h, dup = dh.walk_frames(data, offset)
    total = len(frames)
    if total == 0:
        raise ValueError(f"{file_path}: no MP3 frames found")
    offsets = np.fromiter((fr[0] for fr in frames), np.int64, total)
    first_size = frames[0][2]
    del frames          # ~150 B/frame of tuples; hours-long files add up
    lsf = first_h.mpeg_version != 1
    spf = first_h.frame_samples            # 1152 (MPEG-1) / 576 (LSF)

    # Xing/Info/VBRI tag frame: window 0's parse drops its silence inside
    # _finish_inter; the WAV header must account for it up front
    tag = vbr.parse_vbr_tag(bytes(data[offset:offset + first_size]), 0)
    skip = 1 if (tag is not None and not vbr.keep_tag_frame()) else 0

    n_samples = (total - skip + (1 if dup else 0)) * spf
    bits_out = []
    with open(wav_path, "wb") as out:
        out.write(wav_header(first_h.sampling_rate, first_h.channels,
                             n_samples * first_h.channels * 2))
        f0 = 0
        while f0 < total:
            f1 = min(total, f0 + chunk_frames)
            w0 = max(0, f0 - _WARMUP)
            start = int(offsets[w0])
            if f1 == total:
                stop = end_byte if not dup else len(data)
            else:
                stop = int(offsets[f1])
            window = bytes(data[start:stop])
            _drop_pages(data, start)
            p = dh.parse_mp3(window, 0)
            warm = f0 - w0
            got = p.lsf_granules if lsf else p.num_frames
            if got != f1 - w0:
                raise ValueError(f"{file_path}: window of frames {w0}..{f1} "
                                 f"parsed {got} frames")
            if dev.type == "cpu":
                pcm = dp.decode_pcm_i16_host(p)
                if pcm is None:   # no native toolchain: NumPy parity oracle
                    pcm = dp.pcm_to_i16(dp.decode_pcm(p, "float64", dev))
            else:
                pcm = dp.decode_pcm_i16(p, dev, "float64")
            # drop warm-up PCM; the duplication tail only applies on the
            # final window (the window's decode already appended it there).
            # A window that starts at frame 0 of a tagged stream re-parses
            # the tag frame, whose samples _finish_inter already dropped:
            # one warm-up frame fewer to trim here.
            trim = max(0, warm - (1 if p.skip_first_pcm else 0))
            out.write(pcm[trim * spf:].tobytes())
            bits_out.append(_window_stego_bits(p, warm, lsf))
            if progress_cb:
                progress_cb(f1, total)
            f0 = f1
    kbps = first_h.bit_rate // 1000
    if skip:
        kbps = vbr.avg_bitrate_kbps(tag, first_h) or kbps
    return dict(bitrate=kbps, num_frames=total,
                stego_bits="".join(bits_out))


def _drop_pages(data, upto: int):
    """Drop the consumed input pages below byte ``upto`` of an mmap, so a
    long file's pages do not pile up in RSS."""
    aligned = (upto // mmap.PAGESIZE) * mmap.PAGESIZE
    if isinstance(data, mmap.mmap) and aligned > 0:
        try:
            data.madvise(mmap.MADV_DONTNEED, 0, aligned)
        except (OSError, ValueError, AttributeError):
            pass   # platform without madvise: pages stay (reclaimable)


def encode_file_streaming(wav_path: str, mp3_path: str, bitrate: int = 320,
                          chunk_frames: int = 512, hide_str: str = "",
                          progress_cb=None, device=None,
                          device_search: bool = True) -> dict:
    """WAV -> MP3 in O(chunk) memory, byte-identical to the whole-file
    ``MP3Encoder`` (CBR; VBR's rate choice is a whole-file bisection).

    :param device: the planes' device, as ``MP3Encoder``'s: None means CUDA
        (a missing card raises), "cpu" runs the same torch planes on the
        CPU.
    :param device_search: False runs each window on the native host engine
        (the C++ analysis and ``rate_search_file`` chain), the planes'
        oracle.
    Both need the native host library (the serializer; the host engine
    also its search twins). Returns ``{frames, bytes, too_long}``."""
    w = read_wav(wav_path, bitrate, use_mmap=True)
    enc = enc_mod.MP3Encoder(w, hide_str=hide_str,
                             device_search=device_search, device=device)
    lib = enc_mod._native_rate_lib()
    slib = native.get_lib()
    if slib is None or (lib is None and not device_search):
        raise RuntimeError(
            "streaming encode requires the native host engine (g++ build)")
    # persistent serializer bit cache: chunks continue one bitstream.
    # Compliant-LSF streams serialize through the python BitWriter (its
    # 32-bit cache already persists on the instance)
    if not (enc.version != 3 and enc.lsf_compliant):
        enc._nat_ser = slib
        enc._nat_cache = np.zeros(1, np.uint32)
        enc._nat_cache_bits = np.full(1, 32, np.int32)

    gpf = enc.granules_per_frame
    nch = w.num_of_channels
    nf_total = enc._num_frames()
    chain = (np.zeros(2 * 2 * 12, np.int64), np.zeros(2 * 2 * 576, np.int32))
    timer = StageTimer(enabled=False)

    def stream_slice(t_lo: int, t_hi: int) -> np.ndarray:
        """(nch, t_hi - t_lo) int16 granule-time samples; out-of-range = 0
        (the whole-file zero-padded stream build)."""
        out = np.zeros((nch, t_hi - t_lo), np.int16)
        lo = max(0, t_lo)
        for c in range(nch):
            src = w.buffer if nch == 1 else w.buffer[c::2]
            seg = src[lo:t_hi]
            out[c, lo - t_lo:lo - t_lo + len(seg)] = seg
        return out

    total_bytes = 0
    with open(mp3_path, "wb") as out_f:
        f0 = 0
        while f0 < nf_total:
            f1 = min(nf_total, f0 + chunk_frames)
            nf = f1 - f0
            margin = 1 if f0 > 0 else 0           # MDCT left-context granule
            full = stream_slice((f0 * gpf - margin) * 576 - EP._PAST,
                                f1 * gpf * 576)
            if device_search:
                xr = EP.analysis_stream(
                    torch.from_numpy(full).to(enc.device), skip=margin)
                xr = xr.reshape(-1, 576)
                if hide_str:
                    enc._encode_hide(nf, timer, xr=xr)
                else:
                    enc._encode_plane(nf, timer, xr=xr)
                del xr
            else:
                _host_window(enc, lib, slib, full, margin, nf, f0, chain)
            out_f.write(bytes(enc.out_buffer))
            total_bytes += len(enc.out_buffer)
            enc.out_buffer = bytearray()
            _release_consumed(w.buffer, f1, gpf, nch, EP._PAST)
            if progress_cb:
                progress_cb(f1, nf_total)
            f0 = f1
    too_long = enc.hide_str_offset < len(hide_str) - 1
    return dict(frames=nf_total, bytes=total_bytes, too_long=too_long)


def _host_window(enc, lib, slib, full, margin: int, nf: int, f0: int,
                 chain):
    """One window on the native host engine: the C++ analysis of ``full``
    (its ``margin`` context granules dropped) and the ``rate_search_file``
    chain, continuing ``chain`` (state, ix) from the previous window."""
    gpf = enc.granules_per_frame
    nch = enc.wav.num_of_channels
    tg = nf * gpf
    chain_state, chain_ix = chain
    spec = np.empty((nch, margin + tg, 576), np.int32)
    slib.encode_analysis(np.ascontiguousarray(full), nch, margin + tg,
                         *EP._native_tables(), spec)
    xr = np.ascontiguousarray(spec[:, margin:].reshape(-1, 576))
    paddings, mean_bits_f = enc._plane_framing(nf)
    maxb = enc._lane_budgets(mean_bits_f)
    lanes = nch * tg
    raw = np.zeros((lanes, 12), np.int64)
    ix = np.zeros((lanes, 576), np.int32)
    en_tot = np.zeros(lanes, np.int32)
    en21 = np.zeros((lanes, 21), np.int32)
    lib.rate_search_file(
        xr, maxb, nch, tg, gpf, enc.band_row * 23,
        enc._hide_u8, len(enc.hide_str), enc.hide_str_offset,
        raw, ix, en_tot, en21, chain_state, chain_ix, 1 if f0 else 0)
    res = {k: np.ascontiguousarray(raw[:, c]) for c, k in enumerate(
        ("step", "bits", "bv", "c1", "cts", "r0c", "r1c",
         "ch0", "ch1", "ch2", "xrmax0"))}
    res["ix"] = ix
    mpeg1 = enc.version == 3
    enc._plane_finish(res, en_tot if mpeg1 else None,
                      en21 if mpeg1 else None,
                      nf, paddings, mean_bits_f, tg)


def _release_consumed(buf, frames_done: int, gpf: int, nch: int, past: int):
    """Drop the memmapped WAV pages the encode cursor has passed; the next
    chunk only looks back one granule and the 480-sample filter history."""
    base = getattr(buf, "_mmap", None)
    if base is None:
        return
    keep_from = max(0, (frames_done * gpf - 1) * 576 - past) * nch * 2
    _drop_pages(base, keep_from)


def _window_stego_bits(p, warm: int, lsf: bool) -> str:
    """Stego bits of one window's frames past the warm-up, in the order
    ``decoder_host.stego_bits`` uses for the whole file."""
    if lsf:
        # one granule per real frame: temporal (frame, ch, region) order;
        # side_infos carries the per-REAL-frame fields
        ts = np.stack([si.table_select[0] for si in p.side_infos[warm:]])
    else:
        ts = p.table_select[warm:]
    sub = dh.ParsedMP3()
    sub.num_frames = ts.shape[0]
    sub.lsf_granules = ts.shape[0] if lsf else 0
    sub.table_select = ts if not lsf else ts[:, None]
    return dh.stego_bits(sub)
