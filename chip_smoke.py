#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mp3stego_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (Hopper:
the kernels are built for sm_90a). It builds every kernel of the port's
paths from the sources in the checkout, holds each against its plain
PyTorch version (and times a library call that computes the same function),
drives every entry point at a size users send (one 240.7-second 320 kbps
stereo song through the façade: decode it, measure its capacity, hide a
message of 90 % of it, reveal it, clear it; a batched decode of 32 files
and a batched encode of 9; a VBR encode and the streaming decode and encode
of the song; a hide and reveal through the CLI), checks every output
against the bit-exact host planes, the single-file paths and the goldens,
and times it. Every phase raises on a fault; nothing is caught. The last
line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels (launches during the main-path runs, error
against the plain version, times, bound, library time), and the one before
that the card's name and power limit.

It imports nothing of JAX and nothing of the JAX package. Without a card, or
outside a checkout, it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mp3stego_tpu_torch import Steganography, native
from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.bitstream.decoder_host import ParsedMP3
from mp3stego_tpu_torch.models.encoder import Encoder, MP3Encoder
from mp3stego_tpu_torch.ops import _cuda
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.ops import encode_plane as EP
from mp3stego_tpu_torch.ops import synth_fir as sf
from mp3stego_tpu_torch.steganography import _frame_message
from mp3stego_tpu_torch.utils.profiling import StageTimer
from mp3stego_tpu_torch.utils.wav import WavFile, read_wav, write_wav

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "golden")

# the slice: the 320 kbps golden re-encode (36 frames), one zero byte
# appended (its last frame is one byte short of its header's size, so
# unpadded copies end the sync walk after the first copy), 256 copies:
# 9,216 frames, T = 18,432 granules, 240.7 s of 44.1 kHz stereo
SONG_COPIES = 256
S_SLICE = 18 * 2 * 36 * SONG_COPIES          # FIR sub-steps per channel
MAX_LSB_RATE = 1e-3                          # tests/test_precision.py contract
# the half-second tone streams of the goldens (MPEG-2/2.5 and multirate):
# the JAX package's own float32 plane flips 1.4e-3 of the LSF ones' samples
# (tests/test_torch_facade.py), the port's CPU plane 0.8e-3 to 1.5e-3 of
# them all (a loud stationary tone crosses more truncation boundaries)
TONE_MAX_LSB_RATE = 2e-3
HIDE_SHARE = 0.9                             # message size / capacity
BATCH_SLICES = 23                            # 30 s slices in the batch


def synthetic_parsed(t: int, seed: int = 0) -> ParsedMP3:
    """A synthetic parsed-granule batch covering every block type: long,
    short, start, one mixed granule, MS granules and one intensity
    granule, with linbits escapes. The same construction as the JAX
    package's ``__graft_entry__._synthetic_prep`` (the tests hold the two
    preps equal key by key)."""
    from types import SimpleNamespace
    assert t % 2 == 0, "granule count must be even (2 granules per frame)"
    f = t // 2
    rng = np.random.default_rng(seed)
    bt = np.zeros((f, 2, 2), np.int32)
    bt.reshape(-1)[:: 3] = 2                          # short blocks
    bt.reshape(-1)[1:: 5] = 1                         # start windows
    mixed = np.zeros((f, 2, 2), np.int32)
    mixed[0, 0, :] = (bt[0, 0, :] == 2).astype(np.int32)
    ms = np.zeros(t, bool)
    ms[:: 2] = True
    is_st = np.zeros(t, bool)
    is_st[1] = True                                   # one IS granule
    raw = rng.integers(-140, 140, size=(f, 2, 2, 576)).astype(np.int32)
    raw[0, 1, 1, 300:] = 0        # IS needs a zero upper right channel
    return ParsedMP3(
        num_frames=f,
        header=SimpleNamespace(sr_idx=0),
        raw_samples=raw,
        block_type=bt,
        mixed_block_flag=mixed,
        global_gain=np.full((f, 2, 2), 180, np.int32),
        scale_fac_scale=rng.integers(0, 2, size=(f, 2, 2)).astype(np.int32),
        pre_flag=rng.integers(0, 2, size=(f, 2, 2)).astype(np.int32),
        sub_block_gain=rng.integers(0, 3, size=(f, 2, 2, 3)).astype(np.int32),
        scale_fac_l=rng.integers(0, 4, size=(f, 2, 2, 22)).astype(np.int32),
        scale_fac_s=rng.integers(0, 4, size=(f, 2, 2, 3, 13)).astype(np.int32),
        ms_stereo=ms,
        is_stereo=is_st,
    )


def synthetic_prep(t: int, seed: int = 0) -> dict:
    return dp.host_prepare(synthetic_parsed(t, seed), native_pack=False)


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def _wav_i16(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read()[44:], dtype=np.int16)


def _lsb_contract(name: str, got: np.ndarray, want: np.ndarray,
                  max_rate: float = MAX_LSB_RATE) -> str:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: {got.shape} samples vs {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    rate = float((d != 0).mean())
    if d.max() > 1 or rate >= max_rate:
        raise AssertionError(f"{name}: max |d| {d.max()} LSB, rate {rate}")
    return f"max |d| {int(d.max())} LSB on {rate:.3e} of {d.size} samples"


def _fir_pair(v_ext: torch.Tensor, s: int):
    got = sf.synth_fir(v_ext, s)
    want = sf.synth_fir_torch(v_ext, s)
    torch.cuda.synchronize()
    return got, want


def _time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _median3(fn):
    """fn() once to warm up, then three timed runs: (median s, all s, the
    three results)."""
    fn()
    walls, outs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        outs.append(fn())
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[1], walls, outs


def _say_stages(phase, card, timers):
    for name in timers[0]:
        ms = sorted(t[name] * 1e3 for t in timers)
        _say(phase, f"[{card}] stage {name}: median {ms[len(ms) // 2]:.2f} "
                    f"ms of {[round(m, 2) for m in ms]}")


def _encode_bytes(wav: str, dev, bits="", kbps=320, host=False, vbr=False):
    """An encode of a WAV file on ``dev``, or with the host C++ engine:
    (bytes, the MP3Encoder)."""
    enc = MP3Encoder(read_wav(wav, kbps), hide_str=bits, device=dev, vbr=vbr)
    if host:
        nf = enc._num_frames()
        if not enc._encode_host(nf, StageTimer()):
            raise RuntimeError("the host C++ encode engine is unavailable")
        if vbr:
            enc.out_buffer = bytearray(enc._xing_frame(nf)) + enc.out_buffer
    else:
        enc.encode()
    return bytes(enc.out_buffer), enc


def _scan_line(enc) -> str:
    """The hide's cursor scan record (``MP3Encoder.hide_stats``); raises
    when the card searched no window."""
    st = enc.hide_stats
    if not st["blocks"] or not st["window_lanes"]:
        raise AssertionError(f"the hide searched no window on the card: {st}")
    return (f"{st['window_lanes']} of {st['lanes']} lanes searched under the "
            f"8 windows in {st['blocks']} blocks; {st['sensitive']} "
            f"sensitive, {st['redone']} redone on the host, {st['edge']} "
            f"at the message's end; redo {enc.redo_stats}")


def seeded_song(path: str, seconds: float, seed: int = 10):
    """A seeded 44.1 kHz stereo song that repeats nothing: a drifting tone
    and its overtone, noise under a slow envelope, and half a second of
    silence every 20 s."""
    sr = 44100
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(220 * 2 ** (2 * np.sin(t / 6.0))) / sr
    env = np.sin(2 * np.pi * t / 11.0) ** 2
    sig = (0.35 * np.sin(phase) + 0.15 * np.sin(3.01 * phase)
           + 0.2 * env * rng.standard_normal(t.size))
    sig[(t % 20.0) < 0.5] = 0.0
    right = 0.8 * np.roll(sig, 999) + 0.05 * rng.standard_normal(t.size)
    pcm = np.clip(np.stack([sig, right], axis=1) * 30000, -32768, 32767)
    write_wav(path, sr, pcm.astype(np.int16))


def _expect_equal(name, got: bytes, want: bytes):
    if got != want:
        diff = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
            if len(got) == len(want) else min(len(got), len(want))
        raise AssertionError(f"{name}: {len(got)} bytes differ from the "
                             f"expected {len(want)} at byte {diff}")


def encode_phases(dev, card: str, tmp: str, song: str, wav64: str,
                  s32: Steganography) -> dict:
    """Phases 8-11: the encode and hide path on the song and the goldens.
    Returns the synth_fir launches of the float32 hide (phase 11), the
    song's clear encode bytes and the seeded song's WAV."""
    # ---- phase 8: the Q31 analysis on the card against the host C++ twin
    w = read_wav(wav64, 320)
    seconds = w.num_of_samples / w.samplerate
    tg = 2 * -(-w.num_of_samples // 1152)          # granules per channel
    streams = np.stack([w.buffer[0::2], w.buffer[1::2]])
    t0 = time.perf_counter()
    want = EP.run_analysis_native(streams, tg)
    host_ms = (time.perf_counter() - t0) * 1e3
    got = EP.run_analysis_device(streams, tg, dev)
    card_ms = _time_ms(lambda: EP.run_analysis_device(streams, tg, dev), 3)
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("card analysis != native encode_analysis")
    _say("8 analysis", f"[{card}] {tuple(got.shape)} int32: bitwise equal to "
                       f"the native encode_analysis; card {card_ms:.2f} ms "
                       f"(CUDA events, int16 upload included), host C++ "
                       f"{host_ms:.1f} ms")
    del got

    # ---- phase 9: encode, goldens byte for byte, then the song
    sg = np.load(os.path.join(GOLD, "stego_golden.npz"))
    gold_wav = os.path.join(tmp, "golden.wav")
    with open(gold_wav, "wb") as f:
        f.write(sg["wav_bytes"].tobytes())
    eg = np.load(os.path.join(GOLD, "encode_golden.npz"))
    _expect_equal("encode_golden", _encode_bytes(gold_wav, dev)[0],
                  eg["mp3_bytes"].tobytes())
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    for tag in ("32000_64", "32000_192", "44100_128", "48000_96",
                "48000_320"):
        path = os.path.join(tmp, f"wav_{tag}.wav")
        with open(path, "wb") as f:
            f.write(mr[f"wav_{tag}"].tobytes())
        _expect_equal(tag, _encode_bytes(path, dev,
                                         kbps=int(tag.split("_")[1]))[0],
                      mr[f"mp3_{tag}"].tobytes())
    m2 = np.load(os.path.join(GOLD, "mpeg2_golden.npz"))
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    for name, sr, br in (("mpeg2_24k_64", 24000, 64),
                         ("mpeg2_22k05_80", 22050, 80),
                         ("mpeg25_8k_32", 8000, 32)):
        pcm = m2[name + "_pcm"]
        for compliant, want_b in ((True, lsf[name]), (False, m2[name])):
            enc = MP3Encoder(WavFile(
                file_path="lsf.wav", bitrate=br, num_of_channels=2,
                samplerate=sr, bits_per_sample=16,
                num_of_samples=len(pcm) // 2, mpeg_mode=0, buffer=pcm),
                lsf_compliant=compliant, device=dev)
            enc.encode()
            _expect_equal(f"{name} lsf_compliant={compliant}",
                          bytes(enc.out_buffer), want_b.tobytes())
    _say("9 encode", "goldens byte for byte on the card: encode_golden, 5 "
                     "multirate, 3 torch_lsf (lsf_compliant) and 3 mpeg2 "
                     "(reference layout)")

    t0 = time.perf_counter()
    host_b, _ = _encode_bytes(wav64, dev, host=True)
    host_s = time.perf_counter() - t0
    wall, walls, outs = _median3(lambda: _encode_bytes(wav64, dev))
    card_b, enc = outs[-1]
    clear_b = card_b
    _expect_equal("song encode: card vs host C++", card_b, host_b)
    _say("9 encode", f"[{card}] {seconds:.2f} s song at 320 kbps: card "
                     f"bytes ({len(card_b)}) equal the host C++ engine's; "
                     f"wall median {wall * 1e3:.1f} ms of "
                     f"{[round(x * 1e3, 1) for x in walls]} -> "
                     f"{seconds / wall:.1f}x realtime; host C++ engine "
                     f"{host_s * 1e3:.1f} ms")
    _say_stages("9 encode", card, [o[1].timer.times for o in outs])
    _say("9 encode", f"redo lanes by flag: {enc.redo_stats} of "
                     f"{2 * tg} lanes")

    # ---- phase 10: hide, goldens byte for byte, then the song
    msgs = {"hidden_short": "ddd", "hidden_long": sg["msg_long"].tobytes()
            .decode(), "hidden_toolong": "ddd" * 100}
    for key, msg in msgs.items():
        out = os.path.join(tmp, f"{key}.mp3")
        too_long = Encoder(gold_wav, out, 320, hide_str=_frame_message(msg),
                           device=dev).encode()
        if too_long is not (key == "hidden_toolong"):
            raise AssertionError(f"{key}: too_long {too_long}")
        with open(out, "rb") as f:
            _expect_equal(key, f.read(), sg[key].tobytes())
    cap = np.load(os.path.join(GOLD, "capstego_golden.npz"))
    _expect_equal("capstego", _encode_bytes(
        gold_wav, dev, _frame_message(cap["msg_cap"].tobytes().decode()))[0],
        cap["hidden_cap"].tobytes())
    _say("10 hide", "goldens byte for byte on the card: hidden_short, "
                    "hidden_long, hidden_toolong (too_long True), capstego")

    s64 = Steganography(quiet=True, precision="float64", device=dev)
    t0 = time.perf_counter()
    capacity = s64.message_capacity(song)
    cap_s = time.perf_counter() - t0
    rng = np.random.default_rng(10)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz"
                             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,"))
    msg = "".join(rng.choice(alphabet, size=int(capacity * HIDE_SHARE)))
    bits = _frame_message(msg)
    _say("10 hide", f"[{card}] capacity {capacity} chars ({cap_s * 1e3:.1f} "
                    f"ms through the façade); message {len(msg)} chars, "
                    f"{len(bits)} bits")
    t0 = time.perf_counter()
    host_b, _ = _encode_bytes(wav64, dev, bits, host=True)
    host_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    wall, walls, outs = _median3(lambda: _encode_bytes(wav64, dev, bits))
    card_b, enc = outs[-1]
    peak = torch.cuda.max_memory_allocated()
    _expect_equal("song hide: card vs host C++", card_b, host_b)
    _say("10 hide", f"[{card}] card hide bytes equal the host C++ engine's; "
                    f"{_scan_line(enc)}")
    _say("10 hide", f"[{card}] hide encode wall median {wall * 1e3:.1f} ms "
                    f"of {[round(x * 1e3, 1) for x in walls]} -> "
                    f"{seconds / wall:.1f}x realtime; host C++ engine "
                    f"{host_s * 1e3:.1f} ms; torch.cuda.max_memory_allocated "
                    f"{peak / 2**20:.1f} MiB")
    _say_stages("10 hide", card, [o[1].timer.times for o in outs])

    # a song of the same length that repeats nothing, hidden at 90 % of its
    # channel: card bytes against the host C++ engine's
    wav_s = os.path.join(tmp, "seeded.wav")
    seeded_song(wav_s, seconds)
    usable = _encode_bytes(wav_s, dev)[1].hide_str_offset
    bits_s = "".join(np.random.default_rng(11).choice(
        ["0", "1"], size=int(usable * HIDE_SHARE)))
    t0 = time.perf_counter()
    seeded_host, _ = _encode_bytes(wav_s, dev, bits_s, host=True)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seeded_card, seeded_enc = _encode_bytes(wav_s, dev, bits_s)
    card_s = time.perf_counter() - t0
    _expect_equal("seeded song hide: card vs host C++", seeded_card,
                  seeded_host)
    _say("10 hide", f"[{card}] seeded {seconds:.2f} s song, {len(bits_s)} of "
                    f"{usable} channel bits: card hide bytes equal the host "
                    f"C++ engine's; card {card_s * 1e3:.1f} ms, host C++ "
                    f"{host_s * 1e3:.1f} ms; {_scan_line(seeded_enc)}")
    hidden = os.path.join(tmp, "song_hidden.mp3")
    t0 = time.perf_counter()
    if s64.hide_message(song, hidden, msg):
        raise AssertionError("a 90 % message did not fit")
    facade_s = time.perf_counter() - t0
    with open(hidden, "rb") as f:
        _expect_equal("façade hide vs encoder hide", f.read(), card_b)
    txt = os.path.join(tmp, "song.txt")
    s64.reveal_massage(hidden, txt)
    with open(txt) as f:
        if f.read() != msg:
            raise AssertionError("reveal of the song's message failed")
    _say("10 hide", f"[{card}] façade hide_message (float64 decode + card "
                    f"encode) {facade_s * 1e3:.1f} ms -> "
                    f"{seconds / facade_s:.1f}x realtime; reveal gives "
                    f"the {len(msg)}-char message back")

    # ---- phase 11: the float32 round trip (K1 on the decode inside hide)
    hidden32 = os.path.join(tmp, "song_hidden32.mp3")
    sf.launches = 0
    too_long = s32.hide_message(song, hidden32, msg)
    hide_launches = sf.launches
    if too_long or hide_launches == 0:
        raise AssertionError(f"float32 hide: too_long {too_long}, "
                             f"synth_fir launches {hide_launches}")
    s32.reveal_massage(hidden32, txt)
    with open(txt) as f:
        if f.read() != msg:
            raise AssertionError("float32 hide: reveal failed")
    cleared = os.path.join(tmp, "song_clear32.mp3")
    s32.clear_file(song, cleared)
    wav32 = os.path.join(tmp, "song32b.wav")
    s32.decode_mp3_to_wav(song, wav32)
    plain = os.path.join(tmp, "song_plain32.mp3")
    s32.encode_wav_to_mp3(wav32, plain, 320)
    with open(cleared, "rb") as a, open(plain, "rb") as b:
        _expect_equal("clear_file vs encode of the same decode", a.read(),
                      b.read())
    _say("11 float32", f"hide_message (float32) -> reveal gives the message "
                       f"back; synth_fir launches in the hide {hide_launches}"
                       f"; clear_file bytes equal a plain encode of the same "
                       f"decode")
    return dict(hide_launches=hide_launches, clear_bytes=clear_b,
                seeded_wav=wav_s)


def _write(path: str, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


def _frame_slice(data: bytes, parsed, first: int, count: int) -> bytes:
    """Frames [first, first + count) of a parsed stream, cut at their
    byte offsets (a slice opens with a reservoir the decoder does not
    have, as a file cut from a stream does)."""
    ends = np.cumsum(np.asarray(parsed.frame_sizes, np.int64))
    start = 0 if first == 0 else int(ends[first - 1])
    return data[start:int(ends[first + count - 1])]


def batch_phases(dev, card: str, tmp: str, song: str, wav64: str,
                 enc_out: dict) -> dict:
    """Phases 12-15 and the CLI round trip: the batched decode (K1 over the
    (file, channel) rows of each chunk), the batched encode, VBR, and the
    streaming decode and encode of the song. Returns the batched decode's
    K1 launches and the timings."""
    from mp3stego_tpu_torch.bitstream import vbr
    from mp3stego_tpu_torch.models.streaming import (
        decode_file_streaming, encode_file_streaming)
    from mp3stego_tpu_torch.ops import search_plane as SP
    from mp3stego_tpu_torch.parallel import (
        batch_decode as BD, decode_files_batched, encode_files_batched)

    # ---- phase 12: batched decode of 32 files: 30 s slices of the song,
    # cut at frames spread over it, the goldens at other rates, and mono
    with open(song, "rb") as f:
        song_b = f.read()
    song_parsed = dh.parse_mp3(song_b)
    n_slice = 1148                                 # 30.0 s of 1,152 samples
    span = song_parsed.num_frames - n_slice
    paths = []
    for k in range(BATCH_SLICES):
        first = round(k * span / (BATCH_SLICES - 1))
        paths.append(_write(os.path.join(tmp, f"slice{k}.mp3"), _frame_slice(
            song_b, song_parsed, first, n_slice)))
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    for tag in ("32000_64", "32000_192", "44100_128", "48000_96",
                "48000_320"):
        paths.append(_write(os.path.join(tmp, f"b_{tag}.mp3"),
                            mr[f"mp3_{tag}"].tobytes()))
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    lsf_names = ("mpeg2_24k_64", "mpeg2_22k05_80", "mpeg25_8k_32")
    for name in lsf_names:
        paths.append(_write(os.path.join(tmp, f"b_{name}.mp3"),
                            lsf[name].tobytes()))
    rng = np.random.default_rng(12)
    t = np.arange(30 * 44100) / 44100
    mono = np.clip((0.4 * np.sin(2 * np.pi * 330 * t)
                    + 0.05 * rng.standard_normal(t.size)) * 30000,
                   -32768, 32767).astype(np.int16)
    mono_wav = os.path.join(tmp, "mono.wav")
    write_wav(mono_wav, 44100, mono)
    paths.append(_write(os.path.join(tmp, "b_mono.mp3"),
                        _encode_bytes(mono_wav, dev, kbps=128)[0]))
    metas = []
    for p in paths:
        with open(p, "rb") as f:
            metas.append(dh.parse_mp3(f.read()))
    chunks = BD._chunks(metas, 16)
    # the float run hands K1 each chunk's V history over F * ch rows; a
    # copy of each is held below against the plain version, bit for bit
    fir, v_hist = dp.synth_fir, []

    def fir_copy(v_ext, s):
        v_hist.append(v_ext.clone())
        return fir(v_ext, s)

    dp.synth_fir = fir_copy
    try:
        floats = decode_files_batched(paths, device=dev)
    finally:
        dp.synth_fir = fir
    for p, parsed, got in zip(paths, metas, floats):
        want = dp.decode_pcm(parsed, "float32", dev)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"batched float decode of {p} != its "
                                 f"single-file decode on the card")
    if len(v_hist) != len(chunks):
        raise AssertionError(f"batched decode: {len(v_hist)} K1 calls for "
                             f"{len(chunks)} chunks")
    k1_err = 0.0
    for v in v_hist:
        got, want = _fir_pair(v, v.shape[1] - 15)
        k1_err = max(k1_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"synth_fir != plain on a chunk's V history "
                                 f"{tuple(v.shape)}: max |d| {k1_err}")
    _say("12 batch decode", f"K1 bitwise equal to synth_fir_torch on each "
                            f"chunk's V history (rows, 15 + S, 64): "
                            f"{[tuple(v.shape) for v in v_hist]}")
    del v_hist, got, want
    sf.launches = 0
    t0 = time.perf_counter()
    i16 = decode_files_batched(paths, out="int16", device=dev)
    first_s = time.perf_counter() - t0
    batch_launches = sf.launches
    if batch_launches != len(chunks):
        raise AssertionError(f"batched decode: {batch_launches} K1 launches "
                             f"for {len(chunks)} chunks")
    audio_s, worst = 0.0, (0.0, "")
    for p, parsed, got in zip(paths, metas, i16):
        audio_s += got.shape[0] / parsed.header.sampling_rate
        want = dp.decode_pcm_i16_host(parsed)
        name = os.path.basename(p)
        _lsb_contract(name, got, want, MAX_LSB_RATE
                      if name.startswith("slice") else TONE_MAX_LSB_RATE)
        rate = float((got != want).mean())
        worst = max(worst, (rate, os.path.basename(p)))
    wall, walls, _ = _median3(
        lambda: decode_files_batched(paths, out="int16", device=dev))
    t0 = time.perf_counter()
    for p in paths:
        dp.decode_pcm_i16(BD._read_parsed(p), dev)
    single_s = time.perf_counter() - t0
    _say("12 batch decode", f"{len(paths)} files ({audio_s:.2f} s of audio) "
                            f"in {len(chunks)} chunks: float PCM bit for bit "
                            f"each file's own card decode; int16 within 1 "
                            f"LSB of the float64 host plane (largest share "
                            f"{worst[0]:.3e}, {worst[1]})")
    _say("12 batch decode", f"[{card}] wall median {wall * 1e3:.1f} ms of "
                            f"{[round(x * 1e3, 1) for x in walls]} -> "
                            f"{audio_s / wall:.1f}x realtime (first call "
                            f"{first_s * 1e3:.1f} ms); K1 launches "
                            f"{batch_launches} (one per chunk); one file at "
                            f"a time (read, parse, card plane) "
                            f"{single_s * 1e3:.1f} ms")

    # ---- phase 13: batched encode, 8 stereo WAVs of 30 s and a mono one
    w = read_wav(enc_out["seeded_wav"], 320)
    pcm = w.buffer.reshape(-1, 2)
    n30 = 30 * 44100
    jobs = []
    for k in range(8):
        a = k * (pcm.shape[0] - n30) // 7
        wav = os.path.join(tmp, f"enc{k}.wav")
        write_wav(wav, 44100, pcm[a:a + n30])
        jobs.append((wav, os.path.join(tmp, f"enc{k}.mp3")))
    jobs.append((mono_wav, os.path.join(tmp, "enc_mono.mp3")))
    enc_audio = 9 * 30.0
    encode_files_batched(jobs, device=dev)           # warm-up
    wall, walls, _ = _median3(lambda: encode_files_batched(jobs, device=dev))
    t0 = time.perf_counter()
    singles = [_encode_bytes(wav, dev)[0] for wav, _ in jobs]
    single_s = time.perf_counter() - t0
    for (wav, out), want in zip(jobs, singles):
        with open(out, "rb") as f:
            _expect_equal(f"batched encode of {os.path.basename(wav)}",
                          f.read(), want)
    _say("13 batch encode", f"[{card}] 9 files ({enc_audio:.0f} s of audio, "
                            f"8 stereo + 1 mono): bytes equal each file's own "
                            f"MP3Encoder on the card; wall median "
                            f"{wall * 1e3:.1f} ms of "
                            f"{[round(x * 1e3, 1) for x in walls]} -> "
                            f"{enc_audio / wall:.1f}x realtime; one file at a "
                            f"time {single_s * 1e3:.1f} ms")

    # ---- phase 14: VBR encode of the song at 128 kbps average
    wall, walls, outs = _median3(
        lambda: _encode_bytes(wav64, dev, kbps=128, vbr=True))
    vbr_b, venc = outs[-1]
    host_b, _ = _encode_bytes(wav64, dev, kbps=128, vbr=True, host=True)
    _expect_equal("song VBR: card vs host C++", vbr_b, host_b)
    nf = venc._num_frames()
    xr_card = venc._analysis_device(nf)
    lib = native.get_lib()
    xr_host = np.ascontiguousarray(xr_card.cpu().numpy())
    for step in venc.vbr_steps:
        want = np.empty(xr_host.shape[0], np.int64)
        lib.rate_cost_step(xr_host, xr_host.shape[0], step - 127,
                           venc.band_row * 23, 1 << 20, want)
        got = SP.cost_step(xr_card, step - 127, venc.band_row).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"card lane cost != rate_cost_step at grid "
                                 f"step {step}")
    tag = vbr.parse_vbr_tag(vbr_b, 0)
    if tag is None or tag.stream_bytes != len(vbr_b) or tag.frames != nf:
        raise AssertionError(f"VBR Xing tag does not parse back: {tag}")
    vbr_mp3 = _write(os.path.join(tmp, "song_vbr.mp3"), vbr_b)
    s64 = Steganography(quiet=True, precision="float64", device=dev)
    kbps = s64.decode_mp3_to_wav(vbr_mp3, os.path.join(tmp, "song_vbr.wav"))
    if kbps != vbr.avg_bitrate_kbps(tag, dh.parse_mp3(vbr_b).header):
        raise AssertionError(f"VBR decode reports {kbps} kbps")
    _say("14 vbr", f"[{card}] song at 128 kbps average: {len(vbr_b)} bytes "
                   f"equal the host C++ engine's; card lane cost equals "
                   f"rate_cost_step on all {xr_host.shape[0]} lanes at the "
                   f"{len(venc.vbr_steps)} steps the bisection visited "
                   f"{venc.vbr_steps}; Xing tag parses back ({tag.frames} "
                   f"frames); façade decode reports {kbps} kbps; wall median "
                   f"{wall * 1e3:.1f} ms of {[round(x * 1e3, 1) for x in walls]}"
                   f"; framing stage {venc.timer.times['framing'] * 1e3:.1f} "
                   f"ms")

    # ---- phase 15: streaming decode and encode of the song
    wav_st = os.path.join(tmp, "song_stream.wav")
    t0 = time.perf_counter()
    info = decode_file_streaming(song, wav_st)
    dec_s = time.perf_counter() - t0
    with open(wav_st, "rb") as a, open(wav64, "rb") as b:
        _expect_equal("streaming decode vs whole-file float64", a.read(),
                      b.read())
    mp3_st = os.path.join(tmp, "song_stream.mp3")
    t0 = time.perf_counter()
    encode_file_streaming(wav64, mp3_st, 320)
    enc_s = time.perf_counter() - t0
    with open(mp3_st, "rb") as f:
        _expect_equal("streaming encode vs whole-file encode", f.read(),
                      enc_out["clear_bytes"])
    _say("15 streaming", f"[{card}] song ({info['num_frames']} frames): "
                         f"streaming decode WAV equals the whole-file float64"
                         f" WAV ({dec_s * 1e3:.1f} ms); streaming encode "
                         f"equals the whole-file encode ({enc_s * 1e3:.1f} "
                         f"ms)")

    # ---- the CLI round trip: hide -> reveal in a subprocess
    gold = _write(os.path.join(tmp, "cli.mp3"), np.load(os.path.join(
        GOLD, "encode_golden.npz"))["mp3_bytes"].tobytes())
    cli = [sys.executable, "-m", "mp3stego_tpu_torch", "--device", dev.type]
    hidden = os.path.join(tmp, "cli_hidden.mp3")
    txt = os.path.join(tmp, "cli.txt")
    for argv in (["hide", gold, hidden, "through the CLI"],
                 ["reveal", hidden, txt]):
        r = subprocess.run(cli + argv, cwd=REPO, timeout=300,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise AssertionError(f"CLI {argv[0]} exited {r.returncode}:\n"
                                 f"{r.stdout}{r.stderr}")
    with open(txt) as f:
        if f.read() != "through the CLI":
            raise AssertionError("CLI reveal did not give the message back")
    _say("15 cli", "python -m mp3stego_tpu_torch hide -> reveal gives the "
                   "message back")
    return dict(batch_launches=batch_launches, k1_err=k1_err)


def _conv1d_fir(v_ext: torch.Tensor, s: int):
    """The FIR as one grouped ``conv1d`` (the library yardstick, used
    nowhere in the port): V's channels interleaved as (k, 32 + k) pairs,
    ``w[k, j % 2, 15 - j] = D[j, k]``. Returns (the call, its inputs' layout
    already made, so only the call is timed)."""
    d = sf._window(torch.float32, v_ext.device)
    idx = torch.stack([torch.arange(32), torch.arange(32) + 32], 1) \
        .reshape(-1).to(v_ext.device)
    x = v_ext.permute(0, 2, 1)[:, idx].contiguous()     # (ch, 64, 15 + S)
    w = torch.zeros((32, 2, 16), dtype=torch.float32, device=v_ext.device)
    for j in range(16):
        w[:, j % 2, 15 - j] = d[j]
    return lambda: torch.nn.functional.conv1d(x, w, groups=32)


def _k1_bound_ms(ch: int, s: int):
    """The least time for K1's work on the card: (bytes moved: V history
    read once, window read once, PCM written once) over 3.35 TB/s against
    (2 flops per tap and output) over 67 TFLOP/s float32, the H100 SXM's
    published peaks. Returns (ms, "bytes" or "operations")."""
    nbytes = 4 * (ch * (15 + s) * 64 + 16 * 32 + ch * s * 32)
    flops = 2 * 16 * ch * s * 32
    by_bytes, by_ops = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def main() -> int:
    # ---- phase 0: card and precision
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch: this smoke run "
                           "needs one")
    dev = torch.device("cuda")
    card = _card_line()
    _say("0 card", f"{card} | torch {torch.__version__} CUDA "
                   f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} "
                   f"x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 could not be switched off")
    _say("0 card", "TF32 off (matmul and cuDNN)")

    # ---- phase 1: build the kernel (nvcc, sm_90a) and the host library
    # (g++), both started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        host_lib = pool.submit(native.get_lib)
        _cuda.load("synth_fir", sf._SIGNATURES)
        if host_lib.result() is None:
            raise RuntimeError("the native host library did not build or "
                               "load")
    info = _cuda.builds["synth_fir"]
    _say("1 build", f"csrc/synth_fir.cu -> {os.path.relpath(info['path'], REPO)}"
                    f" in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            _say("1 build", "ptxas: " + line.strip())
    _say("1 build", f"kernel and native host library (in parallel) in "
                    f"{time.perf_counter() - t0:.2f} s")

    # ---- phase 2: K1 against its plain version, bit for bit
    rng = np.random.default_rng(0)
    k1_err = None
    for ch, s in ((2, S_SLICE), (2, 18), (1, 18 * 7)):
        v = torch.from_numpy(rng.standard_normal((ch, 15 + s, 64))
                             .astype(np.float32)).to(dev)
        got, want = _fir_pair(v, s)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"synth_fir != plain at {(ch, 15 + s, 64)}: "
                                 f"max |d| {err}")
        if s == S_SLICE:
            k1_err = err
        _say("2 K1", f"v_ext {(ch, 15 + s, 64)}: bitwise equal to "
                     f"synth_fir_torch (max |d| {err})")
    s = 512
    v = torch.from_numpy(rng.standard_normal((1, 15 + 2 * s, 64))
                         .astype(np.float32)).to(dev)
    whole = sf.synth_fir(v, 2 * s)
    halves = torch.cat([sf.synth_fir(v[:, :15 + s].contiguous(), s),
                        sf.synth_fir(v[:, s:].contiguous(), s)], dim=1)
    torch.cuda.synchronize()
    if not torch.equal(whole, halves):
        raise AssertionError("synth_fir halo continuity broken")
    _say("2 K1", "halo continuity: two halves with a 15-row halo equal one pass")

    # ---- phase 3: plane coverage (short/start/mixed/MS/intensity/linbits)
    prep = synthetic_prep(64)
    ref = dp.decode_granules_np(prep)
    got = dp.decode_granules(dp.prep_to_torch(prep, dev), torch.float32)
    got = got.cpu().numpy()
    err = float(np.abs(got - ref).max())
    # the synthetic batch peaks far above full scale, so the float32 bound
    # of tests/test_precision.py (1e-5 on unit-scale audio) scales with it
    bound = 1e-5 * max(1.0, float(np.abs(ref).max()))
    if not err < bound:
        raise AssertionError(f"card plane vs host float64: {err} >= {bound}")
    _say("3 plane", f"synthetic T=64 batch: card float32 vs host float64 "
                    f"max |d| {err:.3e} (bound {bound:.3e}, peak "
                    f"{np.abs(ref).max():.3f})")

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 4: the slice, a 240.7 s song through the façade
        mp3 = np.load(os.path.join(GOLD, "encode_golden.npz"))["mp3_bytes"]
        song = os.path.join(tmp, "song.mp3")
        with open(song, "wb") as f:
            f.write((mp3.tobytes() + b"\0") * SONG_COPIES)
        s64 = Steganography(quiet=True, precision="float64")
        t0 = time.perf_counter()
        s64.decode_mp3_to_wav(song, os.path.join(tmp, "song64.wav"))
        t64 = time.perf_counter() - t0
        want = _wav_i16(os.path.join(tmp, "song64.wav"))
        seconds = want.size / 2 / 44100
        s32 = Steganography(quiet=True, precision="float32", device="cuda")
        wav32 = os.path.join(tmp, "song32.wav")
        sf.launches = 0
        s32.decode_mp3_to_wav(song, wav32)                  # warm-up
        torch.cuda.reset_peak_memory_stats()
        walls, stages = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            kbps = s32.decode_mp3_to_wav(song, wav32)
            walls.append(time.perf_counter() - t0)
            stages.append(dict(s32._last_decoder.timer.times))
        main_launches = sf.launches
        peak = torch.cuda.max_memory_allocated()
        if main_launches == 0:
            raise AssertionError("the decode path never launched synth_fir")
        got = _wav_i16(wav32)
        _say("4 slice", f"{seconds:.2f} s song at {kbps} kbps: card WAV vs "
                        f"float64 WAV {_lsb_contract('song', got, want)}")
        wall = sorted(walls)[1]
        _say("4 slice", f"[{card}] decode wall median {wall * 1e3:.1f} ms of "
                        f"{[round(w * 1e3, 1) for w in walls]} -> "
                        f"{seconds / wall:.1f}x realtime; float64 host plane "
                        f"{t64 * 1e3:.1f} ms ({seconds / t64:.1f}x); "
                        f"synth_fir launches {main_launches} in 4 decodes")
        for name in stages[0]:
            ms = sorted(st[name] * 1e3 for st in stages)
            _say("4 slice", f"[{card}] stage {name}: median {ms[1]:.2f} ms "
                            f"of {[round(m, 2) for m in ms]}")
        _say("4 slice", f"[{card}] torch.cuda.max_memory_allocated "
                        f"{peak / 2**20:.1f} MiB")

        # device plane by stage, CUDA events, on the song's prep
        with open(song, "rb") as f:
            parsed = dh.parse_mp3(f.read())
        prep = dp.prep_to_torch(dp.host_prepare(parsed), dev)
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        for _ in range(2):                     # the second pass is timed
            marks.clear()
            mark("start")
            x = dp._requantize_stage(prep, torch.float32)
            mark("requantize")
            x = dp._stereo_stage(prep, x, torch.float32)
            mark("stereo")
            x = dp._reorder_alias_stage(prep, x, torch.float32)
            mark("reorder_alias")
            blk = dp._imdct_stage(prep, x, torch.float32)
            mark("imdct")
            pcm = dp.synth_from_blocks(blk, torch.float32)
            mark("overlap_freqinv+synth_v+synth_fir")
            i16 = (pcm * 32767.0).clamp(-32768.0, 32767.0).to(torch.int32)
            i16 = i16.to(torch.int16)
            mark("int16")
            torch.cuda.synchronize()
        total = marks[0][1].elapsed_time(marks[-1][1])
        for (_, a), (name, b) in zip(marks, marks[1:]):
            ms = a.elapsed_time(b)
            _say("4 slice", f"[{card}] device {name}: {ms:.3f} ms "
                            f"({ms / total * 100:.1f}%)")
        _say("4 slice", f"[{card}] device plane total {total:.3f} ms")
        if not torch.equal(i16, dp.decode_granules_i16(prep)):
            raise AssertionError("staged device plane != decode_granules_i16")

        # ---- phase 5: MPEG-2/2.5 through the card path. mpeg2_golden.npz
        # holds the reference encoder's LSF layout, which no decoder reads;
        # torch_lsf_golden.npz holds the same PCM through the JAX package's
        # spec-valid LSF writer (pinned by tests/test_torch_host.py)
        g2 = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
        for name in ("mpeg2_24k_64", "mpeg2_22k05_80", "mpeg25_8k_32"):
            path = os.path.join(tmp, f"{name}.mp3")
            with open(path, "wb") as f:
                f.write(g2[name].tobytes())
            s64.decode_mp3_to_wav(path, os.path.join(tmp, f"{name}64.wav"))
            s32.decode_mp3_to_wav(path, os.path.join(tmp, f"{name}32.wav"))
            line = _lsb_contract(
                name, _wav_i16(os.path.join(tmp, f"{name}32.wav")),
                _wav_i16(os.path.join(tmp, f"{name}64.wav")), TONE_MAX_LSB_RATE)
            parsed = dh.parse_mp3(g2[name].tobytes())
            err = float(np.abs(dp.decode_pcm(parsed, "float32", dev)
                               - dp.decode_pcm(parsed, "float64")).max())
            if not err < 1e-5:
                raise AssertionError(f"{name}: float32 PCM off by {err}")
            _say("5 lsf", f"{name}: {line}; float max |d| {err:.3e}")

        # ---- phase 6: reveal
        sg = np.load(os.path.join(GOLD, "stego_golden.npz"))
        for key, msg in (("hidden_short", "ddd"),
                         ("hidden_long", sg["msg_long"].tobytes().decode())):
            path = os.path.join(tmp, f"{key}.mp3")
            with open(path, "wb") as f:
                f.write(sg[key].tobytes())
            txt = os.path.join(tmp, f"{key}.txt")
            s32.reveal_massage(path, txt)
            with open(txt) as f:
                got = f.read()
            if got != msg:
                raise AssertionError(f"reveal {key}: {got!r} != {msg!r}")
            _say("6 reveal", f"{key}: {got!r}")

        # ---- phases 8-11: the encode and hide path on the same song
        enc_out = encode_phases(dev, card, tmp, song,
                                os.path.join(tmp, "song64.wav"), s32)
        hide_launches = enc_out["hide_launches"]

        # ---- phases 12-15: batched decode and encode, VBR, streaming, CLI
        batch = batch_phases(dev, card, tmp, song,
                             os.path.join(tmp, "song64.wav"), enc_out)
        batch_launches = batch["batch_launches"]
        k1_err = max(k1_err, batch["k1_err"])

    # ---- phase 7: K1 time against its plain version and a grouped conv1d
    # (the library yardstick) at the slice's shape
    v = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 15 + S_SLICE, 64)).astype(np.float32)).to(dev)
    kern = lambda: sf.synth_fir(v, S_SLICE)          # noqa: E731
    plain = lambda: sf.synth_fir_torch(v, S_SLICE)   # noqa: E731
    conv = _conv1d_fir(v, S_SLICE)
    got, lib_out = kern(), conv().permute(0, 2, 1)
    torch.cuda.synchronize()
    # float32, the 16 taps summed in another order: a few ulps of the
    # unit-scale outputs
    lib_err = float((got - lib_out).abs().max())
    lib_tol = 1e-5 * max(1.0, float(got.abs().max()))
    if not lib_err < lib_tol:
        raise AssertionError(f"conv1d FIR vs K1: max |d| {lib_err} >= "
                             f"{lib_tol}")
    plain()
    times = {"plain": [], "kernel": [], "conv1d": []}
    for which in ("plain", "kernel", "conv1d", "conv1d", "kernel", "plain"):
        fn = {"plain": plain, "kernel": kern, "conv1d": conv}[which]
        times[which].append(_time_ms(fn, 20))
    k_ms, p_ms = min(times["kernel"]), min(times["plain"])
    c_ms = min(times["conv1d"])
    bound_ms, bound_by = _k1_bound_ms(2, S_SLICE)
    _say("7 K1 time", f"[{card}] v_ext (2, {15 + S_SLICE}, 64): kernel "
                      f"{times['kernel']} ms, plain {times['plain']} ms "
                      f"(plain/kernel {p_ms / k_ms:.1f}x), grouped conv1d "
                      f"{times['conv1d']} ms (max |d| vs kernel {lib_err:.3e}"
                      f", tolerance {lib_tol:.1e}); bound {bound_ms:.4f} ms "
                      f"by {bound_by}, kernel at {bound_ms / k_ms:.1%} of it")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "synth_fir", "route": "cuda",
        "source": "mp3stego_tpu_torch/csrc/synth_fir.cu",
        "replaces": "mp3stego_tpu/ops/pallas_kernels.py:42",
        "launches": main_launches + hide_launches + batch_launches,
        "max_abs_err": k1_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": c_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
