#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mp3stego_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (Hopper:
the kernels are built for sm_90a). It builds every kernel of the port's
paths from the sources in the checkout (the decode granule plane K2,
``csrc/granule.cu``, and the fused synthesis kernel K1, ``csrc/synth.cu``,
each in float32 and float64, the Huffman bit-scan, ``csrc/huffman.cu``, the
Q31 encode analysis K3, ``csrc/analysis.cu``, the rate-control search
K4, ``csrc/search.cu``, the cost grid K5, ``csrc/cost_grid.cu``, and the
frame serializer, ``csrc/serialize.cu``, which every encode on the card
runs), holds each against its plain PyTorch version bit for bit (and times a
library pair that computes K1's function), drives every
entry point at a size users send (one 240.7-second 320 kbps stereo song
through the façade: decode it with the defaults, which run float64 on the
card, and in float32, measure its capacity, hide a message of 90 % of it,
reveal it, clear it; a batched decode of 32 files in both precisions and a
batched encode of 9; a VBR encode and the streaming decode and encode of the
song, the encode's windows on the card, clear and hidden; hide, reveal and a
streaming decode through the CLI; the song's decode and reveal with the
default route (the Huffman samples scanned on the card); the mesh: the
song's frame-sharded decode over 2, 4 and 8 shards, K1 after a halo, and
the batches on a 4-entry ``files``
mesh, on the visible cards in turn or on repeated entries of one card;
the cost-grid encode engine on a 30 s slice of the song, clear, hidden and
VBR; then the engine choice, measured: the probe of ``utils/calibrate.py``,
the engine its cost models pick for the smoke's inputs, a 1 s slice and
the 32-file batch through the entry point's default (the card) and both
engines its override pins,
the song's ``ix`` and 8-shard PCM fetched through pinned staging and
through ``.cpu()``, a traced clear encode and hide read back by the
device-trace readers (idle share, device ms per stage), and
``decode_pcm`` through the scan on the song),
checks every output against the bit-exact host
planes, the single-file paths and the goldens, and times it. Each main path
runs with every kernel's launch count set to 0 just before it and read just
after; a path that launched none of its kernels fails. Every phase but 21
runs the entry points' default engines (no override set: the card). Every
phase raises on a fault; nothing is caught. The last line of standard output is ``{"ok":
true, "device": {...}}``; the line before it lists the kernels (launches
during the main-path runs, error against the plain version, times, bound,
library time), and the one before that the card's name and power limit.

It imports nothing of JAX and nothing of the JAX package. Without a card, or
outside a checkout, it exits non-zero before printing any result.
"""

import contextlib
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
from mp3stego_tpu_torch.models import encoder as E
from mp3stego_tpu_torch.models.encoder import Encoder, MP3Encoder
from mp3stego_tpu_torch.ops import _cuda
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.ops import encode_plane as EP
from mp3stego_tpu_torch.ops import huffman_device as hd
from mp3stego_tpu_torch.ops import quant_batch as QB
from mp3stego_tpu_torch.ops import search_plane as SP
from mp3stego_tpu_torch.ops import serialize as SZ
from mp3stego_tpu_torch.ops import synth as sf
from mp3stego_tpu_torch.steganography import _frame_message
from mp3stego_tpu_torch.utils.profiling import StageTimer
from mp3stego_tpu_torch.utils.transfer import put_tree
from mp3stego_tpu_torch.utils.wav import WavFile, read_wav, write_wav

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "golden")

# the slice: the 320 kbps golden re-encode (36 frames), one zero byte
# appended (its last frame is one byte short of its header's size, so
# unpadded copies end the sync walk after the first copy), 256 copies:
# 9,216 frames, T = 18,432 granules, 240.7 s of 44.1 kHz stereo
SONG_COPIES = 256
SONG_T = 2 * 36 * SONG_COPIES                # granules per channel
MAX_LSB_RATE = 1e-3                          # tests/test_precision.py contract
# the half-second tone streams of the goldens (MPEG-2/2.5 and multirate):
# the JAX package's own float32 plane flips 1.4e-3 of the LSF ones' samples
# (tests/test_torch_facade.py), the port's CPU plane 0.8e-3 to 1.5e-3 of
# them all (a loud stationary tone crosses more truncation boundaries)
TONE_MAX_LSB_RATE = 2e-3
HIDE_SHARE = 0.9                             # message size / capacity
BATCH_SLICES = 23                            # 30 s slices in the batch
F32, F64 = torch.float32, torch.float64
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and separately rounded
# FP operations/s outside the tensor cores: 67 TFLOP/s float32 and 34
# TFLOP/s float64 count a fused multiply-add as two operations, and K1 may
# not fuse (its products and sums round on their own), so half of each
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {F32: 67e12 / 2, F64: 34e12 / 2}
# integer operations/s: an SM has 64 INT32 lanes beside its 128 FP32 lanes
# (NVIDIA's Hopper architecture paper), so half the non-fused float32 rate
PEAK_INT_OPS_S = 67e12 / 4
# integer operations of K4's function, counted from search_plane's quantize
# and _cost (the note in csrc/search.cu) and charged to the work counts each
# lane writes: an evaluation past the quick reject quantizes 576 samples (7
# each: |x|, product, rounding add, shift, range test, gather, max), one past
# the ixmax gate finds the run lengths (4 a sample), then each count1 quad
# costs 19 (4 sign tests and 3 adds, the pattern's 3 shifts and 3 adds, 2
# table lengths and 4 adds) and each big-values pair 27 (pair index 4, signs
# 3, escapes 3, the 4 table lengths with their signs 8, the pair's region 2,
# its 5 sums, its max 2), 4 more in hide and window mode (the re-cost under
# the emitted table); nothing past the quick reject, and the per-evaluation
# constants (subdivide, table select) left out
K4_OPS_QUANTIZE = 576 * 7
K4_OPS_RUNS = 576 * 4
K4_OPS_QUAD = 19
K4_OPS_PAIR = 27
K4_OPS_PAIR_HIDE = K4_OPS_PAIR + 4
# integer operations of K3's function per (channel, granule) (the note in
# csrc/analysis.cu), in cycles of the INT32 (FMA) pipe: 66,816 Q31 products
# (window 18 x 512, filter 18 x 32 x 64, MDCT 32 x 18 x 36), each a
# multiply-high and its add, which sm_90a issues as one IMAD.HI (its addend
# a register pair with a zero low word) that holds the pipe two cycles
# (tools/imad_probe.py: 7.79 T/s against IMAD's 16.66 T/s on the H100), and
# 31 x 8 alias butterflies of 8 (4 products, 2 sums, 2 shifts). With one
# cycle a product (``analysis_bound``'s ``per_product=1``) the bound would be
# half of what any kernel can reach.
K3_PRODUCTS = 18 * 512 + 18 * 32 * 64 + 32 * 18 * 36
K3_OPS_GRANULE = 2 * K3_PRODUCTS + 8 * 31 * 8
# the window and filter of the granule of MDCT context in front of a
# window's first output (``skip`` > 0), in the same cycles
K3_OPS_CONTEXT = 2 * (18 * 512 + 18 * 32 * 64)
# separately rounded operations of K2's function (the note in
# csrc/granule.cu), counted from decode_plane.granule_blocks_torch and
# charged to what this run's data takes: per sample the requantize (the
# sign, two products); per MS granule and sample index a sum, a difference
# and two divisions; per intensity sample two products; per alias
# butterfly 4 products and 2 sums (248 a long granule, 8 an ISO-mixed one);
# per long band 36 x 18 products and sums and 36 window products; per short
# band 3 x 12 x 6 products and sums, 36 window products and 12 overlap sums
K2_OPS_SAMPLE = 3
K2_OPS_MS = 4
K2_OPS_IS = 2
K2_OPS_BUTTERFLY = 6
K2_OPS_LONG_BAND = 36 * 18 * 2 + 36
K2_OPS_SHORT_BAND = 3 * 12 * 6 * 2 + 36 + 12
# K2's instantiations by (dtype, int32 plane), as -Xptxas -v and the SASS
# name them (granule_kernel<float or double, signed char or int>)
K2_INSTANCES = {(F32, False): "granule_kernelIfa",
                (F32, True): "granule_kernelIfi",
                (F64, False): "granule_kernelIda",
                (F64, True): "granule_kernelIdi"}
# integer operations of K5's function (the note in csrc/cost_grid.cu),
# counted from quant_batch._cost_all_steps and charged to this run's data:
# every cell quantizes its 576 samples, the quick reject's cells included
# (K4's 7 a sample, the approx test, and the run lengths' 4), then the
# count1 quads (K4's 19 each) and the big-values pairs (K4's 27 each: the
# lengths under 13/15/16/24 with signs and escapes, the region, its 5 sums
# and its max); the per-cell constants (bail, subdivide, table choice) and
# the pairs past big_values, which the function masks out, left out
K5_OPS_SAMPLE = 7 + 1 + 4
K5_OPS_QUAD = K4_OPS_QUAD
K5_OPS_PAIR = K4_OPS_PAIR
# the integer operations K5's function needs on this run's data, in the
# form csrc/cost_grid.cu computes it (grid_need_bound; K5_OPS_* above stay
# PR 15's yardstick, which quantizes every sample of every cell): a lane's
# true |x|, its suffix maxima and its int32-wrapped maximum (3 a sample);
# a cell's bail (product, rounding add, shift, compare: 4), its ixmax and
# approx from the lane's largest |x| (a quantize of 3, clip, gather, two
# tests: 7), two 10-probe searches of the suffix maxima for the last
# nonzero and the last sample above 1 (a quantize and a compare, 4 a
# probe: 80), the run lengths (6), the subdivide's read (1), three
# regions' table choice (the ESC rules' read, two costs of a product and
# an add, two compares and two selects: 8 each) and bits (4); a sample it
# reads (below the end of its quads or of its last region: product,
# rounding add, shift, clip); a pair below the last region's end (two
# int2idx gathers, its index into the pair table (two clips, one
# shift-add) and the table's read, its region (two compares) with the
# 64-bit add of its 5 packed sums (2), its max and its region's (2)); a
# count1 quad (its pattern's 3 shifts and 3 ors, the signs as one
# population count, 2 table lengths and 4 adds)
K5_NEED_LANE = 576 * 3
K5_NEED_CELL = 4 + 7 + 2 * 10 * 4 + 6 + 1 + 3 * 8 + 4
K5_NEED_SAMPLE = 4
K5_NEED_PAIR = 2 + 3 + 1 + 2 + 2 + 2
K5_NEED_QUAD = 6 + 1 + 2 + 4
GRID_SECONDS = 30                            # the grid engine's song slice
# the hand kernels, each module with its wrapper's launch count
KERNELS = {"granule": dp, "synth_fused": sf, "huffman_scan": hd,
           "search": SP, "analysis": EP, "cost_grid": QB, "serialize": SZ}
DECODE = ("granule", "synth_fused")          # the kernels a decode runs
ENCODE = ("search", "analysis", "serialize")  # the kernels an encode runs
# the bit-scan kernel's plane instantiation, as -Xptxas -v names it
SCAN_KERNEL = "huffman_scan_kernelINS_3Row"


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


def synthetic_lanes(frames: int = 64, seed: int = 13) -> tuple:
    """A seeded lane set for the Huffman bit-scan, as ``hd.pack`` lays it
    out: (words (W,) int32, fields (4 frames, 8) int32). Each frame's main
    data is random bits, so every codeword, escape and sign occurs. The
    first 96 lanes decode all three regions (big2 = 576) and give every
    table id 0-31 to each region; every fourth frame's lanes take tables
    23 and 31 (13 linbits) in the last region; the rest draw their region
    bounds, big2 (0 to 576, even) and end bit at random, many ending inside
    the count1 quads; count1 tables A and B alternate. Lane 1 has big2 = 0,
    lane 5 three words while it reads 576 samples and far past its end bit,
    lane 9 no words at all (a mono stream's second channel)."""
    rng = np.random.default_rng(seed)
    nwords = rng.integers(24, 480, size=frames)
    base = np.concatenate([[0], np.cumsum(nwords)[:-1]])
    words = np.concatenate([rng.integers(0, 1 << 32, size=int(nwords.sum()),
                                         dtype=np.uint64),
                            np.zeros(hd.PAD_WORDS, np.uint64)])
    fields = np.zeros((4 * frames, 8), np.int64)
    for g in range(4 * frames):
        f = g // 4
        bits = 32 * int(nwords[f])
        start = int(rng.integers(0, 96))
        end = start + int(rng.integers(0, bits - start))
        if g < 96:
            ts = [(g + 11 * r) % 32 for r in range(3)]
            r0, r1, big2 = 2 * int(rng.integers(8, 60)), 360, 576
        else:
            ts = [int(t) for t in rng.integers(0, 32, size=3)]
            if f % 4 == 0:
                ts[2] = 23 if g % 2 else 31
            r0, r1 = sorted(2 * int(v) for v in rng.integers(0, 289, 2))
            big2 = 2 * int(rng.integers(0, 289))
        fields[g] = (base[f], nwords[f], start, end, r0, r1, big2,
                     ts[0] | ts[1] << 5 | ts[2] << 10 | (g // 2 % 2) << 15)
    fields[1, 6] = 0
    fields[5, [1, 3, 6]] = (3, 1 << 20, 576)
    fields[9, :4] = (0, 0, 0, 0)
    fields[9, 6] = 0
    return (words.astype(np.uint32).view(np.int32),
            fields.astype(np.int32))


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


@contextlib.contextmanager
def host_stream_calls():
    """The calls of the host's channel-stream builders
    (``MP3Encoder._channel_streams_i16``, ``encode_plane._padded_streams``)
    while the block runs, by name."""
    calls = []
    names = ((MP3Encoder, "_channel_streams_i16"), (EP, "_padded_streams"))
    saved = [getattr(owner, name) for owner, name in names]
    for (owner, name), fn in zip(names, saved):
        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        setattr(owner, name, spy)
    try:
        yield calls
    finally:
        for (owner, name), fn in zip(names, saved):
            setattr(owner, name, fn)


class Paths:
    """The hand kernels' launches per main path: each path runs with every
    count set to 0 just before it and read just after, and fails if a kernel
    it runs (``kernels``) launched no time, or if a path that runs K3 built
    channel streams on the host."""

    def __init__(self):
        self.log = []                        # (name, dtype, {kernel: n})

    def run(self, name: str, dtype, fn, kernels=DECODE):
        for mod in KERNELS.values():
            mod.launches = 0
        with host_stream_calls() as calls:
            out = fn()
        counts = {k: mod.launches for k, mod in KERNELS.items()}
        for k in kernels:
            if counts[k] == 0:
                raise AssertionError(f"{name}: the path never launched {k}")
        if "analysis" in kernels and calls:
            raise AssertionError(f"{name}: built channel streams on the "
                                 f"host ({sorted(set(calls))}); K3 reads "
                                 f"the WAV's interleaved buffer")
        self.log.append((name, dtype, counts))
        return out

    def last(self, kernel: str = "synth_fused") -> int:
        return self.log[-1][2][kernel]

    def launches(self, kernel: str, dtype=None) -> int:
        return sum(c[kernel] for _, d, c in self.log if dtype in (None, d))


def hold(name: str, blk: torch.Tensor, out: str, channels: int,
         errs: dict, halo: torch.Tensor = None) -> None:
    """The kernel against its plain version on ``blk`` (after ``halo``),
    bit for bit; the largest difference goes into ``errs[dtype]``."""
    got = sf.synth_fused(blk, out, channels, halo)
    want = sf.synth_fused_torch(blk, out, channels, halo)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs the "
                             f"plain {tuple(want.shape)} {want.dtype}")
    err = float((got.double() - want.double()).abs().max())
    errs[blk.dtype] = max(errs.get(blk.dtype, 0.0), err)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: synth_fused != synth_fused_torch "
                             f"({out}, {blk.dtype}, {tuple(blk.shape)}): "
                             f"max |d| {err}")


def _seeded_blk(rows: int, t: int, seed: int, dtype, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(0.3 * rng.standard_normal((rows, t, 32, 36))) \
        .to(device=dev, dtype=dtype)


def song_blocks(prep: dict, dtype) -> torch.Tensor:
    """The song's IMDCT blocks (2, T, 32, 36) in ``dtype``: what the decode
    plane hands the fused kernel."""
    return dp.granule_blocks(prep, dtype)[:2].contiguous()


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


def mono_pcm() -> np.ndarray:
    """30 s of a seeded 44.1 kHz mono tone with noise, int16."""
    rng = np.random.default_rng(12)
    t = np.arange(30 * 44100) / 44100
    return np.clip((0.4 * np.sin(2 * np.pi * 330 * t)
                    + 0.05 * rng.standard_normal(t.size)) * 30000,
                   -32768, 32767).astype(np.int16)


def flipped_song(song_b: bytes) -> bytes:
    """The song with 256 seeded bit flips inside frames' main data (past
    each header and side info, so the sync walk holds)."""
    parsed = dh.parse_mp3(song_b)
    sizes = np.asarray(parsed.frame_sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rng = np.random.default_rng(16)
    flipped = bytearray(song_b)
    for _ in range(256):
        fr = int(rng.integers(0, parsed.num_frames))
        flipped[int(starts[fr]) + int(rng.integers(36, int(sizes[fr])))] ^= \
            1 << int(rng.integers(0, 8))
    return bytes(flipped)


def _expect_equal(name, got: bytes, want: bytes):
    if got != want:
        diff = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
            if len(got) == len(want) else min(len(got), len(want))
        raise AssertionError(f"{name}: {len(got)} bytes differ from the "
                             f"expected {len(want)} at byte {diff}")


def analysis_bound(ch: int, tg: int, skip: int = 0,
                   per_product: int = 2):
    """The least time for K3's work on the card: (bytes that must move: the
    int16 streams and the tables read once, the int32 spectra of granules
    ``skip`` onward written once) over HBM's rate, against
    (``K3_OPS_GRANULE`` a (channel, output granule), ``K3_OPS_CONTEXT`` for
    the granule of context before the first when ``skip`` > 0) over the
    INT32 rate; ``per_product=1`` counts one pipe cycle a product instead
    of the two an IMAD.HI takes. Returns (ms, "bytes" or "operations",
    bytes, operations)."""
    lanes = ch * (tg - skip)
    nbytes = 2 * ch * (EP._PAST + tg * 576) + 4 * lanes * 576 \
        + 4 * (512 + 32 * 64 + 18 * 36 + 16)
    cut = (2 - per_product) * K3_PRODUCTS
    ops = lanes * (K3_OPS_GRANULE - cut) + (
        ch * K3_OPS_CONTEXT * per_product // 2 if skip else 0)
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_INT_OPS_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes, ops
    return by_ops, "operations", nbytes, ops


def hold_analysis(name: str, full: torch.Tensor, skip: int = 0,
                  native=None) -> torch.Tensor:
    """K3 on ``full`` against its plain version and, where given, the
    native twin's spectra, bit for bit; returns the kernel's result."""
    got = EP.analysis_stream(full, skip=skip)
    want = EP.analysis_stream_torch(full, skip=skip)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: analysis kernel != "
                             f"analysis_stream_torch")
    if native is not None and not np.array_equal(got.cpu().numpy(), native):
        raise AssertionError(f"{name}: analysis kernel != native "
                             f"encode_analysis")
    return got


def hold_interleaved(name: str, buf: np.ndarray, nch: int, tg: int,
                     dev) -> torch.Tensor:
    """K3 on the WAV's interleaved buffer against the stream route on the
    channels ``_channel_streams_i16`` cuts from it and the native twin, bit
    for bit; returns the kernel's result."""
    streams = np.zeros((nch, tg * 576), np.int16)
    for c in range(nch):
        part = buf[c::nch][:tg * 576]
        streams[c, :len(part)] = part
    got = EP.analysis_interleaved(torch.from_numpy(buf).to(dev), nch, tg)
    want = EP.analysis_stream(torch.from_numpy(
        EP._padded_streams(streams, tg)).to(dev))
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: interleaved analysis != the stream "
                             f"route")
    if not np.array_equal(got.cpu().numpy(),
                          EP.run_analysis_native(streams, tg)):
        raise AssertionError(f"{name}: interleaved analysis != native "
                             f"encode_analysis")
    return got


def _card_ms(fn, runs: int = 10) -> float:
    """The median card time of ``fn()`` by CUDA events, each call issued
    behind a spin of the card so that the events hold the card's time and
    not the host's enqueue."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def analysis_phase(dev, card: str, wav64: str):
    """Phase 8: K3 (``csrc/analysis.cu``) bit for bit its plain version
    and the native ``encode_analysis`` on the song, a 512-frame and a
    7-frame window sliced as the streaming encode does (``skip=1``, equal
    to the whole stream's granules too), a mono stream, a 1-granule stream
    and a full-scale square wave whose sums wrap; its interleaved entry on
    the song's WAV buffer, a mono buffer and a buffer shorter than whole
    granules bit for bit the stream route and the native twin. Then K3
    alone at the three shapes its launches take (CUDA events behind a card
    spin) beside each bound, the plain version, the host preparation the
    interleaved entry removed, the uploads and the host C++ twin, and the
    kernel's registers, shared memory, spills (a spill fails the phase) and
    resident warps an SM. Returns (the song's seconds, K3's measured fields
    of the kernels line)."""
    enc = MP3Encoder(read_wav(wav64, 320), device=dev)
    nf = enc._num_frames()
    tg = nf * enc.granules_per_frame
    nch = enc.wav.num_of_channels
    seconds = enc.wav.num_of_samples / enc.wav.samplerate
    t0 = time.perf_counter()
    streams = enc._channel_streams_i16(nf)
    t1 = time.perf_counter()
    padded = EP._padded_streams(streams, tg)
    t2 = time.perf_counter()
    full = torch.from_numpy(padded).to(dev)
    up_ms = _time_ms(lambda: torch.from_numpy(padded).to(dev), 3)
    wav_buf = np.ascontiguousarray(enc.wav.buffer[:nch * tg * 576],
                                   np.int16)                # as encodes send
    buf_ms = _time_ms(lambda: torch.from_numpy(wav_buf).to(dev), 3)
    t3 = time.perf_counter()
    native = EP.run_analysis_native(streams, tg)
    host_ms = (time.perf_counter() - t3) * 1e3
    got = hold_analysis("song", full, native=native)
    if not torch.equal(hold_interleaved("song, interleaved", wav_buf, nch,
                                        tg, dev), got):
        raise AssertionError("the song's interleaved spectra differ")

    lo = 1 + tg // 8
    windows = {}
    for frames in (512, 7):
        hi = lo + frames * enc.granules_per_frame
        win = full[:, (lo - 1) * 576:hi * 576 + EP._PAST].contiguous()
        if not torch.equal(hold_analysis(f"{frames}-frame window, skip=1",
                                         win, 1), got[:, lo:hi]):
            raise AssertionError(f"{frames}-frame window slice != the "
                                 f"whole stream's granules")
        windows[f"{frames}-frame window"] = win
    del got
    n = min(300, tg)
    mono = streams[:1, :n * 576]
    hold_analysis("mono", torch.from_numpy(EP._padded_streams(mono, n))
                  .to(dev), native=EP.run_analysis_native(mono, n))
    hold_interleaved("mono, interleaved", np.ascontiguousarray(mono[0]), 1,
                     n, dev)
    hold_interleaved("short buffer, interleaved",
                     wav_buf[:2 * 5 * 576 + 333].copy(), nch, 9, dev)
    one = streams[:, tg // 2 * 576:(tg // 2 + 1) * 576]
    hold_analysis("1 granule", torch.from_numpy(EP._padded_streams(one, 1))
                  .to(dev), native=EP.run_analysis_native(one, 1))
    t = np.arange(300 * 576)
    sq = np.where((t // 50) % 2 == 0, 32767, -32768)
    sq = np.stack([sq, np.roll(sq, 17)]).astype(np.int16)
    wrap = hold_analysis("full-scale square", torch.from_numpy(
        EP._padded_streams(sq, 300)).to(dev),
        native=EP.run_analysis_native(sq, 300))
    if not wrap.abs().max() > 2 ** 30:
        raise AssertionError("the square wave's sums did not wrap")
    _say("8 analysis", f"K3 bitwise equal to analysis_stream_torch and the "
                       f"native encode_analysis on the song {tuple(full.shape)}"
                       f" int16, 512- and 7-frame window slices (skip=1, "
                       f"equal to the whole stream's granules from {lo}), a "
                       f"mono stream, 1 granule and a full-scale square "
                       f"wave; the interleaved entry on the song's WAV "
                       f"buffer, a mono and a short buffer equal to the "
                       f"stream route and the native twin")

    shapes = {"song": (full, 0), **{k: (w, 1) for k, w in windows.items()}}
    buf_dev = torch.from_numpy(wav_buf).to(dev)
    fns = {k: (lambda f=f, sk=sk: EP.analysis_stream(f, skip=sk))
           for k, (f, sk) in shapes.items()}
    fns["song, interleaved"] = lambda: EP.analysis_interleaved(buf_dev, nch,
                                                               tg)
    for fn in fns.values():
        fn()
    ms = {k: _card_ms(fn) for k, fn in fns.items()}
    plain_ms = _time_ms(lambda: EP.analysis_stream_torch(full), 1)
    occ = EP.occupancy(dev)
    for name, (f, sk) in shapes.items():
        n_g = (f.shape[1] - EP._PAST) // 576
        bound, by, nbytes, ops = analysis_bound(f.shape[0], n_g, sk)
        bound1 = analysis_bound(f.shape[0], n_g, sk, per_product=1)[0]
        g, run, items = EP.schedule(f.shape[0], n_g - sk,
                                    EP._grid_cap(dev), occ["granules"])
        _say("8 analysis", f"[{card}] {name}, {f.shape[0]} x {n_g} granules"
                           f" (skip={sk}; tiles of {g}, runs of {run}, "
                           f"{items} runs): kernel {ms[name]:.4f} ms, bound "
                           f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
                           f"{ops / 1e9:.4f} G pipe cycles), at "
                           f"{bound / ms[name]:.1%} of it ({bound1:.4f} ms "
                           f"and {bound1 / ms[name]:.1%} at one cycle a "
                           f"product)")
    bound, by = analysis_bound(full.shape[0], tg)[:2]
    _say("8 analysis", f"[{card}] song from the WAV's interleaved buffer: "
                       f"kernel {ms['song, interleaved']:.4f} ms; plain "
                       f"(streams) {plain_ms:.2f} ms (plain/kernel "
                       f"{plain_ms / ms['song']:.1f}x)")
    _say("8 analysis", f"[{card}] host preparation the interleaved entry "
                       f"removed: _channel_streams_i16 "
                       f"{(t1 - t0) * 1e3:.2f} ms, _padded_streams "
                       f"{(t2 - t1) * 1e3:.2f} ms, their upload "
                       f"({padded.nbytes / 1e6:.1f} MB) {up_ms:.2f} ms; "
                       f"now the WAV buffer's upload ({wav_buf.nbytes / 1e6:.1f}"
                       f" MB) {buf_ms:.2f} ms (CUDA events); host C++ twin "
                       f"{host_ms:.1f} ms")
    res = _cuda.ptxas_resources("analysis", "analysis_kernel")
    _say("8 analysis", f"[{card}] analysis_kernel: {res['registers']} "
                       f"registers a thread, {res['smem'] + occ['smem']} B "
                       f"of shared memory a CTA ({occ['smem']} B dynamic), "
                       f"spills {res['spill_stores']} B stored and "
                       f"{res['spill_loads']} B loaded (-Xptxas -v); "
                       f"{occ['ctas']} CTAs of {occ['warps']} warps an SM, "
                       f"{occ['ctas'] * occ['warps']} resident warps (the "
                       f"runtime's occupancy query)")
    if res["spill_stores"] or res["spill_loads"]:
        raise AssertionError("analysis_kernel spills registers")
    del full, windows, buf_dev
    torch.cuda.empty_cache()
    return seconds, dict(max_abs_err=0, ms=ms["song"], plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None)


def encode_phases(dev, card: str, tmp: str, song: str, wav64: str,
                  s64: Steganography, s32: Steganography,
                  runs: Paths) -> dict:
    """Phases 8-11: the encode and hide path on the song and the goldens,
    with the façade's hide in float64 (the default) and in float32, each a
    counted main path. Returns the song's clear encode bytes, the seeded
    song's WAV, the 90 % hide's bits and bytes, its MP3 and its message."""
    # ---- phase 8: K3 on the card bit for bit its plain version and the
    # host C++ twin, on the song and the edge streams; its time
    seconds, k3 = analysis_phase(dev, card, wav64)

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
    wall, walls, outs = runs.run("clear encode", None, lambda: _median3(
        lambda: _encode_bytes(wav64, dev)), kernels=ENCODE)
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
                     f"{2 * enc._num_frames() * enc.granules_per_frame} "
                     f"lanes")

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
    wall, walls, outs = runs.run("hide encode", None, lambda: _median3(
        lambda: _encode_bytes(wav64, dev, bits)), kernels=ENCODE)
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
    if runs.run("façade hide, float64 decode", F64,
                lambda: s64.hide_message(song, hidden, msg),
                kernels=DECODE + ENCODE):
        raise AssertionError("a 90 % message did not fit")
    facade_s = time.perf_counter() - t0
    with open(hidden, "rb") as f:
        _expect_equal("façade hide vs encoder hide", f.read(), card_b)
    txt = os.path.join(tmp, "song.txt")
    s64.reveal_massage(hidden, txt)
    with open(txt) as f:
        if f.read() != msg:
            raise AssertionError("reveal of the song's message failed")
    _say("10 hide", f"[{card}] façade hide_message (float64 card decode + "
                    f"card encode) {facade_s * 1e3:.1f} ms -> "
                    f"{seconds / facade_s:.1f}x realtime; reveal gives "
                    f"the {len(msg)}-char message back")

    # ---- phase 11: the float32 round trip (K1 on the decode inside hide)
    hidden32 = os.path.join(tmp, "song_hidden32.mp3")
    if runs.run("façade hide, float32 decode", F32,
                lambda: s32.hide_message(song, hidden32, msg),
                kernels=DECODE + ENCODE):
        raise AssertionError("float32 hide: the message did not fit")
    hide_launches = runs.log[-1][2]
    s32.reveal_massage(hidden32, txt)
    with open(txt) as f:
        if f.read() != msg:
            raise AssertionError("float32 hide: reveal failed")
    cleared = os.path.join(tmp, "song_clear32.mp3")
    runs.run("façade clear, float32 decode", F32,
             lambda: s32.clear_file(song, cleared),
             kernels=DECODE + ENCODE)
    wav32 = os.path.join(tmp, "song32b.wav")
    s32.decode_mp3_to_wav(song, wav32)
    plain = os.path.join(tmp, "song_plain32.mp3")
    s32.encode_wav_to_mp3(wav32, plain, 320)
    with open(cleared, "rb") as a, open(plain, "rb") as b:
        _expect_equal("clear_file vs encode of the same decode", a.read(),
                      b.read())
    _say("11 float32", f"hide_message (float32) -> reveal gives the message "
                       f"back; kernel launches in the hide {hide_launches}, "
                       f"in clear_file {runs.log[-1][2]}; clear_file bytes "
                       f"equal a plain encode of the same decode")
    return dict(clear_bytes=clear_b, seeded_wav=wav_s, hide_bits=bits,
                hide_bytes=card_b, hidden=hidden, msg=msg, k3=k3)


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
                 enc_out: dict, s64: Steganography, runs: Paths,
                 errs: dict) -> dict:
    """Phases 12-15 and the CLI round trip: the batched decode (K1 over the
    (file, channel) rows of each chunk) in float32 and float64, the batched
    encode, VBR, and the streaming decode and encode of the song. Returns
    the batches and their outputs (phase 19 runs them on a mesh)."""
    from mp3stego_tpu_torch.bitstream import vbr
    from mp3stego_tpu_torch.models.streaming import decode_file_streaming
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
    mono_wav = os.path.join(tmp, "mono.wav")
    write_wav(mono_wav, 44100, mono_pcm())
    paths.append(_write(os.path.join(tmp, "b_mono.mp3"),
                        _encode_bytes(mono_wav, dev, kbps=128)[0]))
    metas = []
    for p in paths:
        with open(p, "rb") as f:
            metas.append(dh.parse_mp3(f.read()))
    chunks = BD._chunks(metas, 16)
    # the float32 float run and the float64 int16 run hand K1 each chunk's
    # blocks over F * ch rows; a copy of each is held below against the
    # plain version, bit for bit, in both epilogues
    synth, blks = dp.synth_fused, []

    def synth_copy(blk, out="float", channels=1, halo=None):
        blks.append((blk.clone(), channels))
        return synth(blk, out, channels, halo)

    dp.synth_fused = synth_copy
    try:
        floats = decode_files_batched(paths, device=dev)
        i16_64 = decode_files_batched(paths, dtype="float64", out="int16",
                                      device=dev)
    finally:
        dp.synth_fused = synth
    if len(blks) != 2 * len(chunks):
        raise AssertionError(f"batched decode: {len(blks)} K1 calls for "
                             f"2 x {len(chunks)} chunks")
    for blk, channels in blks:
        for out in sf.OUTS:
            hold("batch chunk", blk, out, channels, errs)
    _say("12 batch decode", f"K1 bitwise equal to synth_fused_torch, float "
                            f"and int16, on each chunk's blocks (rows, T, 32,"
                            f" 36), float32 and float64: "
                            f"{[tuple(b.shape) for b, _ in blks[:len(chunks)]]}")
    del blks
    for p, parsed, got, got64 in zip(paths, metas, floats, i16_64):
        want = dp.decode_pcm(parsed, "float32", dev)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"batched float decode of {p} != its "
                                 f"single-file decode on the card")
        want = dp.decode_pcm_i16_host(parsed)
        if got64.shape != want.shape or not np.array_equal(got64, want):
            raise AssertionError(f"batched float64 decode of {p} != its host "
                                 f"float64 decode")
    i16 = runs.run("batched decode, float32 int16", F32,
                    lambda: decode_files_batched(paths, out="int16",
                                                 device=dev))
    if runs.last() != len(chunks) or runs.last("granule") != len(chunks):
        raise AssertionError(f"batched decode: {runs.last()} K1 and "
                             f"{runs.last('granule')} K2 launches for "
                             f"{len(chunks)} chunks")
    audio_s, worst = 0.0, (0.0, "")
    for p, parsed, got in zip(paths, metas, i16):
        audio_s += got.shape[0] / parsed.header.sampling_rate
        want = dp.decode_pcm_i16_host(parsed)
        name = os.path.basename(p)
        _lsb_contract(name, got, want, MAX_LSB_RATE
                      if name.startswith("slice") else TONE_MAX_LSB_RATE)
        rate = float((got != want).mean())
        worst = max(worst, (rate, os.path.basename(p)))
    runs.run("batched decode, float64 int16", F64,
              lambda: decode_files_batched(paths, dtype="float64",
                                           out="int16", device=dev))
    wall, walls, _ = _median3(
        lambda: decode_files_batched(paths, out="int16", device=dev))
    wall_i16 = wall
    wall64, walls64, _ = _median3(
        lambda: decode_files_batched(paths, dtype="float64", out="int16",
                                     device=dev))
    t0 = time.perf_counter()
    for p in paths:
        dp.decode_pcm_i16(BD._read_parsed(p), dev)
    single_s = time.perf_counter() - t0
    _say("12 batch decode", f"{len(paths)} files ({audio_s:.2f} s of audio) "
                            f"in {len(chunks)} chunks: float32 PCM bit for "
                            f"bit each file's own card decode, float32 int16 "
                            f"within 1 LSB of the float64 host plane (largest "
                            f"share {worst[0]:.3e}, {worst[1]}); float64 "
                            f"int16 equal to each file's host decode")
    _say("12 batch decode", f"[{card}] float32 wall median {wall * 1e3:.1f} "
                            f"ms of {[round(x * 1e3, 1) for x in walls]} -> "
                            f"{audio_s / wall:.1f}x realtime; float64 wall "
                            f"median {wall64 * 1e3:.1f} ms of "
                            f"{[round(x * 1e3, 1) for x in walls64]} -> "
                            f"{audio_s / wall64:.1f}x realtime; K2 and K1 launches "
                            f"{len(chunks)} a run (one per chunk); one file "
                            f"at a time (read, parse, float32 card plane) "
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
    wall, walls, _ = runs.run("batched encode", None, lambda: _median3(
        lambda: encode_files_batched(jobs, device=dev)), kernels=ENCODE)
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
    batches = dict(paths=paths, metas=metas, chunks=len(chunks),
                   floats=floats, i16_64=i16_64, i16_wall=wall_i16,
                   jobs=jobs, enc_bytes=singles, enc_wall=wall)

    # ---- phase 14: VBR encode of the song at 128 kbps average
    wall, walls, outs = runs.run("VBR encode", None, lambda: _median3(
        lambda: _encode_bytes(wav64, dev, kbps=128, vbr=True)),
        kernels=ENCODE)
    vbr_b, venc = outs[-1]
    host_b, _ = _encode_bytes(wav64, dev, kbps=128, vbr=True, host=True)
    _expect_equal("song VBR: card vs host C++", vbr_b, host_b)
    nf = venc._num_frames()
    xr_card = venc._analysis_device(nf)
    lib = native.get_lib()
    xr_host = np.ascontiguousarray(xr_card.cpu().numpy())
    errs["search"] = 0
    for step in venc.vbr_steps:
        want = np.empty(xr_host.shape[0], np.int64)
        lib.rate_cost_step(xr_host, xr_host.shape[0], step - 127,
                           venc.band_row * 23, 1 << 20, want)
        got = SP.cost_step(xr_card, step - 127, venc.band_row)
        plain = SP.cost_step_torch(xr_card, step - 127, venc.band_row)
        errs["search"] = max(errs["search"],
                             int((got - plain).abs().max()))
        if not torch.equal(got, plain):
            raise AssertionError(f"cost_step kernel != cost_step_torch at "
                                 f"grid step {step}")
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"card lane cost != rate_cost_step at grid "
                                 f"step {step}")
    tag = vbr.parse_vbr_tag(vbr_b, 0)
    if tag is None or tag.stream_bytes != len(vbr_b) or tag.frames != nf:
        raise AssertionError(f"VBR Xing tag does not parse back: {tag}")
    vbr_mp3 = _write(os.path.join(tmp, "song_vbr.mp3"), vbr_b)
    kbps = s64.decode_mp3_to_wav(vbr_mp3, os.path.join(tmp, "song_vbr.wav"))
    if kbps != vbr.avg_bitrate_kbps(tag, dh.parse_mp3(vbr_b).header):
        raise AssertionError(f"VBR decode reports {kbps} kbps")
    _say("14 vbr", f"[{card}] song at 128 kbps average: {len(vbr_b)} bytes "
                   f"equal the host C++ engine's; the cost_step kernel "
                   f"equals cost_step_torch bit for bit and rate_cost_step "
                   f"on all {xr_host.shape[0]} lanes at the "
                   f"{len(venc.vbr_steps)} steps the bisection visited "
                   f"{venc.vbr_steps}; Xing tag parses back ({tag.frames} "
                   f"frames); façade decode reports {kbps} kbps; wall median "
                   f"{wall * 1e3:.1f} ms of {[round(x * 1e3, 1) for x in walls]}"
                   f"; framing stage {venc.timer.times['framing'] * 1e3:.1f} "
                   f"ms")

    # ---- phase 15: streaming decode (float64 on the card, then the host
    # C++ plane) and encode of the song
    wav_st = os.path.join(tmp, "song_stream.wav")
    t0 = time.perf_counter()
    info = runs.run("streaming decode, float64", F64,
                     lambda: decode_file_streaming(song, wav_st))
    dec_s = time.perf_counter() - t0
    with open(wav_st, "rb") as a, open(wav64, "rb") as b:
        _expect_equal("streaming decode vs whole-file float64", a.read(),
                      b.read())
    t0 = time.perf_counter()
    decode_file_streaming(song, wav_st, device="cpu")
    host_s = time.perf_counter() - t0
    with open(wav_st, "rb") as a, open(wav64, "rb") as b:
        _expect_equal("host streaming decode vs whole-file float64",
                      a.read(), b.read())
    _say("15 streaming", f"[{card}] song ({info['num_frames']} frames): "
                         f"streaming decode WAV on the card equals the "
                         f"whole-file float64 WAV ({dec_s * 1e3:.1f} ms, "
                         f"{runs.last('granule')} K2 and {runs.last()} K1 "
                         f"launches; host C++ plane "
                         f"{host_s * 1e3:.1f} ms)")
    streaming_encode_phase(dev, card, tmp, wav64, enc_out, runs)

    # ---- the CLI: hide -> reveal, and a streaming decode, on the card
    gold = _write(os.path.join(tmp, "cli.mp3"), np.load(os.path.join(
        GOLD, "encode_golden.npz"))["mp3_bytes"].tobytes())
    cli = [sys.executable, "-m", "mp3stego_tpu_torch", "--device", dev.type]
    hidden = os.path.join(tmp, "cli_hidden.mp3")
    txt = os.path.join(tmp, "cli.txt")
    cli_wav = os.path.join(tmp, "cli.wav")
    for argv in (["hide", gold, hidden, "through the CLI"],
                 ["reveal", hidden, txt],
                 ["decode", gold, cli_wav, "--stream-chunk-frames", "7"]):
        r = subprocess.run(cli + argv, cwd=REPO, timeout=300,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise AssertionError(f"CLI {argv[0]} exited {r.returncode}:\n"
                                 f"{r.stdout}{r.stderr}")
    with open(txt) as f:
        if f.read() != "through the CLI":
            raise AssertionError("CLI reveal did not give the message back")
    whole = os.path.join(tmp, "cli_whole.wav")
    s64.decode_mp3_to_wav(gold, whole)
    with open(cli_wav, "rb") as a, open(whole, "rb") as b:
        _expect_equal("CLI streaming decode vs the façade", a.read(),
                      b.read())
    _say("15 cli", "python -m mp3stego_tpu_torch hide -> reveal gives the "
                   "message back; decode --stream-chunk-frames 7 writes the "
                   "façade's WAV")
    return batches


def mesh_entries(n: int) -> list:
    """n mesh entries: the visible cards in turn when there are at least 2,
    else n entries of cuda:0 (n logical shards on one card)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", k % count if count >= 2 else 0)
            for k in range(n)]


def _synced_ms(fn, devices: list, iters: int = 10) -> float:
    """ms a call of ``fn`` over ``iters`` calls after a warm-up, each
    device synchronised before and after (a mesh that spans cards has no
    single stream for CUDA events)."""
    fn()
    for d in set(devices):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    for d in set(devices):
        torch.cuda.synchronize(d)
    return (time.perf_counter() - t0) / iters * 1e3


def mesh_phase(card: str, tmp: str, song: str, batches: dict, runs: Paths,
               errs: dict) -> None:
    """Phase 19, the mesh (``mp3stego_tpu_torch.parallel``): K1 after a
    seeded halo bit for bit its plain version; the song's frame-sharded
    decode at 2, 4 and 8 shards in both dtypes bit for bit the unsharded
    card decode, one K2 and one K1 launch a shard, timed beside it; the
    phase-12 batch (and its first chunk as a stacked batch) and the
    phase-13 encode on a 4-entry ``files`` mesh, equal to their outputs."""
    from mp3stego_tpu_torch.parallel import (
        batch_decode as BD, decode_files_batched, decode_granules_sharded,
        encode_files_batched, frame_shard as FS, make_mesh, prepare_batch)
    count = torch.cuda.device_count()
    dev0 = torch.device("cuda", 0)
    spread = (f"the {count} visible cards in turn" if count >= 2
              else "repeated cuda:0, one card holding every shard")
    _say("19 mesh", f"mesh entries: {spread}")

    # K1 after a seeded two-granule halo, both dtypes and epilogues: one
    # granule, odd counts around the tiles, a song's eighth
    for dtype in (F32, F64):
        for rows, t in ((2, 1), (2, 9), (4, 41), (2, SONG_T // 8)):
            full = _seeded_blk(rows, t + 2, 19 * rows + t, dtype, dev0)
            blk, halo = full[:, 2:].contiguous(), full[:, :2].contiguous()
            for out in sf.OUTS:
                hold("seeded halo", blk, out, 2, errs, halo)
            longer = sf.synth_fused_torch(full)[:, 2:]
            if not torch.equal(sf.synth_fused(blk, halo=halo), longer):
                raise AssertionError(f"{dtype}: K1 after a halo != the "
                                     f"longer rows less two granules")
    _say("19 mesh", "K1 after a seeded halo bitwise equal to "
                    "synth_fused_torch, float and int16, float32 and "
                    f"float64, at (rows, T) (2, 1), (2, 9), (4, 41), (2, "
                    f"{SONG_T // 8}), and to the longer rows' decode less "
                    f"two granules")

    # the song, sharded
    with open(song, "rb") as f:
        hp = dp.host_prepare(dh.parse_mp3(f.read()))
    prep = dp.prep_to_torch(hp, dev0)
    for dtype in (F64, F32):
        name = "float32" if dtype == F32 else "float64"
        whole = dp.decode_granules(prep, dtype).cpu().numpy()
        times = []
        for n in (2, 4, 8):
            mesh = make_mesh(files=1, frames=n, devices=mesh_entries(n))
            got = runs.run(f"sharded decode, {n} shards", dtype,
                           lambda: decode_granules_sharded(hp, mesh, name))
            if runs.last("granule") != n or runs.last() != n:
                raise AssertionError(f"{n} shards: {runs.last('granule')} "
                                     f"K2 and {runs.last()} K1 launches")
            if got.shape != whole.shape or not np.array_equal(got, whole):
                raise AssertionError(f"{name} song sharded over {n} != the "
                                     f"unsharded card decode")
            devs = list(mesh.devices[0])
            preps = FS.shard_preps(hp, mesh)
            plane_ms = _synced_ms(lambda: FS.shard_body(preps, dtype), devs)
            wall, walls, _ = _median3(
                lambda: decode_granules_sharded(hp, mesh, name))
            times.append((n, plane_ms, wall, walls))
            del preps
        plane1 = _synced_ms(lambda: dp.decode_granules(prep, dtype), [dev0])
        wall1, walls1, _ = _median3(lambda: dp.decode_granules(
            dp.prep_to_torch(hp, dev0), dtype).cpu().numpy())
        _say("19 mesh", f"{name} song ({hp['raw_i8'].shape[1]} granules) "
                        f"sharded over 2, 4 and 8: bit for bit the "
                        f"unsharded card decode, one K2 and one K1 launch "
                        f"a shard")
        _say("19 mesh", f"[{card}] {name}, {spread}: device half (K2 + "
                        f"halo + K1, uploaded shards) unsharded "
                        f"{plane1:.4f} ms; " + "; ".join(
                            f"{n} shards {ms:.4f} ms" for n, ms, _, _
                            in times))
        _say("19 mesh", f"[{card}] {name} host prep -> PCM on the host, "
                        f"median of 3: unsharded {wall1 * 1e3:.1f} ms of "
                        f"{[round(w * 1e3, 1) for w in walls1]}; " + "; ".join(
                            f"{n} shards {w * 1e3:.1f} ms of "
                            f"{[round(x * 1e3, 1) for x in ws]}"
                            for n, _, w, ws in times))
    del prep

    # the phase-12 batch and the phase-13 encode on 4 files entries
    mesh = make_mesh(files=4, devices=mesh_entries(4))
    paths, chunks = batches["paths"], batches["chunks"]
    floats = runs.run("batched decode on a 4-entry mesh, float32", F32,
                      lambda: decode_files_batched(paths, mesh))
    if runs.last() != chunks or runs.last("granule") != chunks:
        raise AssertionError(f"mesh batch: {runs.last()} K1 and "
                             f"{runs.last('granule')} K2 launches for "
                             f"{chunks} chunks")
    i16_64 = runs.run("batched decode on a 4-entry mesh, float64 int16",
                      F64, lambda: decode_files_batched(
                          paths, mesh, "float64", out="int16"))
    for p, a, b, c, d in zip(paths, floats, batches["floats"], i16_64,
                             batches["i16_64"]):
        if a.shape != b.shape or not np.array_equal(a, b) \
                or c.shape != d.shape or not np.array_equal(c, d):
            raise AssertionError(f"mesh batch decode of {p} != phase 12's")
    del floats, i16_64
    wall, walls, _ = _median3(lambda: decode_files_batched(
        paths, mesh, out="int16"))
    # the first chunk's files as a stacked batch over the mesh
    idxs = BD._chunks(batches["metas"], 16)[0]
    metas = [batches["metas"][i] for i in idxs]
    batch = prepare_batch([dp.host_prepare(m) for m in metas])
    planes = BD.decode_batch_device(batch, mesh).cpu().numpy()
    for i, pcm in zip(idxs, BD._unpack(planes, batch, metas)):
        if not np.array_equal(pcm, batches["floats"][i]):
            raise AssertionError(f"stacked mesh decode of {paths[i]} != "
                                 f"phase 12's")
    del planes, batch
    jobs = [(wav, out[:-4] + "_mesh.mp3") for wav, out in batches["jobs"]]
    runs.run("batched encode on a 4-entry mesh", None,
             lambda: encode_files_batched(jobs, mesh=mesh), kernels=ENCODE)
    for (wav, out), want in zip(jobs, batches["enc_bytes"]):
        with open(out, "rb") as f:
            _expect_equal(f"mesh batched encode of {os.path.basename(wav)}",
                          f.read(), want)
    ewall, ewalls, _ = _median3(lambda: encode_files_batched(jobs,
                                                             mesh=mesh))
    _say("19 mesh", f"phase 12's {len(paths)} files on a 4-entry files "
                    f"mesh, float32 float and float64 int16: bit for bit "
                    f"phase 12 ({chunks} K2 and K1 launches); its first "
                    f"chunk's {len(idxs)} files as a stacked batch over the "
                    f"mesh bit for bit phase 12; phase 13's 9 encodes: "
                    f"bytes equal phase 13's")
    _say("19 mesh", f"[{card}] {spread}: float32 int16 batch wall median "
                    f"{wall * 1e3:.1f} ms of "
                    f"{[round(x * 1e3, 1) for x in walls]} (phase 12 "
                    f"{batches['i16_wall'] * 1e3:.1f}); encode batch wall "
                    f"median {ewall * 1e3:.1f} ms of "
                    f"{[round(x * 1e3, 1) for x in ewalls]} (phase 13 "
                    f"{batches['enc_wall'] * 1e3:.1f})")


def streaming_encode_phase(dev, card: str, tmp: str, wav64: str,
                           enc_out: dict, runs: Paths) -> None:
    """Phase 15's encode: the song's streaming encode with its default
    planes on the card, clear and the 90 % hide, at windows of 512 and of 7
    frames, each byte for byte the whole-file card encode; the host C++
    chain (``device_search=False``) beside it, each a counted main path
    (K3 analyses and K4 searches every window); the allocations made on the
    card and their peak (one window's tensors)."""
    from mp3stego_tpu_torch.models.streaming import encode_file_streaming
    out = os.path.join(tmp, "song_stream.mp3")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()       # what earlier phases hold
    t0 = time.perf_counter()
    _encode_bytes(wav64, dev)
    whole_s = time.perf_counter() - t0
    whole_peak = torch.cuda.max_memory_allocated() - base
    for label, bits, want in (("clear", "", enc_out["clear_bytes"]),
                              ("hide", enc_out["hide_bits"],
                               enc_out["hide_bytes"])):
        for chunk in (512, 7):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
            t0 = time.perf_counter()
            info = runs.run(
                f"streaming {label} encode, {chunk}-frame windows", None,
                lambda: encode_file_streaming(wav64, out, 320, chunk,
                                              hide_str=bits), kernels=ENCODE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"] \
                - allocs
            peak = torch.cuda.max_memory_allocated() - base
            if not allocs or not peak:
                raise AssertionError(f"streaming {label} encode: nothing was "
                                     f"allocated on the card")
            with open(out, "rb") as f:
                _expect_equal(f"streaming {label} encode, {chunk}-frame "
                              f"windows, vs the whole-file card encode",
                              f.read(), want)
            if info["too_long"]:
                raise AssertionError(f"streaming {label} encode: too_long")
            windows = -(-info["frames"] // chunk)
            _say("15 streaming", f"[{card}] {label} encode of the song on the "
                                 f"card in {windows} windows of {chunk} "
                                 f"frames: bytes equal the whole-file card "
                                 f"encode's; wall {wall * 1e3:.1f} ms "
                                 f"({wall / windows * 1e3:.2f} ms a window); "
                                 f"{allocs} card allocations, "
                                 f"torch.cuda.max_memory_allocated "
                                 f"{peak / 2**20:.1f} MiB over the "
                                 f"{base / 2**20:.1f} MiB held before")
        t0 = time.perf_counter()
        encode_file_streaming(wav64, out, 320, 512, hide_str=bits,
                              device_search=False)
        host_s = time.perf_counter() - t0
        with open(out, "rb") as f:
            _expect_equal(f"host C++ streaming {label} encode", f.read(), want)
        _say("15 streaming", f"[{card}] {label}: the host C++ chain in "
                             f"512-frame windows writes the same bytes in "
                             f"{host_s * 1e3:.1f} ms")
    _say("15 streaming", f"[{card}] whole-file clear card encode "
                         f"{whole_s * 1e3:.1f} ms, "
                         f"torch.cuda.max_memory_allocated "
                         f"{whole_peak / 2**20:.1f} MiB over the "
                         f"{base / 2**20:.1f} MiB held before")


def huffman_bound(fields: torch.Tensor, words: torch.Tensor,
                  out: torch.Tensor):
    """The least time for the bit-scan's work on the card: (bytes that must
    move: the main-data words, the lane fields and the 160 small-table
    entries read once, the (2, T, 576) int32 plane written once; the 2^19-
    entry codebook LUTs are the kernel's own expansion of ISO code tables of
    a few hundred entries and are not counted) over HBM's rate, against (12
    integer operations per big-values pair and 10 per count1 quad, the quads
    counted up to each lane's last nonzero sample) over the INT32 rate.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    big2 = fields[:, 6].long().reshape(-1, 2, 2).permute(2, 0, 1) \
        .reshape(2, -1)                               # (ch, t), as out
    col = torch.arange(576, device=out.device)
    last = torch.where(out != 0, col, -1).amax(-1)
    quads = ((last + 1 - big2 + 3).clamp(min=0) // 4).sum()
    ops = 12 * int(big2.sum()) // 2 + 10 * int(quads)
    nbytes = 4 * words.numel() + 4 * fields.numel() + 4 * 160 \
        + 4 * out.numel()
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_INT_OPS_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes, ops
    return by_ops, "operations", nbytes, ops


def hold_scan(name: str, words: torch.Tensor,
              fields: torch.Tensor) -> torch.Tensor:
    """The bit-scan kernel on card lanes bit for bit its plain version (on
    the host), and its chain-only entry equal to the plain plane's lane
    sums; returns the kernel's plane."""
    got = hd.decode_samples(words, fields)
    chain = hd.scan_chain(words, fields)
    want = hd.decode_samples_plain(words, fields)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: huffman_scan != decode_samples_plain")
    g = fields.shape[0]
    sums = (want.permute(1, 0, 2).reshape(g, 576).long()
            * torch.arange(1, 577, device=want.device)).sum(1)
    if not torch.equal(chain, ((sums + 2**31) % 2**32 - 2**31).int()):
        raise AssertionError(f"{name}: huffman_scan_chain != the plain "
                             f"plane's lane sums")
    return got


def huffman_phase(dev, card: str, tmp: str, song: str, enc_out: dict,
                  runs: Paths) -> dict:
    """Phase 16: the device Huffman decode. The bit-scan kernel
    (``csrc/huffman.cu``) bit for bit its plain version (``hold_scan``) on
    the song's lanes, the 5 multirate goldens, the MPEG-1 crafted streams
    (intensity, MS, short, mixed, linbits escapes), a seeded bit-flipped
    copy of the song, a mono stream and the seeded synthetic lane set, and
    equal to the host parse's samples where the stream is intact; its
    registers, spills (a spill fails the phase), resident warps and the
    bytes its tables hold on the card; the default ``Decoder`` on the song
    in float64 and float32 (``parse_mp3``, then ``decode_pcm_i16`` with
    the scan) writes the WAV bytes and stego bits of the host fill's route
    (``parse_mp3(defer_samples=False)``) of the same precision, and the
    façade's reveal reads the hidden song's message back, each a counted
    main path. Times the kernel, its chain alone, its plain version (on the
    host), the light parse, the decode walls of both routes, and the
    default decode by stage. Returns the kernel's row of the kernels
    line."""
    from mp3stego_tpu_torch.models.decoder import Decoder
    with open(song, "rb") as f:
        song_b = f.read()
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    crafted = np.load(os.path.join(GOLD, "crafted_golden.npz"))
    streams = {"song": song_b}
    streams.update({t: mr[f"mp3_{t}"].tobytes() for t in (
        "32000_64", "32000_192", "44100_128", "48000_96", "48000_320")})
    streams.update({n: crafted[n].tobytes() for n in (
        "is_long", "is_ms_long", "is_ms_short", "mixed_44k")})
    streams["linbits"] = np.load(os.path.join(
        GOLD, "huffman_golden.npz"))["linbits"].tobytes()
    streams["song, 256 bits flipped"] = flipped_song(song_b)
    with open(os.path.join(tmp, "b_mono.mp3"), "rb") as f:
        streams["mono 30 s"] = f.read()
    err, lanes = 0, []                  # bit for bit, or hold_scan raised
    inputs = {name: hd.pack(dh.parse_mp3_light(data)[1])
              for name, data in streams.items()}
    inputs["synthetic lanes"] = synthetic_lanes()
    for name, arrays in inputs.items():
        words, fields = (torch.from_numpy(a).to(dev) for a in arrays)
        got = hold_scan(name, words, fields)
        if name in streams and "flipped" not in name:
            host = dh.parse_mp3(streams[name]).raw_samples
            if not np.array_equal(got.cpu().numpy(), np.moveaxis(
                    host, 2, 0).reshape(2, -1, 576)):
                raise AssertionError(f"{name}: huffman_scan != the host "
                                     f"parse's samples")
        lanes.append(f"{name} ({fields.shape[0]})")
    _say("16 huffman", f"huffman_scan bitwise equal to decode_samples_plain "
                       f"(run on the host) and its chain-only entry to the "
                       f"plain plane's lane sums (and to the host parse's "
                       f"samples on the intact streams) on {len(inputs)} "
                       f"lane sets (lanes): {', '.join(lanes)}")
    res = _cuda.ptxas_resources("huffman", SCAN_KERNEL)
    occ = hd.occupancy(dev)
    table_b = hd._tables(dev).numel() * 4
    flat_b = len(hd._codebooks()) * (4 << hd.LUT_BITS)
    _say("16 huffman", f"huffman_scan_kernel: {res['registers']} registers, "
                       f"{occ['ctas']} CTAs of {occ['warps']} warps an SM "
                       f"({occ['ctas'] * occ['warps']} resident warps; "
                       f"{occ['smem']} B of dynamic shared memory a CTA), "
                       f"spills {res['spill_stores']} B stored and "
                       f"{res['spill_loads']} B loaded (-Xptxas -v); its "
                       f"tables on the card: {table_b:,} B, the codebooks "
                       f"read from shared memory (the flat 2^19-entry LUTs, "
                       f"{flat_b:,} B, stay in host memory for the plain "
                       f"version)")
    if res["spill_stores"] or res["spill_loads"]:
        raise AssertionError("huffman_scan_kernel spills registers")

    # the kernel on the song's lanes: its time, the chain alone, the plain
    # version's on the host, the light parse's beside the native full
    # parse's, and the bound
    t0 = time.perf_counter()
    _, desc = dh.parse_mp3_light(song_b)
    light_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dh.parse_mp3(song_b)
    native_s = time.perf_counter() - t0
    words, fields = (torch.from_numpy(a).to(dev) for a in hd.pack(desc))
    fns = {"kernel": lambda: hd.decode_samples(words, fields),
           "chain": lambda: hd.scan_chain(words, fields)}
    out = fns["kernel"]()
    fns["chain"]()
    times = {k: [] for k in fns}
    for which in ("chain", "kernel", "kernel", "chain"):
        times[which].append(_time_ms(fns[which], 50))
    plain_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hd.decode_samples_plain(words, fields)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    best = {k: min(v) for k, v in times.items()}
    best["plain"] = min(plain_s) * 1e3
    bound, by, nbytes, ops = huffman_bound(fields, words, out)
    _say("16 huffman", f"[{card}] song: {fields.shape[0]} lanes, "
                       f"{words.numel()} words: kernel {times['kernel']} ms, "
                       f"bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
                       f"{ops / 1e6:.1f} M int ops), at "
                       f"{bound / best['kernel']:.1%} of it; the chain "
                       f"alone (no plane stores) {times['chain']} ms; plain "
                       f"on the host {[round(x * 1e3, 1) for x in plain_s]} "
                       f"ms (plain/kernel {best['plain'] / best['kernel']:.0f}"
                       f"x); parse_mp3_light {light_s * 1e3:.1f} ms, native "
                       f"parse_mp3 {native_s * 1e3:.1f} ms")
    del words, fields, out

    # the default Decoder on the song beside the host fill's route, in both
    # precisions
    both = DECODE + ("huffman_scan",)
    for precision, dtype in (("float64", F64), ("float32", F32)):
        wavs = {e: os.path.join(tmp, f"song_{e}_{precision}.wav")
                for e in ("fill", "scan")}

        def fill():
            p = dh.parse_mp3(song_b, defer_samples=False)
            write_wav(wavs["fill"], p.header.sampling_rate,
                      dp.decode_pcm_i16(p, dev, precision))
            return dh.stego_bits(p)

        def scan():
            d = Decoder(song, wavs["scan"], precision=precision)
            d.decode()
            return d

        fill_wall, fill_walls, bits = _median3(fill)
        dev_wall, dev_walls, dev_d = runs.run(
            f"Decoder, {precision}", dtype, lambda: _median3(scan),
            kernels=both)
        with open(wavs["scan"], "rb") as a, open(wavs["fill"], "rb") as b:
            _expect_equal(f"song {precision}: Decoder WAV vs host fill "
                          f"WAV", a.read(), b.read())
        if dev_d[-1].output_bits != bits[-1]:
            raise AssertionError(f"{precision}: the routes' stego bits "
                                 f"differ")
        _say("16 huffman", f"[{card}] song {precision}: the default Decoder "
                           f"({runs.last('huffman_scan')} scan and "
                           f"{runs.last('granule')} K2 and {runs.last()} K1 "
                           f"launches in 4 decodes) writes the host fill "
                           f"route's WAV bytes and stego bits; wall median "
                           f"{dev_wall * 1e3:.1f} ms of "
                           f"{[round(w * 1e3, 1) for w in dev_walls]}, host "
                           f"fill {fill_wall * 1e3:.1f} ms of "
                           f"{[round(w * 1e3, 1) for w in fill_walls]}")
    _say("16 huffman", f"[{card}] default Decoder float32 by stage: "
                       + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                   for k, v in dev_d[-1].timer.times.items()))

    txt = os.path.join(tmp, "song_dh.txt")
    runs.run("façade reveal", F64,
             lambda: Steganography(quiet=True).reveal_massage(
                 enc_out["hidden"], txt), kernels=both)
    with open(txt) as f:
        if f.read() != enc_out["msg"]:
            raise AssertionError("reveal through the façade did not give "
                                 "the message back")
    _say("16 huffman", f"the façade's reveal (its samples scanned on the "
                       f"card) gives the {len(enc_out['msg'])}-char message "
                       f"back")
    return dict(name="huffman_scan", route="cuda",
                source="mp3stego_tpu_torch/csrc/huffman.cu",
                replaces="mp3stego_tpu/ops/huffman_device.py:121",
                launches=runs.launches("huffman_scan"), max_abs_err=err,
                ms=best["kernel"], plain_ms=best["plain"], bound_ms=bound,
                bound_by=by, library_ms=None)


def _random_lanes(rng, n: int, scale_bits: int) -> np.ndarray:
    """Random spectra with realistic dynamic ranges (some quiet, some
    hot); lane 0 is silent."""
    xr = np.zeros((n, 576), np.int32)
    for i in range(n):
        b = int(rng.integers(4, scale_bits))
        row = rng.integers(-(1 << b), 1 << b, size=576)
        cut = int(rng.integers(10, 576))
        row[cut:] = row[cut:] // (1 << min(b, 12))
        xr[i] = row.astype(np.int32)
    xr[0] = 0
    return xr


def search_lanes(name: str):
    """Seeded K4 lanes, built without JAX (the tests hold the JAX search
    to the port's on them, and the card run holds the kernel to its plain
    version): ``fixture``, the golden encode's spectra under their own
    budgets; ``loud``, 96 random lanes up to 31 bits; ``escape``, sparse
    full-scale spikes on a quiet floor under generous budgets (tables 16-31,
    linbits); ``forced``, 32 lanes that reach every host flag: quiet lanes
    whose first nonzero evaluation quantizes to 0/1 only (``FLAG_ADDR``) and
    loud lanes under a negative budget that step past steptab
    (``FLAG_OOB``) and never fit (``FLAG_ITER``). Returns (spectra (N, 576)
    int32, budgets (N,) int32)."""
    if name == "fixture":
        mdct = np.load(os.path.join(GOLD, "encode_golden.npz"))["mdct_freq"]
        xr = mdct.transpose(1, 0, 2, 3).reshape(-1, 576)  # ch*tg + 2f + gr
        enc = MP3Encoder(WavFile(
            file_path="lanes.wav", bitrate=320, num_of_channels=2,
            samplerate=44100, bits_per_sample=16,
            num_of_samples=xr.shape[0] // 2 * 576, mpeg_mode=0,
            buffer=np.zeros(xr.shape[0] * 576, np.int16)), device="cpu")
        _, mean_bits = enc._plane_framing(mdct.shape[0])
        return (np.ascontiguousarray(xr, np.int32),
                enc._lane_budgets(mean_bits))
    rng = np.random.default_rng({"loud": 7, "escape": 11, "forced": 5}[name])
    if name == "loud":
        return (_random_lanes(rng, 96, 31),
                rng.integers(500, 4000, size=96).astype(np.int32))
    if name == "escape":
        xr = rng.integers(-2000, 2000, size=(96, 576)).astype(np.int64)
        spikes = rng.random((96, 576)) < 0.03
        xr[spikes] = rng.integers(-(2 ** 31 - 1), 2 ** 31 - 1,
                                  size=spikes.sum())
        return xr.astype(np.int32), np.full(96, 4095, np.int32)
    xr = _random_lanes(rng, 32, 28)
    mb = rng.integers(800, 3000, size=32).astype(np.int32)
    xr[1:5] = 0
    xr[1:5, :40] = rng.choice([-65536, 65536], size=(4, 40))     # ADDR
    xr[5:7] = rng.integers(-2 ** 30, 2 ** 30, size=(2, 576))
    mb[5:7] = -1                                              # OOB + ITER
    return xr, mb


def grid_lanes() -> np.ndarray:
    """16 seeded edge lanes of the cost grid K5, built without JAX (the
    tests hold the JAX grid to the port's on them, and the card run holds
    the kernel to its plain version): all zeros; a lone INT32_MIN (its
    wrapped |x| clips xrmax to 0, so it never bails, while its true
    magnitude reaches the float64 fallback: approx at the finer steps);
    INT32_MIN everywhere; INT32_MIN on a quiet floor; full scale, +-(2^31 - 1), which
    bails at the finest 58 steps; one nonzero sample at 0, at 575 and at 45
    (band row 5's odd edge); quiet lanes that quantize to 0 and 1 only
    (big_values 0 with count1 quads); a constant 2^27 (approx without a
    bail at several steps); a ramp; sparse full-scale spikes on a quiet
    floor; random lanes up to 2^24 and 2^16; all ones. Returns (16, 576)
    int32."""
    rng = np.random.default_rng(15)
    xr = np.zeros((16, 576), np.int64)
    xr[1, 300] = -2 ** 31
    xr[2] = -2 ** 31
    xr[3] = rng.integers(-100, 100, size=576)
    xr[3, 0] = -2 ** 31
    xr[4] = rng.choice([-(2 ** 31 - 1), 2 ** 31 - 1], size=576)
    xr[5, 0] = 1 << 20
    xr[6, 575] = -(1 << 20)
    xr[7, 45] = 1 << 22
    xr[8, :40] = rng.choice([-65536, 65536], size=40)
    xr[9] = 1 << 27
    xr[10] = np.linspace(-2 ** 30, 2 ** 30, 576).astype(np.int64)
    xr[11] = rng.integers(-2000, 2000, size=576)
    spikes = rng.random(576) < 0.05
    xr[11, spikes] = rng.integers(-(2 ** 31 - 1), 2 ** 31 - 1,
                                  size=spikes.sum())
    xr[12] = rng.integers(-(1 << 24), 1 << 24, size=576)
    xr[13] = rng.integers(-(1 << 16), 1 << 16, size=576)
    xr[13, 200:] //= 64
    xr[14] = rng.choice([-262144, 0, 262144], size=576, p=[0.1, 0.8, 0.1])
    xr[15] = 1
    return xr.astype(np.int32)


def hold_search(name: str, got: dict, want: dict) -> int:
    """K4's results against its plain version's, bit for bit on every row,
    count and the ix plane; returns the largest difference (0)."""
    err = 0
    for k in SP.ROWS + SP.COUNTS + ("ix",):
        if got[k].shape != want[k].shape:
            raise AssertionError(f"{name}: {k} {tuple(got[k].shape)} vs the "
                                 f"plain {tuple(want[k].shape)}")
        if got[k].numel():
            err = max(err, int((got[k].long() - want[k].long()).abs().max()))
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{name}: the search kernel != its plain "
                                 f"version on {k} (max |d| {err})")
    return err


def search_bound(n: int, res: dict, hide: bool):
    """The least time for K4's work on the card: (bytes that must move: the
    n spectra and budgets read once, the rows and counts and the ix plane of
    each lane search written once) over HBM's rate, against (the integer
    operations of the function on this run's data: the kernel's own work
    counts, each times its ``K4_OPS_*``) over the INT32 rate. Returns (ms,
    "bytes" or "operations", bytes, operations)."""
    m = res["ix"].shape[0]
    nbytes = 4 * n * 576 + 4 * n + 4 * len(SP.ROWS + SP.COUNTS) * m \
        + 4 * m * 576
    work = {k: int(res[k].sum()) for k in ("quantized", "costed", "quads",
                                           "pairs")}
    ops = (work["quantized"] * K4_OPS_QUANTIZE + work["costed"] * K4_OPS_RUNS
           + work["quads"] * K4_OPS_QUAD
           + work["pairs"] * (K4_OPS_PAIR_HIDE if hide else K4_OPS_PAIR))
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_INT_OPS_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes, ops
    return by_ops, "operations", nbytes, ops


def search_phase(dev, card: str, wav64: str, enc_out: dict, runs: Paths,
                 errs: dict) -> dict:
    """Phase 17: the rate-control search K4 (``csrc/search.cu``) bit for bit
    its plain version on the card: every lane of the song (clear, at the
    phase-9 budgets), the 8 windows of the 90 % hide's first block (4,096
    lanes in cursor order), every lane of the seeded song, and the
    forced-flag lanes (clear and windows); then the kernel and the plain
    version by CUDA events at the song's shapes (the clear search, one
    window block), each beside its bound, and the kernel's registers,
    shared memory and spills (``-Xptxas -v``; a spill fails the phase) and
    resident warps an SM. Returns the kernel's row of the kernels line;
    its error folds in phase 14's (``errs["search"]``: ``cost_step``
    against ``cost_step_torch`` on the song's lanes)."""
    from mp3stego_tpu_torch.models.encoder import _HIDE_BLOCK

    def lanes(wav):
        enc = MP3Encoder(read_wav(wav, 320), device=dev)
        nf = enc._num_frames()
        mb = enc._lane_budgets(enc._plane_framing(nf)[1])
        return enc, nf, enc._analysis_device(nf), \
            torch.from_numpy(mb).to(dev)

    enc, nf, xr, mb = lanes(wav64)
    band = enc.band_row
    clear = SP.search(xr, mb, band)
    err = max(errs["search"], hold_search("song, clear", clear,
                                          SP.search_torch(xr, mb, band)))
    # the hide's first block: the first lanes in the reference's cursor
    # order f > ch > gr (lane g = ch * tg + f * gpf + gr)
    gpf = enc.granules_per_frame
    tg = nf * gpf
    order = (np.arange(nf)[:, None, None] * gpf
             + np.arange(2)[None, :, None] * tg
             + np.arange(gpf)[None, None, :]).reshape(-1)
    blk = torch.from_numpy(order[:_HIDE_BLOCK]).to(dev)
    xb, mbb = xr[blk], mb[blk]
    win = SP.search_windows(xb, mbb, band)
    err = max(err, hold_search("song, the hide's first block, 8 windows",
                               win, SP.search_windows_torch(xb, mbb, band)))
    _, _, xs, ms = lanes(enc_out["seeded_wav"])
    err = max(err, hold_search("seeded song, clear", SP.search(xs, ms, band),
                               SP.search_torch(xs, ms, band)))
    del xs, ms
    xf, mf = (torch.from_numpy(a).to(dev) for a in search_lanes("forced"))
    forced = SP.search(xf, mf, 0)
    err = max(err, hold_search("forced lanes, clear", forced,
                               SP.search_torch(xf, mf, 0)))
    err = max(err, hold_search("forced lanes, 8 windows",
                               SP.search_windows(xf, mf, 0),
                               SP.search_windows_torch(xf, mf, 0)))
    flags = forced["flags"].cpu().numpy()
    for bit in (SP.FLAG_ADDR, SP.FLAG_OOB, SP.FLAG_ITER):
        if not (flags & bit).any():
            raise AssertionError(f"the forced lanes raised no flag {bit}")
    torch.cuda.synchronize()
    _say("17 K4", f"rate_search bitwise equal to search_torch / "
                  f"search_windows_torch on every row, count and ix: the "
                  f"song's {xr.shape[0]} lanes, the 8 windows of the hide's "
                  f"first block ({xb.shape[0]} lanes), the seeded song's "
                  f"lanes and the {xf.shape[0]} forced-flag lanes (clear and "
                  f"windows; ADDR, OOB and ITER raised)")

    fns = {"kernel": lambda: SP.search(xr, mb, band),
           "plain": lambda: SP.search_torch(xr, mb, band),
           "window kernel": lambda: SP.search_windows(xb, mbb, band),
           "window plain": lambda: SP.search_windows_torch(xb, mbb, band)}
    times = {k: [] for k in fns}
    for pre in ("", "window "):
        for which in ("plain", "kernel", "kernel", "plain"):
            times[pre + which].append(_time_ms(
                fns[pre + which], 1 if which == "plain" else 10))
    best = {k: min(v) for k, v in times.items()}
    bound, by, nbytes, ops = search_bound(xr.shape[0], clear, False)
    wbound, wby, wbytes, wops = search_bound(xb.shape[0], win, True)
    c_rows = SP.rows_to_host(clear)
    w_rows = SP.rows_to_host(win)

    def work(rows):
        return (f"{int(rows['evals'].sum())} evaluations, "
                f"{int(rows['quantized'].sum())} past the quick reject, "
                f"{int(rows['costed'].sum())} costed over "
                f"{int(rows['quads'].sum())} quads and "
                f"{int(rows['pairs'].sum())} pairs")

    _say("17 K4", f"[{card}] song clear search, {xr.shape[0]} lanes, "
                  f"{work(c_rows)} (at most "
                  f"{c_rows['rounds']} inner rounds): kernel "
                  f"{times['kernel']} ms, bound {bound:.4f} ms by {by} "
                  f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G int ops), at "
                  f"{bound / best['kernel']:.1%} of it; plain "
                  f"{times['plain']} ms (plain/kernel "
                  f"{best['plain'] / best['kernel']:.1f}x)")
    _say("17 K4", f"[{card}] hide block, {xb.shape[0]} lanes x 8 windows, "
                  f"{work(w_rows)}: kernel "
                  f"{times['window kernel']} ms, bound {wbound:.4f} ms by "
                  f"{wby} ({wbytes / 1e6:.1f} MB, {wops / 1e9:.3f} G int "
                  f"ops), at {wbound / best['window kernel']:.1%} of it; "
                  f"plain {times['window plain']} ms (plain/kernel "
                  f"{best['window plain'] / best['window kernel']:.1f}x)")
    res = _cuda.ptxas_resources("search", "rate_search_kernel")
    occ = SP.occupancy(dev)
    _say("17 K4", f"[{card}] rate_search_kernel: {res['registers']} "
                  f"registers a thread, {res['smem'] + occ['smem']} B of "
                  f"shared memory a CTA ({occ['smem']} B dynamic), spills "
                  f"{res['spill_stores']} B stored and {res['spill_loads']} B "
                  f"loaded (-Xptxas -v); {occ['ctas']} CTAs of {occ['warps']} "
                  f"warps an SM, {occ['ctas'] * occ['warps']} resident warps "
                  f"(the runtime's occupancy query)")
    if res["spill_stores"] or res["spill_loads"]:
        raise AssertionError("rate_search_kernel spills registers")
    return dict(name="rate_search", route="cuda",
                source="mp3stego_tpu_torch/csrc/search.cu",
                replaces="mp3stego_tpu/ops/search_plane.py:385",
                launches=runs.launches("search"), max_abs_err=err,
                ms=best["kernel"], plain_ms=best["plain"], bound_ms=bound,
                bound_by=by, library_ms=None)


def hold_grid(name: str, xr: torch.Tensor, sr_idx: int, with_hide: bool,
              work: dict = None) -> int:
    """K5 against its plain version on ``xr``, both on the card: every row
    of every cell bit for bit; returns the largest difference (0)."""
    rows = QB.ROWS_HIDE if with_hide else QB.ROWS_CLEAR
    got = QB._launch(xr, sr_idx, rows)
    want = QB.cost_all_steps_torch(xr, sr_idx, with_hide, work=work)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: the grid {tuple(got.shape)} vs the "
                             f"plain {tuple(want.shape)}")
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        names = list(QB._BASE_KEYS) + (list(QB._HIDE_SCALAR) + [
            f"{k}[{r}]" for k in QB._HIDE_R3 for r in range(3)]
            if with_hide else [])
        bad = [names[r] for r in range(rows) if not torch.equal(got[r],
                                                                 want[r])]
        raise AssertionError(f"{name}: cost_grid != cost_all_steps_torch "
                             f"(band row {sr_idx}) on {bad}: max |d| {err}")
    return err


def grid_bound(n: int, rows: int, work: dict):
    """The least time for K5's work on the card: (the n spectra read once
    and the (rows, n, 128) int16 grid written once) over HBM's rate,
    against (the integer operations of the function on this run's data:
    ``K5_OPS_SAMPLE`` a sample of every cell, ``K5_OPS_PAIR`` a big-values
    pair and ``K5_OPS_QUAD`` a count1 quad, the counts from the plain
    version's ``work``) over the INT32 rate. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    nbytes = 4 * n * 576 + 2 * rows * n * QB.S_STEPS
    ops = (work["cells"] * 576 * K5_OPS_SAMPLE + work["pairs"] * K5_OPS_PAIR
           + work["quads"] * K5_OPS_QUAD)
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_INT_OPS_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes, ops
    return by_ops, "operations", nbytes, ops


def grid_need_bound(n: int, rows: int, work: dict):
    """The least time for K5's work on the card as ``grid_bound``, with the
    operations the function needs on this run's data (``K5_NEED_*``): each
    lane's suffix maxima, each cell's constants, the samples it reads, the
    pairs below its last region's end and its count1 quads, the counts from
    the plain version's ``work``. Returns (ms, "bytes" or "operations",
    bytes, operations)."""
    nbytes = 4 * n * 576 + 2 * rows * n * QB.S_STEPS
    ops = (n * K5_NEED_LANE + work["cells"] * K5_NEED_CELL
           + work["samples"] * K5_NEED_SAMPLE
           + work["region_pairs"] * K5_NEED_PAIR
           + work["quads"] * K5_NEED_QUAD)
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_INT_OPS_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes, ops
    return by_ops, "operations", nbytes, ops


@contextlib.contextmanager
def grid_engine():
    """The cost-grid engine (``MP3STEGO_TPU_SEARCH_PLANE=0``) while the
    block runs."""
    old = os.environ.get("MP3STEGO_TPU_SEARCH_PLANE")
    os.environ["MP3STEGO_TPU_SEARCH_PLANE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MP3STEGO_TPU_SEARCH_PLANE"]
        else:
            os.environ["MP3STEGO_TPU_SEARCH_PLANE"] = old


def grid_phase(dev, card: str, tmp: str, wav64: str, seeded_wav: str,
               runs: Paths) -> dict:
    """Phase 20: the cost grid K5 (``csrc/cost_grid.cu``) bit for bit its
    plain version on the card, clear (7 rows) and with the hide channels
    (27): every lane of the song and of the seeded song (which repeats
    nothing), the search's seeded and forced-flag lanes and the grid's edge
    lanes, on MPEG-1, MPEG-2 and MPEG-2.5 band rows; K5 and the plain
    version by CUDA events on the song, K5 on the seeded song, each beside
    its bound on that data (``grid_need_bound``; PR 15's ``grid_bound``
    beside it), with the kernel's registers, shared memory and spills (a
    spill fails the phase) and resident warps an SM. Then the cost-grid
    engine (``MP3STEGO_TPU_SEARCH_PLANE=0``) on a 30 s slice of the song,
    clear, hidden at 90 % of its channel and VBR, and on the goldens: bytes
    equal to the plane engine's and the host C++ engine's; a clear or
    hidden encode launches K3 once and K5 once. Returns K5's row of the
    kernels line."""
    enc = MP3Encoder(read_wav(wav64, 320), device=dev)
    nf = enc._num_frames()
    band = enc.band_row
    xr = enc._analysis_device(nf)
    work = {}
    err = hold_grid("song, clear", xr, band, False, work)
    err = max(err, hold_grid("song, hide channels", xr, band, True))
    seeded = np.concatenate([search_lanes(n)[0] for n in
                             ("fixture", "loud", "escape", "forced")]
                            + [grid_lanes()])
    xs = torch.from_numpy(seeded).to(dev)
    for sr_idx in (0, 5, 8, 13):
        for hide in (False, True):
            err = max(err, hold_grid(f"seeded lanes, band row {sr_idx}", xs,
                                     sr_idx, hide))
    cells = QB.cost_all_steps(xs, 0, True)
    want = QB._unpack(QB.cost_all_steps_torch(xs, 0, True).cpu().numpy(),
                      True)
    for k, v in want.items():
        if cells[k].dtype != v.dtype or not np.array_equal(cells[k], v):
            raise AssertionError(f"cost_all_steps {k} != the plain version's")
    if not (cells["approx"].any() and cells["bail"].any()
            and ((cells["bv"] == 0) & ~cells["bail"]).any()):
        raise AssertionError("the seeded lanes reach no approx, bail or "
                             "big_values-0 cell")
    torch.cuda.synchronize()
    _say("20 K5", f"cost_grid bitwise equal to cost_all_steps_torch on every "
                  f"row of every cell: the song's {xr.shape[0]} lanes (clear "
                  f"and with the hide channels), {xs.shape[0]} seeded, "
                  f"forced-flag and edge lanes at band rows 0, 5, 8 and 13; "
                  f"{int(cells['approx'].sum())} approx, "
                  f"{int(cells['bail'].sum())} bailed cells there")

    fns = {"kernel": lambda: QB._launch(xr, band, QB.ROWS_CLEAR),
           "hide kernel": lambda: QB._launch(xr, band, QB.ROWS_HIDE),
           "plain": lambda: QB.cost_all_steps_torch(xr, band, False),
           "hide plain": lambda: QB.cost_all_steps_torch(xr, band, True)}
    times = {k: [] for k in fns}
    for pre in ("", "hide "):
        for which in ("plain", "kernel", "kernel", "plain"):
            times[pre + which].append(_card_ms(
                fns[pre + which], 1 if which == "plain" else 10))
    best = {k: min(v) for k, v in times.items()}
    n = xr.shape[0]
    bound, by, nbytes, ops = grid_need_bound(n, QB.ROWS_CLEAR, work)
    hbound, hby, hbytes, _ = grid_need_bound(n, QB.ROWS_HIDE, work)
    pr15 = grid_bound(n, QB.ROWS_CLEAR, work)
    hpr15 = grid_bound(n, QB.ROWS_HIDE, work)[0]
    _say("20 K5", f"[{card}] song grid, {n} lanes x 128 steps "
                  f"({work['cells']} cells, {work['samples']} samples read, "
                  f"{work['region_pairs']} pairs below the last region's "
                  f"end, {work['pairs']} big-values pairs, "
                  f"{work['quads']} count1 quads), clear: kernel "
                  f"{times['kernel']} ms, bound {bound:.4f} ms by {by} "
                  f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G int ops), at "
                  f"{bound / best['kernel']:.1%} of it (PR 15's bound "
                  f"{pr15[0]:.4f} ms, {pr15[3] / 1e9:.3f} G int ops: "
                  f"{pr15[0] / best['kernel']:.1%}); plain {times['plain']} "
                  f"ms (plain/kernel {best['plain'] / best['kernel']:.1f}x)")
    _say("20 K5", f"[{card}] song grid with the hide channels: kernel "
                  f"{times['hide kernel']} ms, bound {hbound:.4f} ms by {hby} "
                  f"({hbytes / 1e6:.1f} MB), at "
                  f"{hbound / best['hide kernel']:.1%} of it (PR 15's bound "
                  f"{hpr15:.4f} ms: {hpr15 / best['hide kernel']:.1%}); plain "
                  f"{times['hide plain']} ms")
    res = _cuda.ptxas_resources("cost_grid", "cost_grid_kernel")
    occ = QB.occupancy(dev)
    _say("20 K5", f"[{card}] cost_grid_kernel: {res['registers']} registers "
                  f"a thread, {res['smem'] + occ['smem']} B of shared memory "
                  f"a CTA ({occ['smem']} B dynamic), spills "
                  f"{res['spill_stores']} B stored and {res['spill_loads']} B "
                  f"loaded (-Xptxas -v); {occ['ctas']} CTAs of {occ['warps']} "
                  f"warps an SM, {occ['ctas'] * occ['warps']} resident warps "
                  f"(the runtime's occupancy query)")
    if res["spill_stores"] or res["spill_loads"]:
        raise AssertionError("cost_grid_kernel spills registers")
    del xr, xs, fns
    torch.cuda.empty_cache()

    # the seeded song: its grid bit for bit, K5's time and its bound there
    es = MP3Encoder(read_wav(seeded_wav, 320), device=dev)
    xq = es._analysis_device(es._num_frames())
    swork = {}
    err = max(err, hold_grid("seeded song, clear", xq, band, False, swork))
    err = max(err, hold_grid("seeded song, hide channels", xq, band, True))
    st = {rows: [_card_ms(lambda: QB._launch(xq, band, rows))
                 for _ in range(2)] for rows in (QB.ROWS_CLEAR, QB.ROWS_HIDE)}
    sb, sby, _, sops = grid_need_bound(xq.shape[0], QB.ROWS_CLEAR, swork)
    sbh = grid_need_bound(xq.shape[0], QB.ROWS_HIDE, swork)[0]
    sold = grid_bound(xq.shape[0], QB.ROWS_CLEAR, swork)[0]
    _say("20 K5", f"[{card}] seeded song grid, {xq.shape[0]} lanes "
                  f"({swork['samples']} samples read, "
                  f"{swork['region_pairs']} pairs below the last region's "
                  f"end, {swork['pairs']} big-values pairs, "
                  f"{swork['quads']} count1 quads), bitwise the plain "
                  f"version clear and with the hide channels: kernel "
                  f"{st[QB.ROWS_CLEAR]} ms clear, bound {sb:.4f} ms by {sby} "
                  f"({sops / 1e9:.3f} G int ops), at "
                  f"{sb / min(st[QB.ROWS_CLEAR]):.1%} of it (PR 15's bound "
                  f"{sold:.4f} ms: {sold / min(st[QB.ROWS_CLEAR]):.1%}); "
                  f"{st[QB.ROWS_HIDE]} ms with the hide channels, at "
                  f"{sbh / min(st[QB.ROWS_HIDE]):.1%} of its bound")
    del xq, es
    torch.cuda.empty_cache()

    # the cost-grid engine on a 30 s slice of the song
    pcm = _wav_i16(wav64).reshape(-1, 2)[:GRID_SECONDS * 44100]
    wav = os.path.join(tmp, "grid.wav")
    write_wav(wav, 44100, pcm)
    usable = _encode_bytes(wav, dev)[1].hide_str_offset
    bits = "".join(np.random.default_rng(20).choice(
        ["0", "1"], size=int(usable * HIDE_SHARE)))
    for label, b, vbr, kbps in (("clear", "", False, 320),
                                ("90 % hide", bits, False, 320),
                                ("VBR", "", True, 128)):
        plane = _encode_bytes(wav, dev, b, kbps, vbr=vbr)[0]
        host = _encode_bytes(wav, dev, b, kbps, host=True, vbr=vbr)[0]
        kernels = ("analysis", "cost_grid") + (("search",) if vbr else ())
        with grid_engine():
            t0 = time.perf_counter()
            got, genc = runs.run(f"cost-grid engine, {label}, "
                                 f"{GRID_SECONDS} s", None,
                                 lambda: _encode_bytes(wav, dev, b, kbps,
                                                       vbr=vbr),
                                 kernels=kernels)
            wall = time.perf_counter() - t0
        counts = runs.log[-1][2]
        if not vbr and (counts["analysis"], counts["cost_grid"]) != (1, 1):
            raise AssertionError(f"grid engine, {label}: K3 and K5 launched "
                                 f"{counts['analysis']} and "
                                 f"{counts['cost_grid']} times, not once")
        _expect_equal(f"grid engine, {label}: vs the plane engine", got,
                      plane)
        _expect_equal(f"grid engine, {label}: vs the host C++ engine", got,
                      host)
        _say("20 grid", f"[{card}] {GRID_SECONDS} s {label}: the cost-grid "
                        f"engine's bytes equal the plane and host C++ "
                        f"engines' ({counts['analysis']} K3, "
                        f"{counts['cost_grid']} K5, {counts['search']} K4 "
                        f"launches); wall {wall * 1e3:.1f} ms -> "
                        f"{GRID_SECONDS / wall:.1f}x realtime")
        _say_stages(f"20 grid {label}", card, [genc.timer.times])

    sg = np.load(os.path.join(GOLD, "stego_golden.npz"))
    gold_wav = _write(os.path.join(tmp, "grid_gold.wav"),
                      sg["wav_bytes"].tobytes())
    msgs = {"hidden_short": "ddd",
            "hidden_long": sg["msg_long"].tobytes().decode(),
            "hidden_toolong": "ddd" * 100}
    mp3 = np.load(os.path.join(GOLD, "encode_golden.npz"))["mp3_bytes"]
    with grid_engine():
        got = runs.run("cost-grid engine, the goldens", None, lambda: [
            _encode_bytes(gold_wav, dev)[0]] + [
            _encode_bytes(gold_wav, dev, _frame_message(m))[0]
            for m in msgs.values()], kernels=("analysis", "cost_grid"))
    for name, b, m, want in zip(["encode_golden"] + list(msgs), got,
                                [""] + list(msgs.values()),
                                [mp3] + [sg[k] for k in msgs]):
        _expect_equal(f"grid engine, {name}", b, want.tobytes())
        _expect_equal(f"grid engine, {name}: vs the host C++ engine", b,
                      _encode_bytes(gold_wav, dev, _frame_message(m) if m
                                    else "", host=True)[0])
    _say("20 grid", "the cost-grid engine writes the goldens byte for byte "
                    "on the card, as the host C++ engine does: "
                    "encode_golden, hidden_short, hidden_long, "
                    "hidden_toolong")
    return dict(name="cost_all_steps", route="cuda",
                source="mp3stego_tpu_torch/csrc/cost_grid.cu",
                replaces="mp3stego_tpu/ops/quant_batch.py:55",
                launches=runs.launches("cost_grid"), max_abs_err=err,
                ms=best["kernel"], plain_ms=best["plain"], bound_ms=bound,
                bound_by=by, library_ms=None, bound_pr15_ms=pr15[0])


def serialize_bound(side: np.ndarray, frames: np.ndarray,
                    stream_bytes: int) -> tuple:
    """The frame serializer's bound by bytes on its inputs: (ms, bytes,
    coded ix bytes). It reads each lane's coded samples (big_values pairs
    and count1 quads, 4 B each), the side fields, the frame ints and its
    tables once, and writes the stream once, over HBM's rate; the zeroed
    output buffer and the lengths' scan are not counted."""
    fld = dict(zip(SZ.FIELDS, side.astype(np.int64)))
    pairs = np.clip(fld["big_values"], 0, 288)
    quads = np.minimum(np.maximum(fld["count1"], 0), (576 - 2 * pairs) // 4)
    coded = int((2 * pairs + 4 * quads).sum()) * 4
    need = (coded + side.nbytes + frames.nbytes + SZ._host_tables().nbytes
            + stream_bytes)
    return need / HBM_BYTES_S * 1e3, need, coded


def serialize_phase(dev, card: str, wav64: str, enc_out: dict,
                    runs: Paths) -> dict:
    """Phase 22: the frame serializer (``csrc/serialize.cu``) on the song's
    hide (phase 10's message): its inputs as the encoder holds them (``ix``
    resident, the side fields put up), the kernel's bytes, length and
    returned cache equal to the plain version's (``pack_frames_torch``, on
    the card) and to the C route's (``mp3_format_frames`` on the fetched
    arrays), fresh and after a carried cache of 13 pending bits; then the
    kernel (its four launches with their buffers) by CUDA events beside
    its bound by bytes (``serialize_bound``), the plain version, the C
    route on the host and the encoder's whole card serialize. Returns the
    kernels line's row."""
    seen = []
    orig = MP3Encoder._plane_serialize_card

    def spy(self, res, p23, gg, scfsi_f, paddings, nf):
        n0 = len(self.out_buffer)
        orig(self, res, p23, gg, scfsi_f, paddings, nf)
        seen.append((self, res, p23, gg, scfsi_f, paddings, nf,
                     bytes(self.out_buffer[n0:])))
    MP3Encoder._plane_serialize_card = spy
    try:
        runs.run("hide encode, the serializer's inputs", None,
                 lambda: _encode_bytes(wav64, dev, enc_out["hide_bits"]),
                 kernels=ENCODE)
    finally:
        MP3Encoder._plane_serialize_card = orig
    if len(seen) != 1:
        raise AssertionError(f"the hide serialized {len(seen)} times on the "
                             f"card, not once")
    enc, res, p23, gg, scfsi_f, paddings, nf, appended = seen[0]
    ix = res["ix"]
    if ix.device.type != "cuda":
        raise AssertionError("the hide's ix left the card before its "
                             "serialize")
    side, frames = enc._serialize_fields(res, p23, gg, scfsi_f, paddings, nf)
    cfg = enc._serialize_config()
    up = put_tree({"side": side, "frames": frames}, dev)
    host_ix = ix.cpu().numpy()
    lib = native.get_lib()
    for cache, cache_bits in ((0, 32), (0x5A5A5A5A & ~0x7FFFF, 32 - 13)):
        got = SZ.pack_frames(ix, up["side"], up["frames"], cfg, cache,
                             cache_bits)
        plain = SZ.pack_frames_torch(ix, up["side"], up["frames"], cfg,
                                     cache, cache_bits)
        ca = np.array([cache], np.uint32)
        cb = np.array([cache_bits], np.int32)
        c_bytes = E._format_frames_native(lib, host_ix, side, frames, cfg,
                                          ca, cb)
        name = f"serializer, {32 - cache_bits} carried bits"
        _expect_equal(f"{name}: kernel vs plain version", bytes(got[0]),
                      bytes(plain[0]))
        _expect_equal(f"{name}: kernel vs C route", bytes(got[0]), c_bytes)
        if got[1:] != plain[1:] or got[1:] != (int(ca[0]), int(cb[0])):
            raise AssertionError(f"{name}: cache, cache_bits {got[1:]}, "
                                 f"plain {plain[1:]}, C route "
                                 f"{(int(ca[0]), int(cb[0]))}")
        if cache_bits == 32:
            _expect_equal("serializer vs the hide's own bytes",
                          bytes(got[0]), appended)
            stream = len(c_bytes)
    _say("22 serialize", f"[{card}] the song's hide, {nf} frames, "
                         f"{ix.shape[0]} lanes: kernel bytes ({stream}), "
                         f"length and cache equal the plain version's and "
                         f"the C route's, fresh and after 13 carried bits")

    def kernel():
        SZ._launch(ix, up["side"], up["frames"], cfg, 0, 32)

    def plain():
        SZ.pack_frames_torch(ix, up["side"], up["frames"], cfg)

    def c_route():
        E._format_frames_native(lib, host_ix, side, frames, cfg,
                                np.zeros(1, np.uint32),
                                np.full(1, 32, np.int32))

    def route():
        enc.out_buffer = bytearray()
        enc._plane_serialize_card(res, p23, gg, scfsi_f, paddings, nf)
    kernel()
    plain()
    k_ms = sorted(_card_ms(kernel) for _ in range(3))
    p_ms = sorted(_time_ms(plain, 1) for _ in range(3))
    walls = {}
    for name, fn in (("C route (host)", c_route), ("encoder's card "
                                                  "serialize", route)):
        walls[name] = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    if bytes(enc.out_buffer) != appended:
        raise AssertionError("the encoder's card serialize wrote other "
                             "bytes when run again")
    bound, need, coded = serialize_bound(side, frames, stream)
    _say("22 serialize", f"[{card}] kernel (4 launches with their buffers) "
                         f"{[round(x, 4) for x in k_ms]} ms, bound "
                         f"{bound:.4f} ms by bytes ({need / 1e6:.2f} MB: "
                         f"coded ix {coded / 1e6:.2f} of "
                         f"{ix.numel() * 4 / 1e6:.2f} MB, side fields, "
                         f"tables, stream), at {bound / k_ms[1]:.1%} of it; "
                         f"plain version on the card "
                         f"{[round(x, 1) for x in p_ms]} ms (plain/kernel "
                         f"{p_ms[1] / k_ms[1]:.0f}x); " + "; ".join(
                             f"{k} {[round(x, 2) for x in v]} ms"
                             for k, v in walls.items()))
    return dict(name="serialize_frames", route="cuda",
                source="mp3stego_tpu_torch/csrc/serialize.cu", replaces=None,
                launches=runs.launches("serialize"), max_abs_err=0,
                ms=k_ms[1], plain_ms=p_ms[1], bound_ms=bound,
                bound_by="bytes", library_ms=None,
                c_route_ms=sorted(walls["C route (host)"])[2],
                route_ms=sorted(walls["encoder's card serialize"])[2])


def library_pair(blk: torch.Tensor):
    """K1's function as one ``bmm`` (V) and one grouped ``conv1d`` (the
    FIR), TF32 off, in ``blk``'s dtype: the library yardstick, used nowhere
    in the port. Its inputs' layouts are made here, outside the timed call:
    the overlap-add and inversion, step-major and transposed (rows, 32,
    15 + S) with 15 zero steps in front (their V is zero), N's rows paired
    (k, 32 + k) so that V comes out as the conv's channel pairs, and the
    taps ``w[k, j % 2, 15 - j] = D[j, k]``. Returns the call, which gives
    (rows, 32, S) PCM."""
    rows, tt = blk.shape[0], blk.shape[1]
    n_t, d, _ = sf._tables(blk.dtype, blk.device)
    st = sf.overlap_freqinv(blk)[1].reshape(rows, tt, 32, 18) \
        .permute(0, 2, 1, 3).reshape(rows, 32, tt * 18)
    st = torch.nn.functional.pad(st, (15, 0)).contiguous()
    idx = torch.stack([torch.arange(32), torch.arange(32) + 32], 1) \
        .reshape(-1).to(blk.device)
    n_pair = n_t.T[idx].contiguous().expand(rows, 64, 32)
    w = torch.zeros((32, 2, 16), dtype=blk.dtype, device=blk.device)
    for j in range(16):
        w[:, j % 2, 15 - j] = d[j]
    return lambda: torch.nn.functional.conv1d(torch.bmm(n_pair, st), w,
                                              groups=32)


def fused_bound(rows: int, tt: int, dtype, out: str):
    """The least time for K1's work on the card: (bytes that must move:
    blk read once, N and D read once, the output written once) over HBM's
    rate against (the separately rounded operations: per sub-step the
    overlap-add and inversion 2 x 32, V 2 x 64 x 32, the FIR 2 x 32 x 16,
    the int16 scale 32) over the non-fused peak. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    es = torch.finfo(dtype).bits // 8
    steps = rows * tt * 18
    nbytes = es * (rows * tt * 32 * 36 + 64 * 32 + 16 * 32) \
        + steps * 32 * (2 if out == "int16" else es)
    ops = steps * (2 * 32 + 2 * 64 * 32 + 2 * 32 * 16
                   + (32 if out == "int16" else 0))
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_OPS_S[dtype] * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes, ops
    return by_ops, "operations", nbytes, ops


def granule_bound(prep: dict, dtype):
    """The least time for K2's work on the card: (bytes that must move: the
    kernel's inputs as the prep holds them, the int8 sample plane with its
    escapes and their index or the int32 plane, the side information, the
    static maps and the tables, read once, the (2, T, 32, 36) blocks written
    once) over HBM's rate, against (the ``K2_OPS_*`` operations this prep's
    granules take) over the non-fused peak of ``dtype``. Returns (ms,
    "bytes" or "operations", bytes, operations)."""
    inputs = [t for t in dp.kernel_inputs(prep, dtype) if t is not None]
    tt = inputs[0].shape[1]
    es = torch.finfo(dtype).bits // 8
    nbytes = sum(t.numel() * t.element_size() for t in inputs) \
        + es * 2 * tt * 32 * 36
    mode = prep["mode"].long()
    m3 = mode == 3
    short_band = prep["is_short_blk"][..., None] \
        & ~(m3[..., None] & prep["mix_long_band"][None, None])
    n_short = int(short_band.sum())
    butterflies = 248 * int((~prep["reorder_mask"] & ~m3).sum()) \
        + 8 * int(m3.sum())
    is_samples = 0
    if bool(prep["is_mask"].any()):
        pos = torch.gather(prep["is_pos"].long().reshape(tt, 88), 1,
                           prep["slot_is"].long()[mode[1]])
        is_samples = int(((pos >= 0) & prep["is_mask"][:, None]).sum())
    ops = (2 * tt * 576 * K2_OPS_SAMPLE
           + int(prep["ms_mask"].sum()) * 576 * K2_OPS_MS
           + is_samples * K2_OPS_IS
           + butterflies * K2_OPS_BUTTERFLY
           + (2 * tt * 32 - n_short) * K2_OPS_LONG_BAND
           + n_short * K2_OPS_SHORT_BAND)
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / PEAK_OPS_S[dtype] * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes, ops
    return by_ops, "operations", nbytes, ops


def hold_granule(name: str, prep: dict, errs: dict) -> None:
    """K2 against its plain version on ``prep`` in both dtypes, bit for bit
    with the signs of zero; the largest difference goes into
    ``errs[dtype]``."""
    for dtype in (F32, F64):
        got = dp.granule_blocks(prep, dtype)
        want = dp.granule_blocks_torch(prep, dtype)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                                 f"the plain {tuple(want.shape)} "
                                 f"{want.dtype}")
        err = float((got.double() - want.double()).abs().max())
        errs[dtype] = max(errs.get(dtype, 0.0), err)
        if not (torch.equal(got, want)
                and torch.equal(got.signbit(), want.signbit())):
            raise AssertionError(f"{name}: granule_blocks != "
                                 f"granule_blocks_torch ({dtype}): max |d| "
                                 f"{err}")


def dense_prep(prep: dict) -> dict:
    """``prep`` with its int8 plane and escapes replaced by the int32 plane
    they stand for, as the device Huffman decode hands it over
    (``raw_dense``)."""
    raw = prep["raw_i8"].to(torch.int32)
    t, ch, s = (prep[k].long() for k in ("exc_t", "exc_ch", "exc_s"))
    raw[ch, t, s] = prep["exc_val"].to(torch.int32)
    dense = {k: v for k, v in prep.items()
             if k not in dp.RAW_KEYS + ("exc_start",)}
    dense["raw_dense"] = raw
    return dense


def granule_song_phase(dev, card: str, prep: dict, errs: dict) -> dict:
    """Phase 4's device plane: K2 bit for bit its plain version on the
    song's prep in both dtypes, on the int8 plane with its escapes (the
    host parse's route, every decode but the device-Huffman one), on the
    int32 plane and on a song-sized synthetic prep of every block type;
    then, by CUDA events, the kernel on each of the three (the wrapper
    launches nothing else), each with its bound, the plain version whole
    and its four stages apart, and K1; a float32 ``torch.matmul`` of the
    long IMDCT alone beside them (one part of the function, not a
    yardstick of all of it); and each instantiation's registers, shared
    memory, spills (a spill fails the phase) and resident warps an SM.
    Returns K2's measured fields of the kernels line per dtype, from the
    int8 plane."""
    dense = dense_prep(prep)
    synth = dp.prep_to_torch(synthetic_prep(SONG_T), dev)
    hold_granule("song, int8 plane", prep, errs)
    hold_granule("song, dense plane", dense, errs)
    hold_granule("song-sized synthetic prep", synth, errs)
    out = {}
    for dtype in (F32, F64):
        fns = {"kernel": lambda: dp.granule_blocks(prep, dtype),
               "kernel, int32 plane": lambda: dp.granule_blocks(dense, dtype),
               "kernel, synthetic": lambda: dp.granule_blocks(synth, dtype),
               "plain": lambda: dp.granule_blocks_torch(prep, dtype)}
        for fn in fns.values():
            fn()
        times = {k: [] for k in fns}
        for which in ("plain", "kernel", "kernel, int32 plane",
                      "kernel, synthetic", "kernel, synthetic",
                      "kernel, int32 plane", "kernel", "plain"):
            times[which].append(_time_ms(fns[which], 1 if which == "plain"
                                         else 20))
        best = {k: min(v) for k, v in times.items()}
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        for _ in range(2):                     # the second pass is timed
            marks.clear()
            mark("start")
            x = dp._requantize_stage(prep, dtype)
            mark("requantize")
            x = dp._stereo_stage(prep, x, dtype)
            mark("stereo")
            x = dp._reorder_alias_stage(prep, x, dtype)
            mark("reorder_alias")
            blk = dp._imdct_stage(prep, x, dtype)
            mark("imdct")
            dp.synth_from_blocks(blk, None, "int16", 2)
            mark("synth (K1, int16)")
            torch.cuda.synchronize()
        stages = ", ".join(f"{name} {a.elapsed_time(b):.3f}" for (_, a), (
            name, b) in zip(marks, marks[1:]))
        del x, blk
        bound, by, nbytes, ops = granule_bound(prep, dtype)
        wide, wide_by, wide_bytes, _ = granule_bound(dense, dtype)
        syn, syn_by, syn_bytes, syn_ops = granule_bound(synth, dtype)
        _say("4 K2", f"[{card}] {dtype} song ({dense['raw_dense'].shape[1]} "
                     f"granules x 2 channels), int8 plane and "
                     f"{prep['exc_t'].numel()} escapes: kernel "
                     f"{times['kernel']} ms, bound {bound:.4f} ms by {by} "
                     f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G ops), at "
                     f"{bound / best['kernel']:.1%} of it; int32 plane: "
                     f"kernel {times['kernel, int32 plane']} ms, bound "
                     f"{wide:.4f} ms by {wide_by} ({wide_bytes / 1e6:.1f} "
                     f"MB), at {wide / best['kernel, int32 plane']:.1%}; "
                     f"song-sized synthetic prep (every block type, "
                     f"{synth['exc_t'].numel()} escapes): kernel "
                     f"{times['kernel, synthetic']} ms, bound {syn:.4f} ms "
                     f"by {syn_by} ({syn_bytes / 1e6:.1f} MB, "
                     f"{syn_ops / 1e9:.3f} G ops), at "
                     f"{syn / best['kernel, synthetic']:.1%}; plain "
                     f"{times['plain']} ms (plain/kernel "
                     f"{best['plain'] / best['kernel']:.1f}x); plain stages, "
                     f"ms: {stages}")
        out[dtype] = dict(ms=best["kernel"], plain_ms=best["plain"],
                          bound_ms=bound, bound_by=by, library_ms=None)
    rows = dense["raw_dense"].shape[1] * 2 * 32
    x = torch.randn((rows, 18), device=dev)
    w = dp._c(F32, dev).c_long_t
    mm = _time_ms(lambda: torch.matmul(x, w), 20)
    _say("4 K2", f"[{card}] float32 long IMDCT alone as one torch.matmul "
                 f"({rows}, 18) @ (18, 36), TF32 off: {mm:.4f} ms (one part "
                 f"of K2's function; library_ms stays null)")
    spills = []
    for (dtype, wide), kern in K2_INSTANCES.items():
        res = _cuda.ptxas_resources("granule", kern)
        occ = dp.occupancy(dev, dtype, wide)
        _say("4 K2", f"[{card}] granule_kernel<{dtype}, "
                     f"{'int32' if wide else 'int8'} plane>: "
                     f"{res['registers']} registers a thread, "
                     f"{res['smem'] + occ['smem']} B of shared memory a CTA "
                     f"({occ['smem']} B dynamic), spills "
                     f"{res['spill_stores']} B stored and {res['spill_loads']}"
                     f" B loaded (-Xptxas -v); {occ['ctas']} CTAs of "
                     f"{occ['warps']} warps an SM, "
                     f"{occ['ctas'] * occ['warps']} resident warps (the "
                     f"runtime's occupancy query)")
        if res["spill_stores"] or res["spill_loads"]:
            spills.append(kern)
    if spills:
        raise AssertionError(f"granule_kernel spills registers: {spills}")
    del dense, synth, x
    torch.cuda.empty_cache()
    return out


def granule_phase(dev, card: str, tmp: str, song: str, errs: dict) -> None:
    """Phase 18: K2 bit for bit its plain version in both dtypes on the
    synthetic prep (also under MP3STEGO_TPU_REF_START_WINDOW=1), the 7
    crafted streams, the 3 LSF and 5 multirate goldens (8 kHz MPEG-2.5
    among them), a mono stream and the song's device-Huffman ``raw_dense``
    prep."""
    names = []
    hold_granule("synthetic", dp.prep_to_torch(synthetic_prep(64), dev), errs)
    before = os.environ.get("MP3STEGO_TPU_REF_START_WINDOW")
    os.environ["MP3STEGO_TPU_REF_START_WINDOW"] = "1"
    try:
        hold_granule("synthetic, reference start window",
                     dp.prep_to_torch(synthetic_prep(64), dev), errs)
    finally:
        if before is None:
            del os.environ["MP3STEGO_TPU_REF_START_WINDOW"]
        else:
            os.environ["MP3STEGO_TPU_REF_START_WINDOW"] = before
    crafted = np.load(os.path.join(GOLD, "crafted_golden.npz"))
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    streams = [(n, crafted[n].tobytes()) for n in sorted(crafted.files)]
    streams += [(n, lsf[n].tobytes()) for n in sorted(lsf.files)]
    streams += [(t, mr[f"mp3_{t}"].tobytes()) for t in (
        "32000_64", "32000_192", "44100_128", "48000_96", "48000_320")]
    with open(os.path.join(tmp, "b_mono.mp3"), "rb") as f:
        streams.append(("mono 30 s", f.read()))
    for name, data in streams:
        parsed = dh.parse_mp3(data)
        if name.startswith("mono") and parsed.header.channels != 1:
            raise AssertionError("the mono stream is not mono")
        hold_granule(name, dp.prep_to_torch(dp.host_prepare(parsed), dev),
                     errs)
        names.append(name)
    with open(song, "rb") as f:
        parsed, desc = dh.parse_mp3_light(f.read())
    prep = dp.prep_to_torch(dp.host_prepare(parsed, raw=False), dev)
    prep["raw_dense"] = hd.decode_raw_device(desc, dev)
    hold_granule("song, device-Huffman raw_dense", prep, errs)
    _say("18 K2", f"granule_blocks bitwise equal to granule_blocks_torch "
                  f"(signs of zero included) in float32 and float64 on the "
                  f"synthetic prep (also with the reference start window), "
                  f"{', '.join(names)} and the song's device-Huffman plane")


# the engine overrides of utils/calibrate.py, which phase 21 sets per run
OVERRIDES = ("MP3STEGO_TPU_BATCH_HOST_G", "MP3STEGO_TPU_BATCH_ENC_HOST",
             "MP3STEGO_TPU_ENC_HOST")
# each hand kernel's module and the name its CUDA kernel has in a trace
TRACE_NAMES = {"granule": "granule_kernel", "synth_fused": "synth_fused_kernel",
               "analysis": "analysis_kernel", "search": "rate_search_kernel",
               "huffman_scan": "huffman_scan_kernel",
               "cost_grid": "cost_grid_kernel", "serialize": "pack_kernel"}


@contextlib.contextmanager
def engines(**env):
    """The block with the engine overrides ``env`` and no other (a value of
    None: that override unset, the entry point's default, the card)."""
    saved = {k: os.environ.get(k) for k in OVERRIDES}
    try:
        for k in OVERRIDES:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in env.items() if v is not None})
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _turns_ms(fns: dict, rounds: int = 5) -> dict:
    """Each function once to warm up, then ``rounds`` rounds in turns, the
    order reversed every other round, each call synchronised (host clock):
    name -> the median ms."""
    for fn in fns.values():
        fn()
    times, names = {k: [] for k in fns}, list(fns)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def engine_phase(dev, card: str, tmp: str, song: str, wav64: str,
                 enc_out: dict, inputs: dict, runs: Paths) -> None:
    """Phase 21: the engine choice (``utils/calibrate.py``), the pinned
    transfers (``utils/transfer.py``), the device-trace readers
    (``utils/profiling.py``) and ``decode_pcm`` through the scan, on the
    song and phase 12's and 13's batches."""
    from mp3stego_tpu_torch.parallel import (decode_files_batched,
                                             frame_shard as FS, make_mesh)
    from mp3stego_tpu_torch.utils import calibrate as C
    from mp3stego_tpu_torch.utils import profiling as P
    from mp3stego_tpu_torch.utils.transfer import fetch_concat

    # the probe, measured here (no entry point measures or reads one)
    probe = C.measure_probe(dev)
    _say("21 engine", f"[{card}] measure_probe: {json.dumps(probe.__dict__)}")

    with open(song, "rb") as f:
        song_b = f.read()
    parsed = dh.parse_mp3(song_b)
    second_frames = 39                                    # 1.02 s
    second = _write(os.path.join(tmp, "second.mp3"),
                    _frame_slice(song_b, parsed, 0, second_frames))
    paths, jobs = inputs["paths"], inputs["jobs"]
    g_batch = 2 * sum(m.num_frames for m in inputs["metas"])
    g_jobs = 2 * sum(MP3Encoder(read_wav(w, 320), device=dev)._num_frames()
                     for w, _ in jobs)
    picks = {
        "song, single encode": C.single_encode_engine(probe, dev),
        "song, int16 decode": C.batch_decode_engine(
            2 * parsed.num_frames, probe, dev),
        "32-file decode batch": C.batch_decode_engine(g_batch, probe,
                                                      dev),
        "9-file encode batch": C.batch_encode_engine(g_jobs, probe, dev),
        "1 s slice, decode": C.batch_decode_engine(
            2 * second_frames, probe, dev),
        "1 s slice, encode": C.batch_encode_engine(
            2 * second_frames, probe, dev),
        "7-frame window, decode": C.batch_decode_engine(14, probe, dev),
        "7-frame window, encode": C.batch_encode_engine(14, probe, dev),
    }
    _say("21 engine", f"[{card}] the cost model's picks: " + "; ".join(
        f"{k} -> {v}" for k, v in picks.items()))

    # the 1 s slice and the 32-file batch through the entry point's default
    # (no override: the card) and both pinned engines; the host plane is
    # float64 exact, the card's float32 within 1 LSB of it
    for name, files, pick in (("1 s slice", [second],
                               picks["1 s slice, decode"]),
                              ("32-file batch", paths,
                               picks["32-file decode batch"])):
        outs, fns = {}, {}
        for engine, env in (("default", None), ("host", str(1 << 40)),
                            ("device", "0")):
            def run(env=env, engine=engine):
                with engines(MP3STEGO_TPU_BATCH_HOST_G=env):
                    outs[engine] = decode_files_batched(files, out="int16",
                                                        device=dev)
            fns[engine] = run
        runs.run(f"engine choice, {name}, pinned device", F32,
                 fns["device"])
        ms = _turns_ms(fns, 3)
        for k, (a, b, c) in enumerate(zip(outs["default"], outs["host"],
                                           outs["device"])):
            f = os.path.basename(files[k])
            tol = MAX_LSB_RATE if f.startswith(("slice", "second")) \
                else TONE_MAX_LSB_RATE
            _lsb_contract(f"{name} {f}: device vs host", c, b, tol)
            if a.tobytes() != c.tobytes():
                raise AssertionError(f"{name} {f}: the default engine's "
                                     f"bytes are not the card's")
        faster = min(("host", "device"), key=ms.get)
        _say("21 engine", f"[{card}] {name} ({len(files)} files), int16 "
                          f"float32: default (the card) {ms['default']:.2f} "
                          f"ms, host {ms['host']:.2f} ms, device "
                          f"{ms['device']:.2f} ms (medians of 3 in turns); "
                          f"outputs within the float32 contract, the "
                          f"default's bytes the card's; the cost model "
                          f"would pick {pick}, "
                          f"{'the faster' if pick == faster else 'the slower'}"
                          f" engine ({faster} is faster)")

    # the pinned fetches against pageable .cpu(): the song's ix (to_host)
    # and its 8-shard PCM
    enc = MP3Encoder(read_wav(wav64, 320), device=dev)
    nf = enc._num_frames()
    xr = enc._analysis_device(nf)
    _, mean_bits_f = enc._plane_framing(nf)
    res_d = SP.search(xr, torch.from_numpy(enc._lane_budgets(mean_bits_f))
                      .to(dev), enc.band_row)
    keys = list(SP.ROWS) + list(SP.COUNTS)
    new = SP.to_host(res_d)
    old_rows = torch.stack([res_d[k] for k in keys]).cpu().numpy()
    old_ix = res_d["ix"].cpu().numpy()
    if new["ix"].tobytes() != old_ix.tobytes() or any(
            new[k].tobytes() != old_rows[r].tobytes()
            for r, k in enumerate(keys)):
        raise AssertionError("to_host through fetch_pieces != .cpu()")
    ms_ix = _turns_ms({
        "pageable .cpu()": lambda: (
            torch.stack([res_d[k] for k in keys]).cpu().numpy(),
            res_d["ix"].cpu().numpy()),
        "fetch_pieces": lambda: SP.to_host(res_d)})
    ix_mb = old_ix.nbytes / 1e6
    del xr, res_d, new, old_rows, old_ix
    hp = dp.host_prepare(parsed)
    mesh = make_mesh(files=1, frames=8, devices=mesh_entries(8))
    pcm = FS.shard_body(FS.shard_preps(hp, mesh), F32)
    old = np.concatenate([p.cpu().numpy() for p in pcm], axis=1)
    if fetch_concat(pcm, 1).tobytes() != old.tobytes():
        raise AssertionError("8-shard PCM through fetch_concat != .cpu()")
    ms_pcm = _turns_ms({
        "pageable .cpu() + np.concatenate": lambda: np.concatenate(
            [p.cpu().numpy() for p in pcm], axis=1),
        "fetch_concat": lambda: fetch_concat(pcm, 1)})
    _say("21 transfer", f"[{card}] the song's ix ({ix_mb:.1f} MB int32) "
                        f"and rows, bytes equal: " + "; ".join(
                            f"{k} {v:.3f} ms" for k, v in ms_ix.items())
         + f"; its 8-shard float32 PCM ({old.nbytes / 1e6:.1f} MB), bytes "
           f"equal: " + "; ".join(f"{k} {v:.3f} ms"
                                  for k, v in ms_pcm.items())
         + " (medians of 5 in turns)")
    del pcm, old

    # one clear encode and one 90 % hide of the song under trace(), read
    # back by the device-trace readers
    for name, bits in (("clear encode", ""), ("90 % hide",
                                              enc_out["hide_bits"])):
        log_dir = os.path.join(tmp, f"trace_{len(bits)}")
        _encode_bytes(wav64, dev, bits)                     # warm-up
        torch.cuda.synchronize()
        with P.trace(log_dir):
            t0 = time.perf_counter()
            _, enc = runs.run(f"traced {name}", None,
                              lambda: _encode_bytes(wav64, dev, bits),
                              kernels=ENCODE)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        got = P.parse_device_trace(log_dir)
        names = " | ".join(op["name"] for op in got["ops"])
        for k, n in runs.log[-1][2].items():
            if n and TRACE_NAMES[k] not in names:
                raise AssertionError(f"traced {name}: {k} launched {n} "
                                     f"times and no {TRACE_NAMES[k]} record")
        busy = P.device_busy(log_dir, wall_ms=wall_ms)
        if busy["idle_share"] is None:
            raise AssertionError(f"traced {name}: no kernel in the trace")
        util = P.stage_utilization(got["ops"], list(enc.timer.times),
                                   rolled_stage="(no scope)")
        _say("21 trace", f"[{card}] {name}: traced wall {wall_ms:.1f} ms, "
                         f"device busy {busy['busy_ms']:.3f} ms over "
                         f"{busy['counts']}, idle share "
                         f"{busy['idle_share']:.4f}; device ms per stage: "
                         + "; ".join(f"{k} {v['ms']:.3f} ({v['dominant']})"
                                     for k, v in util.items())
                         + f"; top kernels: " + "; ".join(
                             f"{t['name'][:40]} x{t['launches']} "
                             f"{t['ms']:.3f} ms"
                             for t in busy["top_kernels"][:5]))

    # decode_pcm of the default parse: the song through the scan, bit for
    # bit the float32 decode of the host fill
    got = runs.run("decode_pcm, scan (float32)", F32,
                   lambda: dp.decode_pcm(dh.parse_mp3(song_b), "float32",
                                         dev),
                   kernels=("huffman_scan",) + DECODE)
    want = dp.decode_pcm(dh.parse_mp3(song_b, defer_samples=False),
                         "float32", dev)
    if got.dtype != np.float32 or got.tobytes() != want.tobytes():
        raise AssertionError("decode_pcm through the scan != the float32 "
                             "decode of the host fill")
    _say("21 huffman", f"decode_pcm of the default parse on the song: "
                       f"{got.shape} float32 PCM bit for bit the host "
                       f"fill's float32 decode ({runs.last('huffman_scan')} "
                       f"scan, {runs.last('granule')} K2, {runs.last()} K1 "
                       f"launches)")


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
    for k in OVERRIDES:                 # every entry point on its default
        os.environ.pop(k, None)

    # ---- phase 1: build the kernels (one nvcc per source, sm_90a) and the
    # host library (g++), all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=7) as pool:
        host_lib = pool.submit(native.get_lib)
        built = [pool.submit(_cuda.load, name, mod._SIGNATURES)
                 for name, mod in (("granule", dp), ("synth", sf),
                                   ("huffman", hd), ("search", SP),
                                   ("analysis", EP), ("cost_grid", QB),
                                   ("serialize", SZ))]
        for b in built:
            b.result()
        if host_lib.result() is None:
            raise RuntimeError("the native host library did not build or "
                               "load")
    for name in ("granule", "synth", "huffman", "search", "analysis",
                 "cost_grid", "serialize"):
        info = _cuda.builds[name]
        _say("1 build", f"csrc/{name}.cu -> "
                        f"{os.path.relpath(info['path'], REPO)} in "
                        f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                _say("1 build", "ptxas: " + line.strip())
    for dtype in (F32, F64):
        g, smem = sf.tile(dtype)
        _say("1 build", f"{dtype}: {g} granules and {smem} B of shared "
                        f"memory per CTA")
    occ = EP.occupancy(dev)
    _say("1 build", f"analysis: up to {occ['granules']} granules a tile and "
                    f"{occ['smem']} B of shared memory per CTA, "
                    f"{occ['ctas']} CTAs an SM")
    _say("1 build", f"kernels and native host library (in parallel) in "
                    f"{time.perf_counter() - t0:.2f} s")

    # ---- phase 2: K1 against its plain version, bit for bit, in both
    # dtypes and epilogues: the song's shape, one granule, odd counts
    # around the tiles (8 granules in float32, 4 in float64), a batch
    errs = {}
    for dtype in (F32, F64):
        for rows, t in ((2, SONG_T), (2, 1), (1, 7), (2, 9), (1, 5),
                        (3, 41), (32, 2298)):
            blk = _seeded_blk(rows, t, rows * 100 + t, dtype, dev)
            ch = 2 if rows % 2 == 0 else 1
            for out in sf.OUTS:
                hold("seeded blocks", blk, out, ch, errs)
        # rows are independent and tiles join without a seam
        blk = _seeded_blk(3, 41, 1, dtype, dev)
        whole = sf.synth_fused(blk)
        for r in range(3):
            if not torch.equal(whole[r:r + 1],
                               sf.synth_fused(blk[r:r + 1].contiguous())):
                raise AssertionError(f"{dtype}: row {r} alone != in a batch")
        # loud blocks: the int16 epilogue saturates, or wraps on request
        loud = 40 * _seeded_blk(2, 13, 2, dtype, dev)
        for wrap in ("0", "1"):
            os.environ["MP3STEGO_TPU_REF_PCM_WRAP"] = wrap
            hold(f"loud blocks, wrap={wrap}", loud, "int16", 2, errs)
        del os.environ["MP3STEGO_TPU_REF_PCM_WRAP"]
        _say("2 K1", f"{dtype}: bitwise equal to synth_fused_torch, float "
                     f"and int16, at (rows, T) (2, {SONG_T}), (2, 1), (1, "
                     f"7), (2, 9), (1, 5), (3, 41), (32, 2298); rows alone "
                     f"equal rows in a batch; loud blocks saturate and wrap "
                     f"alike")
    torch.cuda.empty_cache()

    # ---- phase 3: plane coverage (short/start/mixed/MS/intensity/linbits)
    prep = synthetic_prep(64)
    ref = dp.decode_granules_np(prep)
    got = dp.decode_granules(dp.prep_to_torch(prep, dev), F32)
    got = got.cpu().numpy()
    err = float(np.abs(got - ref).max())
    # the synthetic batch peaks far above full scale, so the float32 bound
    # of tests/test_precision.py (1e-5 on unit-scale audio) scales with it
    bound = 1e-5 * max(1.0, float(np.abs(ref).max()))
    if not err < bound:
        raise AssertionError(f"card plane vs host float64: {err} >= {bound}")
    got64 = dp.decode_granules(dp.prep_to_torch(prep, dev), F64)
    if not np.array_equal(got64.cpu().numpy(), ref):
        raise AssertionError("card float64 plane != decode_granules_np")
    _say("3 plane", f"synthetic T=64 batch: card float32 vs host float64 "
                    f"max |d| {err:.3e} (bound {bound:.3e}, peak "
                    f"{np.abs(ref).max():.3f}); card float64 bit for bit "
                    f"decode_granules_np")

    runs = Paths()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 4: the slice, a 240.7 s song through the façade: the
        # default (float64 on the card) against the host C++ plane, then
        # float32
        mp3 = np.load(os.path.join(GOLD, "encode_golden.npz"))["mp3_bytes"]
        song = os.path.join(tmp, "song.mp3")
        with open(song, "wb") as f:
            f.write((mp3.tobytes() + b"\0") * SONG_COPIES)
        s_host = Steganography(quiet=True, device="cpu")
        host_wav = os.path.join(tmp, "song_host.wav")
        t_host, walls_host, _ = _median3(
            lambda: s_host.decode_mp3_to_wav(song, host_wav))
        s64 = Steganography(quiet=True)              # float64 on the card
        wav64 = os.path.join(tmp, "song64.wav")

        def decode64():
            s64.decode_mp3_to_wav(song, wav64)
            return dict(s64._last_decoder.timer.times)

        wall64, walls64, stages64 = runs.run("façade decode, float64 "
                                             "(default)", F64,
                                             lambda: _median3(decode64))
        with open(wav64, "rb") as a, open(host_wav, "rb") as b:
            _expect_equal("song: default card decode vs host C++ plane",
                          a.read(), b.read())
        want = _wav_i16(wav64)
        seconds = want.size / 2 / 44100
        _say("4 slice", f"{seconds:.2f} s song: the default decode (float64 "
                        f"on the card, {runs.last('granule')} K2 and "
                        f"{runs.last()} K1 launches in 4 "
                        f"decodes) writes the host C++ plane's WAV bytes")
        _say("4 slice", f"[{card}] float64 card decode wall median "
                        f"{wall64 * 1e3:.1f} ms of "
                        f"{[round(w * 1e3, 1) for w in walls64]} -> "
                        f"{seconds / wall64:.1f}x realtime; host C++ float64 "
                        f"plane median {t_host * 1e3:.1f} ms of "
                        f"{[round(w * 1e3, 1) for w in walls_host]} -> "
                        f"{seconds / t_host:.1f}x")
        _say_stages("4 slice float64", card, stages64)
        s32 = Steganography(quiet=True, precision="float32")
        wav32 = os.path.join(tmp, "song32.wav")

        def decode32():
            s32.decode_mp3_to_wav(song, wav32)
            return dict(s32._last_decoder.timer.times)

        torch.cuda.reset_peak_memory_stats()
        wall, walls, stages = runs.run("façade decode, float32", F32,
                                       lambda: _median3(decode32))
        peak = torch.cuda.max_memory_allocated()
        _say("4 slice", f"float32: card WAV vs float64 WAV "
                        f"{_lsb_contract('song', _wav_i16(wav32), want)}")
        _say("4 slice", f"[{card}] float32 decode wall median "
                        f"{wall * 1e3:.1f} ms of "
                        f"{[round(w * 1e3, 1) for w in walls]} -> "
                        f"{seconds / wall:.1f}x realtime; "
                        f"torch.cuda.max_memory_allocated "
                        f"{peak / 2**20:.1f} MiB")
        _say_stages("4 slice float32", card, stages)

        # K2 on the song's prep: bit for bit its plain version, then timed
        # with its plain version's stages and K1 (CUDA events)
        with open(song, "rb") as f:
            parsed = dh.parse_mp3(f.read())
        prep = dp.prep_to_torch(dp.host_prepare(parsed), dev)
        k2_errs = {}
        k2 = granule_song_phase(dev, card, prep, k2_errs)

        # ---- phase 5: the default decode on the card against the host C++
        # plane, byte for byte, on every golden and crafted stream; float32
        # against float64 on the MPEG-2/2.5 ones. mpeg2_golden.npz holds the
        # reference encoder's LSF layout, which no decoder reads;
        # torch_lsf_golden.npz holds the same PCM through the JAX package's
        # spec-valid LSF writer (pinned by tests/test_torch_host.py)
        g2 = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
        mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
        crafted = np.load(os.path.join(GOLD, "crafted_golden.npz"))
        lsf_names = ("mpeg2_24k_64", "mpeg2_22k05_80", "mpeg25_8k_32")
        streams = [(n, g2[n].tobytes()) for n in lsf_names]
        streams += [(t, mr[f"mp3_{t}"].tobytes()) for t in (
            "32000_64", "32000_192", "44100_128", "48000_96", "48000_320")]
        streams += [("encode_golden", mp3.tobytes())]
        streams += [(n, crafted[n].tobytes()) for n in sorted(crafted.files)]
        files = {n: _write(os.path.join(tmp, f"{n}.mp3"), b)
                 for n, b in streams}
        runs.run("façade decode of the goldens and crafted streams, "
                 "float64 (default)", F64, lambda: [
                     s64.decode_mp3_to_wav(p, os.path.join(tmp, f"{n}64.wav"))
                     for n, p in files.items()])
        for n, p in files.items():
            s_host.decode_mp3_to_wav(p, os.path.join(tmp, f"{n}_host.wav"))
            with open(os.path.join(tmp, f"{n}64.wav"), "rb") as a, \
                    open(os.path.join(tmp, f"{n}_host.wav"), "rb") as b:
                _expect_equal(f"{n}: default card decode vs host C++ plane",
                              a.read(), b.read())
        _say("5 goldens", f"default decode on the card ({runs.last('granule')} "
                          f"K2 and {runs.last()} K1 "
                          f"launches) writes the host C++ plane's WAV bytes "
                          f"on {len(files)} streams: {', '.join(files)}")
        for name in lsf_names:
            s32.decode_mp3_to_wav(files[name],
                                  os.path.join(tmp, f"{name}32.wav"))
            line = _lsb_contract(
                name, _wav_i16(os.path.join(tmp, f"{name}32.wav")),
                _wav_i16(os.path.join(tmp, f"{name}64.wav")),
                TONE_MAX_LSB_RATE)
            parsed = dh.parse_mp3(g2[name].tobytes())
            err = float(np.abs(dp.decode_pcm(parsed, "float32", dev)
                               - dp.decode_pcm(parsed, "float64", dev)).max())
            if not err < 1e-5:
                raise AssertionError(f"{name}: float32 PCM off by {err}")
            _say("5 lsf", f"{name}: float32 {line}; float max |d| {err:.3e}")

        # ---- phase 6: reveal, float64 (default) and float32
        sg = np.load(os.path.join(GOLD, "stego_golden.npz"))
        for key, msg in (("hidden_short", "ddd"),
                         ("hidden_long", sg["msg_long"].tobytes().decode())):
            path = _write(os.path.join(tmp, f"{key}.mp3"), sg[key].tobytes())
            for s in (s64, s32):
                txt = os.path.join(tmp, f"{key}.txt")
                s.reveal_massage(path, txt)
                with open(txt) as f:
                    got = f.read()
                if got != msg:
                    raise AssertionError(f"reveal {key}: {got!r} != {msg!r}")
            _say("6 reveal", f"{key}: {got!r} (float64 and float32)")

        # ---- phases 8-11: the encode and hide path on the same song
        enc_out = encode_phases(dev, card, tmp, song, wav64, s64, s32, runs)

        # ---- phases 12-15: batched decode and encode, VBR, streaming, CLI
        batches = batch_phases(dev, card, tmp, song, wav64, enc_out, s64,
                               runs, errs)

        # ---- phase 19: the mesh: K1 after a halo, the song sharded over
        # 2, 4 and 8 shards, the phase-12 and -13 batches on 4 entries
        mesh_phase(card, tmp, song, batches, runs, errs)
        inputs = {k: batches[k] for k in ("paths", "metas", "jobs")}
        del batches

        # ---- phase 16: the device Huffman decode (the bit-scan kernel)
        huffman_row = huffman_phase(dev, card, tmp, song, enc_out, runs)

        # ---- phase 18: K2 bit for bit its plain version on the synthetic
        # prep, the crafted, LSF, multirate and mono streams and the song's
        # device-Huffman plane
        granule_phase(dev, card, tmp, song, k2_errs)

        # ---- phase 17: K4 bit for bit its plain version on the song, a
        # hide block's 8 windows, the seeded song and the forced-flag lanes;
        # its time at the song's shapes, with its bound
        search_row = search_phase(dev, card, wav64, enc_out, runs, errs)

        # ---- phase 20: K5 bit for bit its plain version on the song and
        # the seeded lanes, timed with its bound; the cost-grid engine's
        # clear, hide and VBR encodes of a 30 s slice and of the goldens
        grid_row = grid_phase(dev, card, tmp, wav64,
                              enc_out["seeded_wav"], runs)

        # ---- phase 22: the frame serializer bit for bit its plain version
        # and the C route on the song's hide, timed with its bound
        serialize_row = serialize_phase(dev, card, wav64, enc_out, runs)

        # ---- phase 21: the engine choice, the pinned transfers, the
        # device-trace readers and decode_pcm through the scan
        engine_phase(dev, card, tmp, song, wav64, enc_out, inputs, runs)

        # ---- phase 7: K1's time on the song's own blocks in both dtypes,
        # beside its plain version and the library pair, each with its bound
        timing = {}
        for dtype in (F32, F64):
            blk = song_blocks(prep, dtype)
            lib = library_pair(blk)
            got = sf.synth_fused(blk)
            lib_out = lib().transpose(1, 2).reshape(got.shape)
            torch.cuda.synchronize()
            # the library sums V and the taps in another order
            lib_err = float((got - lib_out).abs().max())
            lib_tol = (1e-5 if dtype == F32 else 1e-12) * max(
                1.0, float(got.abs().max()))
            if not lib_err < lib_tol:
                raise AssertionError(f"{dtype}: bmm + conv1d vs K1: max |d| "
                                     f"{lib_err} >= {lib_tol}")
            del got, lib_out
            fns = {"kernel": lambda: sf.synth_fused(blk, "int16", 2),
                   "kernel_float": lambda: sf.synth_fused(blk),
                   "plain": lambda: sf.synth_fused_torch(blk, "int16", 2),
                   "library": lib}
            for fn in fns.values():
                fn()
            times = {k: [] for k in fns}
            for which in ("plain", "kernel", "kernel_float", "library",
                          "library", "kernel_float", "kernel", "plain"):
                times[which].append(_time_ms(fns[which], 3 if which ==
                                             "plain" else 20))
            best = {k: min(v) for k, v in times.items()}
            b_i16, by_i16, nb, nops = fused_bound(2, SONG_T, dtype, "int16")
            b_f, by_f, _, _ = fused_bound(2, SONG_T, dtype, "float")
            timing[dtype] = dict(ms=best["kernel"], plain_ms=best["plain"],
                                 library_ms=best["library"], bound_ms=b_i16,
                                 bound_by=by_i16)
            _say("7 K1 time", f"[{card}] {dtype} song blocks "
                              f"{tuple(blk.shape)}: kernel (int16) "
                              f"{times['kernel']} ms, bound {b_i16:.4f} ms by "
                              f"{by_i16} ({nb / 1e6:.1f} MB, "
                              f"{nops / 1e9:.3f} G ops), at "
                              f"{b_i16 / best['kernel']:.1%} of it; kernel "
                              f"(float) {times['kernel_float']} ms, bound "
                              f"{b_f:.4f} ms by {by_f}; plain (int16) "
                              f"{times['plain']} ms (plain/kernel "
                              f"{best['plain'] / best['kernel']:.1f}x); bmm "
                              f"+ grouped conv1d {times['library']} ms "
                              f"(max |d| vs kernel {lib_err:.3e}, tolerance "
                              f"{lib_tol:.1e})")
            del blk, lib, fns
            torch.cuda.empty_cache()

    for name, dtype, counts in runs.log:
        _say("launches", f"{name} ({dtype}): " + ", ".join(
            f"{k} {n}" for k, n in counts.items()))
    print(card)
    print(json.dumps({"kernels": [dict(
        name=f"granule_blocks ({'float32' if dtype == F32 else 'float64'})",
        route="cuda", source="mp3stego_tpu_torch/csrc/granule.cu",
        replaces="mp3stego_tpu/ops/decode_plane.py:729",
        launches=runs.launches("granule", dtype),
        max_abs_err=k2_errs[dtype], **k2[dtype]) for dtype in (F64, F32)]
        + [dict(
        name=f"synth_fused ({'float32' if dtype == F32 else 'float64'})",
        route="cuda", source="mp3stego_tpu_torch/csrc/synth.cu",
        replaces="mp3stego_tpu/ops/pallas_kernels.py:42",
        launches=runs.launches("synth_fused", dtype),
        max_abs_err=errs[dtype], **timing[dtype]) for dtype in (F64, F32)]
        + [huffman_row, search_row, grid_row, serialize_row, dict(
            name="analysis_mdct", route="cuda",
            source="mp3stego_tpu_torch/csrc/analysis.cu",
            replaces="mp3stego_tpu/ops/encode_plane.py:35",
            launches=runs.launches("analysis"), **enc_out["k3"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
