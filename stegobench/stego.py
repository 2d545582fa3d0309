"""A hide's messages and its check: each input's seeded message, sized
from the input's capacity as the plain reference counts it, and the check
of a stego file against the plain reference encode.

The check: the file's length; the message read back from the file's side
information (one bit a nonzero table selection); and frames of the file
against ``ref_encode.FrameEncoder``, byte for byte: the first
``start_frames`` from the file's start, then ``sampled_frames`` drawn from
the seed, each from the state the file's earlier frames record
(``ref_encode.state_at``).
"""

import numpy as np

import pool
import ref_encode as RE

_LETTERS = "abcdefghijklmnopqrstuvwxyz" * 3 + "éüßøλжが"


def message(rng: np.random.Generator, nbits: int) -> str:
    """Seeded UTF-8 text whose framed bits ("{len}#{text}", 8 a byte) are
    at most ``nbits``: words of 1 to 9 letters, some of them multi-byte."""
    words = []
    while True:
        w = "".join(rng.choice(list(_LETTERS), size=int(rng.integers(1, 10))))
        text = " ".join(words + [w])
        if 8 * len(f"{len(text)}#{text}".encode()) > nbits:
            return " ".join(words)
        words.append(w)


def framed(text: str) -> str:
    """The message's framed bits, MSB first: "{len}#{text}" in UTF-8."""
    return "".join(format(b, "08b") for b in f"{len(text)}#{text}".encode())


def capacity(pcm: np.ndarray, kbps: int, frames: int,
             rng: np.random.Generator) -> int:
    """The stego bits of a clear re-encode of ``pcm`` (the nonzero table
    selections, as ``message_capacity`` counts them), estimated by the plain
    reference from ``frames`` seeded frames."""
    fe = RE.FrameEncoder(pcm, kbps)
    picks = rng.choice(fe.frames, size=min(frames, fe.frames), replace=False)
    tables = 0
    for f in picks:
        state = RE.State()
        fe.encode(int(f), state)
        tables += sum(t > 0 for row in state.slots for gi in row
                      for t in gi.table_select)
    return int(tables / len(picks) * fe.frames)


def texts(cfg: dict, mix: dict, seed: int, pcms: list) -> list:
    """Each input's message: its framed bits fill a fixed share of its
    capacity, the shares being the quantiles (k + 0.5) / n of
    [``share_min``, ``share_max``] dealt to the inputs in a seeded order."""
    n = len(pcms)
    lo, hi = mix["share_min"], mix["share_max"]
    shares = [lo + (hi - lo) * (k + 0.5) / n for k in range(n)]
    deal = pool.rng(seed, 3).permutation(n)
    words = pool.rng(seed, 4)
    caps = pool.rng(seed, 6)
    return [message(words, int(shares[int(deal[k])] * capacity(
        pcms[k], cfg["bitrate_kbps"], mix["capacity_frames"], caps)))
        for k in range(n)]


class Counts:
    """The compared numbers of a hide check, summed over its answers."""

    def __init__(self):
        self.lengths = self.message = self.frames_bad = self.frames = 0

    def frame(self, out: bytes, start, data: bytes) -> bool:
        self.frames += 1
        same = out[int(start):int(start) + len(data)] == data
        self.frames_bad += not same
        return same


def check(out: bytes, pcm: np.ndarray, kbps: int, text: str,
          too_long: bool, mix: dict, rng: np.random.Generator,
          counts: Counts) -> bool:
    """Whether the stego file ``out`` is the plain reference's hide of
    ``text`` in ``pcm``, as far as the check reads it."""
    bits = framed(text)
    fe = RE.FrameEncoder(pcm, kbps, bits)
    starts = fe.starts()
    if len(out) != int(fe.frame_bits.sum()) // 32 * 4:
        counts.lengths += 1
        return False
    whole = int(np.searchsorted(starts + fe.frame_bits // 8, len(out),
                                side="right"))
    si = RE.side_info(out, starts[:whole])
    got = RE.stego_bits(si)
    n = min(len(bits), len(got))
    # the last framed bit need not land (the façade's too_long contract)
    wrong = sum(a != b for a, b in zip(bits[:n], got[:n])) \
        + max(0, len(bits) - 1 - len(got)) + int(too_long)
    counts.message += wrong
    ok = wrong == 0
    first = min(mix["start_frames"], whole)
    state = RE.State()
    for f in range(first):
        data, state = fe.encode(f, state)
        ok &= counts.frame(out, starts[f], data)
    done = 0
    for f in rng.permutation(np.arange(first, whole)):
        state = RE.state_at(si, int(f))
        if state is None:
            continue
        data, _ = fe.encode(int(f), state)
        ok &= counts.frame(out, starts[f], data)
        done += 1
        if done == mix["sampled_frames"]:
            break
    return ok


def numbers(kept: int, counts: Counts) -> dict:
    return dict(
        compared_answers=(kept, 1, ">="),
        compared_frames=(counts.frames, 1, ">="),
        length_errors=(counts.lengths, 0, "<="),
        message_bits_wrong=(counts.message, 0, "<="),
        frames_differing=(counts.frames_bad, 0, "<="))
