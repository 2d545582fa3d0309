"""A configuration's pool of inputs, made from the seed, and the check of
decoded answers against the plain reference.

Every input of a pool is ``length_s`` long, the same for every seed; the
seed chooses the content and the order. So two seeds give the same work in
another order.
"""

from dataclasses import dataclass

import numpy as np
import torch

import mp3gen
import reference


@dataclass
class Item:
    data: bytes
    truth: mp3gen.Truth
    pcm: np.ndarray = None       # the (n, 2) int16 PCM it was written from


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one purpose (``stream``)."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def make(cfg: dict, seed: int, device, keep_pcm: bool = False) -> list:
    """The pool: each input's PCM made on ``device`` from its own seed,
    then written as an MP3 file by the benchmark's own writer; with
    ``keep_pcm`` each item keeps that PCM on the host."""
    seeds = rng(seed, 0).integers(0, 1 << 62, size=cfg["pool"])
    items = []
    for s in seeds:
        pcm = mp3gen.song_pcm(cfg["length_s"], int(s), device)
        data, truth = mp3gen.encode(pcm, cfg["bitrate_kbps"])
        items.append(Item(data, truth,
                          pcm.cpu().numpy() if keep_pcm else None))
        del pcm
    return items


def work(item: Item, launches: int = 1) -> dict:
    """The shapes the kernel bounds read: granules a channel, escapes,
    launches."""
    t = item.truth.ix.shape[1]
    return dict(granules=t, escapes=item.truth.escapes, launches=launches)


def differing(got: np.ndarray, want: np.ndarray):
    """Samples that differ, or None where the shapes do."""
    if got.shape != want.shape:
        return None
    return int(np.count_nonzero(got != want))


def check(kept: list, items: list, device) -> tuple:
    """Compare each kept answer, (pool index, int16 PCM), with the plain
    reference's decode of that input, sample for sample. Returns (answers
    that failed, the compared numbers as {name: (value, limit, op)})."""
    refs, failed, mismatched, lengths_off = {}, 0, 0, 0
    for k, got in kept:
        if k not in refs:
            refs[k] = reference.decode(items[k].truth, device)
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        bad = differing(got, refs[k])
        if bad is None:
            lengths_off += 1
            failed += 1
            continue
        mismatched += bad
        failed += bad > 0
    return failed, dict(
        compared_answers=(len(kept), 1, ">="),
        length_errors=(lengths_off, 0, "<="),
        mismatched_samples=(mismatched, 0, "<="))
