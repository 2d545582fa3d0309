"""Request kind ``decode_lame``: ``kinds/decode.py``'s request, one file's
MP3 bytes in memory to its int16 PCM in memory (``parse_mp3``, then
``decode_pcm_i16`` in the configuration's precision), on a pool of songs
as LAME writes them (``mp3gen_lame``), each checked sample for sample
against ``reference_lame``.

The reference decodes every song of the pool once, after the warm-up
(its seconds are ``reference_s``, which the set-up leaves out), and a kept
answer is compared with it as it is kept, between requests: what a kept
answer leaves is its count of differing samples, not a copy of its PCM,
so the host's memory stays level through the window.

The process serves with one intra-op thread (``torch.set_num_threads(1)``
from the warm-up, restored at ``close``), as a worker with one caller
is set up: the request's host half is one thread's work, and a host
copy that torch spread over its pool would wait for its slowest thread,
on a machine whose cores are shared, the cell's tail."""

import time

import torch

import core
import mp3gen_lame
import pool
import reference_lame

_decode = core.load("kinds", "decode")


def make(cfg, seed, device) -> list:
    """The pool: each song's PCM made on ``device`` from its own seed, then
    written by ``mp3gen_lame``."""
    seeds = pool.rng(seed, 0).integers(0, 1 << 62, size=cfg["pool"])
    items = []
    for s in seeds:
        pcm = mp3gen_lame.lame_pcm(cfg["length_s"], int(s), device)
        data, truth = mp3gen_lame.encode(pcm, cfg["bitrate_kbps"])
        items.append(pool.Item(data, truth))
        del pcm
    return items


def work(item) -> dict:
    """The shapes the kernel bounds read: granules a channel, escapes,
    launches, and the short (channel, granule)s and mid/side granules."""
    t = item.truth
    return dict(granules=t.ix.shape[1], escapes=t.escapes, launches=1,
                short_granules=t.short_granules, ms_granules=t.ms_granules)


def check(kept) -> tuple:
    """The kept answers' differing samples (None where the length
    differs) as ``pool.check``'s compared numbers."""
    failed, mismatched, lengths_off = 0, 0, 0
    for bad in kept:
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


class Workload(_decode.Workload):
    def __init__(self, cfg, mix, seed, device):
        from mp3stego_tpu_torch.bitstream import decoder_host
        from mp3stego_tpu_torch.ops import decode_plane
        self.dh, self.dp = decoder_host, decode_plane
        self.cfg, self.mix, self.device = cfg, mix, device
        self.items = make(cfg, seed, device)
        self.order = pool.rng(seed, 1)
        self.sample = pool.rng(seed, 2)
        self.kept, self._last, self.refs = [], None, []
        self.threads = None

    def warm(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)
        super().warm()
        t = time.perf_counter()
        for item in self.items:
            self.refs.append(reference_lame.decode(item.truth, self.device))
            if torch.device(self.device).type == "cuda":
                torch.cuda.empty_cache()
        self.reference_s = time.perf_counter() - t

    def keep(self, i, n):
        """Compare the answer of the window's request n (pool input i) with
        the reference: the first request's, and each other's with the
        mix's ``keep_share``, drawn from the seed."""
        last, self._last = self._last, None
        if last is not None and (n == 0 or self.sample.random()
                                 < self.mix["keep_share"]):
            self.kept.append(pool.differing(last, self.refs[i]))

    def work(self, i):
        return work(self.items[i])

    def check(self):
        return check(self.kept)

    def close(self):
        self.kept, self.refs = [], []
        if self.threads:
            torch.set_num_threads(self.threads)
