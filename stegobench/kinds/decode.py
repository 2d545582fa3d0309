"""Request kind ``decode``: one file's MP3 bytes in memory to its int16 PCM
in memory, as the façade decodes but without its WAV file:
``bitstream.decoder_host.parse_mp3`` (the benchmark's span ``parse_mp3``),
then ``ops.decode_plane.decode_pcm_i16`` in the configuration's precision
on the card (its stages ``host_prepare``, ``h2d``, ``device plane``,
``d2h``). One caller cycles through the pool in seeded orders."""

import time

import numpy as np
import torch

import pool


class Workload:
    def __init__(self, cfg, mix, seed, device):
        from mp3stego_tpu_torch.bitstream import decoder_host
        from mp3stego_tpu_torch.ops import decode_plane
        self.dh, self.dp = decoder_host, decode_plane
        self.cfg, self.mix, self.device = cfg, mix, device
        self.items = pool.make(cfg, seed, device)
        self.order = pool.rng(seed, 1)
        self.sample = pool.rng(seed, 2)
        self.kept, self._last = [], None

    def warm(self):
        for k in range(len(self.items)):
            self.call(k, None, {})
        self._last = None

    def schedule(self):
        while True:
            yield from (int(k) for k in
                        self.order.permutation(len(self.items)))

    def call(self, i, timer, spans):
        item = self.items[i]
        t = time.perf_counter()
        with torch.profiler.record_function("parse_mp3"):
            parsed = self.dh.parse_mp3(item.data)
        spans["parse_mp3"] = time.perf_counter() - t
        self._last = self.dp.decode_pcm_i16(
            parsed, self.device, self.cfg["precision"], timer=timer)
        return item.truth.audio_s

    def keep(self, i, n):
        """Copy the answer of the window's request n (pool input i) for the
        check: the first request's, and each other's with the mix's
        ``keep_share``, drawn from the seed."""
        last, self._last = self._last, None
        if last is not None and (n == 0 or self.sample.random()
                                 < self.mix["keep_share"]):
            self.kept.append((i, np.array(last)))

    def work(self, i):
        return pool.work(self.items[i])

    def check(self):
        return pool.check(self.kept, self.items, self.device)

    def close(self):
        self.kept = []
