"""Request kind ``batch_decode``: the whole pool, as files written at
set-up, through ``parallel.decode_files_batched(paths, dtype=<the
configuration's precision>, out="int16")`` in a seeded order each request:
its parse pool, ``prepare_batch_concat`` and one K2 and one K1 launch a
chunk of ``chunk_files``."""

import os
import shutil
import tempfile

import numpy as np

import pool


class Workload:
    def __init__(self, cfg, mix, seed, device):
        from mp3stego_tpu_torch.parallel import decode_files_batched
        self.decode = decode_files_batched
        self.cfg, self.mix, self.device = cfg, mix, device
        self.items = pool.make(cfg, seed, device)
        self.dir = tempfile.mkdtemp(prefix="stegobench-")
        self.paths = []
        for k, item in enumerate(self.items):
            path = os.path.join(self.dir, f"clip{k:03d}.mp3")
            with open(path, "wb") as f:
                f.write(item.data)
            self.paths.append(path)
        self.order = pool.rng(seed, 1)
        self.sample = pool.rng(seed, 2)
        self.orders, self.kept, self._last = {}, [], None
        self.audio_s = sum(it.truth.audio_s for it in self.items)

    def warm(self):
        self.orders[-1] = list(range(len(self.items)))
        self.call(-1, None, {})
        self._last = None

    def schedule(self):
        n = 0
        while True:
            self.orders[n] = [int(k) for k in
                              self.order.permutation(len(self.items))]
            yield n
            n += 1

    def call(self, i, timer, spans):
        order = self.orders[i]
        outs = self.decode([self.paths[k] for k in order],
                           dtype=self.cfg["precision"], out="int16",
                           device=self.device,
                           chunk_files=self.mix["chunk_files"])
        self._last = list(zip(order, outs))
        return self.audio_s

    def keep(self, i, n):
        """Copy every file's answer of the window's request n: the first
        request's, and each other's with the mix's ``keep_share``, drawn
        from the seed."""
        last, self._last = self._last, None
        if last is not None and (n == 0 or self.sample.random()
                                 < self.mix["keep_share"]):
            self.kept.extend((k, np.array(pcm)) for k, pcm in last)

    def work(self, i):
        chunks = -(-len(self.items) // self.mix["chunk_files"])
        one = [pool.work(it) for it in self.items]
        return dict(granules=sum(w["granules"] for w in one),
                    escapes=sum(w["escapes"] for w in one),
                    launches=chunks)

    def check(self):
        return pool.check(self.kept, self.items, self.device)

    def close(self):
        self.kept = []
        shutil.rmtree(self.dir, ignore_errors=True)
