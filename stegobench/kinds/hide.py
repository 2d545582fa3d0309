"""Request kind ``hide``: a message hidden in one file, MP3 bytes in memory
to stego MP3 bytes in memory: the façade's ``hide_message`` without its
temporary WAV file. ``bitstream.decoder_host.parse_mp3`` (the span
``parse_mp3``), ``ops.decode_plane.decode_pcm_i16`` in the configuration's
precision on the card, the PCM as the façade's WAV reader would hold it (a
``utils.wav.WavFile``), then ``models.encoder.MP3Encoder`` with the
message's framed bits (``steganography._frame_message``) on the card. The
request's stages are the decode's and the encoder's. One caller cycles
through the pool in seeded orders.

Each input has its own seeded UTF-8 message (``stego.texts``), sized from
the capacity that the plain reference counts in the PCM the input was
written from: that count is the reference's work, so its seconds
(``reference_s``) are left out of the set-up. The check, after the window:
the decode half against the plain reference decode, sample for sample,
then the stego file against the plain reference encode (``stego.check``).
"""

import time

import numpy as np
import torch

import pool
import reference
import stego


class Workload:
    def __init__(self, cfg, mix, seed, device):
        from mp3stego_tpu_torch.bitstream import decoder_host
        from mp3stego_tpu_torch.models.encoder import MP3Encoder
        from mp3stego_tpu_torch.ops import decode_plane
        from mp3stego_tpu_torch.steganography import _frame_message
        from mp3stego_tpu_torch.utils.wav import WavFile
        self.dh, self.dp = decoder_host, decode_plane
        self.encoder, self.wav, self.frame = MP3Encoder, WavFile, \
            _frame_message
        self.cfg, self.mix, self.device = cfg, mix, device
        self.items = pool.make(cfg, seed, device, keep_pcm=True)
        t = time.perf_counter()
        self.texts = stego.texts(cfg, mix, seed,
                                 [it.pcm for it in self.items])
        self.reference_s = time.perf_counter() - t
        for it in self.items:
            it.pcm = None
        self.order = pool.rng(seed, 1)
        self.sample = pool.rng(seed, 2)
        self.frames_rng = pool.rng(seed, 5)
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
        pcm = self.dp.decode_pcm_i16(parsed, self.device,
                                     self.cfg["precision"], timer=timer)
        ch = parsed.header.channels
        flat = pcm.reshape(-1)
        # as the façade's WAV reader holds it: zero-padded to twice its
        # samples (utils/wav.read_wav over-asks)
        w = self.wav(bitrate=parsed.header.bit_rate // 1000,
                     num_of_channels=ch,
                     samplerate=parsed.header.sampling_rate,
                     num_of_samples=pcm.shape[0],
                     mpeg_mode=0 if ch > 1 else 3,
                     buffer=np.concatenate([flat, np.zeros_like(flat)]))
        bits = self.frame(self.texts[i])
        enc = self.encoder(w, hide_str=bits, device=self.device)
        enc.encode()
        if timer is not None:
            for k, v in enc.timer.times.items():
                timer.times[k] = timer.times.get(k, 0.0) + v
        self._last = (pcm, bytes(enc.out_buffer),
                      enc.hide_str_offset < len(bits) - 1)
        return item.truth.audio_s

    def keep(self, i, n):
        """Keep the answer of the window's request n (pool input i), its
        decoded PCM with it: the first request's, and each other's with the
        mix's ``keep_share``, drawn from the seed."""
        last, self._last = self._last, None
        if last is not None and (n == 0 or self.sample.random()
                                 < self.mix["keep_share"]):
            self.kept.append((i, np.array(last[0])) + last[1:])

    def work(self, i):
        return pool.work(self.items[i])

    def check(self):
        failed, mismatched = 0, 0
        counts = stego.Counts()
        refs = {}
        for k, pcm, out, too_long in self.kept:
            if k not in refs:
                refs[k] = reference.decode(self.items[k].truth, self.device)
                if torch.device(self.device).type == "cuda":
                    torch.cuda.empty_cache()
            bad = pool.differing(pcm, refs[k])
            if bad is None:
                counts.lengths += 1
            else:
                mismatched += bad
            ok = stego.check(out, refs[k], self.cfg["bitrate_kbps"],
                             self.texts[k], too_long, self.mix,
                             self.frames_rng, counts)
            failed += bool(bad is None or bad or not ok)
        return failed, dict(stego.numbers(len(self.kept), counts),
                            mismatched_samples=(mismatched, 0, "<="))

    def close(self):
        self.kept = []
