"""Request kind ``decode_f32``: ``kinds/decode.py``'s request on the
configuration's pool in the mix's ``precision`` (float32, as ML pipelines
load audio): ``parse_mp3``, then ``decode_pcm_i16(..., "float32")``. The
check holds each kept answer to the plain reference's float64 decode
(``reference.decode``) within the mix's limits: at most ``max_abs_lsb``
off in any sample and at most ``mismatched_share`` of the samples off at
all. The reference decodes every song of the pool once, after the warm-up
(``reference_s``, which the set-up leaves out), and a kept answer is
compared with it as it is kept, between requests, leaving its numbers and
not a copy of its PCM. The process serves with one intra-op thread from
the warm-up on, as ``kinds/decode_lame.py`` says.

The control, asked for by the configuration key ``control`` (which
``readings_f32.py`` and the tests set, to "bfloat16"), answers each
request with the plain reference computed in that lower precision
(``control_decode``) in place of the program."""

import time

import numpy as np
import torch

import core
import reference
from mp3gen import Truth

_decode = core.load("kinds", "decode")


def control_decode(truth: Truth, device, dtype) -> np.ndarray:
    """``reference.decode`` with every table and sum in ``dtype``."""
    t = {name: torch.as_tensor(v, dtype=torch.float64, device=device)
         .to(dtype) for name, v in reference._tables().items()}
    raw = torch.as_tensor(truth.ix, device=device).to(torch.int64)
    gg = torch.as_tensor(truth.gg, device=device).to(torch.int64)
    nch, tt = raw.shape[0], raw.shape[1]
    sign = torch.where(raw < 0, -1.0, 1.0).to(dtype)
    x = (sign * t["pow43"][raw.abs()]) * t["exp1"][
        gg - 210 + reference._EXP_OFF][..., None]
    sb = torch.arange(1, 32, device=device)[:, None]
    s = torch.arange(8, device=device)[None, :]
    lo_i = (18 * sb - s - 1).reshape(-1)
    hi_i = (18 * sb + s).reshape(-1)
    lo, hi = x[..., lo_i], x[..., hi_i]
    x = x.clone()
    x[..., lo_i] = lo * t["cs"] - hi * t["ca"]
    x[..., hi_i] = hi * t["cs"] + lo * t["ca"]
    s18 = x.reshape(nch, tt, 32, 18)
    xi = torch.zeros((nch, tt, 32, 36), dtype=dtype, device=device)
    for k in range(18):
        xi = xi + s18[..., k, None] * t["c_long"][:, k]
    blk = xi * t["sine"]
    prev = torch.cat([torch.zeros_like(blk[:, :1, :, 18:]),
                      blk[:, :-1, :, 18:]], 1)
    y = (blk[..., :18] + prev).reshape(nch, tt, 576) * t["inv"]
    del xi, blk, prev, x
    st = y.reshape(nch, tt, 32, 18).transpose(2, 3).reshape(nch, tt * 18, 32)
    v = torch.zeros((nch, tt * 18, 64), dtype=dtype, device=device)
    for j in range(32):
        v = v + st[..., j, None] * t["n_mat"][:, j]
    pad = torch.zeros((nch, 15, 32), dtype=dtype, device=device)
    halves = (torch.cat([pad, v[..., :32]], 1),
              torch.cat([pad, v[..., 32:]], 1))
    steps = tt * 18
    pcm = torch.zeros((nch, steps, 32), dtype=dtype, device=device)
    for j in range(16):
        pcm = pcm + halves[j % 2][:, 15 - j:15 - j + steps] * t["d_win"][j]
    del v, halves
    out = (pcm.reshape(nch, tt * 576).to(torch.float64) * 32767.0) \
        .clamp(-32768.0, 32767.0)
    return out.to(torch.int16).T.contiguous().cpu().numpy()


# samples a comparison takes at a time (its int32 differences, 4 MB)
CHUNK = 1 << 20


def compare(got: np.ndarray, want: np.ndarray):
    """(largest difference in LSB, samples that differ, samples) of one
    answer against its reference, a ``CHUNK`` at a time; None where the
    shapes differ."""
    if got.shape != want.shape:
        return None
    g, w = got.reshape(-1), want.reshape(-1)
    big, n_off = 0, 0
    for a in range(0, g.size, CHUNK):
        d = np.subtract(g[a:a + CHUNK], w[a:a + CHUNK], dtype=np.int32)
        np.abs(d, out=d)
        big = max(big, int(d.max(initial=0)))
        n_off += int(np.count_nonzero(d))
    return big, n_off, g.size


def check(kept, mix) -> tuple:
    """The kept answers' ``compare`` numbers against the float64 reference:
    the largest difference in LSB and the share of samples that differ,
    each beside the mix's limit. An answer fails where either is over its
    limit or its length differs."""
    failed, lengths_off = 0, 0
    worst, off, total = 0, 0, 0
    share_limit = mix["mismatched_share"]
    for got in kept:
        if got is None:
            lengths_off += 1
            failed += 1
            continue
        big, n_off, size = got
        worst, off, total = max(worst, big), off + n_off, total + size
        failed += big > mix["max_abs_lsb"] or n_off > share_limit * size
    return failed, dict(
        compared_answers=(len(kept), 1, ">="),
        length_errors=(lengths_off, 0, "<="),
        max_abs_lsb=(worst, mix["max_abs_lsb"], "<="),
        mismatched_share=(off / total if total else 0.0, share_limit, "<="))


class Workload(_decode.Workload):
    def __init__(self, cfg, mix, seed, device):
        super().__init__(dict(cfg, precision=mix["precision"]), mix, seed,
                         device)
        self.control = getattr(torch, cfg["control"]) \
            if cfg.get("control") else None
        self.refs, self.threads = [], None

    def warm(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)
        super().warm()
        t = time.perf_counter()
        for item in self.items:
            self.refs.append(reference.decode(item.truth, self.device))
            if torch.device(self.device).type == "cuda":
                torch.cuda.empty_cache()
        self.reference_s = time.perf_counter() - t

    def call(self, i, timer, spans):
        if self.control is None:
            return super().call(i, timer, spans)
        item = self.items[i]
        self._last = control_decode(item.truth, self.device, self.control)
        return item.truth.audio_s

    def keep(self, i, n):
        """Compare the answer of the window's request n (pool input i) with
        the reference: the first request's, and each other's with the
        mix's ``keep_share``, drawn from the seed."""
        last, self._last = self._last, None
        if last is not None and (n == 0 or self.sample.random()
                                 < self.mix["keep_share"]):
            self.kept.append(compare(last, self.refs[i]))

    def check(self):
        return check(self.kept, self.mix)

    def close(self):
        self.kept, self.refs = [], []
        if self.threads:
            torch.set_num_threads(self.threads)
