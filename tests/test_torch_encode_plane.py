"""The port's encode analysis plane against the JAX package's, on the CPU.

* ``ops/fixedpoint``: torch and NumPy forms against the JAX package's
  ``fixedpoint`` on edge values (INT32_MIN/MAX, products that overflow int32).
* ``encode_plane.analysis_mdct`` (through ``run_analysis_device``) against
  JAX ``run_analysis`` and the native ``encode_analysis`` on seeded PCM,
  including full-scale square waves whose Q31 sums wrap, chunked against
  whole, and against ``encode_golden`` ``mdct_freq``.
* ``search_plane.scfsi_sums`` against JAX ``_scfsi_sums``.

Tolerance: exact (bitwise) everywhere.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mp3stego_tpu.ops import encode_plane as JEP  # noqa: E402
from mp3stego_tpu.ops import fixedpoint as jfx  # noqa: E402
from mp3stego_tpu.ops import search_plane as JSP  # noqa: E402
from mp3stego_tpu_torch.ops import encode_plane as EP  # noqa: E402
from mp3stego_tpu_torch.ops import fixedpoint as fx  # noqa: E402
from mp3stego_tpu_torch.ops import search_plane as SP  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
EDGE = np.array([I32_MIN, I32_MIN + 1, -65536, -1, 0, 1, 65535, I32_MAX - 1,
                 I32_MAX], np.int64)


def _pcm(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """(2, n) int16 test streams."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if kind == "noise":
        return rng.integers(-32768, 32768, size=(2, n)).astype(np.int16)
    if kind == "square":       # full-scale: the Q31 sums overflow and wrap
        sq = np.where((t // 50) % 2 == 0, 32767, -32768)
        return np.stack([sq, np.roll(sq, 17)]).astype(np.int16)
    if kind == "music":
        sig = (0.6 * np.sin(2 * np.pi * 440 * t / 44100)
               + 0.3 * np.sin(2 * np.pi * 3111 * t / 44100)
               + 0.05 * rng.standard_normal(n))
        return np.clip(np.stack([sig, sig[::-1]]) * 30000, -32768,
                       32767).astype(np.int16)
    raise ValueError(kind)


@pytest.mark.parametrize("name", ["mul", "mulr", "mulsr"])
def test_fixedpoint_matches_jax(name):
    a, b = np.meshgrid(EDGE, EDGE)
    want = np.asarray(getattr(jfx, name)(jnp.asarray(a), jnp.asarray(b),
                                         xp=jnp))
    got_t = getattr(fx, name)(torch.from_numpy(a), torch.from_numpy(b))
    got_n = getattr(fx, name)(a, b)
    assert got_t.dtype == torch.int32 and got_n.dtype == np.int32
    assert np.array_equal(got_t.numpy(), want)
    assert np.array_equal(got_n, want)


def test_fixedpoint_cmuls_matches_jax():
    grid = np.stack(np.meshgrid(EDGE, EDGE, EDGE, EDGE), 0).reshape(4, -1)
    want = jfx.cmuls(*(jnp.asarray(g) for g in grid), xp=jnp)
    got_t = fx.cmuls(*(torch.from_numpy(g) for g in grid))
    got_n = fx.cmuls(*grid)
    for w, t, n in zip(want, got_t, got_n):
        assert np.array_equal(t.numpy(), np.asarray(w))
        assert np.array_equal(n, np.asarray(w))


def test_int32_sum_paths_wrap_alike():
    """Both ways the plane sums int32 terms wrap mod 2^32: a sum with
    dtype=int32 and an int64 sum narrowed with .to(int32)."""
    x = torch.from_numpy(np.full((3, 1000), I32_MAX - 5, np.int32))
    want = np.full(3, (1000 * (I32_MAX - 5)) % 2 ** 32, np.int64)
    want = np.where(want >= 2 ** 31, want - 2 ** 32, want)
    assert np.array_equal(x.sum(dim=1, dtype=torch.int32).numpy(), want)
    assert np.array_equal(x.to(torch.int64).sum(dim=1).to(torch.int32)
                          .numpy(), want)
    cs = x.to(torch.int64).cumsum(dim=1).to(torch.int32)[:, -1]
    assert np.array_equal(cs.numpy(), want)


@pytest.mark.parametrize("kind", ["noise", "square", "music"])
def test_analysis_matches_jax_and_native(kind):
    tg = 24
    pcm = _pcm(kind, tg * 576 - 333, seed=3)
    got = EP.run_analysis_device(pcm, tg, "cpu")
    assert got.dtype == torch.int32 and got.shape == (2, tg, 576)
    got = got.numpy()
    want = JEP.run_analysis(pcm.astype(np.int32) << 16, tg)
    assert np.array_equal(got, want)
    native = EP.run_analysis_native(pcm, tg)
    assert native is not None and np.array_equal(got, native)
    if kind == "square":       # the wrap is really exercised
        assert np.abs(got.astype(np.int64)).max() > 2 ** 30


@pytest.mark.parametrize("chunk_g", [1, 2, 5, 7, 64])
def test_analysis_chunked_equals_whole(chunk_g):
    tg = 19
    pcm = _pcm("square", tg * 576, seed=1)
    pcm[:, ::7] = _pcm("noise", tg * 576, seed=2)[:, ::7]
    whole = EP.run_analysis_device(pcm, tg, "cpu", chunk_g=tg)
    chunked = EP.run_analysis_device(pcm, tg, "cpu", chunk_g=chunk_g)
    assert torch.equal(whole, chunked)


def test_analysis_matches_encode_golden():
    wav = np.load(os.path.join(GOLD, "stego_golden.npz"))["wav_bytes"]
    pcm = np.frombuffer(wav.tobytes()[44:], np.int16)
    streams = np.stack([pcm[0::2], pcm[1::2]])
    want = np.load(os.path.join(GOLD, "encode_golden.npz"))["mdct_freq"]
    nf = want.shape[0]
    got = EP.run_analysis_device(streams, 2 * nf, "cpu").numpy()
    # golden layout (frame, ch, gr, 576); plane layout (ch, frame*2 + gr, 576)
    assert np.array_equal(got.reshape(2, nf, 2, 576).transpose(1, 0, 2, 3),
                          want)


@pytest.mark.parametrize("sr_idx", [0, 3, 8, 14])
@pytest.mark.parametrize("kind", ["square", "noise"])
def test_scfsi_sums_match_jax(kind, sr_idx):
    xr = EP.run_analysis_device(_pcm(kind, 16 * 576, seed=5), 16, "cpu")
    xr = xr.reshape(-1, 576)
    tot, en = SP.scfsi_sums(xr, sr_idx)
    jt, je = JSP._scfsi_sums(jnp.asarray(xr.numpy()), sr_idx)
    assert tot.dtype == torch.int32 and en.shape == (xr.shape[0], 21)
    assert np.array_equal(tot.numpy(), np.asarray(jt))
    assert np.array_equal(en.numpy(), np.asarray(je))
