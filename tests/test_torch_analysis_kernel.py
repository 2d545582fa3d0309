"""The Q31 analysis wrapper (``ops/encode_plane.analysis_stream``) on the
CPU, where it takes its plain version, against the JAX package; and the
identities the CUDA kernel (``csrc/analysis.cu``) relies on.

* A CPU tensor takes ``analysis_stream_torch`` and launches nothing.
* A streaming window's slice with ``skip=1`` equals the JAX package's
  ``run_analysis`` on the whole stream for those granules (noise, a
  full-scale square wave whose sums wrap, music), at several chunk sizes;
  mono and 1-granule streams likewise.
* The tables fit int32, and ``fx.mul`` is the high word of the 64-bit
  product (the kernel's ``__mulhi``) on the tables' values times int16 << 16
  extremes and int32 extremes.
* The wrapper's refusals that precede any dispatch.

Tolerance: exact (bitwise) everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend
torch.set_num_threads(1)

from mp3stego_tpu.ops import encode_plane as JEP  # noqa: E402
from mp3stego_tpu_torch import tables as T  # noqa: E402
from mp3stego_tpu_torch.ops import encode_plane as EP  # noqa: E402
from mp3stego_tpu_torch.ops import fixedpoint as fx  # noqa: E402

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _pcm(kind: str, ch: int, n: int, seed: int = 0) -> np.ndarray:
    """(ch, n) int16 streams."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if kind == "noise":
        return rng.integers(-32768, 32768, size=(ch, n)).astype(np.int16)
    if kind == "square":       # full-scale: the Q31 sums overflow and wrap
        sq = np.where((t // 50) % 2 == 0, 32767, -32768)
        return np.stack([np.roll(sq, 17 * c) for c in range(ch)]) \
            .astype(np.int16)
    sig = (0.6 * np.sin(2 * np.pi * 440 * t / 44100)
           + 0.3 * np.sin(2 * np.pi * 3111 * t / 44100)
           + 0.05 * rng.standard_normal(n))
    return np.clip(np.stack([sig, sig[::-1]][:ch]) * 30000, -32768,
                   32767).astype(np.int16)


def _jax(pcm: np.ndarray, tg: int) -> np.ndarray:
    return JEP.run_analysis(pcm.astype(np.int32) << 16, tg)


@pytest.mark.parametrize("skip", [0, 1])
def test_cpu_tensor_takes_the_plain_version(skip):
    full = torch.from_numpy(EP._padded_streams(_pcm("noise", 2, 9 * 576), 9))
    before = EP.launches
    got = EP.analysis_stream(full, skip=skip)
    assert EP.launches == before
    assert got.dtype == torch.int32 and got.shape == (2, 9 - skip, 576)
    assert torch.equal(got, EP.analysis_stream_torch(full, skip=skip))


@pytest.mark.parametrize("chunk_g", [3, 1024])
@pytest.mark.parametrize("kind", ["noise", "square", "music"])
def test_window_slice_equals_jax_whole_stream(kind, chunk_g):
    """Granules [lo, hi) of a 30-granule stream from their slice with one
    granule of MDCT context and 480 samples of history (``skip=1``), as
    ``models/streaming`` cuts a window."""
    tg, lo, hi = 30, 11, 25
    pcm = _pcm(kind, 2, tg * 576 - 100, seed=4)
    want = _jax(pcm, tg)
    full = EP._padded_streams(pcm, tg)
    win = torch.from_numpy(full[:, (lo - 1) * 576:hi * 576 + EP._PAST])
    got = EP.analysis_stream(win, chunk_g, skip=1)
    assert got.shape == (2, hi - lo, 576)
    assert np.array_equal(got.numpy(), want[:, lo:hi])
    whole = EP.analysis_stream(torch.from_numpy(full), chunk_g)
    assert np.array_equal(whole.numpy(), want)
    if kind == "square":       # the wrap is really exercised
        assert np.abs(want.astype(np.int64)).max() > 2 ** 30


@pytest.mark.parametrize("ch,tg", [(1, 5), (2, 1), (1, 1)])
def test_mono_and_one_granule_equal_jax(ch, tg):
    pcm = _pcm("music", ch, tg * 576, seed=ch + tg)
    got = EP.run_analysis_device(pcm, tg, "cpu")
    assert got.shape == (ch, tg, 576)
    assert np.array_equal(got.numpy(), _jax(pcm, tg))
    native = EP.run_analysis_native(pcm, tg)
    assert native is not None and np.array_equal(got.numpy(), native)


def test_skip_past_the_stream_is_empty():
    full = torch.from_numpy(EP._padded_streams(_pcm("noise", 2, 576), 1))
    got = EP.analysis_stream(full, skip=1)
    assert got.shape == (2, 0, 576) and got.dtype == torch.int32


@pytest.mark.parametrize("name", ["window", "filter", "cos", "cs", "ca"])
def test_tables_fit_int32(name):
    a = np.asarray({"window": T.ENWINDOW, "filter": T.subband_filter_fixed(),
                    "cos": T.mdct_cos_fixed(), "cs": T.MDCT_CS_FIX,
                    "ca": T.MDCT_CA_FIX}[name], np.int64)
    assert a.min() >= I32_MIN and a.max() <= I32_MAX
    win, fl, cos_l, cs, ca = EP._kernel_tables(torch.device("cpu"))
    kernel = {"window": win.numpy(), "filter": fl.numpy(), "cos": cos_l,
              "cs": cs, "ca": ca}[name]
    assert kernel.dtype == np.int32 and kernel.flags.c_contiguous
    assert np.array_equal(kernel.reshape(a.shape), a)


def _mulhi(a: int, b: int) -> int:
    """The high word of the exact 64-bit product, as an int32."""
    hi = (a * b) >> 32
    assert I32_MIN <= hi <= I32_MAX
    return hi


@pytest.mark.parametrize("name,operands", [
    ("window", [s << 16 for s in (-32768, -32767, -1, 0, 1, 32766, 32767)]),
    ("filter", [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX]),
    ("cos", [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX]),
])
def test_mul_is_the_high_word_of_the_product(name, operands):
    """``fx.mul`` on the tables' values against Python's exact integers:
    the kernel's ``__mulhi`` identity."""
    tab = np.asarray({"window": T.ENWINDOW, "filter": T.subband_filter_fixed(),
                      "cos": T.mdct_cos_fixed()}[name], np.int64).reshape(-1)
    a, b = np.meshgrid(tab, np.asarray(operands, np.int64))
    got = fx.mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.array([_mulhi(int(x), int(y))
                     for x, y in zip(a.reshape(-1), b.reshape(-1))])
    assert np.array_equal(got.reshape(-1), want)


def test_butterfly_and_inversion_wrap_like_the_kernel():
    """``fx.cmuls`` keeps the low 32 bits of the int64 sum shifted right by
    31 even where that sum wraps (the kernel sums in unsigned 64-bit), and
    the inversion of INT32_MIN stays INT32_MIN (the kernel's 0u - v)."""
    cs = np.asarray(T.MDCT_CS_FIX, np.int64)
    ca = np.asarray(T.MDCT_CA_FIX, np.int64)
    ext = [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX]
    bu, bd = (g.reshape(-1) for g in np.meshgrid(ext, ext))
    for i in range(8):
        re, im = fx.cmuls(torch.from_numpy(bu), torch.from_numpy(bd),
                          int(cs[i]), int(ca[i]))
        for k in range(len(bu)):
            x, y = int(bu[k]), int(bd[k])
            for got, exact in ((re, x * int(cs[i]) - y * int(ca[i])),
                               (im, x * int(ca[i]) + y * int(cs[i]))):
                wrapped = (exact + 2 ** 63) % 2 ** 64 - 2 ** 63
                low = (wrapped >> 31) % 2 ** 32
                assert int(got[k]) % 2 ** 32 == low
    v = torch.tensor([I32_MIN, -5, 7, I32_MAX], dtype=torch.int32)
    assert np.array_equal((-v).numpy().astype(np.int64) % 2 ** 32,
                          (0 - v.numpy().astype(np.int64)) % 2 ** 32)


REFUSALS = [
    ("int32", lambda f: f.to(torch.int32), 0, "int16"),
    ("1-D", lambda f: f[0], 0, "int16"),
    ("no channel", lambda f: f[:0], 0, "int16"),
    ("mis-sized", lambda f: f[:, :-1], 0, "480"),
    ("short", lambda f: f[:, :100], 0, "480"),
    ("negative skip", lambda f: f, -1, "skip"),
    ("meta device", lambda f: torch.empty(f.shape, dtype=f.dtype,
                                          device="meta"), 0, "CPU or CUDA"),
]


@pytest.mark.parametrize("name,make,skip,match", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_wrapper_refuses_before_dispatch(name, make, skip, match):
    full = torch.from_numpy(EP._padded_streams(_pcm("noise", 2, 576), 2))
    before = EP.launches
    with pytest.raises(ValueError, match=match):
        EP.analysis_stream(make(full), skip=skip)
    assert EP.launches == before
