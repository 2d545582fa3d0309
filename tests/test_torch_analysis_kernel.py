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
* ``analysis_interleaved`` on a CPU tensor (the WAV's interleaved buffer)
  equals the stream route on the channels ``MP3Encoder._channel_streams_i16``
  builds, and the encoder's ``_analysis_device`` equals its old route.
* The kernel's source itself, built for the host with g++ against the
  emulation of ``tests/cuda_host_shim.py`` (one thread per CUDA thread,
  ``cp.async`` a plain copy) and launched through the wrapper's own launch
  code on a grid of one or two emulated SMs, equals ``analysis_stream_torch``
  and the JAX package's ``analysis_mdct_i16`` on stereo, mono, one granule,
  the full-scale square wave, 7- and 512-frame window slices with
  ``skip=1`` and runs that end in a partial tile, and in its interleaved
  mode on stereo, mono and short buffers; and the ``-Xptxas -v``
  resources of ``analysis_kernel`` are read from a kept build log.

Tolerance: exact (bitwise) everywhere.
"""

import contextlib
import ctypes
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend
torch.set_num_threads(1)

import cuda_host_shim  # noqa: E402
from mp3stego_tpu.ops import encode_plane as JEP  # noqa: E402
from mp3stego_tpu_torch import tables as T  # noqa: E402
from mp3stego_tpu_torch.ops import _cuda  # noqa: E402
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
    kernel = {"window": win.numpy(), "filter": fl.numpy().T, "cos": cos_l,
              "cs": cs, "ca": ca}[name]
    assert kernel.dtype == np.int32
    assert (kernel.T if name == "filter" else kernel).flags.c_contiguous
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


def _jax_stream(full: np.ndarray, skip: int = 0, cg: int = 128) -> np.ndarray:
    """The JAX package's ``analysis_mdct_i16`` on padded int16 streams (ch,
    480 + Tg * 576), granules ``skip`` onward, in chunks of ``cg`` granules
    with one granule of MDCT context, as its ``run_analysis`` dispatches."""
    tg = (full.shape[1] - EP._PAST) // 576
    parts, a = [], skip
    while a < tg:
        s = max(0, a - 1)
        e = min(tg, s + cg + 1)
        sl = full[:, s * 576:e * 576 + EP._PAST]
        r = np.asarray(JEP._analysis_call(JEP._pad_to(
            sl, EP._PAST + (cg + 1) * 576)))
        parts.append(r[:, a - s:e - s])
        a = e
    return np.concatenate(parts, axis=1)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/analysis.cu built for the host with g++ against the emulation
    of ``tests/cuda_host_shim.py``. Returns the loaded library."""
    return cuda_host_shim.build("analysis", tmp_path_factory.mktemp(
        "analysis_host"), EP._SIGNATURES)


def _on_host(lib, monkeypatch, sms: int):
    """Route ``EP._launch`` to the host build: CPU tensors, stream 0, the
    occupancy the host build reports on a grid of ``sms`` SMs. Returns a
    launch that fails instead of hanging."""
    out = [ctypes.c_int(0) for _ in range(4)]
    assert lib.analysis_occupancy(*(ctypes.addressof(v) for v in out)) == 0
    occ = dict(zip(("ctas", "warps", "smem", "granules"),
                   (v.value for v in out)))
    assert occ["ctas"] >= 1 and occ["smem"] > 48 * 1024
    monkeypatch.setattr(_cuda, "load", lambda name, sig: lib)
    monkeypatch.setattr(EP, "occupancy", lambda dev: occ)
    monkeypatch.setattr(EP, "_grid_cap", lambda dev: sms * occ["ctas"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def launch(fn, *args):
        box = []
        th = threading.Thread(target=lambda: box.append(fn(*args)),
                              daemon=True)
        th.start()
        th.join(300)
        assert not th.is_alive(), "the host build of the kernel hung"
        return box[0]
    return launch


# (name, channels, granules of the stream, skip, slice, kind, SMs): a
# window slice keeps granules [lo - 1, hi) of the stream with the 480
# samples before them, as models/streaming cuts a window (skip=1)
HOST_CASES = [
    ("stereo", 2, 29, 0, None, "music", 2),
    ("mono", 1, 23, 0, None, "music", 2),
    ("one granule", 2, 1, 0, None, "noise", 2),
    ("square", 2, 20, 0, None, "square", 2),
    ("7-frame window", 2, 40, 1, (11, 25), "music", 2),
    ("512-frame window", 2, 1030, 1, (3, 1027), "music", 2),
    ("partial tiles", 2, 45, 0, None, "noise", 1),
    ("partial tiles, skip=1", 1, 38, 1, None, "noise", 1),
]


@pytest.mark.parametrize("name,ch,tg,skip,cut,kind,sms", HOST_CASES,
                         ids=[c[0] for c in HOST_CASES])
def test_kernel_source_on_the_host_equals_plain_and_jax(
        name, ch, tg, skip, cut, kind, sms, host_kernel, monkeypatch):
    """csrc/analysis.cu, built for the host, through the wrapper's launch
    code: the tiling the wrapper chooses on ``sms`` emulated SMs (runs that
    carry the MDCT context from tile to tile, tiles that end a channel part
    full), bit for bit ``analysis_stream_torch`` and the JAX package."""
    launch = _on_host(host_kernel, monkeypatch, sms)
    full = EP._padded_streams(_pcm(kind, ch, tg * 576 - 77, seed=tg), tg)
    if cut is not None:
        lo, hi = cut
        full = np.ascontiguousarray(full[:, (lo - 1) * 576:hi * 576
                                         + EP._PAST])
    n = (full.shape[1] - EP._PAST) // 576
    g, run, _ = EP.schedule(ch, n - skip, EP._grid_cap(None),
                            EP.occupancy(None)["granules"])
    if name.startswith("partial"):
        assert (n - skip) % g and -(-(n - skip) // g) % run, (g, run)
    got = launch(EP._launch, torch.from_numpy(full), ch, n, skip)
    assert got.shape == (ch, n - skip, 576) and got.dtype == torch.int32
    plain = EP.analysis_stream_torch(torch.from_numpy(full), 64, skip)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), _jax_stream(full, skip))
    if kind == "square":       # the wrap is really exercised
        assert got.abs().max() > 2 ** 30


# (name, channels, granules, int16 values in the buffer, skip, SMs): the
# WAV's interleaved buffer, its end anywhere (an odd stereo length ends in
# half a frame; a short buffer leaves whole granules of zeros)
INTERLEAVED_CASES = [
    ("stereo", 2, 29, 2 * 29 * 576 - 77, 0, 2),
    ("mono", 1, 23, 23 * 576 - 50, 0, 2),
    ("short buffer", 2, 6, 2 * 2 * 576 + 101, 0, 1),
    ("stereo, skip=1", 2, 17, 2 * 17 * 576, 1, 1),
    ("mono, one granule", 1, 1, 300, 0, 2),
]


@pytest.mark.parametrize("name,ch,tg,n,skip,sms", INTERLEAVED_CASES,
                         ids=[c[0] for c in INTERLEAVED_CASES])
def test_interleaved_route_on_the_host_equals_the_stream_route(
        name, ch, tg, n, skip, sms, host_kernel, monkeypatch):
    """The kernel's interleaved mode, built for the host, through the
    wrapper's launch code: channel c at c + nch * t with zeros in front
    and past the buffer's end, bit for bit its plain version, the stream
    route on ``_padded_streams`` of the same channels, the JAX package and
    the native twin."""
    launch = _on_host(host_kernel, monkeypatch, sms)
    buf = np.random.default_rng(n).integers(-32768, 32768, size=n) \
        .astype(np.int16)
    streams = np.zeros((ch, tg * 576), np.int16)   # _channel_streams_i16
    for c in range(ch):
        s = buf[c::ch][:tg * 576]
        streams[c, :len(s)] = s
    full = EP._padded_streams(streams, tg)
    got = launch(EP._launch, torch.from_numpy(buf), ch, tg, skip, True)
    assert got.shape == (ch, tg - skip, 576) and got.dtype == torch.int32
    plain = EP.analysis_interleaved(torch.from_numpy(buf), ch, tg, skip, 4)
    assert torch.equal(got, plain)
    assert torch.equal(got, EP.analysis_stream_torch(
        torch.from_numpy(full), 64, skip))
    assert np.array_equal(got.numpy(), _jax_stream(full, skip))
    native = EP.run_analysis_native(streams, tg)
    assert native is not None and np.array_equal(got.numpy(),
                                                 native[:, skip:])


@pytest.mark.parametrize("nch,samples", [(2, 7 * 1152 + 333), (1, 4000)])
def test_encoder_analysis_reads_the_interleaved_buffer(nch, samples):
    """``MP3Encoder._analysis_device`` on the CPU: the spectra of the old
    route (``_channel_streams_i16`` then ``run_analysis_device``), without
    building the channel streams."""
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import WavFile
    buf = _pcm("music", 2, samples)[:nch].T.reshape(-1).copy()
    wav = WavFile(file_path="x.wav", bitrate=128, num_of_channels=nch,
                  samplerate=44100, num_of_samples=samples,
                  mpeg_mode=0 if nch == 2 else 3, buffer=buf)
    enc = MP3Encoder(wav, device="cpu")
    nf = enc._num_frames()
    tg = nf * enc.granules_per_frame
    want = EP.run_analysis_device(enc._channel_streams_i16(nf), tg, "cpu")
    calls = []
    orig = MP3Encoder._channel_streams_i16
    MP3Encoder._channel_streams_i16 = lambda *a: calls.append(a) or orig(*a)
    try:
        got = enc._analysis_device(nf)
    finally:
        MP3Encoder._channel_streams_i16 = orig
    assert not calls
    assert torch.equal(got, want.reshape(-1, 576))


def test_ptxas_resources_read_the_kept_build_log(monkeypatch):
    """``_cuda.ptxas_resources`` reads K3's registers, static shared memory
    and spills from a build's kept ``-Xptxas -v`` log, and refuses a log
    that does not name the kernel."""
    name = "_ZN12_GLOBAL__N_115analysis_kernelENS_6ParamsE"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 32 bytes smem, "
        "3592 bytes cmem[0]"])
    monkeypatch.setitem(_cuda.builds, "analysis", {"log": log})
    assert _cuda.ptxas_resources("analysis", "analysis_kernel") == dict(
        registers=80, smem=32, spill_stores=8, spill_loads=12)
    monkeypatch.setitem(_cuda.builds, "analysis", {"log": "(cached build)"})
    with pytest.raises(RuntimeError, match="analysis_kernel"):
        _cuda.ptxas_resources("analysis", "analysis_kernel")
