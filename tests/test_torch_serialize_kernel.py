"""The frame serializer's kernel (``csrc/serialize.cu``) rehearsed on the
CPU, its plain version, and the encoder's route to them.

* ``csrc/serialize.cu`` built for the host with g++ against the emulation of
  ``tests/cuda_host_shim.py`` and run through the wrapper's launch and fetch
  code (``serialize._launch``, ``_collect``), and ``pack_frames_torch``:
  both byte for byte ``mp3_format_frames`` (the host route's C serializer),
  with its length and its returned ``cache``/``cache_bits``, on the planes
  of a clear and a hide encode of the golden WAV (stuffing over 32 bits,
  the ``MAX_BITS_ALLOWANCE`` split), a mono encode, a VBR encode (per-frame
  rates), an MPEG-2 encode in the reference's LSF layout, seeded lanes
  (every escape table 16-31 with its linbits, both count1 tables, nonzero
  scalefac_compress, part2_length, preflag and scalefac_scale), the golden
  planes after a carried-in cache of 1-31 pending bits, and a stream past
  the C route's buffer, which all three refuse with the same error.
* The encoder's routes: on the CPU ``ix`` is NumPy and the C route runs,
  its ``finish.serialize`` span counting no ``card_frames``; with ``ix``
  kept as a tensor the card route runs (``pack_frames``, here its plain
  version) and writes the C route's bytes for a clear, a hide, a mono, a
  VBR, a batched and a windowed (streaming) encode, whose cache carries
  across windows, counting every frame as ``card_frames``.

Tolerance: exact. Small inputs (a few hundred lanes), so the file runs in
seconds.
"""

import contextlib
import os
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cuda_host_shim  # noqa: E402
from mp3stego_tpu_torch import native  # noqa: E402
from mp3stego_tpu_torch import tables as T  # noqa: E402
from mp3stego_tpu_torch.models import encoder as E  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.ops import _cuda  # noqa: E402
from mp3stego_tpu_torch.ops import serialize as SZ  # noqa: E402
from mp3stego_tpu_torch.utils import profiling  # noqa: E402
from mp3stego_tpu_torch.utils.wav import WavFile, read_wav  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIDE = "0110100111" * 30


@pytest.fixture(scope="module")
def lib():
    got = native.get_lib()
    if got is None or not hasattr(got, "mp3_format_frames"):
        pytest.skip("the native host library did not build")
    return got


def _c_route(lib, ix, side, frames, cfg, cache=0, cache_bits=32):
    """``mp3_format_frames`` on the serializer's inputs, through the host
    route's own call (``encoder._format_frames_native``): (bytes, cache,
    cache_bits); raises its ``RuntimeError`` on overflow."""
    ca = np.array([cache], np.uint32)
    cb = np.array([cache_bits], np.int32)
    data = E._format_frames_native(lib, ix, side, frames, cfg, ca, cb)
    return data, int(ca[0]), int(cb[0])


def _planes(make) -> dict:
    """The serializer's inputs of the encode ``make()`` runs on the CPU (C
    route), from its first ``_plane_serialize_native`` call, with the bytes
    that call appended."""
    got = []
    orig = MP3Encoder._plane_serialize_native

    def capture(self, lib, res, p23, gg, scfsi_f, paddings, nf):
        n0 = len(self.out_buffer)
        orig(self, lib, res, p23, gg, scfsi_f, paddings, nf)
        if not got:
            side, frames = self._serialize_fields(res, p23, gg, scfsi_f,
                                                  paddings, nf)
            got.append(dict(
                ix=np.ascontiguousarray(res["ix"], np.int32).reshape(-1, 576),
                side=side, frames=frames, cfg=self._serialize_config(),
                written=bytes(self.out_buffer[n0:]),
                bits=np.asarray(res["bits"]).copy()))

    MP3Encoder._plane_serialize_native = capture
    try:
        make()
    finally:
        MP3Encoder._plane_serialize_native = orig
    return got[0]


def _wav(pcm: np.ndarray, sr: int, nch: int, kbps: int) -> WavFile:
    return WavFile(file_path="s.wav", bitrate=kbps, num_of_channels=nch,
                   samplerate=sr, bits_per_sample=16,
                   num_of_samples=pcm.size // nch,
                   mpeg_mode=3 if nch == 1 else 0, buffer=pcm)


def _tone(n: int, nch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sig = 0.4 * np.sin(2 * np.pi * 440 * t / 44100) \
        + 0.1 * rng.standard_normal((nch, n))
    return np.clip(sig.T * 30000, -32768, 32767).astype(np.int16).reshape(-1)


def _golden_wav(tmp) -> str:
    p = os.path.join(tmp, "golden.wav")
    if not os.path.exists(p):
        with open(p, "wb") as f:
            f.write(np.load(os.path.join(GOLD, "stego_golden.npz"))[
                "wav_bytes"].tobytes())
    return p


def _encode(wav, hide="", **kw):
    enc = MP3Encoder(wav, hide_str=hide, device="cpu", **kw)
    enc.encode()
    return enc


def _seeded(seed: int, nf: int = 12) -> dict:
    """Seeded MPEG-1 stereo lanes: every table id 1-31 but 4 and 14 drawn
    in each region (values up to the table's range, escapes up to their
    linbits), count1 quads of either table, stuffing or none, random
    scalefac_compress, part2_length, preflag and scalefac_scale; the first
    lanes take every escape table once."""
    rng = np.random.default_rng(seed)
    nch, gpf = 2, 2
    lanes = nch * nf * gpf
    tables = [t for t in range(1, 32) if t not in (4, 14)]
    ix = np.zeros((lanes, 576), np.int32)
    side = np.zeros((len(SZ.FIELDS), lanes), np.int32)
    fld = dict(zip(SZ.FIELDS, side))
    band = T.BAND_ALL[0]
    for g in range(lanes):
        pairs = int(rng.integers(0, 289))
        quads = int(rng.integers(0, (576 - 2 * pairs) // 4 + 1))
        r0 = int(rng.integers(0, 16))
        r1 = int(rng.integers(0, min(8, 21 - r0)))
        ts = [int(rng.choice(tables)) for _ in range(3)]
        if g < 16:
            ts[g % 3] = 16 + g
        starts = [0, band[r0 + 1], band[r0 + r1 + 2], 576]
        for r in range(3):
            t = ts[r]
            top = 15 + (1 << int(T.HUFF_LINBITS[t])) - 1 if t > 15 else \
                int(T.HUFF_XLEN[t]) - 1
            a, b = min(starts[r], 2 * pairs), min(starts[r + 1], 2 * pairs)
            v = rng.integers(-top, top + 1, size=b - a)
            v[rng.random(b - a) < 0.3] = 0
            ix[g, a:b] = v
        q = rng.integers(-1, 2, size=4 * quads)
        ix[g, 2 * pairs:2 * pairs + 4 * quads] = q
        for k, v in (("big_values", pairs), ("count1", quads),
                     ("region0_count", r0), ("region1_count", r1),
                     ("table_select0", ts[0]), ("table_select1", ts[1]),
                     ("table_select2", ts[2]),
                     ("count1table_select", rng.integers(0, 2)),
                     ("global_gain", rng.integers(0, 256)),
                     ("scalefac_compress", rng.integers(0, 16)),
                     ("preflag", rng.integers(0, 2)),
                     ("scalefac_scale", rng.integers(0, 2)),
                     ("part2_length", rng.integers(0, 80)),
                     ("part2_3_length", rng.integers(0, 4096))):
            fld[k][g] = v
    frames = np.zeros((nf, SZ.FRAME_INTS), np.int32)
    frames[:, 0] = rng.integers(1, 15, nf)
    frames[:, 1] = rng.integers(0, 2, nf)
    frames[:, 2:] = rng.integers(0, 2, (nf, 8))
    cfg = SZ.config(band, version=3, layer=1, crc=0, sr_mod3=0, ext=0,
                    mode=1, mode_ext=2, copyright=1, original=1, emphasis=0,
                    private_bits=5, nch=nch, gpf=gpf)
    return dict(ix=ix, side=side, frames=frames, cfg=cfg)


def _case(name: str, tmp: str) -> dict:
    if name in ("clear", "hide") or name.startswith("carried"):
        wav = read_wav(_golden_wav(tmp), 320)
        got = _planes(lambda: _encode(wav, HIDE if name == "hide" else ""))
        if name.startswith("carried"):
            k = int(name.split()[1])
            rng = np.random.default_rng(k)
            got["cache"] = int(rng.integers(0, 1 << 32)) \
                & ~((1 << (32 - k)) - 1) & 0xFFFFFFFF
            got["cache_bits"] = 32 - k
        return got
    if name == "mono":
        return _planes(lambda: _encode(_wav(_tone(44100, 1, 3), 44100, 1,
                                            128)))
    if name == "vbr":
        wav = read_wav(_golden_wav(tmp), 160)
        return _planes(lambda: _encode(wav, vbr=True))
    if name == "lsf":
        return _planes(lambda: _encode(_wav(_tone(24000, 2, 5), 24000, 2,
                                            64)))
    if name == "seeded":
        return _seeded(11)
    if name == "overflow":
        got = _seeded(12, nf=1)
        got["side"][SZ.FIELDS.index("part2_3_length")] = 1 << 20
        return got
    raise KeyError(name)


CASES = ("clear", "hide", "mono", "vbr", "lsf", "seeded", "carried 1",
         "carried 13", "carried 31", "overflow")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("serialize"))
    made = {}

    def get(name):
        if name not in made:
            made[name] = _case(name, tmp)
        return made[name]
    return get


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/serialize.cu built for the host with g++ against the emulation
    of ``tests/cuda_host_shim.py``. Returns the loaded library."""
    return cuda_host_shim.build("serialize", tmp_path_factory.mktemp(
        "serialize_host"), SZ._SIGNATURES)


def _host_pack(host, monkeypatch, ix, side, frames, cfg, cache, cache_bits):
    """``serialize._launch`` and ``_collect`` on the host build: CPU
    tensors, stream 0; a launch that fails instead of hanging."""
    monkeypatch.setattr(_cuda, "load", lambda name, sig: host)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    out = []

    def run():
        try:
            words, off = SZ._launch(ix, side, frames, cfg, cache, cache_bits)
            out.append(SZ._collect(words, off, frames.shape[0]))
        except RuntimeError as e:
            out.append(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(300)
    assert not th.is_alive(), "the host build of the kernel hung"
    if isinstance(out[0], RuntimeError):
        raise out[0]
    return out[0]


@pytest.mark.parametrize("name", CASES)
def test_kernel_and_plain_version_write_the_c_routes_bytes(
        name, cases, lib, host_kernel, monkeypatch):
    case = cases(name)
    ix, side, frames, cfg = (case[k] for k in ("ix", "side", "frames",
                                              "cfg"))
    cache, cache_bits = case.get("cache", 0), case.get("cache_bits", 32)
    t = [torch.from_numpy(a) for a in (ix, side, frames)]
    if name == "overflow":
        for run in (lambda: _c_route(lib, ix, side, frames, cfg),
                    lambda: SZ.pack_frames_torch(*t, cfg),
                    lambda: _host_pack(host_kernel, monkeypatch, *t, cfg, 0,
                                       32)):
            with pytest.raises(RuntimeError, match="buffer overflow"):
                run()
        return
    want = _c_route(lib, ix, side, frames, cfg, cache, cache_bits)
    if "written" in case and not name.startswith("carried"):
        assert want[0] == case["written"]
    plain = SZ.pack_frames_torch(*t, cfg, cache, cache_bits)
    kernel = _host_pack(host_kernel, monkeypatch, *t, cfg, cache, cache_bits)
    for got in (plain, kernel):
        assert got[0].dtype == np.uint8
        assert bytes(got[0]) == want[0]
        assert got[1:] == want[1:]
    fld = dict(zip(SZ.FIELDS, side))
    if name == "clear":
        # stuffing over 32 bits, and a frame whose stuffing passed
        # MAX_BITS_ALLOWANCE on its first granule and spilled into another
        p23, bits = fld["part2_3_length"], case["bits"]
        nf = frames.shape[0]
        first = p23[:nf * 2:2] == 4095
        other = (p23 - bits > 0).reshape(2, nf, 2)
        other[0, :, 0] = False
        assert (first & other.any((0, 2))).any()
    if name == "seeded":
        tabs = {int(t) for r in range(3) for t in fld[f"table_select{r}"]}
        assert set(range(16, 32)) <= tabs
        assert set(fld["count1table_select"]) == {0, 1}
    if name == "vbr":
        assert len(set(frames[:, 0])) > 1
    if name == "lsf":
        assert cfg[0] == 2 and cfg[SZ.CONFIG.index("gpf")] == 1


def test_host_tables_are_what_the_kernel_reads(host_kernel):
    tab = SZ._host_tables()
    assert tab.size == SZ.TABLE_INTS == host_kernel.serialize_table_ints()
    entries = tab[:34 * 256].view(np.uint32)
    np.testing.assert_array_equal(entries & 0xFFFFFF,
                                  T.HUFF_CODE.reshape(-1))
    np.testing.assert_array_equal(entries >> 24, T.HUFF_LEN.reshape(-1))
    np.testing.assert_array_equal(tab[SZ._LINBITS:SZ._LINBITS + 32],
                                  T.HUFF_LINBITS[:32])


def test_wrapper_refuses_what_it_cannot_take():
    case = _seeded(2, nf=2)
    t = [torch.from_numpy(case[k]) for k in ("ix", "side", "frames")]
    with pytest.raises(ValueError):
        SZ.pack_frames(t[0][1:], t[1], t[2], case["cfg"])
    with pytest.raises(ValueError):
        SZ.pack_frames(t[0], t[1].to(torch.int64), t[2], case["cfg"])
    with pytest.raises(ValueError):
        SZ.pack_frames(*t, case["cfg"][:-1])
    before = SZ.launches
    SZ.pack_frames(*t, case["cfg"])
    assert SZ.launches == before


def _card_route(monkeypatch):
    """Keep the CPU planes' ``ix`` a tensor, as a card's is, so that the
    encoder takes the card route (its plain version on the CPU)."""
    from mp3stego_tpu_torch.parallel import batch_encode
    for mod in (E, batch_encode):
        monkeypatch.setattr(mod, "_ix_home", lambda ix: ix)


def _serialize_spans():
    return [s for s in profiling.spans() if s.name == "finish.serialize"]


ROUTES = {
    "clear": lambda tmp: _encode(read_wav(_golden_wav(tmp), 320)),
    "hide": lambda tmp: _encode(read_wav(_golden_wav(tmp), 320), HIDE),
    "mono": lambda tmp: _encode(_wav(_tone(44100, 1, 3), 44100, 1, 128)),
    "vbr": lambda tmp: _encode(read_wav(_golden_wav(tmp), 160), vbr=True),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_encoder_card_route_writes_the_c_routes_bytes(name, tmp_path,
                                                      monkeypatch):
    with profiling.recording():
        n0 = len(_serialize_spans())
        host = ROUTES[name](str(tmp_path))
        spans = _serialize_spans()[n0:]
    assert spans and all(s.counts["card_frames"] == 0 for s in spans)
    _card_route(monkeypatch)
    with profiling.recording():
        n0 = len(_serialize_spans())
        card = ROUTES[name](str(tmp_path))
        spans = _serialize_spans()[n0:]
    assert bytes(card.out_buffer) == bytes(host.out_buffer)
    assert card.hide_str_offset == host.hide_str_offset
    assert spans and all(s.counts["card_frames"] == s.counts["frames"] > 0
                         for s in spans)


def test_batched_card_route_writes_the_c_routes_bytes(tmp_path,
                                                     monkeypatch):
    """A batched encode of two files: each file's frames through the card
    route, from its rows of the batch's ``ix``, write the C route's bytes,
    every frame counted as ``card_frames``."""
    from mp3stego_tpu_torch.parallel import encode_files_batched
    wav = _golden_wav(str(tmp_path))

    def batch(tag):
        jobs = [(wav, str(tmp_path / f"{tag}{i}.mp3")) for i in range(2)]
        with profiling.recording():
            n0 = len(_serialize_spans())
            encode_files_batched(jobs, device="cpu", max_workers=2)
            spans = _serialize_spans()[n0:]
        return [open(out, "rb").read() for _, out in jobs], spans

    want, spans = batch("host")
    assert len(spans) == 2 and all(s.counts["card_frames"] == 0
                                   for s in spans)
    _card_route(monkeypatch)
    got, spans = batch("card")
    assert got == want
    assert len(spans) == 2 and all(
        s.counts["card_frames"] == s.counts["frames"] > 0 for s in spans)


@pytest.mark.parametrize("hide", [False, True])
def test_windowed_card_route_carries_the_cache(hide, tmp_path, monkeypatch):
    """A streaming encode at 7-frame windows through the card route, whose
    cache carries each window's pending bits into the next, writes the
    whole-file C route's bytes."""
    from mp3stego_tpu_torch.models.streaming import encode_file_streaming
    wav = _golden_wav(str(tmp_path))
    msg = HIDE if hide else ""
    whole = _encode(read_wav(wav, 320), msg)
    _card_route(monkeypatch)
    calls = []
    orig = MP3Encoder._plane_serialize_card

    def spy(self, *args):
        calls.append((int(self._nat_cache_bits[0])))
        return orig(self, *args)
    monkeypatch.setattr(MP3Encoder, "_plane_serialize_card", spy)
    encode_file_streaming(wav, str(tmp_path / "s.mp3"), 320, 7,
                          hide_str=msg, device="cpu")
    assert (tmp_path / "s.mp3").read_bytes() == bytes(whole.out_buffer)
    assert len(calls) > 2 and any(b != 32 for b in calls[1:])
