"""The port's native light parse (``native/src/mp3_light.cpp``, bound as
``bitstream/decoder_host.parse_mp3_light_native``) and the samples that
``parse_mp3`` defers to the card, on the CPU:

* its side planes equal the Python parse's (``backend="python"``), and the
  JAX package's Python parse's, on the fixture, the crafted long, short and
  mixed-block goldens, two multirate goldens, a mono stream, a CRC stream,
  a stream cut mid-frame and a bit-flipped one;
* its lanes (words, fields) equal ``huffman_device.pack`` of the Python
  light parse's descriptors;
* the plain scan of its lanes equals the deferred ``raw_samples``, which
  equal the full native fill and the Python parse's samples;
* a stream it does not read (free-format, LSF) or whose walk is
  inconsistent falls back as ``parse_mp3`` did: the samples filled at
  parse time, as do ``defer_samples=False`` and the other backends;
* the deferred fill runs once, under its own span, and the words past a
  short capacity are never written;
* the scan route (``parse_mp3``, then ``decode_pcm_i16`` with the scan,
  which ``scan_on_the_cpu`` lets run on the CPU) reads the host fill where
  an intensity-stereo granule needs the right channel's samples, and drops
  a VBR tag frame's silence as the host fill's route does; the façade's
  ``Decoder`` reports the tag's average rate.

Every JAX-package parse here names its Python engine (``backend="python"``),
so nothing depends on whether the JAX package's native library loaded.
Tolerance: exact.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mp3stego_tpu.bitstream import decoder_host as jdh  # noqa: E402
from mp3stego_tpu_torch import native  # noqa: E402
from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402
from mp3stego_tpu_torch.ops import huffman_device as hd  # noqa: E402
from mp3stego_tpu_torch.utils import profiling as P  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CRAFTED = ("is_long", "is_ms_long", "is_ms_short", "mixed_44k")
STREAMS = (["fixture", "multirate_32000_64", "multirate_48000_320"]
           + [f"crafted_{n}" for n in CRAFTED]
           + ["mono", "crc", "truncated", "flipped"])
SIDE = ("frame_sizes", "block_type", "mixed_block_flag", "window_switching",
        "global_gain", "scale_fac_scale", "pre_flag", "sub_block_gain",
        "scale_fac_l", "scale_fac_s", "table_select", "ms_stereo",
        "is_stereo", "duplicate_last_pcm", "skip_first_pcm")


@pytest.fixture(autouse=True)
def lib():
    """The native library, decided at run time."""
    got = native.get_lib()
    if got is None:
        pytest.skip("the native library did not build")
    return got


def _frames(data: bytes) -> list:
    """(start, size) of each frame of ``data`` by the Python walk."""
    sizes = pdh.parse_mp3(data, 0, backend="python").frame_sizes
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return [(int(a), int(s)) for a, s in zip(starts, sizes)]


def _with_crc(data: bytes) -> bytes:
    """A stream without a reservoir (``main_data_begin`` 0) with every
    frame CRC-protected: the protection bit cleared and two check bytes
    after the header, the frame's two last bytes (zero padding) dropped."""
    out = bytearray()
    for a, n in _frames(data):
        frame = data[a:a + n]
        assert frame[-2:] == b"\0\0"
        out += bytes([frame[0], frame[1] & 0xFE]) + frame[2:4] + b"\xab\xcd" \
            + frame[4:-2]
    return bytes(out)


def _flipped(data: bytes, seed: int) -> bytes:
    """12 seeded bit flips inside frames' main data (past each header and
    side info), so the sync walk holds and the scan meets corrupt codes."""
    frames = _frames(data)
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    for _ in range(12):
        a, n = frames[int(rng.integers(0, len(frames)))]
        b[a + int(rng.integers(36, n))] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


def _mono_stream() -> bytes:
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import WavFile
    rng = np.random.default_rng(7)
    t = np.arange(44100 // 4)
    pcm = np.clip((0.4 * np.sin(2 * np.pi * 440 * t / 44100)
                   + 0.05 * rng.standard_normal(t.size)) * 30000,
                  -32768, 32767).astype(np.int16)
    enc = MP3Encoder(WavFile(file_path="m.wav", bitrate=96,
                             num_of_channels=1, samplerate=44100,
                             bits_per_sample=16, num_of_samples=pcm.size,
                             mpeg_mode=3, buffer=pcm), device="cpu")
    enc.encode()
    return bytes(enc.out_buffer)


def _free_format(data: bytes) -> bytes:
    b = bytearray(data)
    for a, _ in _frames(data):
        b[a + 2] &= 0x0F
    return bytes(b)


def scan_here(p, device) -> tuple:
    """``decode_plane.scan_lanes`` as it answers on a card, for any device:
    the parse's lanes while its samples are pending. A test fake that runs
    the scan route on the CPU (the scan's plain version)."""
    return p.lanes if p.lanes is not None and p.samples_pending else None


@pytest.fixture
def scan_on_the_cpu(monkeypatch):
    monkeypatch.setattr(pdp, "scan_lanes", scan_here)


def make_streams(fixture: bytes) -> dict:
    """The streams of ``STREAMS``, and a free-format and an LSF stream,
    from the fixture's bytes and the goldens."""
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    crafted = np.load(os.path.join(GOLD, "crafted_golden.npz"))
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    out = {"fixture": fixture, "mono": _mono_stream(),
           "crc": _with_crc(crafted["mixed_44k"].tobytes()),
           "truncated": fixture[:len(fixture) // 2 + 37],
           "flipped": _flipped(fixture, 11),
           "free_format": _free_format(fixture),
           "lsf": lsf[lsf.files[0]].tobytes()}
    out.update({f"multirate_{t}": mr[f"mp3_{t}"].tobytes()
                for t in ("32000_64", "48000_320")})
    out.update({f"crafted_{n}": crafted[n].tobytes() for n in CRAFTED})
    return out


@pytest.fixture(scope="module")
def streams(fixture_mp3):
    with open(fixture_mp3, "rb") as f:
        return make_streams(f.read())


def test_the_crafted_streams_are_what_they_claim(streams):
    crc = pdh.parse_mp3(streams["crc"], 0, backend="python")
    plain = pdh.parse_mp3(streams["crafted_mixed_44k"], 0, backend="python")
    assert crc.header.crc == 0 and plain.header.crc == 1
    assert np.array_equal(crc.raw_samples, plain.raw_samples)
    assert pdh.parse_mp3(streams["mono"], 0).header.channels == 1
    assert pdh.parse_header(*streams["free_format"][:4]).free_format
    p = pdh.parse_mp3(streams["crafted_is_ms_short"], 0, backend="python")
    assert (p.block_type == 2).any() and p.is_stereo.any()
    assert pdh.parse_mp3(streams["crafted_mixed_44k"], 0,
                         backend="python").mixed_block_flag.any()


@pytest.mark.parametrize("name", STREAMS)
def test_light_parse_side_planes_equal_the_python_parse(name, streams):
    data = streams[name]
    got = pdh.parse_mp3_light_native(data, 0)
    want = pdh.parse_mp3(data, 0, backend="python")
    jwant = jdh.parse_mp3(data, 0, backend="python")
    assert got.num_frames == want.num_frames == jwant.num_frames > 0
    for k in SIDE:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
        np.testing.assert_array_equal(getattr(got, k), getattr(jwant, k),
                                      err_msg=k)
    assert vars(got.header) == vars(want.header)
    assert pdh.stego_bits(got) == pdh.stego_bits(want)


@pytest.mark.parametrize("name", STREAMS)
def test_light_parse_lanes_equal_pack(name, streams):
    data = streams[name]
    words, fields = pdh.parse_mp3_light_native(data, 0).lanes
    want_w, want_f = hd.pack(pdh.parse_mp3_light(data, 0)[1])
    assert words.dtype == fields.dtype == np.int32
    np.testing.assert_array_equal(words, want_w)
    np.testing.assert_array_equal(fields, want_f)


@pytest.mark.parametrize("name", STREAMS)
def test_deferred_samples_equal_the_scan_and_the_full_fill(name, streams):
    data = streams[name]
    p = pdh.parse_mp3(data, 0)
    assert p.samples_pending and p.lanes is not None
    words, fields = (torch.from_numpy(a) for a in p.lanes)
    scan = hd.decode_samples_plain(words, fields).numpy()
    full = pdh.parse_mp3(data, 0, defer_samples=False)
    assert not full.samples_pending and full.lanes is None
    assert p.samples_pending          # the scan read no host samples
    got = p.raw_samples
    assert not p.samples_pending
    np.testing.assert_array_equal(got, full.raw_samples)
    np.testing.assert_array_equal(
        got, pdh.parse_mp3(data, 0, backend="python").raw_samples)
    np.testing.assert_array_equal(
        scan, np.moveaxis(got, 2, 0).reshape(2, -1, 576))


def test_mono_lanes_store_each_frame_once(streams):
    """A mono frame's two granules share its words; its second channel's
    lanes read none."""
    words, fields = pdh.parse_mp3_light_native(streams["mono"], 0).lanes
    f = fields.reshape(-1, 2, 2, 8)
    assert (f[:, 0, 0, :2] == f[:, 1, 0, :2]).all()
    assert not f[:, :, 1].any()
    assert words.size == int(f[:, 0, 0, 1].sum()) + pdh.LIGHT_PAD_WORDS


@pytest.mark.parametrize("name", ["free_format", "lsf"])
def test_streams_the_light_parse_does_not_read_fill_at_parse_time(
        name, streams):
    data = streams[name]
    assert pdh.parse_mp3_light_native(data, 0) is None
    p = pdh.parse_mp3(data, 0)
    want = pdh.parse_mp3(data, 0, backend="python")
    assert p.lanes is None and not p.samples_pending
    for k in SIDE + ("raw_samples", "num_frames", "lsf_granules"):
        np.testing.assert_array_equal(getattr(p, k), getattr(want, k),
                                      err_msg=k)


def test_an_inconsistent_light_walk_falls_back_to_the_full_fill(
        streams, lib, monkeypatch):
    data = streams["fixture"]
    want = pdh.parse_mp3_native(data, 0)
    monkeypatch.setattr(lib, "mp3_parse_light", lambda *a: 0)
    assert pdh.parse_mp3_light_native(data, 0) is None
    p = pdh.parse_mp3(data, 0)
    assert p.lanes is None and not p.samples_pending
    for k in SIDE + ("raw_samples", "num_frames"):
        np.testing.assert_array_equal(getattr(p, k), getattr(want, k),
                                      err_msg=k)


@pytest.mark.parametrize("how", ["defer_samples=False", "python", "native"])
def test_the_other_routes_fill_at_parse_time(how, streams):
    data = streams["fixture"]
    kw = {"defer_samples=False": dict(defer_samples=False),
          "python": dict(backend="python"),
          "native": dict(backend="native")}[how]
    p = pdh.parse_mp3(data, 0, **kw)
    assert p.lanes is None and not p.samples_pending
    np.testing.assert_array_equal(
        p.raw_samples, pdh.parse_mp3(data, 0, backend="python").raw_samples)


def test_the_deferred_fill_runs_once_under_its_span(streams):
    data = streams["fixture"]
    n0 = len(P.spans())
    with P.recording():
        p = pdh.parse_mp3(data, 0)
        first = p.raw_samples
        again = p.raw_samples
    got = P.spans()[n0:]
    assert first is again
    fills = [s for s in got if s.name == "parse.fill"]
    assert len(fills) == 1 and fills[0].counts == {"frames": p.num_frames}
    natives = [s for s in got if s.name == "parse.native"]
    assert len(natives) == 1 and natives[0].t1 <= fills[0].t0
    inside = [s for s in got if s.parent == fills[0].id]
    assert inside == []


def test_words_past_a_short_capacity_are_never_written(streams, lib):
    """The C call writes no word past its capacity and reports the words
    the stream needs; the Python binding parses again with that many."""
    data = streams["fixture"]
    want_w, want_f = pdh.parse_mp3_light_native(data, 0).lanes
    buf = np.frombuffer(data, np.uint8)
    F = pdh.parse_mp3(data, 0).num_frames
    planes = pdh._side_planes(F)
    words = np.full(want_w.size + 64, 0x5A5A5A5A, np.int32)
    fields = np.empty((4 * F, 8), np.int32)
    used = np.zeros(1, np.int64)
    cap = 100
    got = lib.mp3_parse_light(
        buf, len(buf), 0, pdh._native_luts()[6], F, np.zeros(8, np.int32),
        np.zeros(F, np.int64),
        *(planes[k].reshape(-1) for k, _ in pdh._SIDE_PLANES),
        np.zeros(F, np.uint8), words, cap, pdh.LIGHT_PAD_WORDS, fields, used)
    assert got == F and int(used[0]) == want_w.size
    np.testing.assert_array_equal(words[:cap], want_w[:cap])
    assert (words[cap:] == 0x5A5A5A5A).all()
    np.testing.assert_array_equal(fields, want_f)


@pytest.mark.parametrize("name", ["crafted_is_long", "crafted_is_ms_long",
                                  "crafted_is_ms_short"])
def test_device_route_reads_the_host_fill_for_intensity_stereo(
        name, streams, scan_on_the_cpu):
    """Intensity positions need the right channel's samples on the host:
    the scan route reads the deferred fill for them beside the scan and
    writes the host fill's route's bytes."""
    data = streams[name]
    want = pdp.decode_pcm_i16(pdh.parse_mp3(data, 0, defer_samples=False),
                              "cpu", "float32")
    parsed = pdh.parse_mp3(data, 0)
    assert parsed.samples_pending
    n0 = len(P.spans())
    with P.recording():
        got = pdp.decode_pcm_i16(parsed, "cpu", "float32")
    names = [s.name for s in P.spans()[n0:]]
    assert names.count("samples.device") == names.count("parse.fill") == 1
    assert not parsed.samples_pending
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def tagged_mp3():
    """A short VBR encode with its Xing tag frame."""
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import WavFile
    rng = np.random.default_rng(3)
    t = np.arange(44100)
    sig = 0.3 * np.sin(2 * np.pi * 440 * t / 44100)
    sig[t.size // 2:] += 0.4 * rng.standard_normal(t.size - t.size // 2)
    pcm = np.clip(sig * 20000, -32768, 32767).astype(np.int16)
    buf = np.repeat(pcm, 2)
    enc = MP3Encoder(WavFile(file_path="v.wav", bitrate=128,
                             num_of_channels=2, samplerate=44100,
                             bits_per_sample=16, num_of_samples=pcm.size,
                             mpeg_mode=0, buffer=buf), vbr=True, device="cpu")
    enc.encode()
    return bytes(enc.out_buffer)


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_device_route_drops_a_vbr_tag_frame_as_the_host_route(
        precision, tagged_mp3, tmp_path, scan_on_the_cpu):
    from mp3stego_tpu_torch.bitstream import vbr
    from mp3stego_tpu_torch.models import decoder as pdec
    from mp3stego_tpu_torch.utils.wav import write_wav
    data = tagged_mp3
    host = pdh.parse_mp3(data, 0, defer_samples=False)
    assert host.vbr_tag is not None and host.skip_first_pcm
    want = pdp.decode_pcm_i16(host, "cpu", precision)
    parsed = pdh.parse_mp3(data, 0)
    assert parsed.samples_pending
    got = pdp.decode_pcm_i16(parsed, "cpu", precision)
    assert parsed.samples_pending           # scanned, never filled
    assert parsed.skip_first_pcm and parsed.vbr_tag is not None
    assert (parsed.vbr_tag.kind, parsed.vbr_tag.frames) == \
        (host.vbr_tag.kind, host.vbr_tag.frames)
    assert got.tobytes() == want.tobytes()
    path = tmp_path / "v.mp3"
    path.write_bytes(data)
    write_wav(str(tmp_path / "h.wav"), host.header.sampling_rate, want)
    kbps = pdec.Decoder(str(path), str(tmp_path / "d.wav"),
                        precision=precision, device="cpu").decode()
    avg = vbr.avg_bitrate_kbps(host.vbr_tag, host.header)
    assert avg is not None and kbps == avg
    assert (tmp_path / "d.wav").read_bytes() == \
        (tmp_path / "h.wav").read_bytes()
