"""The port's device Huffman decode (``mp3stego_tpu_torch.ops.huffman_device``)
on the CPU, against the JAX package's, mirroring tests/test_huffman_device.py
and tests/test_backend_select.py:

* ``decode_samples_plain`` (what ``decode_samples`` runs on CPU tensors)
  against the JAX package's ``decode_raw_device`` (its XLA scan, jitted on
  the CPU) and against the Python host parse's ``raw_samples``, on the
  fixture, every MPEG-1 multirate golden, the MPEG-1 crafted streams, a
  stream of linbits escapes, three seeded bit-flipped copies of the fixture
  and a mono stream;
* ``parse_mp3_light``: its descriptors and parsed fields equal the JAX
  package's, field by field; LSF raises the same ``ValueError``;
* the façade's ``Decoder`` (``device="cpu"``) runs the benchmark's route,
  ``parse_mp3`` then ``decode_pcm_i16``, on every stream of
  ``test_torch_light_parse.STREAMS``: in float32 with the samples scanned
  (``scan_on_the_cpu`` lets the scan route run on the CPU), in float64 the
  host plane reading the deferred fill; either way the WAV bytes and stego
  bits of the host fill's route (``parse_mp3(defer_samples=False)``), and
  reveal reads the message back;
* where the choice lives: ``parse_mp3`` leaves lanes on MPEG-1 streams and
  none on the streams the light parse does not read (LSF and free-format
  heads), and ``decode_plane.scan_lanes`` hands them to the scan on a card
  only; with the native library patched away, an LSF or free-format decode
  writes the host parse's bytes, and the Python light parse reads a
  free-format stream at its measured stride.

Every parse here uses the JAX package's Python engine (``backend="python"``)
as the reference, so nothing depends on whether the JAX package's native
library loaded. Tolerance: exact.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_light_parse as tlp  # noqa: E402
from craft_mp3 import Granule, build_stream  # noqa: E402

from mp3stego_tpu.bitstream import decoder_host as jdh  # noqa: E402
from mp3stego_tpu.ops import huffman_device as jhd  # noqa: E402
from mp3stego_tpu_torch import native  # noqa: E402
from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.models import decoder as pdec  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402
from mp3stego_tpu_torch.ops import huffman_device as hd  # noqa: E402
from mp3stego_tpu_torch.utils import profiling as P  # noqa: E402
from mp3stego_tpu_torch.utils.wav import write_wav  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MULTIRATE = ("32000_64", "32000_192", "44100_128", "48000_96", "48000_320")
CRAFTED = ("is_long", "is_ms_long", "is_ms_short", "mixed_44k")
FLIPS = (1, 2, 3)
STREAMS = (["fixture"] + [f"multirate_{t}" for t in MULTIRATE]
           + [f"crafted_{n}" for n in CRAFTED] + ["linbits"]
           + [f"flipped_{s}" for s in FLIPS] + ["mono"])
LSF = ("torch_lsf_mpeg2_24k_64", "torch_lsf_mpeg2_22k05_80",
       "torch_lsf_mpeg25_8k_32", "crafted_mixed_8k_lsf",
       "crafted_lsf_is_scale0", "crafted_lsf_is_ms_scale1")


def _linbits_stream() -> bytes:
    """Escapes of every size under table 23 (13 linbits) and 24 (4): values
    up to 8,206, the largest a linbits code reaches."""
    big = [8206, -15, 16, -8000, 1000, 0, -31, 15, 17, 3] * 4
    small = [30, -16, 15, 0, -29, 18, 1, -1] * 5
    g = lambda v, t: Granule(values=v, table=t, global_gain=160)  # noqa
    return build_stream([[(g(big, 23), g(small, 24)),
                          (g(small, 24), g(big, 23))]] * 3,
                        bitrate=320, mode=0, mode_ext=0)


def _flipped(data: bytes, seed: int) -> bytes:
    """``data`` with 12 seeded bit flips inside frames' main data (past
    each header and side info), so the sync walk holds and the scan meets
    corrupt codes."""
    sizes = pdh.parse_mp3(data, 0).frame_sizes
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    for _ in range(12):
        f = int(rng.integers(0, len(sizes)))
        i = int(starts[f]) + int(rng.integers(36, int(sizes[f])))
        b[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


def _mono_stream() -> bytes:
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import WavFile
    rng = np.random.default_rng(4)
    t = np.arange(44100 // 2)
    pcm = np.clip((0.4 * np.sin(2 * np.pi * 330 * t / 44100)
                   + 0.05 * rng.standard_normal(t.size)) * 30000,
                  -32768, 32767).astype(np.int16)
    enc = MP3Encoder(WavFile(file_path="m.wav", bitrate=128,
                             num_of_channels=1, samplerate=44100,
                             bits_per_sample=16, num_of_samples=pcm.size,
                             mpeg_mode=3, buffer=pcm), device="cpu")
    enc.encode()
    return bytes(enc.out_buffer)


@pytest.fixture(scope="module")
def streams(fixture_mp3):
    with open(fixture_mp3, "rb") as f:
        fixture = f.read()
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    crafted = np.load(os.path.join(GOLD, "crafted_golden.npz"))
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    out = {"fixture": fixture, "linbits": _linbits_stream(),
           "mono": _mono_stream()}
    out.update({f"multirate_{t}": mr[f"mp3_{t}"].tobytes()
                for t in MULTIRATE})
    out.update({f"crafted_{n}": crafted[n].tobytes() for n in crafted.files})
    out.update({f"torch_lsf_{n}": lsf[n].tobytes() for n in lsf.files})
    out.update({f"flipped_{s}": _flipped(fixture, s) for s in FLIPS})
    return out


@pytest.fixture(scope="module")
def jax_raw(streams):
    """The JAX package's scan of every MPEG-1 stream, in ONE jitted call
    over their lanes back to back (one compile): name -> (2, T, 576)."""
    descs, spans, t0 = [], {}, 0
    for name in STREAMS:
        _, d = jdh.parse_mp3_light(streams[name], 0)
        descs += d
        spans[name] = (t0, t0 + len(d) // 2)
        t0 += len(d) // 2
    raw = np.asarray(jhd.decode_raw_device(descs))
    return {name: raw[:, a:b] for name, (a, b) in spans.items()}


def _host_raw(data: bytes) -> np.ndarray:
    p = jdh.parse_mp3(data, 0, backend="python")
    return np.ascontiguousarray(
        np.moveaxis(p.raw_samples, 2, 0).reshape(2, -1, 576)).astype(np.int32)


@pytest.mark.parametrize("name", STREAMS)
def test_plain_scan_equals_jax_scan_and_host_parse(name, streams, jax_raw):
    data = streams[name]
    _, desc = pdh.parse_mp3_light(data, 0)
    words, fields = hd.pack(desc)
    before = hd.launches
    got = hd.decode_samples(torch.from_numpy(words),
                            torch.from_numpy(fields)).numpy()
    assert hd.launches == before          # the CPU takes the plain version
    want = _host_raw(data)
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_raw[name])
    if name == "linbits":
        assert np.abs(got).max() == 8206
    if name == "mono":
        assert not got[1].any()


@pytest.mark.parametrize("name", STREAMS)
def test_light_parse_equals_jax_package(name, streams):
    data = streams[name]
    p, desc = pdh.parse_mp3_light(data, 0)
    jp, jdesc = jdh.parse_mp3_light(data, 0)
    assert len(desc) == len(jdesc) == 4 * p.num_frames
    for d, jd in zip(desc, jdesc):
        assert d.keys() == jd.keys()
        for k in d:
            np.testing.assert_array_equal(d[k], jd[k], err_msg=k)
    for k in ("num_frames", "frame_sizes", "raw_samples", "block_type",
              "mixed_block_flag", "window_switching", "global_gain",
              "scale_fac_scale", "pre_flag", "sub_block_gain", "scale_fac_l",
              "scale_fac_s", "table_select", "ms_stereo", "is_stereo",
              "duplicate_last_pcm", "skip_first_pcm"):
        np.testing.assert_array_equal(getattr(p, k), getattr(jp, k),
                                      err_msg=k)
    assert vars(p.header) == vars(jp.header)
    assert pdh.stego_bits(p) == jdh.stego_bits(jp)


@pytest.mark.parametrize("name", LSF)
def test_light_parse_refuses_lsf_like_jax(name, streams):
    with pytest.raises(ValueError) as want:
        jdh.parse_mp3_light(streams[name], 0)
    with pytest.raises(ValueError) as got:
        pdh.parse_mp3_light(streams[name], 0)
    assert str(got.value) == str(want.value)


def test_huffman_golden_holds_the_linbits_stream(streams):
    """tests/golden/huffman_golden.npz (tools/gen_huffman_golden.py), which
    the card's smoke run reads, is the stream this file builds."""
    gold = np.load(os.path.join(GOLD, "huffman_golden.npz"))
    assert gold["linbits"].tobytes() == streams["linbits"]


def test_pack_stores_each_frame_once(streams):
    _, desc = pdh.parse_mp3_light(streams["fixture"], 0)
    words, fields = hd.pack(desc)
    frames = [desc[i]["md"] for i in range(0, len(desc), 4)]
    assert words.shape == (sum((len(m) + 3) // 4 for m in frames)
                           + hd.PAD_WORDS,)
    assert not words[-hd.PAD_WORDS:].any()
    f = fields.reshape(-1, 4, 8)
    assert (f[:, :, 0] == f[:, :1, 0]).all()      # a frame's lanes share it
    assert (np.diff(f[:, 0, 0]) == f[:-1, 0, 1]).all()
    be = words[:2].view(np.uint32).astype(">u4").tobytes()
    assert be == frames[0][:8]
    _, mono = pdh.parse_mp3_light(streams["mono"], 0)
    mf = hd.pack(mono)[1].reshape(-1, 2, 2, 8)
    assert not mf[:, :, 1, 1].any()               # ch 1 reads no words


def test_decode_samples_refuses_bad_input():
    w = torch.zeros(8, dtype=torch.int32)
    f = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        hd.decode_samples(w.to(torch.int64), f)
    with pytest.raises(ValueError):
        hd.decode_samples(w, f[:3])
    with pytest.raises(ValueError):
        hd.decode_samples(w[:2], f)
    with pytest.raises(ValueError):
        hd.decode_samples(w.to("meta"), f.to("meta"))
    assert not hd.decode_samples(w, f).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["fixture", "crafted_is_ms_short", "linbits"])
def test_dense_plane_equals_int8_plane(name, dtype, streams):
    """The decode plane from the scan's int32 plane (``raw_dense``) equals
    the plane from the host parse's int8 plane and escapes."""
    data = streams[name]
    p = pdh.parse_mp3(data, 0, backend="python")
    want = pdp.decode_granules(pdp.prep_to_torch(pdp.host_prepare(p), "cpu"),
                               dtype)
    lp, desc = pdh.parse_mp3_light(data, 0)
    prep = pdp.prep_to_torch(pdp.host_prepare(lp, raw=False), "cpu")
    assert not set(pdp.RAW_KEYS) & set(prep)
    prep["raw_dense"] = hd.decode_raw_device(desc, "cpu")
    got = pdp.decode_granules(prep, dtype)
    assert torch.equal(got, want)


@pytest.fixture
def scan_on_the_cpu(monkeypatch):
    monkeypatch.setattr(pdp, "scan_lanes", tlp.scan_here)


@pytest.fixture(scope="module")
def light_streams(fixture_mp3):
    with open(fixture_mp3, "rb") as f:
        return tlp.make_streams(f.read())


def _host_wav(data: bytes, precision: str, out) -> tuple:
    """The host fill's route to a WAV at ``out``: ``parse_mp3`` with the
    samples filled at parse time, then ``decode_pcm_i16`` on the CPU.
    Returns (the WAV's bytes, the stego bits)."""
    full = pdh.parse_mp3(data, 0, defer_samples=False)
    assert full.lanes is None and not full.samples_pending
    write_wav(str(out), full.header.sampling_rate,
              pdp.decode_pcm_i16(full, "cpu", precision))
    return out.read_bytes(), pdh.stego_bits(full)


def _decode(path, out, precision):
    d = pdec.Decoder(path, out, precision=precision, device="cpu")
    d.decode(quiet=True)
    with open(out, "rb") as f:
        return f.read(), d


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("name", tlp.STREAMS)
def test_decoder_device_engine_writes_host_bytes(name, precision,
                                                 light_streams, tmp_path,
                                                 scan_on_the_cpu):
    """The façade's ``Decoder`` writes the host fill's route's WAV bytes
    and stego bits: in float32 through the scan, in float64 on the CPU
    through the host plane, which reads the deferred fill."""
    data = light_streams[name]
    path = tmp_path / "in.mp3"
    path.write_bytes(data)
    host, bits = _host_wav(data, precision, tmp_path / "h.wav")
    n0 = len(P.spans())
    with P.recording():
        got, d = _decode(str(path), str(tmp_path / "d.wav"), precision)
    assert got == host and len(got) > 44
    assert d.output_bits == bits
    names = [s.name for s in P.spans()[n0:]]
    assert names.count("parse_mp3") == 1
    assert list(d.timer.times) == ["bitstream parse (host)"] + (
        ["host_prepare", "h2d", "device plane", "d2h"]
        if precision == "float32" else ["numeric plane (float64)"]) + [
        "wav write"]
    if native.get_lib() is not None:    # the light parse deferred them
        assert names.count("samples.device") == (precision == "float32")
        assert names.count("parse.fill") == (
            precision == "float64" or name.startswith("crafted_is"))


def test_device_engine_reveals(stego_golden, tmp_path, scan_on_the_cpu):
    """Reveal through the default façade reads ``table_select`` from the
    light parse."""
    from mp3stego_tpu_torch import Steganography
    path = tmp_path / "h.mp3"
    path.write_bytes(stego_golden["hidden_long"].tobytes())
    s = Steganography(quiet=True, precision="float32", device="cpu")
    s.reveal_massage(str(path), str(tmp_path / "r.txt"))
    assert (tmp_path / "r.txt").read_text() == \
        stego_golden["msg_long"].tobytes().decode()


def test_huffman_backend_selection(streams):
    """Where the scan runs is decided by ``decode_plane.scan_lanes``: a
    default parse of an MPEG-1 stream leaves its lanes with its samples
    pending, and they go to the scan on a card, not on the CPU; a parse
    whose samples were filled, or filled at parse time, scans nowhere."""
    data = streams["multirate_44100_128"]
    full = pdh.parse_mp3(data, 0, defer_samples=False)
    assert full.lanes is None and not full.samples_pending
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    p = pdh.parse_mp3(data, 0)
    if native.get_lib() is None:        # the Python full parse
        assert p.lanes is None and not p.samples_pending
        return
    assert p.lanes is not None and p.samples_pending
    assert pdp.scan_lanes(p, cuda) is p.lanes
    assert pdp.scan_lanes(p, "cuda:0") is p.lanes
    assert pdp.scan_lanes(p, cpu) is None
    for q in (full, p):
        q.raw_samples
        assert pdp.scan_lanes(q, cuda) is None


def _free_format(data: bytes) -> bytes:
    """``data`` (a CBR MPEG-1 stream) with every frame's bitrate index set
    to 0, "free": the frames keep their sizes, which only the spacing of
    the sync words now gives."""
    b = bytearray(data)
    sizes = pdh.parse_mp3(data, 0, backend="python").frame_sizes
    for start in np.concatenate([[0], np.cumsum(sizes)[:-1]]):
        b[int(start) + 2] &= 0x0F
    return bytes(b)


@pytest.fixture(scope="module")
def free_format_mp3(stego_golden):
    """The port's 128 kbps encode of the stego golden's WAV, free-format."""
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import read_wav
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "g.wav")
        with open(wav, "wb") as f:
            f.write(stego_golden["wav_bytes"].tobytes())
        enc = MP3Encoder(read_wav(wav, 128), device="cpu")
        enc.encode()
    return _free_format(bytes(enc.out_buffer))


def test_huffman_backend_keeps_lsf_and_free_format_on_the_host(
        streams, free_format_mp3, monkeypatch):
    """A stream whose head the light parse does not read gets its samples
    at parse time, and no lanes, so nothing scans it, on a card or not;
    without the native library no stream is light-parsed."""
    heads = {name: streams[name] for name in LSF}
    heads["free_format"] = free_format_mp3
    assert pdh.parse_header(*free_format_mp3[:4]).free_format
    for name, data in heads.items():
        p = pdh.parse_mp3(data, 0)
        assert p.lanes is None and not p.samples_pending, name
        assert p.num_frames > 0, name
        for dev in ("cpu", "cuda"):
            assert pdp.scan_lanes(p, dev) is None, (name, dev)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    p = pdh.parse_mp3(streams["fixture"], 0)
    assert p.lanes is None and not p.samples_pending
    assert pdp.scan_lanes(p, "cuda") is None


@pytest.mark.parametrize("name", ["torch_lsf_mpeg2_24k_64",
                                  "torch_lsf_mpeg2_22k05_80",
                                  "torch_lsf_mpeg25_8k_32"])
def test_lsf_decode_without_native_library_writes_host_bytes(
        name, streams, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    path = tmp_path / "lsf.mp3"
    path.write_bytes(streams[name])
    host, bits = _host_wav(streams[name], "float32", tmp_path / "h.wav")
    got, d = _decode(str(path), str(tmp_path / "d.wav"), "float32")
    assert got == host and len(host) > 44
    assert d.output_bits == bits


def test_free_format_decode_writes_host_bytes(free_format_mp3, tmp_path,
                                              monkeypatch):
    """The façade decodes every frame of a free-format stream, as the host
    parse does, and the Python light parse, the native one's oracle,
    reads every frame at the measured stride."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    path = tmp_path / "free.mp3"
    path.write_bytes(free_format_mp3)
    host, bits = _host_wav(free_format_mp3, "float32", tmp_path / "h.wav")
    frames = pdh.parse_mp3(free_format_mp3, 0, backend="python").num_frames
    assert frames > 30 and len(host) == 44 + 2 * 2 * 1152 * frames
    got, d = _decode(str(path), str(tmp_path / "a.wav"), "float32")
    assert got == host and d.output_bits == bits
    light, desc = pdh.parse_mp3_light(free_format_mp3, 0)
    assert light.num_frames == frames and len(desc) == 4 * frames


@pytest.mark.parametrize("name", ("fixture", "multirate_32000_64",
                                  "crafted_is_ms_short", "linbits",
                                  "flipped_1", "mono"))
def test_decode_pcm_device_equals_the_host_parse_decode(name, streams,
                                                        scan_on_the_cpu):
    """``decode_pcm`` of a default parse through the scan (light parse,
    scan, float32 plane) is bit for bit the port's float32 decode of the
    host fill."""
    data = streams[name]
    host = pdh.parse_mp3(data, 0, defer_samples=False)
    want = pdp.decode_pcm(host, "float32", "cpu")
    parsed = pdh.parse_mp3(data, 0)
    n0 = len(P.spans())
    with P.recording():
        got = pdp.decode_pcm(parsed, "float32", "cpu")
    if native.get_lib() is not None:
        assert [s.name for s in P.spans()[n0:]].count("samples.device") == 1
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert parsed.num_frames == host.num_frames
    assert vars(parsed.header) == vars(host.header)


def test_decode_pcm_device_within_one_lsb_of_the_jax_package(
        streams, scan_on_the_cpu):
    """Against the JAX package's ``decode_pcm_device`` on the CPU (as
    tests/test_huffman_device.py runs it): the float32 planes round apart
    (the JAX plane's linbits escapes go through exp2/log2), within 1 int16
    LSB."""
    parsed = pdh.parse_mp3(streams["fixture"], 0)
    got = pdp.decode_pcm(parsed, "float32", "cpu")
    want, jparsed = jhd.decode_pcm_device(streams["fixture"], 0)
    assert got.shape == want.shape and want.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1 / 32768
    assert parsed.header.bit_rate == jparsed.header.bit_rate == 320000
