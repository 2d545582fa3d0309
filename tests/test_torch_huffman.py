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
* ``Decoder`` with the device engine (``device="cpu"``) writes the host
  parse's WAV bytes in float32 and float64 and reveals the same bits;
* ``_huffman_backend`` picks the engine by the JAX package's rule, and
  "host" for the streams the light parse does not read (LSF and
  free-format heads) unless MP3STEGO_TPU_DEVICE_HUFFMAN=1 forces "device";
  with the native library patched away, an LSF or free-format decode
  writes the host parse's bytes, and the forced device engine reads a
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

from craft_mp3 import Granule, build_stream  # noqa: E402

from mp3stego_tpu.bitstream import decoder_host as jdh  # noqa: E402
from mp3stego_tpu.ops import huffman_device as jhd  # noqa: E402
from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.models import decoder as pdec  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402
from mp3stego_tpu_torch.ops import huffman_device as hd  # noqa: E402

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


def _decode(path, out, precision, engine, monkeypatch):
    monkeypatch.setenv("MP3STEGO_TPU_DEVICE_HUFFMAN", engine)
    d = pdec.Decoder(path, out, precision=precision, device="cpu")
    d.decode(quiet=True)
    with open(out, "rb") as f:
        return f.read(), d


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("name", ["fixture", "mono", "crafted_is_ms_short",
                                  "flipped_2"])
def test_decoder_device_engine_writes_host_bytes(name, precision, streams,
                                                 tmp_path, monkeypatch):
    path = tmp_path / "in.mp3"
    path.write_bytes(streams[name])
    host, dh_ = _decode(str(path), str(tmp_path / "h.wav"), precision, "0",
                        monkeypatch)
    dev, dd = _decode(str(path), str(tmp_path / "d.wav"), precision, "1",
                      monkeypatch)
    assert dev == host and len(dev) > 44
    assert "decode (device huffman)" in dd.timer.times
    assert "decode (device huffman)" not in dh_.timer.times
    assert dd.output_bits == dh_.output_bits


def test_device_engine_reveals(stego_golden, tmp_path, monkeypatch):
    """Reveal reads ``table_select`` from the light parse."""
    path = tmp_path / "h.mp3"
    path.write_bytes(stego_golden["hidden_long"].tobytes())
    monkeypatch.setenv("MP3STEGO_TPU_DEVICE_HUFFMAN", "1")
    d = pdec.Decoder(str(path), str(tmp_path / "h.wav"), precision="float32",
                     device="cpu")
    d.decode(quiet=True, reveal=True, txt_file_path=str(tmp_path / "r.txt"))
    assert (tmp_path / "r.txt").read_text() == \
        stego_golden["msg_long"].tobytes().decode()


def test_device_engine_refuses_lsf(streams, tmp_path, monkeypatch):
    """No fallback: the forced device engine raises on an LSF stream."""
    path = tmp_path / "lsf.mp3"
    path.write_bytes(streams["torch_lsf_mpeg2_24k_64"])
    monkeypatch.setenv("MP3STEGO_TPU_DEVICE_HUFFMAN", "1")
    with pytest.raises(ValueError, match="MPEG-1-only"):
        pdec.Decoder(str(path), str(tmp_path / "o.wav"),
                     precision="float32", device="cpu").decode(quiet=True)


def test_huffman_backend_selection(monkeypatch):
    """On a card the scan runs there behind the native light parse; off it,
    tests/test_backend_select.py's rule (the C++ parse when it loads), and
    float64 on the CPU (the host plane) keeps "host"."""
    from mp3stego_tpu_torch import native
    sel = pdec._huffman_backend
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("MP3STEGO_TPU_DEVICE_HUFFMAN", raising=False)
    monkeypatch.setattr(native, "get_lib", lambda: object())
    assert sel("float32", cpu) == "host"           # C++ wins when loadable
    assert sel("float64", cpu) == "host"
    assert sel("float32", cuda) == "device"        # the card's scan
    assert sel("float64", cuda) == "device"
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert sel("float32", cpu) == "device"         # beats the python parse
    assert sel("float32", cuda) == "device"
    assert sel("float64", cuda) == "device"        # the card's float64 plane
    assert sel("float64", cpu) == "host"           # the host float64 plane
    monkeypatch.setenv("MP3STEGO_TPU_DEVICE_HUFFMAN", "1")
    assert sel("float64", cpu) == "device"         # explicit override
    monkeypatch.setenv("MP3STEGO_TPU_DEVICE_HUFFMAN", "0")
    assert sel("float32", cuda) == "host"


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
    """Without the native library the device engine is the default, but
    not for a stream whose head the light parse does not read."""
    from mp3stego_tpu_torch import native
    sel = pdec._huffman_backend
    monkeypatch.delenv("MP3STEGO_TPU_DEVICE_HUFFMAN", raising=False)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    heads = {name: streams[name] for name in LSF}
    heads["free_format"] = free_format_mp3
    assert pdh.parse_header(*free_format_mp3[:4]).free_format
    for dev in (torch.device("cpu"), torch.device("cuda")):
        for precision in ("float32", "float64"):
            for name, data in heads.items():
                assert sel(precision, dev, data, 0) == "host", (name, dev)
            assert sel(precision, dev, streams["fixture"], 0) == (
                "host" if (precision, dev.type) == ("float64", "cpu")
                else "device")
    monkeypatch.setenv("MP3STEGO_TPU_DEVICE_HUFFMAN", "1")
    assert sel("float32", torch.device("cpu"), free_format_mp3, 0) == "device"


@pytest.mark.parametrize("name", ["torch_lsf_mpeg2_24k_64",
                                  "torch_lsf_mpeg2_22k05_80",
                                  "torch_lsf_mpeg25_8k_32"])
def test_lsf_decode_without_native_library_writes_host_bytes(
        name, streams, tmp_path, monkeypatch):
    from mp3stego_tpu_torch import native
    monkeypatch.setattr(native, "get_lib", lambda: None)
    path = tmp_path / "lsf.mp3"
    path.write_bytes(streams[name])
    host, _ = _decode(str(path), str(tmp_path / "h.wav"), "float32", "0",
                      monkeypatch)
    monkeypatch.delenv("MP3STEGO_TPU_DEVICE_HUFFMAN")
    d = pdec.Decoder(str(path), str(tmp_path / "d.wav"), precision="float32",
                     device="cpu")
    d.decode(quiet=True)
    assert "decode (device huffman)" not in d.timer.times
    assert (tmp_path / "d.wav").read_bytes() == host and len(host) > 44


def test_free_format_decode_writes_host_bytes(free_format_mp3, tmp_path,
                                              monkeypatch):
    """The default engine takes the host parse; the forced device engine
    reads every frame at the measured stride, so neither writes a short
    WAV."""
    from mp3stego_tpu_torch import native
    monkeypatch.setattr(native, "get_lib", lambda: None)
    path = tmp_path / "free.mp3"
    path.write_bytes(free_format_mp3)
    host, dh_ = _decode(str(path), str(tmp_path / "h.wav"), "float32", "0",
                        monkeypatch)
    frames = pdh.parse_mp3(free_format_mp3, 0, backend="python").num_frames
    assert frames > 30 and len(host) == 44 + 2 * 2 * 1152 * frames
    monkeypatch.delenv("MP3STEGO_TPU_DEVICE_HUFFMAN")
    d = pdec.Decoder(str(path), str(tmp_path / "a.wav"), precision="float32",
                     device="cpu")
    d.decode(quiet=True)
    assert "decode (device huffman)" not in d.timer.times
    assert (tmp_path / "a.wav").read_bytes() == host
    dev, dd = _decode(str(path), str(tmp_path / "d.wav"), "float32", "1",
                      monkeypatch)
    assert "decode (device huffman)" in dd.timer.times
    assert dev == host and dd.output_bits == dh_.output_bits


@pytest.mark.parametrize("name", ("fixture", "multirate_32000_64",
                                  "crafted_is_ms_short", "linbits",
                                  "flipped_1", "mono"))
def test_decode_pcm_device_equals_the_host_parse_decode(name, streams):
    """``decode_pcm_device`` (light parse, scan, float32 plane) is bit for
    bit the port's float32 decode through the host parse."""
    data = streams[name]
    got, parsed = hd.decode_pcm_device(data, 0, "cpu")
    host = pdh.parse_mp3(data, 0)
    want = pdp.decode_pcm(host, "float32", "cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert parsed.num_frames == host.num_frames
    assert vars(parsed.header) == vars(host.header)


def test_decode_pcm_device_within_one_lsb_of_the_jax_package(streams):
    """Against the JAX package's ``decode_pcm_device`` on the CPU (as
    tests/test_huffman_device.py runs it): the float32 planes round apart
    (the JAX plane's linbits escapes go through exp2/log2), within 1 int16
    LSB."""
    got, parsed = hd.decode_pcm_device(streams["fixture"], 0, "cpu")
    want, jparsed = jhd.decode_pcm_device(streams["fixture"], 0)
    assert got.shape == want.shape and want.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1 / 32768
    assert parsed.header.bit_rate == jparsed.header.bit_rate == 320000


def test_decode_pcm_device_refuses_lsf_like_the_int16_entry(streams):
    data = streams["torch_lsf_mpeg2_24k_64"]
    with pytest.raises(ValueError) as want:
        hd.decode_pcm_i16_device(data, 0, "cpu")
    with pytest.raises(ValueError) as got:
        hd.decode_pcm_device(data, 0, "cpu")
    assert str(got.value) == str(want.value)
