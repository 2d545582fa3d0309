"""The port's ``Steganography`` façade (decode and reveal) against the JAX
package's, on the CPU.

* ``precision="float32", device="cpu"``: the torch plane's WAV is within
  1 int16 LSB of the JAX package's float64 WAV on fewer than 1e-3 of
  samples on the fixture (the tests/test_precision.py contract), and on
  fewer than 2e-3 on the three half-second MPEG-2/2.5 tone streams, where
  the JAX package's own float32 plane already flips 1.4e-3 (a float32 error
  of ~2e-7 on a loud stationary signal crosses more truncation boundaries);
  its float PCM stays within 1e-5 of float64 on all of them.
* ``precision="float64"``: WAV bytes equal the JAX package's exactly (the
  host plane under ``device="cpu"``; the default device is the card).
* Encode, hide (then reveal), clear, capacity and the ID3 carry-over with
  ``device="cpu"``: bytes equal the JAX façade's.

Both sides convert through the saturating int16 form. The golden
``wav_bytes`` are not used: they belong to the reference's original fixture,
which this suite does not mount.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

from mp3stego_tpu import Steganography as JaxSteganography  # noqa: E402
from mp3stego_tpu_torch import Steganography  # noqa: E402
from mp3stego_tpu_torch.ops import synth as sf  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
LSF = ("mpeg2_24k_64", "mpeg2_22k05_80", "mpeg25_8k_32")
MULTIRATE = ("mp3_32000_64", "mp3_48000_320")
MAX_LSB_RATE = {"fixture": 1e-3, **{name: 2e-3 for name in LSF}}


@pytest.fixture(scope="module")
def stream_path(tmp_path_factory, fixture_mp3):
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    multi = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    d = tmp_path_factory.mktemp("streams")
    paths = {"fixture": fixture_mp3}
    for name in LSF:
        paths[name] = str(d / f"{name}.mp3")
        with open(paths[name], "wb") as f:
            f.write(lsf[name].tobytes())
    for name in MULTIRATE:
        paths[name] = str(d / f"{name}.mp3")
        with open(paths[name], "wb") as f:
            f.write(multi[name].tobytes())
    return paths


def _decode(stego, mp3, wav):
    kbps = stego.decode_mp3_to_wav(mp3, wav)
    with open(wav, "rb") as f:
        return kbps, f.read()


@pytest.mark.parametrize("name", ("fixture",) + LSF + MULTIRATE)
def test_f64_wav_bytes_equal_jax(name, stream_path, tmp_path):
    kj, wj = _decode(JaxSteganography(quiet=True), stream_path[name],
                     str(tmp_path / "jax.wav"))
    kp, wp = _decode(Steganography(quiet=True, device="cpu"),
                     stream_path[name], str(tmp_path / "port.wav"))
    assert kp == kj
    assert wp == wj


@pytest.mark.parametrize("name", ("fixture",) + LSF)
def test_f32_wav_within_one_lsb_of_jax_f64(name, stream_path, tmp_path):
    kj, wj = _decode(JaxSteganography(quiet=True), stream_path[name],
                     str(tmp_path / "jax.wav"))
    kp, wp = _decode(Steganography(quiet=True, precision="float32",
                                   device="cpu"),
                     stream_path[name], str(tmp_path / "port.wav"))
    assert kp == kj
    assert wp[:44] == wj[:44]
    a = np.frombuffer(wp[44:], np.int16).astype(np.int32)
    b = np.frombuffer(wj[44:], np.int16).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 1
    assert (d != 0).mean() < MAX_LSB_RATE[name]


@pytest.mark.parametrize("name", ("fixture",) + LSF)
def test_f32_pcm_float_error_small(name, stream_path):
    from mp3stego_tpu.bitstream import decoder_host as jdh
    from mp3stego_tpu.ops import decode_plane as jdp
    from mp3stego_tpu_torch.bitstream import decoder_host as pdh
    from mp3stego_tpu_torch.ops import decode_plane as pdp
    with open(stream_path[name], "rb") as f:
        data = f.read()
    want = jdp.decode_pcm(jdh.parse_mp3(data, 0), "float64")
    got = pdp.decode_pcm(pdh.parse_mp3(data, 0), "float32", device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("key", ["hidden_short", "hidden_long"])
def test_reveal_golden_messages(key, precision, tmp_path):
    gold = np.load(os.path.join(GOLD, "stego_golden.npz"))
    want = {"hidden_short": gold["msg_short"],
            "hidden_long": gold["msg_long"]}[key].tobytes().decode()
    mp3 = tmp_path / "h.mp3"
    mp3.write_bytes(gold[key].tobytes())
    txt = str(tmp_path / "h.txt")
    s = Steganography(quiet=True, precision=precision, device="cpu")
    s.reveal_massage(str(mp3), txt)
    with open(txt) as f:
        assert f.read() == want
    assert not (tmp_path / "h.wav").exists(), "reveal drops its temp WAV"


def test_f32_default_device_raises_without_a_card(monkeypatch):
    """No silent CPU fallback: float32 with the default (CUDA) device and no
    card raises at construction, and so does the default float64 decode,
    naming the way to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Steganography(quiet=True, precision="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        Steganography(quiet=True, precision="float32", device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Steganography(quiet=True)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_default_device_is_the_card(precision, monkeypatch):
    """Both precisions resolve ``device=None`` to CUDA (the float64 decode
    no longer stays on the host unless asked for the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    s = Steganography(quiet=True, precision=precision)
    assert s.device == torch.device("cuda")
    assert Steganography(quiet=True, precision=precision,
                         device="cpu").device == torch.device("cpu")


def test_cpu_decode_launches_no_kernel(stream_path, tmp_path):
    before = sf.launches
    Steganography(quiet=True, precision="float32", device="cpu") \
        .decode_mp3_to_wav(stream_path["fixture"], str(tmp_path / "c.wav"))
    assert sf.launches == before


def test_unknown_precision_rejected():
    with pytest.raises(ValueError, match="precision"):
        Steganography(precision="bfloat16")


@pytest.mark.parametrize("call,kbps", [
    (lambda s, w, o: s.encode_wav_to_mp3(w, o, vbr=True), 320),
    (lambda s, w, o: s.encode_wav_to_mp3(w, o, 128, True), 128),
    (lambda s, w, o: s._encode(w, o, 320, vbr=True), 320),
])
def test_vbr_facade_bytes_equal_jax_package(call, kbps, fixture_wav,
                                            tmp_path):
    """VBR through the façade writes the JAX façade's bytes, Xing tag
    first."""
    out, jout = str(tmp_path / "p.mp3"), str(tmp_path / "j.mp3")
    call(Steganography(quiet=True, device="cpu"), fixture_wav, out)
    JaxSteganography(quiet=True).encode_wav_to_mp3(fixture_wav, jout, kbps,
                                                   vbr=True)
    assert _bytes(out) == _bytes(jout)
    assert _bytes(out)[36:40] == b"Xing"


def test_vbr_hide_raises_value_error(fixture_wav, tmp_path):
    """A VBR hide raises ``ValueError`` (as the JAX package does) before
    any output is written."""
    out = str(tmp_path / "h.mp3")
    with pytest.raises(ValueError, match="CBR"):
        Steganography(quiet=True, device="cpu")._encode(
            fixture_wav, out, 320, hide_bits="01", vbr=True)
    assert not os.path.exists(out)


@pytest.fixture(scope="module")
def fixture_wav(tmp_path_factory, fixture_mp3):
    """The fixture decoded (float64, the parity WAV)."""
    wav = str(tmp_path_factory.mktemp("fwav") / "fixture.wav")
    JaxSteganography(quiet=True).decode_mp3_to_wav(fixture_mp3, wav)
    return wav


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kbps", [320, 128])
def test_encode_wav_to_mp3_equals_jax(kbps, fixture_wav, tmp_path):
    j, p = str(tmp_path / "j.mp3"), str(tmp_path / "p.mp3")
    JaxSteganography(quiet=True).encode_wav_to_mp3(fixture_wav, j, kbps)
    Steganography(quiet=True, device="cpu").encode_wav_to_mp3(fixture_wav, p,
                                                              kbps)
    assert _bytes(p) == _bytes(j)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("message", ["ddd", "the port hides, too"])
def test_hide_then_reveal(message, precision, fixture_mp3, tmp_path):
    """float64: the hidden bytes equal the JAX façade's. float32 (the torch
    decode plane): the WAV may differ by 1 LSB, so the bytes may too; the
    message still reads back."""
    out = str(tmp_path / "h.mp3")
    s = Steganography(quiet=True, precision=precision, device="cpu")
    too_long = s.hide_message(fixture_mp3, out, message)
    if precision == "float64":
        j = str(tmp_path / "j.mp3")
        assert too_long == JaxSteganography(quiet=True).hide_message(
            fixture_mp3, j, message)
        assert _bytes(out) == _bytes(j)
    assert too_long is False
    txt = str(tmp_path / "r.txt")
    s.reveal_massage(out, txt)
    with open(txt) as f:
        assert f.read() == message


def test_clear_file_equals_jax(fixture_mp3, tmp_path):
    j, p = str(tmp_path / "j.mp3"), str(tmp_path / "p.mp3")
    JaxSteganography(quiet=True).clear_file(fixture_mp3, j)
    Steganography(quiet=True, device="cpu").clear_file(fixture_mp3, p)
    assert _bytes(p) == _bytes(j)


def test_message_capacity_equals_jax_and_is_exact(fixture_mp3, tmp_path):
    s = Steganography(quiet=True, device="cpu")
    c = s.message_capacity(fixture_mp3)
    assert c == JaxSteganography(quiet=True).message_capacity(fixture_mp3)
    assert c > 0
    assert s.hide_message(fixture_mp3, str(tmp_path / "fit.mp3"),
                          "x" * c) is False
    assert s.hide_message(fixture_mp3, str(tmp_path / "over.mp3"),
                          "x" * (c + 1)) is True


@pytest.mark.parametrize("keep_id3", [False, True])
def test_keep_id3_equals_jax(keep_id3, fixture_mp3, tmp_path):
    """With keep_id3 the input's ID3v2 tag is carried over to the hidden
    and the cleared file, byte for byte as the JAX façade does."""
    tag = (b"ID3\x03\x00\x00\x00\x00\x00\x15"
           b"TIT2\x00\x00\x00\x0b\x00\x00\x00port title")
    tagged = str(tmp_path / "tagged.mp3")
    with open(tagged, "wb") as f:
        f.write(tag + _bytes(fixture_mp3))
    s = Steganography(quiet=True, keep_id3=keep_id3, device="cpu")
    js = JaxSteganography(quiet=True, keep_id3=keep_id3)
    for op in ("hide", "clear"):
        p, j = str(tmp_path / f"p_{op}.mp3"), str(tmp_path / f"j_{op}.mp3")
        if op == "hide":
            s.hide_message(tagged, p, "id3")
            js.hide_message(tagged, j, "id3")
        else:
            s.clear_file(tagged, p)
            js.clear_file(tagged, j)
        assert _bytes(p) == _bytes(j)
        assert _bytes(p).startswith(tag) is keep_id3


def test_encoder_default_device_raises_without_a_card(fixture_wav, tmp_path,
                                                      monkeypatch):
    """No silent CPU fallback for the encoder either: with the default
    device and no card, encoding raises."""
    from mp3stego_tpu_torch import Encoder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(fixture_wav, str(tmp_path / "o.mp3"), 320).encode()


def test_path_checks_exit_like_the_reference(stream_path, tmp_path):
    s = Steganography(quiet=True, device="cpu")
    with pytest.raises(SystemExit, match="not found"):
        s.decode_mp3_to_wav(str(tmp_path / "missing.mp3"))
    with pytest.raises(SystemExit, match="must be mp3"):
        s.decode_mp3_to_wav(stream_path["fixture"], str(tmp_path / "x.raw"))
    with pytest.raises(SystemExit, match="must be txt"):
        s.reveal_massage(stream_path["fixture"], str(tmp_path / "x.doc"))


def test_stage_timer_covers_the_device_path(stream_path, tmp_path):
    s = Steganography(quiet=True, precision="float32", device="cpu")
    s.decode_mp3_to_wav(stream_path["fixture"], str(tmp_path / "t.wav"))
    assert list(s._last_decoder.timer.times) == [
        "bitstream parse (host)", "host_prepare", "h2d", "device plane",
        "d2h", "wav write"]


def test_trace_names_stages_like_the_jax_scopes(stream_path, tmp_path,
                                                monkeypatch):
    """MP3STEGO_TPU_TRACE=<dir> writes a torch.profiler trace whose decode
    plane stages carry the JAX package's named_scope names."""
    import json
    monkeypatch.setenv("MP3STEGO_TPU_TRACE", str(tmp_path / "trace"))
    s = Steganography(quiet=True, precision="float32", device="cpu")
    s.decode_mp3_to_wav(stream_path["fixture"], str(tmp_path / "t.wav"))
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    for scope in ("requantize", "stereo", "reorder_alias", "imdct",
                  "overlap_freqinv", "synth_v", "synth_fir"):
        assert scope in names, scope
