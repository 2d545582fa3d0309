"""The port's ``Steganography`` façade (decode and reveal) against the JAX
package's, on the CPU.

* ``precision="float32", device="cpu"``: the torch plane's WAV is within
  1 int16 LSB of the JAX package's float64 WAV on fewer than 1e-3 of
  samples on the fixture (the tests/test_precision.py contract), and on
  fewer than 2e-3 on the three half-second MPEG-2/2.5 tone streams, where
  the JAX package's own float32 plane already flips 1.4e-3 (a float32 error
  of ~2e-7 on a loud stationary signal crosses more truncation boundaries);
  its float PCM stays within 1e-5 of float64 on all of them.
* ``precision="float64"``: WAV bytes equal the JAX package's exactly.

Both sides convert through the saturating int16 form. The golden
``wav_bytes`` are not used: they belong to the reference's original fixture,
which this suite does not mount.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mp3stego_tpu import Steganography as JaxSteganography  # noqa: E402
from mp3stego_tpu_torch import Steganography  # noqa: E402
from mp3stego_tpu_torch.ops import synth_fir as sf  # noqa: E402

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
    kp, wp = _decode(Steganography(quiet=True), stream_path[name],
                     str(tmp_path / "port.wav"))
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
    card raises at construction."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Steganography(quiet=True, precision="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        Steganography(quiet=True, precision="float32", device="cuda")
    assert Steganography(quiet=True).device is None     # float64: host


def test_cpu_decode_launches_no_kernel(stream_path, tmp_path):
    before = sf.launches
    Steganography(quiet=True, precision="float32", device="cpu") \
        .decode_mp3_to_wav(stream_path["fixture"], str(tmp_path / "c.wav"))
    assert sf.launches == before


def test_unknown_precision_rejected():
    with pytest.raises(ValueError, match="precision"):
        Steganography(precision="bfloat16")


@pytest.mark.parametrize("call", [
    lambda s: s.encode_wav_to_mp3("a.wav", "b.mp3"),
    lambda s: s.hide_message("a.mp3", "b.mp3", "m"),
    lambda s: s.clear_file("a.mp3", "b.mp3"),
    lambda s: s.message_capacity("a.mp3"),
])
def test_encoder_paths_not_ported(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(Steganography(quiet=True))


def test_path_checks_exit_like_the_reference(stream_path, tmp_path):
    s = Steganography(quiet=True)
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
