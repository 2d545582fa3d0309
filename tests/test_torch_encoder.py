"""The port's encoder against the goldens and the JAX package's encoder, on
the CPU (``device="cpu"``: the torch analysis and search planes run there).

* Bytes equal every golden the card's smoke run holds: ``encode_golden``
  (the fixture's WAV re-encoded), ``stego_golden`` ``hidden_short``/
  ``hidden_long``/``hidden_toolong`` with their ``too_long`` results,
  ``capstego_golden``, the five ``multirate_golden`` wav->mp3 pairs, the
  reference-layout MPEG-2/2.5 streams of ``mpeg2_golden`` and the
  spec-valid ones of ``torch_lsf_golden`` (``lsf_compliant=True``).
* JAX ``Encoder`` parity on a seeded multi-second WAV, encode and hide.
* The engines agree: the device hide with the host C++ engine on a song
  whose cursors the JAX design's re-pinning fixpoint needs several rounds
  to settle, the host C++ engine and the host oracle with the device plane,
  runs that send every lane through the host redo with the plain ones.

Tolerance: identical bytes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

from mp3stego_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from mp3stego_tpu_torch import Encoder  # noqa: E402
from mp3stego_tpu_torch import Steganography  # noqa: E402
from mp3stego_tpu_torch.models import encoder as E  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.ops import search_plane as SP  # noqa: E402
from mp3stego_tpu_torch.steganography import _frame_message  # noqa: E402
from mp3stego_tpu_torch.utils.profiling import StageTimer  # noqa: E402
from mp3stego_tpu_torch.utils.wav import WavFile, read_wav, write_wav  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MULTIRATE = ("32000_64", "32000_192", "44100_128", "48000_96", "48000_320")
MPEG2 = (("mpeg2_24k_64", 24000, 64), ("mpeg2_22k05_80", 22050, 80),
         ("mpeg25_8k_32", 8000, 32))


@pytest.fixture(scope="module")
def gold():
    return {n: np.load(os.path.join(GOLD, f"{n}.npz"))
            for n in ("encode_golden", "stego_golden", "capstego_golden",
                      "multirate_golden", "mpeg2_golden", "torch_lsf_golden")}


@pytest.fixture(scope="module")
def fixture_wav(tmp_path_factory, gold):
    p = tmp_path_factory.mktemp("wav") / "fixture.wav"
    p.write_bytes(gold["stego_golden"]["wav_bytes"].tobytes())
    return str(p)


@pytest.fixture(scope="module")
def seeded_wav(tmp_path_factory):
    """3 s of seeded 44.1 kHz stereo: two tones, a sweep, noise bursts."""
    rng = np.random.default_rng(2024)
    sr = 44100
    t = np.arange(3 * sr) / sr
    sig = (0.45 * np.sin(2 * np.pi * 220 * t)
           + 0.25 * np.sin(2 * np.pi * (500 + 1500 * t) * t)
           + 0.2 * rng.standard_normal(len(t)) * (np.sin(2 * np.pi * t) > 0))
    pcm = np.clip(sig * 30000, -32768, 32767).astype(np.int16)
    p = tmp_path_factory.mktemp("seeded") / "seeded.wav"
    write_wav(str(p), sr, np.stack([pcm, np.roll(pcm, 999)], axis=1))
    return str(p)


def _encode(wav_path, bitrate=320, hide="", **kw):
    enc = MP3Encoder(read_wav(wav_path, bitrate), hide_str=hide,
                     device=kw.pop("device", "cpu"), **kw)
    enc.encode()
    return enc


def _golden_case(case, gold):
    """(message or None, expected bytes, expected too_long) of a golden."""
    sg = gold["stego_golden"]
    if case == "clear":
        return None, gold["encode_golden"]["mp3_bytes"], False
    if case == "capstego":
        g = gold["capstego_golden"]
        return g["msg_cap"].tobytes().decode(), g["hidden_cap"], False
    msg = {"hidden_short": "ddd", "hidden_toolong": "ddd" * 100,
           "hidden_long": sg["msg_long"].tobytes().decode()}[case]
    return msg, sg[case], case == "hidden_toolong"


@pytest.mark.parametrize("case", ["clear", "hidden_short", "hidden_long",
                                  "hidden_toolong", "capstego"])
def test_fixture_goldens(case, gold, fixture_wav, tmp_path):
    msg, want, want_too_long = _golden_case(case, gold)
    out = str(tmp_path / "o.mp3")
    enc = Encoder(fixture_wav, out, 320,
                  hide_str="" if msg is None else _frame_message(msg),
                  device="cpu")
    assert enc.encode() is want_too_long
    with open(out, "rb") as f:
        assert f.read() == want.tobytes()


@pytest.mark.parametrize("tag", MULTIRATE)
def test_multirate_goldens(tag, gold, tmp_path):
    wav = tmp_path / "in.wav"
    wav.write_bytes(gold["multirate_golden"][f"wav_{tag}"].tobytes())
    enc = _encode(str(wav), int(tag.split("_")[1]))
    assert bytes(enc.out_buffer) == \
        gold["multirate_golden"][f"mp3_{tag}"].tobytes()


def _lsf_wav(pcm, sr, br):
    return WavFile(file_path="synth.wav", bitrate=br, num_of_channels=2,
                   samplerate=sr, bits_per_sample=16,
                   num_of_samples=len(pcm) // 2, mpeg_mode=0, buffer=pcm)


@pytest.mark.parametrize("compliant", [False, True])
@pytest.mark.parametrize("name,sr,br", MPEG2)
def test_lsf_goldens(name, sr, br, compliant, gold):
    """Reference LSF layout against ``mpeg2_golden``; the spec-valid writer
    against ``torch_lsf_golden``."""
    pcm = gold["mpeg2_golden"][name + "_pcm"]
    enc = MP3Encoder(_lsf_wav(pcm, sr, br), lsf_compliant=compliant,
                     device="cpu")
    enc.encode()
    want = gold["torch_lsf_golden" if compliant else "mpeg2_golden"][name]
    assert bytes(enc.out_buffer) == want.tobytes()


@pytest.mark.parametrize("message", [None, "seeded parity message #1"])
def test_seeded_wav_equals_jax_encoder(message, seeded_wav, tmp_path):
    bits = "" if message is None else _frame_message(message)
    jout, pout = str(tmp_path / "j.mp3"), str(tmp_path / "p.mp3")
    jtl = JaxEncoder(seeded_wav, jout, 256, hide_str=bits).encode()
    ptl = Encoder(seeded_wav, pout, 256, hide_str=bits, device="cpu").encode()
    assert ptl == jtl
    with open(jout, "rb") as a, open(pout, "rb") as b:
        assert b.read() == a.read()


@pytest.mark.parametrize("message", [None, "mono"])
def test_seeded_mono_wav_equals_jax_encoder(message, tmp_path):
    """Mono reads its samples at stride 1 (the reference has no working
    mono path to follow); both packages write the same bytes."""
    rng = np.random.default_rng(77)
    t = np.arange(44100 * 2) / 44100
    sig = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(len(t))
    wav = str(tmp_path / "mono.wav")
    write_wav(wav, 44100, np.clip(sig * 30000, -32768, 32767)
              .astype(np.int16))
    bits = "" if message is None else _frame_message(message)
    jout, pout = str(tmp_path / "j.mp3"), str(tmp_path / "p.mp3")
    jtl = JaxEncoder(wav, jout, 160, hide_str=bits).encode()
    ptl = Encoder(wav, pout, 160, hide_str=bits, device="cpu").encode()
    assert ptl == jtl
    with open(jout, "rb") as a, open(pout, "rb") as b:
        assert b.read() == a.read()


def test_seeded_hide_equals_jax_device_plane(seeded_wav, monkeypatch):
    """The JAX package's own device hide (fused pass A, pin, pass B) on the
    same WAV and bits."""
    from mp3stego_tpu.models.encoder import MP3Encoder as JaxMP3Encoder
    from mp3stego_tpu.utils.wav import read_wav as jax_read_wav
    monkeypatch.setenv("MP3STEGO_TPU_ENC_HOST", "0")
    bits = _frame_message("x" * 120)
    jenc = JaxMP3Encoder(jax_read_wav(seeded_wav, 320), hide_str=bits)
    jenc.encode()
    assert jenc.last_hide_parallel_stats["fused"] is True
    enc = _encode(seeded_wav, 320, bits)
    assert bytes(enc.out_buffer) == bytes(jenc.out_buffer)
    assert enc.hide_str_offset == jenc.hide_str_offset


@pytest.fixture(scope="module")
def long_song(tmp_path_factory, gold):
    """The fixture's MP3 four times over (144 frames), decoded to WAV in
    float64, and its capacity: at 90 % of it the JAX design's re-pinning
    fixpoint takes 3 extra rounds here, and more as songs grow."""
    d = tmp_path_factory.mktemp("long")
    mp3 = (gold["encode_golden"]["mp3_bytes"].tobytes() + b"\0") * 4
    (d / "song.mp3").write_bytes(mp3)
    steg = Steganography(quiet=True, device="cpu")
    cap = steg.message_capacity(str(d / "song.mp3"))   # drops its WAV
    steg.decode_mp3_to_wav(str(d / "song.mp3"), str(d / "song.wav"))
    return str(d / "song.wav"), cap


@pytest.mark.parametrize("share", [0.9, 0.5])
def test_hide_equals_host_engine_on_a_long_song(share, long_song):
    """The device hide resolves every cursor in one pass: its bytes equal
    the host C++ engine's, whose search runs the live cursor in order."""
    wav, cap = long_song
    rng = np.random.default_rng(10)
    msg = "".join(rng.choice(list("abcdefghij klmnop"), size=int(cap * share)))
    bits = _frame_message(msg)
    dev = _encode(wav, 320, bits)
    host = MP3Encoder(read_wav(wav, 320), hide_str=bits, device="cpu")
    assert host._encode_host(host._num_frames(), StageTimer())
    assert bytes(dev.out_buffer) == bytes(host.out_buffer)
    assert dev.hide_str_offset == host.hide_str_offset
    st = dev.hide_stats
    assert st["lanes"] == 576 and st["blocks"] == 1
    assert st["edge"] >= 1 and st["redone"] >= 1
    if share < 0.9:      # the lanes past the message keep the clear pass
        assert st["window_lanes"] < 576


@pytest.mark.parametrize("message", [None, "host engine"])
def test_host_engine_equals_device_plane(message, seeded_wav):
    bits = "" if message is None else _frame_message(message)
    plane = _encode(seeded_wav, 192, bits)
    host = MP3Encoder(read_wav(seeded_wav, 192), hide_str=bits, device="cpu")
    assert host._encode_host(host._num_frames(), StageTimer())
    assert bytes(host.out_buffer) == bytes(plane.out_buffer)
    assert host.hide_str_offset == plane.hide_str_offset


def _no_native_rate(monkeypatch, native_rate):
    """Run the NumPy oracle where the native search twin would run."""
    if native_rate == "0":
        monkeypatch.setattr(E, "_native_rate_lib", lambda: None)


@pytest.mark.parametrize("native_rate", ["1", "0"])
def test_host_oracle_equals_golden(native_rate, gold, fixture_wav,
                                   monkeypatch):
    """``device_search=False``: the sequential host search, native and
    NumPy, needs no device."""
    _no_native_rate(monkeypatch, native_rate)
    enc = MP3Encoder(read_wav(fixture_wav, 320), device_search=False)
    assert enc.device is None
    enc.encode()
    assert bytes(enc.out_buffer) == \
        gold["encode_golden"]["mp3_bytes"].tobytes()


@pytest.mark.parametrize("native_rate", ["1", "0"])
def test_every_lane_through_the_host_redo(native_rate, gold, fixture_wav,
                                          monkeypatch):
    """Flag every searched lane: the host oracle (the native twin, and the
    NumPy one) with the true address chains must still write the golden
    bytes."""
    _no_native_rate(monkeypatch, native_rate)
    orig = SP.search_torch        # the CPU's search, windows included

    def flag_all(xr, max_bits, sr_idx, hide=None):
        res = orig(xr, max_bits, sr_idx, hide)
        res["flags"] = torch.where(res["xrmax0"] == 0, SP.FLAG_ADDR, 0) \
            .to(torch.int32)
        return res

    monkeypatch.setattr(SP, "search_torch", flag_all)
    enc = _encode(fixture_wav)
    # 138 of the fixture's 144 granules are searched (6 are silent)
    assert enc.redo_stats["lanes"] == enc.redo_stats["ADDR"] == 138
    assert bytes(enc.out_buffer) == \
        gold["encode_golden"]["mp3_bytes"].tobytes()


@pytest.mark.parametrize("native_rate", ["1", "0"])
def test_every_hide_lane_through_the_host_redo(native_rate, gold,
                                               fixture_wav, monkeypatch):
    """Flag every searched lane under every window: the hide's scan then
    redoes each granule on the host at its true cursor, with the address
    chain, and must still write the ``hidden_long`` golden."""
    _no_native_rate(monkeypatch, native_rate)
    orig = SP.search_torch        # the CPU's search, windows included

    def flag_all(xr, max_bits, sr_idx, hide=None):
        res = orig(xr, max_bits, sr_idx, hide)
        res["flags"] = torch.where(res["xrmax0"] == 0, SP.FLAG_ADDR, 0) \
            .to(torch.int32)
        return res

    monkeypatch.setattr(SP, "search_torch", flag_all)
    msg, want, _ = _golden_case("hidden_long", gold)
    enc = _encode(fixture_wav, hide=_frame_message(msg))
    # the scan redoes the lanes the message reaches, the tail redo the rest
    assert enc.hide_stats["redone"] > 0
    assert enc.redo_stats["lanes"] == enc.redo_stats["ADDR"] \
        + enc.hide_stats["edge"] == 138
    assert bytes(enc.out_buffer) == want.tobytes()


def test_empty_message_equals_jax(seeded_wav, tmp_path):
    """hide_message("") still embeds the framing "0#"."""
    bits = _frame_message("")
    j, p = str(tmp_path / "j.mp3"), str(tmp_path / "p.mp3")
    assert JaxEncoder(seeded_wav, j, 128, hide_str=bits).encode() is False
    assert Encoder(seeded_wav, p, 128, hide_str=bits,
                   device="cpu").encode() is False
    with open(j, "rb") as a, open(p, "rb") as b:
        assert b.read() == a.read()


def test_stage_timer_names_the_plane_stages(fixture_wav):
    enc = _encode(fixture_wav, hide=_frame_message("stages"))
    assert list(enc.timer.times) == [
        "analysis+mdct (device)", "hide clear pass (device)", "d2h",
        "hide window pass (device)", "hide scan (host)", "redo (host)",
        "scfsi sums (device)", "assemble+serialize (host)"]
    assert enc.hide_stats == {"lanes": 144, "window_lanes": 92, "blocks": 1,
                              "sensitive": 2, "redone": 2, "edge": 1}


def _vbr_mp3encoder(wav, out):
    enc = MP3Encoder(read_wav(wav, 160), vbr=True, device="cpu")
    enc.encode()
    enc.write_mp3_file(out)


@pytest.mark.parametrize("make", [
    _vbr_mp3encoder,
    lambda w, out: Encoder(w, out, 160, vbr=True, device="cpu").encode(),
])
def test_vbr_bytes_equal_jax_package(make, fixture_wav, tmp_path):
    """VBR through ``MP3Encoder`` and ``Encoder``: bytes equal the JAX
    package's Encoder's."""
    out, jout = str(tmp_path / "p.mp3"), str(tmp_path / "j.mp3")
    make(fixture_wav, out)
    JaxEncoder(fixture_wav, jout, 160, vbr=True).encode()
    with open(out, "rb") as a, open(jout, "rb") as b:
        got = a.read()
        assert got == b.read()
    assert got[36:40] == b"Xing"          # after the 4-byte header + 32 si


def test_default_device_raises_without_a_card(fixture_wav, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MP3Encoder(read_wav(fixture_wav, 320))
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(fixture_wav, "o.mp3", 320, device="cuda")
