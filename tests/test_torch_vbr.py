"""The port's constant-quality VBR encode (beyond the reference, which is
CBR-only), on the CPU, mirroring tests/test_vbr_encode.py.

Bytes equal the JAX package's VBR encode on the same seeded WAV, for every
engine of the port (the device plane, whose lane costs come from
``search_plane.cost_step``; the host C++ engine and the host oracle, whose
costs come from the native ``rate_cost_step``). ``cost_step`` equals
``rate_cost_step`` on every lane at all 128 steps. Tolerance: identical
bytes and identical integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

from mp3stego_tpu_torch.bitstream import decoder_host as dh  # noqa: E402
from mp3stego_tpu_torch.bitstream import vbr  # noqa: E402
from mp3stego_tpu_torch.models import encoder as E  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as dp  # noqa: E402
from mp3stego_tpu_torch.ops import encode_plane as EP  # noqa: E402
from mp3stego_tpu_torch.ops import search_plane as SP  # noqa: E402
from mp3stego_tpu_torch.utils.profiling import StageTimer  # noqa: E402
from mp3stego_tpu_torch.utils.wav import WavFile, write_wav  # noqa: E402


def _pcm(secs=2.0, sr=44100, seed=0):
    """Half quiet sine, half noisy: forces the per-frame rates apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * secs))
    sig = 0.3 * np.sin(2 * np.pi * 440 * t / sr)
    half = len(t) // 2
    sig[half:] += 0.4 * rng.standard_normal(len(t) - half)
    pcm = np.clip(sig * 20000, -32768, 32767).astype(np.int16)
    buf = np.empty(2 * len(pcm), np.int16)
    buf[0::2] = pcm
    buf[1::2] = pcm
    return buf


def _wav(secs=2.0, sr=44100, target=128, seed=0, cls=WavFile):
    buf = _pcm(secs, sr, seed)
    return cls(file_path="synth.wav", bitrate=target, num_of_channels=2,
               samplerate=sr, bits_per_sample=16,
               num_of_samples=len(buf) // 2, mpeg_mode=0, buffer=buf)


def _jax_bytes(**kw):
    from mp3stego_tpu.models.encoder import MP3Encoder as JaxMP3Encoder
    from mp3stego_tpu.utils.wav import WavFile as JaxWavFile
    lsf = kw.pop("lsf_compliant", None)
    enc = JaxMP3Encoder(_wav(cls=JaxWavFile, **kw), vbr=True,
                        lsf_compliant=lsf)
    enc.encode(quiet=True)
    return bytes(enc.out_buffer)


@pytest.fixture(scope="module")
def vbr_mp3():
    enc = MP3Encoder(_wav(), vbr=True, device="cpu")
    enc.encode()
    return bytes(enc.out_buffer), enc


def test_vbr_stream_structure(vbr_mp3):
    data, enc = vbr_mp3
    tag = vbr.parse_vbr_tag(data, 0)
    assert tag is not None and tag.kind == "xing"
    assert tag.stream_bytes == len(data)
    assert tag.toc is not None and len(tag.toc) == 100
    assert (np.diff(tag.toc.astype(int)) >= 0).all()   # monotone seek table
    p = dh.parse_mp3(data, 0)
    assert p.num_frames == tag.frames + 1      # + the tag frame
    assert p.skip_first_pcm
    # every audio frame's byte size matches its own header (padding-free)
    assert (np.asarray(p.frame_sizes[1:-1])
            == enc._vbr_rates[:-1] * 144000 // 44100).all()
    # target average respected within one rate notch
    assert vbr.avg_bitrate_kbps(tag, p.header) in (112, 128, 160)
    rates = enc._vbr_rates
    assert len(set(rates.tolist())) >= 2
    h = len(rates) // 2
    assert rates[h:].mean() > rates[:h].mean()
    # the bisection over 128 steps costs about log2(128) + 1 of them
    assert 7 <= len(enc.vbr_steps) <= 10


def test_vbr_rejects_hide():
    with pytest.raises(ValueError, match="CBR"):
        MP3Encoder(_wav(), hide_str="101", vbr=True, device="cpu")


def test_vbr_equals_jax_package(vbr_mp3):
    assert vbr_mp3[0] == _jax_bytes()


@pytest.mark.parametrize("engine", ["host", "oracle", "oracle_numpy"])
def test_vbr_engines_byte_identical(engine, monkeypatch):
    """The host C++ engine and the host oracle (native, and NumPy with the
    costs from ``cost_step`` on the CPU) write the device plane's bytes."""
    plane = MP3Encoder(_wav(secs=1.0), vbr=True, device="cpu")
    plane.encode()
    if engine == "oracle_numpy":
        monkeypatch.setattr(E, "_native_rate_lib", lambda: None)
    if engine == "host":
        enc = MP3Encoder(_wav(secs=1.0), vbr=True, device="cpu")
        nf = enc._num_frames()
        assert enc._encode_host(nf, StageTimer())
        enc.out_buffer = bytearray(enc._xing_frame(nf)) + enc.out_buffer
    else:
        enc = MP3Encoder(_wav(secs=1.0), vbr=True, device_search=False)
        enc.encode()
    assert bytes(enc.out_buffer) == bytes(plane.out_buffer)
    assert enc.vbr_steps == plane.vbr_steps


@pytest.mark.parametrize("seed,band_row", [(1, 1), (0, 0), (4, 13)])
def test_lane_cost_equals_native_at_every_step(seed, band_row):
    """``cost_step`` against the native ``rate_cost_step`` on every lane at
    all 128 steps: the seeded song's spectra plus loud lanes that reach the
    float64 fallback, the bail and the ixmax gate."""
    lib = E._native_rate_lib()
    assert lib is not None
    buf = _pcm(secs=0.5, sr=44100)
    streams = np.stack([buf[0::2], buf[1::2]])
    tg = 2 * -(-streams.shape[1] // 1152)
    xr = EP.run_analysis_native(streams, tg).reshape(-1, 576)
    rng = np.random.default_rng(seed)
    loud = rng.integers(-2 ** 31, 2 ** 31, size=(24, 576)) \
        >> rng.integers(0, 28, size=(24, 1))
    xr = np.ascontiguousarray(np.concatenate([xr, loud]).astype(np.int32))
    xr_t = torch.from_numpy(xr)
    gated = 0
    for s in range(128):
        want = np.empty(len(xr), np.int64)
        lib.rate_cost_step(xr, len(xr), s - 127, band_row * 23, 1 << 20,
                           want)
        got = SP.cost_step(xr_t, s - 127, band_row).numpy()
        assert np.array_equal(got, want), s
        gated += int((want == 1 << 20).sum())
    assert 0 < gated < 128 * len(xr)


def test_vbr_decode_all_surfaces(vbr_mp3, tmp_path):
    """True VBR decode: the whole-file float64 plane, the batched decode
    and the streaming decode agree across varying frame sizes."""
    from mp3stego_tpu_torch.models.streaming import decode_file_streaming
    from mp3stego_tpu_torch.parallel import decode_files_batched
    from mp3stego_tpu_torch.utils.wav import wav_header

    data, _ = vbr_mp3
    mp3 = tmp_path / "v.mp3"
    mp3.write_bytes(data)
    p = dh.parse_mp3(data, 0)
    ref = dp.decode_pcm_i16_host(p)
    ref_f32 = dp.decode_pcm_i16(p, torch.device("cpu"))
    for o in decode_files_batched([str(mp3)] * 2, out="int16",
                                  device="cpu"):
        np.testing.assert_array_equal(o, ref_f32)
    out_wav = tmp_path / "v.wav"
    info = decode_file_streaming(str(mp3), str(out_wav), chunk_frames=13,
                                 device="cpu")
    assert out_wav.read_bytes() == wav_header(
        p.header.sampling_rate, ref.shape[1], ref.nbytes) + ref.tobytes()
    assert info["bitrate"] == vbr.avg_bitrate_kbps(
        vbr.parse_vbr_tag(data, 0), p.header)


def test_vbr_encoder_and_decoder_roundtrip(tmp_path):
    """Encoder(vbr=True) -> Decoder: the reported bitrate is the Xing
    average; the bytes equal the JAX package's Encoder's."""
    from mp3stego_tpu.models.encoder import Encoder as JaxEncoder
    from mp3stego_tpu_torch.models.decoder import Decoder
    from mp3stego_tpu_torch.models.encoder import Encoder

    wav_path = tmp_path / "in.wav"
    write_wav(str(wav_path), 44100, _pcm(secs=1.0).reshape(-1, 2))
    mp3_path, jax_path = tmp_path / "out.mp3", tmp_path / "jax.mp3"
    Encoder(str(wav_path), str(mp3_path), bitrate=128, vbr=True,
            device="cpu").encode()
    JaxEncoder(str(wav_path), str(jax_path), bitrate=128, vbr=True) \
        .encode(quiet=True)
    data = mp3_path.read_bytes()
    assert data == jax_path.read_bytes()
    tag = vbr.parse_vbr_tag(data, 0)
    assert tag is not None
    kbps = Decoder(str(mp3_path), str(tmp_path / "out.wav"),
                   device="cpu").decode()
    assert kbps == vbr.avg_bitrate_kbps(tag, dh.parse_mp3(data, 0).header)


def test_vbr_lsf_stream():
    """MPEG-2 VBR with the spec-valid LSF writer: bytes equal the JAX
    package's, the tag parses and the stream decodes (virtual frames with
    per-frame sizes)."""
    enc = MP3Encoder(_wav(secs=1.5, sr=22050, target=48), vbr=True,
                     lsf_compliant=True, device="cpu")
    enc.encode()
    data = bytes(enc.out_buffer)
    assert data == _jax_bytes(secs=1.5, sr=22050, target=48,
                              lsf_compliant=True)
    tag = vbr.parse_vbr_tag(data, 0)
    assert tag is not None and tag.stream_bytes == len(data)
    p = dh.parse_mp3(data, 0)
    assert p.skip_first_pcm and p.lsf_granules == tag.frames + 1
    out = dp.decode_pcm_i16_host(p)
    assert out.shape[0] == tag.frames * 576 + (
        576 if p.duplicate_last_pcm else 0)
