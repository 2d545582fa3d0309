"""The port's bounded-memory streaming decode and encode
(``mp3stego_tpu_torch.models.streaming``), mirroring tests/test_streaming.py
and tests/test_streaming_encode.py: every window and chunk alignment writes
the bytes of the whole-file path (the float64 decode, ``MP3Encoder``), and
the same bytes as the JAX package's streaming twins. The encode runs on
both engines: the host C++ chain (``device_search=False``) and the torch
planes the card runs by default, here on the CPU (``device="cpu"``), each
held to the whole-file encode and to the other. Tolerance: identical bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

from mp3stego_tpu_torch.bitstream import decoder_host as dh  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.models.streaming import (  # noqa: E402
    decode_file_streaming, encode_file_streaming)
from mp3stego_tpu_torch.ops import decode_plane as dp  # noqa: E402
from mp3stego_tpu_torch.utils.wav import read_wav, write_wav  # noqa: E402

N_FRAMES = 383   # ~10 s at 44.1 kHz


@pytest.fixture(scope="module")
def long_mp3(tmp_path_factory):
    """A multi-chunk CBR stream: 10 s of a seeded signal at 128 kbps,
    encoded by the port's host oracle (the native sequential search)."""
    d = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(7)
    t = np.arange(int(44100 * 10.0))
    sig = (0.4 * np.sin(2 * np.pi * 440 * t / 44100)
           + 0.08 * rng.standard_normal(len(t)))
    pcm = np.clip(sig * 22000, -32768, 32767).astype(np.int16)
    wav = d / "long.wav"
    write_wav(str(wav), 44100, np.stack([pcm, np.roll(pcm, 441)], axis=1))
    enc = MP3Encoder(read_wav(str(wav), 128), device_search=False)
    enc.encode()
    mp3 = d / "long.mp3"
    mp3.write_bytes(bytes(enc.out_buffer))
    return str(mp3), bytes(enc.out_buffer)


def _whole_file_wav(data, path):
    parsed = dh.parse_mp3(data, 0)
    write_wav(path, parsed.header.sampling_rate,
              dp.decode_pcm_i16_host(parsed))
    return parsed


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("chunk", [64, 100, N_FRAMES, 1000])
def test_streaming_matches_whole_file(long_mp3, tmp_path, chunk):
    path, data = long_mp3
    ref_wav = str(tmp_path / "ref.wav")
    parsed = _whole_file_wav(data, ref_wav)
    out_wav = str(tmp_path / f"s{chunk}.wav")
    info = decode_file_streaming(path, out_wav, chunk_frames=chunk,
                                 device="cpu")
    assert info["num_frames"] == parsed.num_frames == N_FRAMES
    assert info["bitrate"] == parsed.header.bit_rate // 1000
    assert _read(out_wav) == _read(ref_wav)
    assert info["stego_bits"] == dh.stego_bits(parsed)


def test_streaming_duplicate_tail_quirk(long_mp3, tmp_path):
    """A bad sync at the end triggers the reference's stale-PCM duplication
    (MP3_Parser.py:79); the final window reproduces it."""
    _, data = long_mp3
    broken = data + b"\x12\x34\x56\x78" * 4   # trailing garbage, no sync
    p = tmp_path / "broken.mp3"
    p.write_bytes(broken)
    ref_wav = str(tmp_path / "ref.wav")
    assert _whole_file_wav(broken, ref_wav).duplicate_last_pcm
    out_wav = str(tmp_path / "s.wav")
    decode_file_streaming(str(p), out_wav, chunk_frames=100, device="cpu")
    assert _read(out_wav) == _read(ref_wav)


def test_streaming_progress_and_single_chunk(long_mp3, tmp_path):
    path, _ = long_mp3
    seen = []
    decode_file_streaming(path, str(tmp_path / "one.wav"),
                          chunk_frames=10_000,
                          progress_cb=lambda d, t: seen.append((d, t)),
                          device="cpu")
    assert seen == [(N_FRAMES, N_FRAMES)]


def test_streaming_decode_equals_jax_package(long_mp3, tmp_path):
    from mp3stego_tpu.models.streaming import \
        decode_file_streaming as jax_streaming
    path, _ = long_mp3
    a, b = str(tmp_path / "p.wav"), str(tmp_path / "j.wav")
    pinfo = decode_file_streaming(path, a, chunk_frames=77, device="cpu")
    jinfo = jax_streaming(path, b, chunk_frames=77)
    assert _read(a) == _read(b)
    assert pinfo == jinfo


def test_streaming_lsf_decode(tmp_path):
    """MPEG-2/2.5 windows count real frames and re-derive their virtual
    frames."""
    import os
    lsf = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "golden", "torch_lsf_golden.npz"))
    for name in ("mpeg2_24k_64", "mpeg25_8k_32"):
        data = lsf[name].tobytes()
        mp3 = tmp_path / f"{name}.mp3"
        mp3.write_bytes(data)
        ref_wav = str(tmp_path / f"{name}_ref.wav")
        parsed = _whole_file_wav(data, ref_wav)
        out_wav = str(tmp_path / f"{name}.wav")
        info = decode_file_streaming(str(mp3), out_wav, chunk_frames=7,
                                     device="cpu")
        assert _read(out_wav) == _read(ref_wav)
        assert info["stego_bits"] == dh.stego_bits(parsed)


# ------------------------------------------------------------------ encode


def _wav_file(tmp_path, secs=2.0, sr=44100, seed=5, mono=False):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * secs))
    sig = 0.35 * np.sin(2 * np.pi * 440 * t / sr)
    sig[len(t) // 2:] += 0.25 * rng.standard_normal(len(t) - len(t) // 2)
    pcm = np.clip(sig * 20000, -32768, 32767).astype(np.int16)
    p = tmp_path / "in.wav"
    data = pcm if mono else np.stack([pcm, np.roll(pcm, 100)], axis=1)
    write_wav(str(p), sr, data)
    return str(p)


def _whole_file(wav_path, bitrate, hide_str=""):
    """The whole-file encode on the CPU planes."""
    enc = MP3Encoder(read_wav(wav_path, bitrate), hide_str=hide_str,
                     device="cpu")
    enc.encode()
    return bytes(enc.out_buffer)


@pytest.mark.parametrize("chunk", [1, 7, 64, 10_000])
def test_streaming_encode_byte_identity(tmp_path, chunk):
    wav = _wav_file(tmp_path)
    ref = _whole_file(wav, 192)
    out = tmp_path / "out.mp3"
    info = encode_file_streaming(wav, str(out), bitrate=192,
                                 chunk_frames=chunk, device_search=False)
    assert out.read_bytes() == ref
    assert info["bytes"] == len(ref)
    assert info["frames"] * 1152 >= 2 * 44100


def test_streaming_encode_hide_chain(tmp_path):
    """The stego cursor and the in-search transform thread through chunk
    boundaries exactly (the message spans many chunks)."""
    wav = _wav_file(tmp_path, secs=2.5)
    msg = "1011001110" * 40
    ref = _whole_file(wav, 128, hide_str=msg)
    out = tmp_path / "out.mp3"
    info = encode_file_streaming(wav, str(out), bitrate=128,
                                 chunk_frames=9, hide_str=msg,
                                 device_search=False)
    assert out.read_bytes() == ref
    assert info["too_long"] is False
    p = dh.parse_mp3(out.read_bytes(), 0)
    assert dh.stego_bits(p)[:len(msg)] == msg


def test_streaming_encode_mono_48k(tmp_path):
    wav = _wav_file(tmp_path, sr=48000, mono=True)
    ref = _whole_file(wav, 96)
    out = tmp_path / "out.mp3"
    encode_file_streaming(wav, str(out), bitrate=96, chunk_frames=11,
                          device_search=False)
    assert out.read_bytes() == ref


@pytest.mark.parametrize("sr,br", [(22050, 64), (11025, 32)])
def test_streaming_encode_lsf(tmp_path, sr, br, monkeypatch):
    """MPEG-2/2.5 (one granule per frame) through the chunked path, with
    the spec-valid LSF writer, whose stream decodes back."""
    monkeypatch.setenv("MP3STEGO_TPU_LSF_COMPLIANT", "1")
    wav = _wav_file(tmp_path, secs=1.5, sr=sr)
    ref = _whole_file(wav, br)
    out = tmp_path / "out.mp3"
    encode_file_streaming(wav, str(out), bitrate=br, chunk_frames=13,
                          device_search=False)
    assert out.read_bytes() == ref
    assert dh.parse_mp3(out.read_bytes(), 0).header.sampling_rate == sr


def test_streaming_encode_uses_mmap(tmp_path):
    """The WAV rides a memmap; short tails read as zeros."""
    wav = _wav_file(tmp_path, secs=0.5)
    assert isinstance(read_wav(wav, 128, use_mmap=True).buffer, np.memmap)
    out = tmp_path / "out.mp3"
    encode_file_streaming(wav, str(out), bitrate=128, chunk_frames=3,
                          device_search=False)
    assert out.read_bytes() == _whole_file(wav, 128)


def test_streaming_encode_equals_jax_package(tmp_path):
    from mp3stego_tpu.models.streaming import \
        encode_file_streaming as jax_streaming
    wav = _wav_file(tmp_path, secs=1.0)
    a, b = tmp_path / "p.mp3", tmp_path / "j.mp3"
    pinfo = encode_file_streaming(wav, str(a), bitrate=160, chunk_frames=5,
                                  hide_str="110" * 30, device_search=False)
    jinfo = jax_streaming(wav, str(b), bitrate=160, chunk_frames=5,
                          hide_str="110" * 30)
    assert a.read_bytes() == b.read_bytes()
    assert pinfo == jinfo


# ------------------------------------------------- encode on the torch planes


def _both_engines(wav, bitrate, chunk, tmp_path, hide_str=""):
    """The streaming encode on the torch planes (CPU) and on the host
    chain: (planes bytes, planes info, host bytes, host info)."""
    a, b = tmp_path / "planes.mp3", tmp_path / "host.mp3"
    pinfo = encode_file_streaming(wav, str(a), bitrate=bitrate,
                                  chunk_frames=chunk, hide_str=hide_str,
                                  device="cpu")
    hinfo = encode_file_streaming(wav, str(b), bitrate=bitrate,
                                  chunk_frames=chunk, hide_str=hide_str,
                                  device_search=False)
    return a.read_bytes(), pinfo, b.read_bytes(), hinfo


@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_streaming_encode_planes_clear(tmp_path, chunk):
    wav = _wav_file(tmp_path)
    ref = _whole_file(wav, 192)
    got, info, host, hinfo = _both_engines(wav, 192, chunk, tmp_path)
    assert got == ref == host
    assert info == hinfo == dict(frames=77, bytes=len(ref), too_long=False)


@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_streaming_encode_planes_hide(tmp_path, chunk):
    """The stego cursor, the eight-window pass and the host scan continue
    across windows; the message spans many of them."""
    wav = _wav_file(tmp_path, secs=2.5)
    msg = "1011001110" * 40
    ref = _whole_file(wav, 128, hide_str=msg)
    got, info, host, hinfo = _both_engines(wav, 128, chunk, tmp_path, msg)
    assert got == ref == host
    assert info == hinfo and info["too_long"] is False
    assert dh.stego_bits(dh.parse_mp3(got, 0))[:len(msg)] == msg


@pytest.mark.parametrize("chunk", [7, 512])
def test_streaming_encode_planes_too_long(tmp_path, chunk):
    """A message longer than the channel: ``too_long`` as the whole-file
    encode reports it, the same bytes."""
    wav = _wav_file(tmp_path, secs=0.5)
    msg = "".join(np.random.default_rng(chunk).choice(["0", "1"], 4000))
    enc = MP3Encoder(read_wav(wav, 128), hide_str=msg, device="cpu")
    enc.encode()
    want_too_long = enc.hide_str_offset < len(msg) - 1
    assert want_too_long
    got, info, host, hinfo = _both_engines(wav, 128, chunk, tmp_path, msg)
    assert got == bytes(enc.out_buffer) == host
    assert info["too_long"] is hinfo["too_long"] is True


def test_streaming_encode_planes_mono_48k(tmp_path):
    wav = _wav_file(tmp_path, sr=48000, mono=True)
    got, _, host, _ = _both_engines(wav, 96, 11, tmp_path)
    assert got == _whole_file(wav, 96) == host


@pytest.mark.parametrize("sr,br", [(22050, 64), (11025, 32)])
def test_streaming_encode_planes_lsf(tmp_path, sr, br, monkeypatch):
    monkeypatch.setenv("MP3STEGO_TPU_LSF_COMPLIANT", "1")
    wav = _wav_file(tmp_path, secs=1.5, sr=sr)
    got, _, host, _ = _both_engines(wav, br, 13, tmp_path)
    assert got == _whole_file(wav, br) == host


def test_streaming_encode_planes_carry_stale_addresses(tmp_path,
                                                       monkeypatch):
    """A quiet signal whose granules often quantize to count1 values only
    (big_values 0): a lane flagged FLAG_ADDR at a window's head reads the
    addresses its slot carried from the previous window
    (``MP3Encoder._slot_carry``), as the whole-file encode reads them."""
    from mp3stego_tpu_torch.models import encoder as enc_mod
    rng = np.random.default_rng(3)
    t = np.arange(2 * 44100)
    sig = 30 * (np.sin(2 * np.pi * 3000 * t / 44100)
                * (rng.random(t.size) < 0.02)
                + 0.3 * rng.standard_normal(t.size))
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    wav = str(tmp_path / "quiet.wav")
    write_wav(wav, 44100, np.stack([pcm, np.roll(pcm, 50)], axis=1))
    heads = []
    redo = enc_mod.MP3Encoder._redo_lane

    def spy(self, res, g, row, max_bits, prev, hide, flag):
        if prev[g] < 0 and self._slot_carry is not None:
            heads.append(flag)
        return redo(self, res, g, row, max_bits, prev, hide, flag)

    monkeypatch.setattr(enc_mod.MP3Encoder, "_redo_lane", spy)
    got, _, host, _ = _both_engines(wav, 128, 3, tmp_path)
    assert heads and all(f == enc_mod.SP.FLAG_ADDR for f in heads)
    assert got == _whole_file(wav, 128) == host


def test_streaming_encode_planes_window_spectra(tmp_path, monkeypatch):
    """Each window's spectra, analysed from its slice with the history and
    the context granule in front, are bitwise the same granules of the
    whole stream's analysis."""
    from mp3stego_tpu_torch.ops import encode_plane as EP
    wav = _wav_file(tmp_path, secs=1.0)
    w = read_wav(wav, 128)
    enc = MP3Encoder(w, device="cpu")
    whole = enc._analysis_device(enc._num_frames())
    seen = []
    stream = EP.analysis_stream

    def spy(full, chunk_g=EP.CHUNK_G, skip=0):
        out = stream(full, chunk_g, skip)
        seen.append(out)
        return out

    monkeypatch.setattr(EP, "analysis_stream", spy)
    encode_file_streaming(wav, str(tmp_path / "o.mp3"), bitrate=128,
                          chunk_frames=10, device="cpu")
    assert [x.shape[1] for x in seen] == [20] * 3 + [whole.shape[0] // 2
                                                     - 60]
    got = torch.cat([x.reshape(2, -1, 576) for x in seen], dim=1)
    assert torch.equal(got.reshape(-1, 576), whole)


def test_streaming_encode_default_device_is_the_card(tmp_path):
    """Without a card the default (CUDA) planes raise, naming the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    wav = _wav_file(tmp_path, secs=0.2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_file_streaming(wav, str(tmp_path / "o.mp3"), bitrate=128)
