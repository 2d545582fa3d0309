"""The hide cell's pieces on the CPU: the in-memory composition writes the
façade's bytes; the plain reference encode writes the program's frames;
the stego file's message reads back; and the check reads the float32
control and the faults a hide can have as not correct."""

import numpy as np
import pytest
import torch

import core
import pool
import ref_encode as RE
import reference
import stego

SMALL = dict(pool=2, length_s=2.0)


def _workload(seed=2 ** 36 + 1):
    _, cfg, mix = core.find_cell("song320.hide")
    kind = core.load("kinds", "hide")
    return kind, kind.Workload(dict(cfg, **SMALL), mix, seed,
                               torch.device("cpu"))


def _run(seed=2 ** 41 + 5, **over):
    return core.run_cell("song320.hide", seed, 1.0, False, device="cpu",
                         overrides=dict(SMALL, **over), log=lambda m: None)


def test_in_memory_hide_is_the_facades(tmp_path):
    from mp3stego_tpu_torch import Steganography
    kind, w = _workload()
    try:
        for k, item in enumerate(w.items):
            w.call(k, None, {})
            _, got, too_long = w._last
            src = tmp_path / f"in{k}.mp3"
            dst = tmp_path / f"out{k}.mp3"
            src.write_bytes(item.data)
            want_long = Steganography(quiet=True, device="cpu").hide_message(
                str(src), str(dst), w.texts[k])
            assert got == dst.read_bytes() and too_long == want_long
            assert stego.framed(w.texts[k]) == w.frame(w.texts[k])
    finally:
        w.close()


@pytest.mark.parametrize("bits", ["", "hide"])
def test_reference_encode_writes_the_programs_frames(bits):
    import mp3gen
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import WavFile
    pcm = mp3gen.song_pcm(2.0, 31, "cpu")
    data, truth = mp3gen.encode(pcm, 320)
    dec = reference.decode(truth, "cpu")
    if bits:
        bits = stego.framed(stego.message(pool.rng(1, 4), 500))
    flat = dec.reshape(-1)
    w = WavFile(num_of_samples=dec.shape[0], mpeg_mode=0,
                buffer=np.concatenate([flat, np.zeros_like(flat)]))
    enc = MP3Encoder(w, hide_str=bits, device="cpu")
    enc.encode()
    out = bytes(enc.out_buffer)
    fe = RE.FrameEncoder(dec, 320, bits)
    starts = fe.starts()
    assert len(out) == int(fe.frame_bits.sum()) // 32 * 4
    state = RE.State()
    for f in range(fe.frames):
        frame, state = fe.encode(f, state)
        assert out[starts[f]:starts[f] + len(frame)] == \
            frame[:len(out) - starts[f]], f
    si = RE.side_info(out, starts[:-1])
    assert RE.stego_bits(si)[:len(bits)] == bits
    # a frame from the state the stream records before it
    f = fe.frames // 2
    at = RE.state_at(si, f)
    if at is not None:
        assert fe.encode(f, at)[0] == out[starts[f]:starts[f + 1]]


def test_message_fills_its_share():
    rng = pool.rng(5, 4)
    text = stego.message(rng, 4000)
    bits = stego.framed(text)
    assert 3900 < len(bits) <= 4000
    assert text.encode().decode() == text


def test_float32_control_is_not_correct():
    r = _run(precision="float32")
    assert r["correct"] is False
    assert r["checks"]["mismatched_samples"]["value"] > 0


def test_message_bit_altered_where_produced(monkeypatch):
    import mp3stego_tpu_torch.models.encoder as E
    real = E.MP3Encoder

    class Flipped(real):
        def __init__(self, wav, hide_str="", **k):
            hide_str = hide_str[:20] + ("1" if hide_str[20] == "0" else "0") \
                + hide_str[21:]
            super().__init__(wav, hide_str=hide_str, **k)
    monkeypatch.setattr(E, "MP3Encoder", Flipped)
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["message_bits_wrong"]["value"] >= 1


def test_stego_byte_altered_where_produced(monkeypatch):
    import mp3stego_tpu_torch.models.encoder as E
    real = E.MP3Encoder

    class Altered(real):
        def encode(self, quiet=True):
            super().encode(quiet)
            self.out_buffer[100] ^= 0x10      # main data of the first frame
    monkeypatch.setattr(E, "MP3Encoder", Altered)
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["frames_differing"]["value"] >= 1
