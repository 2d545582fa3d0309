"""The port's CLI (``python -m mp3stego_tpu_torch``), every subcommand run
in-process through ``main(argv)`` with ``--device cpu``. Each output is held
to the bytes of the API call it routes to (the façade, the streaming and
batched paths, the goldens). Tolerance: identical bytes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

from mp3stego_tpu_torch import Steganography  # noqa: E402
from mp3stego_tpu_torch.__main__ import main  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.parallel import decode_files_batched  # noqa: E402
from mp3stego_tpu_torch.utils.wav import read_wav, write_wav  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory, fixture_mp3):
    """The fixture MP3, its golden WAV and the encode golden's bytes."""
    d = tmp_path_factory.mktemp("cli")
    sg = np.load(os.path.join(GOLD, "stego_golden.npz"))
    wav = str(d / "golden.wav")
    with open(wav, "wb") as f:
        f.write(sg["wav_bytes"].tobytes())
    mp3 = str(d / "fixture.mp3")
    with open(fixture_mp3, "rb") as src, open(mp3, "wb") as f:
        f.write(src.read())
    eg = np.load(os.path.join(GOLD, "encode_golden.npz"))["mp3_bytes"]
    return dict(mp3=mp3, wav=wav, encoded=eg.tobytes())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("extra", [[], ["--stream-chunk-frames", "7"]])
def test_decode(extra, files, tmp_path, capsys):
    out = str(tmp_path / "o.wav")
    assert main(CPU + ["decode", files["mp3"], out] + extra) == 0
    ref = str(tmp_path / "ref.wav")
    Steganography(quiet=True, device="cpu").decode_mp3_to_wav(files["mp3"], ref)
    assert _read(out) == _read(ref)
    assert "decoded at 320 kbps" in capsys.readouterr().out


def test_decode_float32_on_the_device_plane(files, tmp_path):
    out = str(tmp_path / "o.wav")
    assert main(CPU + ["--precision", "float32", "decode", files["mp3"],
                       out]) == 0
    ref = str(tmp_path / "ref.wav")
    Steganography(quiet=True, precision="float32", device="cpu") \
        .decode_mp3_to_wav(files["mp3"], ref)
    assert _read(out) == _read(ref)


@pytest.mark.parametrize("extra", [[], ["--stream-chunk-frames", "5"]])
def test_encode(extra, files, tmp_path):
    out = str(tmp_path / "o.mp3")
    assert main(CPU + ["encode", files["wav"], out] + extra) == 0
    assert _read(out) == files["encoded"]


def test_encode_vbr(files, tmp_path, capsys):
    out = str(tmp_path / "o.mp3")
    assert main(CPU + ["encode", files["wav"], out, "--bitrate", "128",
                       "--vbr"]) == 0
    enc = MP3Encoder(read_wav(files["wav"], 128), vbr=True, device="cpu")
    enc.encode()
    assert _read(out) == bytes(enc.out_buffer)
    assert "average (VBR)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(CPU + ["encode", files["wav"], out, "--vbr",
                    "--stream-chunk-frames", "4"])


def test_encode_lsf_compliant(tmp_path, monkeypatch):
    """--lsf-compliant writes the spec-valid LSF golden and leaves the
    process environment as it found it."""
    monkeypatch.delenv("MP3STEGO_TPU_LSF_COMPLIANT", raising=False)
    m2 = np.load(os.path.join(GOLD, "mpeg2_golden.npz"))
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    wav = str(tmp_path / "in.wav")
    write_wav(wav, 24000, m2["mpeg2_24k_64_pcm"].reshape(-1, 2))
    out = str(tmp_path / "o.mp3")
    assert main(CPU + ["encode", wav, out, "--bitrate", "64",
                       "--lsf-compliant"]) == 0
    assert _read(out) == lsf["mpeg2_24k_64"].tobytes()
    assert "MP3STEGO_TPU_LSF_COMPLIANT" not in os.environ


def test_hide_reveal_capacity(files, tmp_path, capsys):
    hidden = str(tmp_path / "h.mp3")
    assert main(CPU + ["hide", files["mp3"], hidden, "cli message"]) == 0
    ref = str(tmp_path / "ref.mp3")
    Steganography(quiet=True, device="cpu").hide_message(
        files["mp3"], ref, "cli message")
    assert _read(hidden) == _read(ref)
    txt = str(tmp_path / "m.txt")
    assert main(CPU + ["reveal", hidden, txt]) == 0
    assert _read(txt) == b"cli message"
    capsys.readouterr()
    assert main(CPU + ["capacity", files["mp3"]]) == 0
    cap = int(capsys.readouterr().out.split()[0])
    assert cap == Steganography(quiet=True, device="cpu") \
        .message_capacity(files["mp3"])
    assert main(CPU + ["hide", files["mp3"], hidden, "x" * (cap + 1)]) == 1


def test_clear_and_keep_id3(files, tmp_path):
    tag = (b"ID3\x03\x00\x00\x00\x00\x00\x15"
           b"TIT2\x00\x00\x00\x0b\x00\x00\x00port title")
    tagged = str(tmp_path / "tagged.mp3")
    with open(tagged, "wb") as f:
        f.write(tag + _read(files["mp3"]))
    plain, kept = str(tmp_path / "c.mp3"), str(tmp_path / "k.mp3")
    assert main(CPU + ["clear", tagged, plain]) == 0
    assert main(CPU + ["clear", tagged, kept, "--keep-id3"]) == 0
    ref = str(tmp_path / "ref.mp3")
    Steganography(quiet=True, device="cpu").clear_file(files["mp3"], ref)
    assert _read(plain) == _read(ref)
    assert _read(kept) == tag + _read(ref)
    hid = str(tmp_path / "h.mp3")
    assert main(CPU + ["hide", tagged, hid, "id3", "--keep-id3"]) == 0
    assert _read(hid).startswith(tag)


def test_decode_batch_and_resume(files, tmp_path, capsys):
    bad = str(tmp_path / "bad.mp3")
    with open(bad, "wb") as f:
        f.write(b"not an mp3")
    out = tmp_path / "out"
    out.mkdir()
    other = str(tmp_path / "other.mp3")
    with open(other, "wb") as f:
        f.write(np.load(os.path.join(GOLD, "multirate_golden.npz"))
                ["mp3_32000_64"].tobytes())
    args = CPU + ["decode-batch", files["mp3"], other, bad, "--outdir",
                  str(out)]
    assert main(args) == 1                               # bad.mp3 failed
    assert "FAILED" in capsys.readouterr().out
    want = decode_files_batched([files["mp3"], other], out="int16",
                                device="cpu")
    for name, pcm, rate in (("fixture", want[0], 44100),
                            ("other", want[1], 32000)):
        ref = str(tmp_path / f"{name}_ref.wav")
        write_wav(ref, rate, pcm)
        assert _read(str(out / f"{name}.wav")) == _read(ref)
    assert main(args[:-3] + ["--outdir", str(out), "--resume"]) == 0
    assert "skipping 2" in capsys.readouterr().out


def test_encode_batch_and_resume(files, tmp_path, capsys):
    out = tmp_path / "out"
    out.mkdir()
    args = CPU + ["encode-batch", files["wav"], str(tmp_path / "none.wav"),
                  "--outdir", str(out)]
    assert main(args) == 1                           # none.wav is missing
    assert _read(str(out / "golden.mp3")) == files["encoded"]
    capsys.readouterr()
    assert main(CPU + ["encode-batch", files["wav"], "--outdir", str(out),
                       "--resume"]) == 0
    assert "skipping 1" in capsys.readouterr().out
