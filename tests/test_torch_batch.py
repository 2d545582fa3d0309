"""The port's batched decode and batched encode (``mp3stego_tpu_torch.
parallel``), on the CPU (``device="cpu"``).

Decode: every file's output equals its own decode through the port's
single-file plane bit for bit (``decode_plane.decode_pcm`` float32 and
``decode_pcm_i16``), across chunk boundaries, ragged lengths, mixed
samplerates, all-mono chunks and isolated failures; two different files in
one chunk catch any IMDCT-tail or V-history leak from one file into the
next. Against the JAX package's batched decode the float PCM agrees within
1e-5 (the float32 bound of tests/test_precision.py: the two planes round
their float32 sums in different orders).

Encode: every file's bytes equal its own ``MP3Encoder`` run, the goldens
and the JAX package's per-file encoder, with sub-batches and isolation.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402
from mp3stego_tpu_torch.ops import search_plane as SP  # noqa: E402
from mp3stego_tpu_torch.parallel import batch_decode as BD  # noqa: E402
from mp3stego_tpu_torch.parallel import batch_encode as BE  # noqa: E402
from mp3stego_tpu_torch.parallel import (decode_files_batched,  # noqa: E402
                                         encode_files_batched)
from mp3stego_tpu_torch.utils.wav import read_wav, write_wav  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def streams(tmp_path_factory, fixture_mp3):
    """Named MP3 paths: the fixture, three multirate goldens, two LSF
    goldens, a 10-frame cut of the fixture and a seeded mono stream."""
    d = tmp_path_factory.mktemp("batch")
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    lsf = np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))
    paths = {"fixture": fixture_mp3}
    blobs = {f"mp3_{t}": mr[f"mp3_{t}"] for t in
             ("32000_64", "44100_128", "48000_96")}
    blobs.update({n: lsf[n] for n in ("mpeg2_24k_64", "mpeg25_8k_32")})
    with open(fixture_mp3, "rb") as f:
        data = f.read()
    sizes = np.cumsum(pdh.parse_mp3(data, 0).frame_sizes)
    blobs["cut10"] = np.frombuffer(data[:int(sizes[9])], np.uint8)
    for name, blob in blobs.items():
        paths[name] = str(d / f"{name}.mp3")
        with open(paths[name], "wb") as f:
            f.write(blob.tobytes())
    for seed in (3, 4):
        paths[f"mono{seed}"] = _mono_mp3(d, seed)
    return paths


def _mono_mp3(d, seed) -> str:
    rng = np.random.default_rng(seed)
    t = np.arange(44100 // 2)
    sig = 0.4 * np.sin(2 * np.pi * (300 + 40 * seed) * t / 44100) \
        + 0.05 * rng.standard_normal(len(t))
    wav = str(d / f"mono{seed}.wav")
    write_wav(wav, 44100, np.clip(sig * 20000, -32768, 32767)
              .astype(np.int16))
    enc = MP3Encoder(read_wav(wav, 128), device="cpu")
    enc.encode()
    path = str(d / f"mono{seed}.mp3")
    with open(path, "wb") as f:
        f.write(bytes(enc.out_buffer))
    return path


def _single(path, out):
    with open(path, "rb") as f:
        p = pdh.parse_mp3(f.read(), 0)
    if out == "int16":
        return pdp.decode_pcm_i16(p, CPU)
    return pdp.decode_pcm(p, "float32", CPU)


def _assert_each_equals_single(paths, outs, out):
    assert len(outs) == len(paths)
    for path, got in zip(paths, outs):
        want = _single(path, out)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


@pytest.mark.parametrize("out", ["float", "int16"])
def test_batched_decode_equals_per_file(out, streams):
    """Every stream at once, two files per chunk: MPEG-1 at three rates,
    MPEG-2 and 2.5 (virtual frames), a cut stream, mono."""
    paths = [streams[k] for k in ("fixture", "mp3_32000_64", "mpeg2_24k_64",
                                  "mp3_44100_128", "cut10", "mpeg25_8k_32",
                                  "mp3_48000_96", "mono3")]
    outs = decode_files_batched(paths, out=out, device="cpu", chunk_files=2)
    _assert_each_equals_single(paths, outs, out)


@pytest.mark.parametrize("order", [("fixture", "mp3_44100_128"),
                                   ("mp3_44100_128", "fixture")])
def test_no_state_leaks_across_a_file_boundary(order, streams):
    """Two different files in ONE chunk: the second's first granules would
    take the first's IMDCT tail and V history if synthesis ran on the
    concat axis."""
    paths = [streams[k] for k in order]
    outs = decode_files_batched(paths, device="cpu", chunk_files=0)
    _assert_each_equals_single(paths, outs, "float")


def test_ragged_lengths(streams):
    paths = [streams["fixture"], streams["cut10"], streams["fixture"]]
    outs = decode_files_batched(paths, out="int16", device="cpu")
    assert outs[1].shape[0] in (10 * 1152, 11 * 1152)
    _assert_each_equals_single(paths, outs, "int16")


def test_mixed_samplerates_come_back_in_order(streams):
    order = ["fixture", "mp3_32000_64", "mp3_44100_128", "mp3_32000_64",
             "mpeg25_8k_32", "fixture"]
    paths = [streams[k] for k in order]
    outs = decode_files_batched(paths, out="int16", device="cpu",
                                chunk_files=2)
    _assert_each_equals_single(paths, outs, "int16")


@pytest.mark.parametrize("chunk_files", [0, 2])
def test_all_mono_chunk_synthesizes_one_row_per_file(chunk_files, streams,
                                                     monkeypatch):
    rows = []
    orig = pdp.synth_from_blocks

    def spy(blk, *args, **kwargs):
        rows.append(blk.shape[0])
        return orig(blk, *args, **kwargs)

    monkeypatch.setattr(pdp, "synth_from_blocks", spy)
    paths = [streams["mono3"], streams["mono4"], streams["mono3"]]
    outs = decode_files_batched(paths, out="int16", device="cpu",
                                chunk_files=chunk_files)
    assert rows == ([3] if chunk_files == 0 else [2, 1])
    for o in outs:
        assert o.shape[1] == 1
    _assert_each_equals_single(paths, outs, "int16")


def test_chunks_of_two_two_one(streams, monkeypatch):
    """Five files in chunks of 2 + 2 + 1: one synthesis pass per chunk over
    F * 2 rows, and the same PCM as one chunk of all five."""
    rows = []
    orig = pdp.synth_from_blocks

    def spy(blk, *args, **kwargs):
        rows.append(blk.shape[0])
        return orig(blk, *args, **kwargs)

    paths = [streams[k] for k in ("fixture", "cut10", "fixture",
                                  "mp3_44100_128", "cut10")]
    whole = decode_files_batched(paths, out="int16", device="cpu",
                                 chunk_files=0)
    monkeypatch.setattr(pdp, "synth_from_blocks", spy)
    chunked = decode_files_batched(paths, out="int16", device="cpu",
                                   chunk_files=2)
    assert rows == [4, 4, 2]
    for a, b in zip(chunked, whole):
        assert np.array_equal(a, b)


def test_errors_isolate_and_raise(streams, tmp_path):
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"not an mp3 at all")
    paths = [streams["fixture"], str(bad), str(tmp_path / "missing.mp3"),
             streams["mono3"]]
    outs = decode_files_batched(paths, errors="isolate", device="cpu")
    assert isinstance(outs[1], ValueError)
    assert isinstance(outs[2], FileNotFoundError)
    _assert_each_equals_single([paths[0], paths[3]], [outs[0], outs[3]],
                               "float")
    with pytest.raises(ValueError, match="no MP3 frames"):
        decode_files_batched([str(bad)], device="cpu")


def test_concat_batch_layout(streams):
    """File i's granules start at i * t_max; its escapes shift with it;
    files of two samplerates are refused."""
    preps = []
    for k in ("fixture", "cut10"):
        with open(streams[k], "rb") as f:
            preps.append(pdp.host_prepare(pdh.parse_mp3(f.read(), 0)))
    batch = BD.prepare_batch_concat(preps)
    t_max = preps[0]["raw_i8"].shape[1]
    assert batch["t_max"] == t_max and list(batch["lengths"]) == \
        [t_max, preps[1]["raw_i8"].shape[1]]
    assert batch["raw_i8"].shape == (2, 2 * t_max, 576)
    assert np.array_equal(batch["raw_i8"][:, t_max:t_max + 20],
                          preps[1]["raw_i8"])
    assert not batch["raw_i8"][:, t_max + 20:].any()
    n0 = len(preps[0]["exc_t"])
    assert np.array_equal(batch["exc_t"][n0:], preps[1]["exc_t"] + t_max)
    with open(streams["mp3_32000_64"], "rb") as f:
        other = pdp.host_prepare(pdh.parse_mp3(f.read(), 0))
    with pytest.raises(ValueError, match="mixed samplerates"):
        BD.prepare_batch_concat([preps[0], other])


def test_batched_decode_equals_jax_package(streams, monkeypatch):
    """The JAX package's concat-layout batch decode (no mesh), with no
    link probe: float PCM within 1e-5 of the port's."""
    from mp3stego_tpu.parallel import decode_files_batched as jax_batched
    monkeypatch.setenv("MP3STEGO_TPU_FETCH_THREAD", "0")
    paths = [streams[k] for k in ("fixture", "mp3_32000_64", "cut10",
                                  "mpeg2_24k_64")]
    want = jax_batched(paths, mesh=None, dtype="float32", out="float")
    got = decode_files_batched(paths, device="cpu", chunk_files=2)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 1e-5


@pytest.mark.parametrize("form", ["positional", "keyword"])
def test_batched_decode_takes_the_jax_signature(form, streams, monkeypatch):
    """``decode_files_batched`` in the JAX package's call forms (``mesh``
    second, then ``dtype``, ``errors``, ``out``), the port's ``device``
    by keyword after them: the float PCM of the JAX package's own call in
    the same form, within its 1e-5."""
    from mp3stego_tpu.parallel import decode_files_batched as jax_batched
    monkeypatch.setenv("MP3STEGO_TPU_FETCH_THREAD", "0")
    paths = [streams[k] for k in ("fixture", "cut10", "mpeg2_24k_64")]
    if form == "positional":
        args, kw = (paths, None, "float32", "raise", "float"), {}
    else:
        args, kw = (paths,), dict(mesh=None, dtype="float32",
                                  errors="raise", out="float")
    want = jax_batched(*args, **kw)
    got = decode_files_batched(*args, **kw, device="cpu")
    assert len(got) == len(want) == len(paths)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() < 1e-5


@pytest.mark.parametrize("fn", ["decode", "encode"])
def test_batched_entry_points_refuse_a_foreign_mesh(fn, streams, tmp_path):
    """A mesh that is not the port's own (``parallel.make_mesh``) raises
    ``TypeError`` naming it, and a mesh with ``device=`` beside it raises
    ``ValueError``, both before any file is touched."""
    from mp3stego_tpu_torch.parallel import make_mesh
    if fn == "decode":
        def call(mesh, **kw):
            decode_files_batched([streams["fixture"]], mesh, **kw)
    else:
        def call(mesh, **kw):
            encode_files_batched([("missing.wav", str(tmp_path / "a.mp3"))],
                                 320, mesh, **kw)
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        call(object())
    with pytest.raises(ValueError, match="not both"):
        call(make_mesh(files=2, devices=["cpu"] * 2), device="cpu")


def test_float64_batch_on_the_cpu(streams):
    """``dtype="float64"`` on the CPU: bit for bit the host float64 parity
    plane (the torch float64 plane sums in its ascending order)."""
    paths = [streams[k] for k in ("fixture", "mpeg2_24k_64", "cut10")]
    outs = decode_files_batched(paths, dtype="float64", device="cpu")
    for path, got in zip(paths, outs):
        with open(path, "rb") as f:
            want = pdp.decode_pcm(pdh.parse_mp3(f.read(), 0), "float64",
                                  "cpu")
        assert got.dtype == np.float64 and got.shape == want.shape
        assert np.array_equal(got, want)


def test_default_device_raises_without_a_card(streams, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_files_batched([streams["fixture"]])
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_files_batched([("a.wav", "a.mp3")])


# ------------------------------------------------------------------ encode


@pytest.fixture(scope="module")
def wavs(tmp_path_factory, fixture_mp3):
    """Named WAV paths: the golden fixture WAV, two multirate golden WAVs,
    a seeded 3 s stereo WAV and a seeded mono WAV."""
    d = tmp_path_factory.mktemp("bwav")
    sg = np.load(os.path.join(GOLD, "stego_golden.npz"))
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    paths = {"golden": str(d / "golden.wav")}
    with open(paths["golden"], "wb") as f:
        f.write(sg["wav_bytes"].tobytes())
    for t in ("32000_64", "48000_96"):
        paths[t] = str(d / f"{t}.wav")
        with open(paths[t], "wb") as f:
            f.write(mr[f"wav_{t}"].tobytes())
    rng = np.random.default_rng(2024)
    t = np.arange(3 * 44100) / 44100
    sig = (0.45 * np.sin(2 * np.pi * 220 * t)
           + 0.2 * rng.standard_normal(len(t)) * (np.sin(2 * np.pi * t) > 0))
    pcm = np.clip(sig * 30000, -32768, 32767).astype(np.int16)
    paths["seeded"] = str(d / "seeded.wav")
    write_wav(paths["seeded"], 44100, np.stack([pcm, np.roll(pcm, 999)], 1))
    paths["mono"] = str(d / "mono.wav")
    write_wav(paths["mono"], 44100, pcm[:44100])
    return paths


def _per_file(wav, kbps):
    enc = MP3Encoder(read_wav(wav, kbps), device="cpu")
    enc.encode()
    return bytes(enc.out_buffer)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_batched_encode_equals_per_file_and_goldens(wavs, tmp_path):
    names = ["golden", "32000_64", "seeded", "golden", "48000_96", "mono"]
    jobs = [(wavs[n], str(tmp_path / f"{i}.mp3"))
            for i, n in enumerate(names)]
    outs = encode_files_batched(jobs, bitrate=320, device="cpu")
    assert outs == [o for _, o in jobs]
    for (wav, out) in jobs:
        assert _read(out) == _per_file(wav, 320), wav
    eg = np.load(os.path.join(GOLD, "encode_golden.npz"))["mp3_bytes"]
    assert _read(jobs[0][1]) == _read(jobs[3][1]) == eg.tobytes()


def test_batched_encode_equals_jax_encoder(wavs, tmp_path):
    from mp3stego_tpu.models.encoder import MP3Encoder as JaxMP3Encoder
    from mp3stego_tpu.utils.wav import read_wav as jax_read_wav
    names = ["seeded", "mono", "32000_64"]
    jobs = [(wavs[n], str(tmp_path / f"{n}.mp3")) for n in names]
    encode_files_batched(jobs, bitrate=128, device="cpu")
    for wav, out in jobs:
        j = JaxMP3Encoder(jax_read_wav(wav, 128))
        j.encode(quiet=True)
        assert _read(out) == bytes(j.out_buffer), wav


@pytest.mark.parametrize("form", ["positional", "keyword"])
def test_batched_encode_takes_the_jax_signature(form, wavs, tmp_path):
    """``encode_files_batched`` in the JAX package's call forms (``bitrate``,
    ``mesh``, ``max_workers``, ``errors``), the port's ``device`` by
    keyword after them: each file's bytes are its own encode's and the JAX
    package's encoder's."""
    from mp3stego_tpu.models.encoder import MP3Encoder as JaxMP3Encoder
    from mp3stego_tpu.utils.wav import read_wav as jax_read_wav
    jobs = [(wavs[n], str(tmp_path / f"{n}.mp3")) for n in ("mono",
                                                            "seeded")]
    if form == "positional":
        outs = encode_files_batched(jobs, 128, None, 2, "raise",
                                    device="cpu")
    else:
        outs = encode_files_batched(jobs, bitrate=128, mesh=None,
                                    max_workers=2, errors="raise",
                                    device="cpu")
    assert outs == [o for _, o in jobs]
    for wav, out in jobs:
        j = JaxMP3Encoder(jax_read_wav(wav, 128))
        j.encode(quiet=True)
        assert _read(out) == _per_file(wav, 128) == bytes(j.out_buffer)


def test_sub_batches_equal_one_pass(wavs, tmp_path, monkeypatch):
    """A lane budget below one file: every file searches alone."""
    calls = []
    orig = SP.search

    def spy(xr, max_bits, sr_idx, hide=None):
        calls.append(xr.shape[0])
        return orig(xr, max_bits, sr_idx, hide)

    names = ["golden", "seeded", "golden"]
    jobs = [(wavs[n], str(tmp_path / f"{i}.mp3"))
            for i, n in enumerate(names)]
    monkeypatch.setattr(SP, "search", spy)
    encode_files_batched(jobs, device="cpu")
    assert len(calls) == 1
    whole = [_read(o) for _, o in jobs]
    monkeypatch.setattr(BE, "MAX_LANES", 200)
    calls.clear()
    encode_files_batched(jobs, device="cpu")
    assert len(calls) == 3
    assert [_read(o) for _, o in jobs] == whole


def test_redo_stays_inside_each_file(wavs, tmp_path, monkeypatch):
    """Every searched lane of two different files in one search flagged
    FLAG_ADDR: each file's host redo chains its own slots only, and the
    bytes still equal the per-file encodes."""
    orig = SP.search

    def flag_all(xr, max_bits, sr_idx, hide=None):
        res = orig(xr, max_bits, sr_idx, hide)
        res["flags"] = torch.where(res["xrmax0"] == 0, SP.FLAG_ADDR, 0) \
            .to(torch.int32)
        return res

    jobs = [(wavs[n], str(tmp_path / f"{n}.mp3"))
            for n in ("seeded", "golden")]
    want = [_per_file(w, 320) for w, _ in jobs]
    monkeypatch.setattr(SP, "search", flag_all)
    encode_files_batched(jobs, device="cpu")
    assert [_read(o) for _, o in jobs] == want


def test_batched_encode_isolates_failures(wavs, tmp_path):
    junk = tmp_path / "junk.wav"
    junk.write_bytes(b"RIFF....not a wave file")
    jobs = [(wavs["golden"], str(tmp_path / "a.mp3")),
            (str(tmp_path / "missing.wav"), str(tmp_path / "b.mp3")),
            (str(junk), str(tmp_path / "c.mp3"))]
    outs = encode_files_batched(jobs, device="cpu", errors="isolate")
    assert outs[0] == jobs[0][1]
    assert isinstance(outs[1], FileNotFoundError)
    assert isinstance(outs[2], (SystemExit, Exception))
    assert not os.path.exists(jobs[1][1])
    with pytest.raises(FileNotFoundError):
        encode_files_batched(jobs[1:2], device="cpu")
