"""The port's mesh layer (``mp3stego_tpu_torch.parallel``) on the CPU, on
meshes of repeated ``"cpu"`` devices (the port's counterpart of the JAX
package's 8 virtual CPU devices, tests/conftest.py).

* ``make_mesh``: shapes and errors as ``tests/test_parallel.py``; no card,
  no default mesh.
* The frame-sharded decode at 1, 2, 4 and 8 shards and with one granule a
  shard (the halo then spans two shards): float32 within 1e-5 of the JAX
  package's sharded decode (scaled by the peak on the synthetic batch,
  whose noise is far above full scale), and in both dtypes bit for bit the
  port's unsharded decode (float64 also ``decode_granules_np``).
* K1's halo: ``synth_fused_torch(blk, halo=h)`` is the plain decode of
  ``[h | blk]`` less its first two granules, in both dtypes and epilogues.
* ``prepare_batch`` array for array the JAX package's; the stacked decode,
  the batched decode and the batched encode on a 4 x 2 mesh equal their
  runs without a mesh (and the JAX package's stacked decode within 1e-5,
  the encode the goldens), ragged lengths and mixed samplerates included.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as graft  # noqa: E402
from mp3stego_tpu import parallel as jpar  # noqa: E402
from mp3stego_tpu.ops import decode_plane as jdp  # noqa: E402
from mp3stego_tpu.parallel.batch_decode import \
    decode_batch_device as jax_decode_batch_device  # noqa: E402
from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402
from mp3stego_tpu_torch.ops import synth as sf  # noqa: E402
from mp3stego_tpu_torch.parallel import (  # noqa: E402
    decode_files_batched, decode_granules_sharded, encode_files_batched,
    make_mesh, prepare_batch)
from mp3stego_tpu_torch.parallel import batch_encode as BE  # noqa: E402
from mp3stego_tpu_torch.parallel import frame_shard as FS  # noqa: E402
from mp3stego_tpu_torch.parallel.batch_decode import \
    decode_batch_device  # noqa: E402
from mp3stego_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from mp3stego_tpu_torch.utils.wav import read_wav, write_wav  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CPU8 = ["cpu"] * 8
DTYPES = ["float32", "float64"]


def _parse(path):
    with open(path, "rb") as f:
        return pdh.parse_mp3(f.read(), 0, backend="python")


@pytest.fixture(scope="module")
def streams(tmp_path_factory, fixture_mp3):
    """MP3 paths: the fixture, a 10-frame cut of it and two multirate
    goldens (32 and 48 kHz)."""
    d = tmp_path_factory.mktemp("mesh")
    with open(fixture_mp3, "rb") as f:
        data = f.read()
    sizes = np.cumsum(_parse(fixture_mp3).frame_sizes)
    paths = {"fixture": fixture_mp3, "cut10": str(d / "cut10.mp3")}
    with open(paths["cut10"], "wb") as f:
        f.write(data[:int(sizes[9])])
    mr = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    for t in ("32000_64", "48000_96"):
        paths[t] = str(d / f"{t}.mp3")
        with open(paths[t], "wb") as f:
            f.write(mr[f"mp3_{t}"].tobytes())
    return paths


@pytest.fixture(scope="module")
def fixture_prep(streams):
    return pdp.host_prepare(_parse(streams["fixture"]), native_pack=False)


# ------------------------------------------------------------------ mesh


def test_mesh_shapes():
    m = make_mesh(files=4, frames=2, devices=CPU8)
    assert isinstance(m, Mesh)
    assert m.shape == {"files": 4, "frames": 2}
    assert m.axis_names == ("files", "frames")
    assert m.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    m = make_mesh(frames=2, devices=CPU8)
    assert m.shape == {"files": 4, "frames": 2}
    assert make_mesh(devices=CPU8).shape == {"files": 8, "frames": 1}
    assert make_mesh(files=1, frames=3, devices=CPU8).shape == \
        {"files": 1, "frames": 3}
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(frames=3, devices=CPU8)
    with pytest.raises(ValueError, match="needs 16"):
        make_mesh(files=4, frames=4, devices=CPU8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        make_mesh(files=1, devices=["meta"])


def test_make_mesh_needs_a_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(files=2, devices=["cuda:0", "cuda:0"])
    assert make_mesh(files=2, devices=[torch.device("cpu")] * 2).shape == \
        {"files": 2, "frames": 1}


@pytest.mark.parametrize("entry", ["decode", "encode", "sharded", "stacked"])
def test_a_jax_mesh_is_refused(entry, streams, fixture_prep, tmp_path):
    """The JAX package's mesh is not the port's: ``TypeError`` naming
    ``make_mesh``, before any work."""
    mesh = jpar.make_mesh(files=2, frames=1)
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        if entry == "decode":
            decode_files_batched([streams["fixture"]], mesh)
        elif entry == "encode":
            encode_files_batched([("a.wav", str(tmp_path / "a.mp3"))], 320,
                                 mesh)
        elif entry == "sharded":
            decode_granules_sharded(fixture_prep, mesh)
        else:
            decode_batch_device(prepare_batch([fixture_prep]), mesh)


# ------------------------------------------------------------------ K1 halo


@pytest.mark.parametrize("out", ["float", "int16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_synthesis_is_the_decode_of_the_longer_row(dtype, out):
    """Rows of 11 granules after a 2-granule halo: bit for bit the rows of
    13 granules from zero state, less their first two granules; a zero halo
    is no halo."""
    rng = np.random.default_rng(5)
    full = torch.from_numpy(0.3 * rng.standard_normal((4, 13, 32, 36))) \
        .to(dtype)
    blk, halo = full[:, 2:].contiguous(), full[:, :2].contiguous()
    want = sf.synth_fused_torch(full, out, 2)
    want = want[:, 2:] if out == "float" else want[:, 2 * 576:]
    for fn in (sf.synth_fused_torch, sf.synth_fused):
        got = fn(blk, out, 2, halo=halo)
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(sf.synth_fused_torch(blk, out, 2,
                                            halo=torch.zeros_like(halo)),
                       sf.synth_fused_torch(blk, out, 2))


def test_halo_is_checked():
    blk = torch.zeros((2, 3, 32, 36))
    for bad in (torch.zeros((2, 1, 32, 36)), torch.zeros((1, 2, 32, 36)),
                torch.zeros((2, 2, 32, 36), dtype=torch.float64)):
        with pytest.raises(ValueError, match="halo"):
            sf.synth_fused(blk, halo=bad)


# ------------------------------------------------------------------ frames


@pytest.mark.parametrize("frames", [1, 2, 4, 8])
def test_sharded_decode_matches_jax_and_the_unsharded_decode(frames,
                                                             fixture_prep):
    mesh = make_mesh(files=1, frames=frames, devices=CPU8)
    got = decode_granules_sharded(fixture_prep, mesh, "float32")
    whole = pdp.decode_granules(pdp.prep_to_torch(fixture_prep, "cpu"),
                                torch.float32).numpy()
    assert got.dtype == np.float32 and got.shape == whole.shape
    assert np.array_equal(got, whole)
    want = jpar.decode_granules_sharded(
        fixture_prep, jpar.make_mesh(files=1, frames=frames), "float32")
    assert np.abs(got - want).max() < 1e-5
    got64 = decode_granules_sharded(fixture_prep, mesh, "float64")
    assert np.array_equal(got64, pdp.decode_granules_np(fixture_prep))


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_granule_a_shard(dtype):
    """8 granules of every block type over 8 shards: each shard's halo
    comes from its two left neighbours (zeros and shard 0 for shard 1)."""
    prep = graft._synthetic_prep(8)
    got = decode_granules_sharded(prep, make_mesh(files=1, frames=8,
                                                  devices=CPU8), dtype)
    whole = pdp.decode_granules(pdp.prep_to_torch(prep, "cpu"),
                                pdp.DTYPES[dtype]).numpy()
    assert got.shape == (2, 8, 576) and np.array_equal(got, whole)
    if dtype == "float64":
        assert np.array_equal(got, pdp.decode_granules_np(prep))
    else:
        want = jpar.decode_granules_sharded(
            prep, jpar.make_mesh(files=1, frames=8), "float32")
        assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("frames,t", [(3, 8), (4, 8), (8, 8), (8, 3)])
def test_shard_body_launches_and_halos(frames, t, monkeypatch):
    """One K2 and one K1 call a shard, T padded to a multiple of the shard
    count; shard k's halo is the unsharded blocks of the two granules
    before it (zeros before granule 0), shard 0 has none."""
    prep = graft._synthetic_prep(8)
    if t < 8:
        prep = dict(prep)
        for k in pdp.T_AXIS1_KEYS:
            prep[k] = prep[k][:, :t]
        for k in pdp.T_AXIS0_KEYS:
            prep[k] = prep[k][:t]
        keep = prep["exc_t"] < t
        for k in pdp.EXC_KEYS:
            prep[k] = prep[k][keep]
    per = -(-t // frames)
    calls = {"k2": 0, "k1": []}
    k2, k1 = pdp.granule_blocks, pdp.synth_from_blocks

    def spy_k2(p, dtype, stages=None):
        calls["k2"] += 1
        return k2(p, dtype, stages)

    def spy_k1(blk, stages=None, out="float", channels=1, halo=None):
        calls["k1"].append(halo)
        return k1(blk, stages, out, channels, halo)

    monkeypatch.setattr(pdp, "granule_blocks", spy_k2)
    monkeypatch.setattr(pdp, "synth_from_blocks", spy_k1)
    mesh = make_mesh(files=1, frames=frames, devices=CPU8)
    got = decode_granules_sharded(prep, mesh, "float64")
    assert calls["k2"] == frames and len(calls["k1"]) == frames
    monkeypatch.undo()
    blocks = pdp.granule_blocks(pdp.prep_to_torch(
        FS._pad_t(prep, per * frames), "cpu"), torch.float64)
    ext = torch.cat([torch.zeros_like(blocks[:, :2]), blocks], 1)
    assert calls["k1"][0] is None
    for k, halo in enumerate(calls["k1"][1:], 1):
        assert halo.is_contiguous()
        assert torch.equal(halo, ext[:, k * per:k * per + 2])
    assert np.array_equal(got, pdp.decode_granules_np(prep))


# ------------------------------------------------------------------ files


def _preps(streams, names):
    return [pdp.host_prepare(_parse(streams[n]), native_pack=False)
            for n in names]


@pytest.mark.parametrize("t_pad_to", [1, 32])
def test_prepare_batch_equals_jax(t_pad_to, streams):
    preps = _preps(streams, ["fixture", "cut10", "32000_64"])
    got = prepare_batch(preps, t_pad_to=t_pad_to)
    want = jpar.prepare_batch(preps, t_pad_to=t_pad_to)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("to_i16", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_stacked_decode_on_a_mesh(dtype, to_i16, streams):
    """Five files of three samplerates and two lengths over a 4 x 2 mesh
    (groups of 2, 2, 1 files, the 4th device idle): bit for bit the run
    without a mesh, trimmed to each file, equal to each file's own decode;
    float32 within 1e-5 of the JAX package's stacked decode."""
    names = ["fixture", "cut10", "32000_64", "48000_96", "fixture"]
    batch = prepare_batch(_preps(streams, names))
    mesh = make_mesh(files=4, frames=2, devices=CPU8)
    got = decode_batch_device(batch, mesh, dtype, to_i16)
    want = decode_batch_device(batch, None, dtype, to_i16, device="cpu")
    assert got.dtype == want.dtype and torch.equal(got, want)
    t = batch["raw_i8"].shape[2]
    assert got.shape == (5, 2, t, 576)
    for j, name in enumerate(names):
        n = int(batch["lengths"][j])
        single = pdp.decode_granules(
            pdp.prep_to_torch(_preps(streams, [name])[0], "cpu"),
            pdp.DTYPES[dtype], out="int16" if to_i16 else "float")
        if to_i16:
            single = single.reshape(n, 576, 2).permute(2, 0, 1)
        assert torch.equal(got[j, :, :n], single), name
    if dtype == "float32" and not to_i16:
        ref = np.asarray(jax_decode_batch_device(
            batch, jpar.make_mesh(files=8, frames=1)))
        assert np.abs(got.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("out", ["float", "int16"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_decode_on_a_mesh(dtype, out, streams):
    """Ragged lengths and two samplerates, one file a chunk so the chunks
    go round-robin over the 4 ``files`` devices: bit for bit the run
    without a mesh."""
    paths = [streams[k] for k in ("fixture", "cut10", "32000_64", "fixture",
                                  "cut10")]
    mesh = make_mesh(files=4, frames=2, devices=CPU8)
    got = decode_files_batched(paths, mesh, dtype, out=out, chunk_files=1)
    want = decode_files_batched(paths, None, dtype, out=out, device="cpu",
                                chunk_files=1)
    assert len(got) == len(want) == len(paths)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].shape[0] == _parse(paths[0]).num_frames * 1152
    assert got[1].shape[0] in (10 * 1152, 11 * 1152)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """The golden fixture WAV and a seeded 1 s mono WAV."""
    d = tmp_path_factory.mktemp("mesh_wav")
    sg = np.load(os.path.join(GOLD, "stego_golden.npz"))
    paths = {"golden": str(d / "golden.wav"), "mono": str(d / "mono.wav")}
    with open(paths["golden"], "wb") as f:
        f.write(sg["wav_bytes"].tobytes())
    rng = np.random.default_rng(7)
    t = np.arange(44100) / 44100
    sig = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(
        len(t))
    write_wav(paths["mono"], 44100, np.clip(sig * 30000, -32768, 32767)
              .astype(np.int16))
    return paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_batched_encode_on_a_mesh(wavs, tmp_path, monkeypatch):
    """Five stereo files and a mono one over a 4 x 2 mesh: the stereo
    group in sub-batches of ceil(5 / 4) = 2 files, every file's bytes
    those of the run without a mesh and the goldens."""
    names = ["golden"] * 5 + ["mono"]
    jobs = [(wavs[n], str(tmp_path / f"m{i}.mp3"))
            for i, n in enumerate(names)]
    sizes = []
    run = BE._run_sub_batch

    def spy(sub, dev, pool):
        sizes.append(len(sub))
        return run(sub, dev, pool)

    monkeypatch.setattr(BE, "_run_sub_batch", spy)
    mesh = make_mesh(files=4, frames=2, devices=CPU8)
    assert encode_files_batched(jobs, 320, mesh) == [o for _, o in jobs]
    assert sorted(sizes) == [1, 1, 2, 2]
    monkeypatch.undo()
    plain = [(w, str(tmp_path / f"p{i}.mp3")) for i, (w, _) in
             enumerate(jobs)]
    encode_files_batched(plain, 320, device="cpu")
    eg = np.load(os.path.join(GOLD, "encode_golden.npz"))["mp3_bytes"]
    for (_, a), (_, b), name in zip(jobs, plain, names):
        assert _read(a) == _read(b)
        if name == "golden":
            assert _read(a) == eg.tobytes()
    enc = MP3Encoder(read_wav(wavs["mono"], 320), device="cpu")
    enc.encode()
    assert _read(jobs[-1][1]) == bytes(enc.out_buffer)
