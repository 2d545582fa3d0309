"""The torch decode plane against the JAX package, on the CPU.

One numpy prep per input feeds both packages: the synthetic batch of
``__graft_entry__._synthetic_prep(t=32)`` (short, start, mixed, MS and
intensity granules, linbits escapes), the 320 kbps fixture, the 5 multirate
goldens and the 3 MPEG-2/2.5 streams of ``torch_lsf_golden.npz``.

* float32: the port's plane against the JAX plane (``granule_blocks`` /
  ``synth_from_blocks`` run op by op, unjitted) at ``rtol=1e-5`` with
  ``atol=1e-5 * max|ref|``. The two differ by matmul summation order, XLA's
  FMA contraction, and the linbits escapes, which the port reads from the
  exact pow43 table where the JAX plane takes ``exp2(4/3 * log2|x|)``.
* float64: the torch plane against ``decode_granules_np`` stage by stage,
  bit for bit: it runs the same operations in the same order (the
  requantize tables, the ascending IMDCT and synthesis sums), which is what
  lets the card's float64 plane write the host plane's WAV bytes.
* int16: the synthesis kernel's epilogue against ``pcm_to_i16`` of the
  float PCM, saturating and wrapping, in both dtypes, on the fixture (7 of
  its samples lie above full scale).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mp3stego_tpu.bitstream import decoder_host as jdh  # noqa: E402
from mp3stego_tpu.ops import decode_plane as jdp  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402

F32 = jnp.dtype("float32")


GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MULTIRATE = ("32000_64", "32000_192", "44100_128", "48000_96", "48000_320")
LSF = ("mpeg2_24k_64", "mpeg2_22k05_80", "mpeg25_8k_32")


@pytest.fixture(scope="module")
def preps(fixture_mp3):
    with open(fixture_mp3, "rb") as f:
        fixture = jdp.host_prepare(jdh.parse_mp3(f.read(), 0))
    return {"synthetic": graft._synthetic_prep(32), "fixture": fixture}


def _golden_bytes(name: str) -> bytes:
    if name in LSF:
        return np.load(os.path.join(GOLD, "torch_lsf_golden.npz"))[name] \
            .tobytes()
    return np.load(os.path.join(GOLD, "multirate_golden.npz"))[
        f"mp3_{name}"].tobytes()


@pytest.fixture(scope="module")
def jax_f32(preps):
    """The JAX float32 plane's blocks and PCM per input (computed once)."""
    out = {}
    for name, prep in preps.items():
        jprep = {k: jnp.asarray(v) for k, v in prep.items()}
        blk = jdp.granule_blocks(jprep, F32)
        pcm, _, _ = jdp.synth_from_blocks(blk, F32)
        out[name] = (np.asarray(blk), np.asarray(pcm))
    return out


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", ["synthetic", "fixture"])
def test_f32_granule_blocks_match_jax(name, preps, jax_f32):
    prep = pdp.prep_to_torch(preps[name], "cpu")
    blk = pdp.granule_blocks(prep, torch.float32)
    assert blk.dtype == torch.float32
    _close(blk.numpy(), jax_f32[name][0], 1e-5)


@pytest.mark.parametrize("name", ["synthetic", "fixture"])
def test_f32_pcm_matches_jax(name, preps, jax_f32):
    prep = pdp.prep_to_torch(preps[name], "cpu")
    pcm = pdp.decode_granules(prep, torch.float32)
    _close(pcm.numpy(), jax_f32[name][1], 1e-5)


@pytest.mark.parametrize("name", ["synthetic", "fixture"])
def test_f64_stages_match_numpy_plane(name, preps):
    want = {}
    ref = jdp.decode_granules_np(preps[name], stages=want)
    got = {}
    pcm = pdp.decode_granules(pdp.prep_to_torch(preps[name], "cpu"),
                              torch.float64, stages=got)
    assert set(got) == set(want) == {"requant", "pre_imdct", "post_imdct",
                                     "pre_synth"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(pcm.numpy(), ref)


@pytest.mark.parametrize("name", MULTIRATE + LSF)
def test_f64_plane_bitwise_on_goldens(name):
    """The multirate and MPEG-2/2.5 goldens: the torch float64 plane equals
    ``decode_granules_np`` bit for bit, and its int16 WAV samples (the
    route of the default decode on the card) equal the host C++ plane's."""
    from mp3stego_tpu_torch.bitstream import decoder_host as pdh
    data = _golden_bytes(name)
    prep = jdp.host_prepare(jdh.parse_mp3(data, 0))
    got = pdp.decode_granules(pdp.prep_to_torch(prep, "cpu"), torch.float64)
    np.testing.assert_array_equal(got.numpy(), jdp.decode_granules_np(prep))
    parsed = pdh.parse_mp3(data, 0)
    np.testing.assert_array_equal(pdp.decode_pcm_i16(parsed, "cpu", "float64"),
                                  pdp.decode_pcm_i16_host(parsed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrap", [False, True])
def test_i16_epilogue_matches_pcm_to_i16(dtype, wrap, preps, monkeypatch):
    """The fused int16 epilogue (files, T*576, ch) against the JAX
    package's ``pcm_to_i16`` of the same plane's float PCM, interleaved."""
    if wrap:
        monkeypatch.setenv("MP3STEGO_TPU_REF_PCM_WRAP", "1")
    prep = pdp.prep_to_torch(preps["fixture"], "cpu")
    pcm = pdp.decode_granules(prep, dtype).numpy()
    inter = pcm.transpose(1, 2, 0).reshape(-1, 2)
    assert (np.abs(inter) > 1.0).sum() == 7      # the fixture clips
    got = pdp.decode_granules_i16(prep, dtype)
    assert got.dtype == torch.int16 and got.shape == (1,) + inter.shape
    want = jdp.pcm_to_i16(inter)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_prep_to_torch_keeps_keys_types_and_values(preps):
    """Every host key crosses with its type and values; the escapes are
    the same list in granule order (``index_escapes``), with their index
    ``exc_start`` beside them."""
    prep = preps["synthetic"]
    tp = pdp.prep_to_torch(prep, "cpu")
    assert set(tp) == set(pdp.TORCH_KEYS)
    for k in pdp.ALL_KEYS:
        assert tp[k].dtype == torch.from_numpy(np.asarray(prep[k])).dtype, k
        if k not in pdp.EXC_KEYS:
            assert np.array_equal(tp[k].numpy(), prep[k]), k
    assert len(prep["exc_t"]) > 0 and (prep["exc_t"] < 32).all()

    def rows(d):
        return sorted(zip(*(np.asarray(d[k]).tolist() for k in pdp.EXC_KEYS)))
    assert rows({k: tp[k].numpy() for k in pdp.EXC_KEYS}) == rows(prep)
    assert (np.diff(tp["exc_t"].numpy()) >= 0).all()
    assert np.array_equal(tp["exc_start"].numpy(), np.searchsorted(
        tp["exc_t"].numpy(), np.arange(33)))


def test_chip_smoke_synthetic_prep_equals_graft_entry():
    """chip_smoke.py rebuilds the synthetic batch through the port (it
    cannot import the JAX package); it must stay the same batch."""
    import chip_smoke
    want = graft._synthetic_prep(32)
    got = chip_smoke.synthetic_prep(32)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


@pytest.mark.parametrize("wrap", [False, True])
def test_i16_epilogue(wrap, preps, monkeypatch):
    """The device int16 conversion: saturating by default, numpy's
    truncate-and-wrap under MP3STEGO_TPU_REF_PCM_WRAP=1, interleaved per
    file (1, T * 576, 2)."""
    if wrap:
        monkeypatch.setenv("MP3STEGO_TPU_REF_PCM_WRAP", "1")
    prep = pdp.prep_to_torch(preps["synthetic"], "cpu")
    pcm = pdp.decode_granules(prep, torch.float32).numpy()
    got = pdp.decode_granules_i16(prep)
    assert got.dtype == torch.int16
    x = pcm * np.float32(32767)
    if not wrap:
        x = np.clip(x, np.float32(-32768), np.float32(32767))
    want = x.astype(np.int32).astype(np.int16)          # (2, T, 576)
    np.testing.assert_array_equal(got.numpy(),
                                  want.transpose(1, 2, 0).reshape(1, -1, 2))
    assert np.abs(pcm).max() > 1.0      # the batch does clip


@pytest.mark.parametrize("dtype,lo,hi", [(torch.float32, -126, 127),
                                         (torch.float64, -1022, 1023)])
def test_pow2_int_is_exact(dtype, lo, hi):
    e = torch.arange(lo, hi + 1)
    got = pdp._pow2_int(e, dtype)
    want = torch.tensor([2.0 ** int(i) for i in e], dtype=torch.float64)
    assert got.dtype == dtype
    assert torch.equal(got.to(torch.float64), want)

