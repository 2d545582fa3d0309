"""Kernel K1 of the torch port, the fused synthesis (overlap-add, frequency
inversion, V matmul, 16-tap FIR, int16 epilogue): its plain version and its
wrapper's routing, on the CPU.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py). Here:

* the plain FIR step is held bit for bit against the NumPy expression of
  ``tests/test_pallas.py`` (the JAX package's FIR reference);
* the plain fused version equals the composition of its five steps written
  in NumPy, bit for bit, in float32 and float64 (NumPy rounds each product
  and each sum on its own, in the order written);
* in float32 it agrees with the JAX package's ``synth_from_blocks`` within
  1e-5 of the peak (another V summation order), once with its jnp FIR and
  once with the FIR through the Pallas kernel in interpret mode;
* rows are independent: a row in a batch gives the bits it gives alone;
* the wrapper takes the plain version for CPU tensors without counting a
  launch, and refuses what it cannot launch.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_pallas import _fir_reference  # noqa: E402

from mp3stego_tpu import tables as JT  # noqa: E402
from mp3stego_tpu.ops import decode_plane as jdp  # noqa: E402
from mp3stego_tpu.ops import pallas_kernels as pk  # noqa: E402
from mp3stego_tpu_torch.ops import synth as sf  # noqa: E402

DTYPES = [(torch.float32, np.float32), (torch.float64, np.float64)]


def _blk(rows, t, seed, np_dtype):
    """Random IMDCT blocks at unit scale (numpy default_rng)."""
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((rows, t, 32, 36))).astype(np_dtype)


def _fused_numpy(blk: np.ndarray) -> np.ndarray:
    """The five steps in NumPy, in blk's dtype, from the JAX package's
    tables: the composition the plain fused version must equal."""
    dt = blk.dtype.type
    rows, t = blk.shape[:2]
    prev = np.concatenate([np.zeros_like(blk[:, :1, :, 18:]),
                           blk[:, :-1, :, 18:]], axis=1)
    y = blk[..., :18] + prev
    y = y * jdp._freq_inv_mask().reshape(32, 18).astype(dt)
    st = y.transpose(0, 1, 3, 2).reshape(rows, t * 18, 32)
    n_mat = JT.synth_filter_matrix().astype(dt)
    v = np.zeros((rows, t * 18, 64), dt)
    for i in range(32):
        v = v + st[..., i, None] * n_mat[:, i]
    v_ext = np.concatenate([np.zeros((rows, 15, 64), dt), v], axis=1)
    d = JT.SYNTH_WINDOW.reshape(16, 32).astype(dt)
    pcm = np.zeros((rows, t * 18, 32), dt)
    for j in range(16):
        src = v_ext[..., :32] if j % 2 == 0 else v_ext[..., 32:]
        pcm = pcm + d[j] * src[:, 15 - j:15 - j + t * 18]
    return pcm.reshape(rows, t, 576)


@pytest.mark.parametrize("ch,s", [(2, 512), (1, 256 + 18), (2, 18 * 7)])
def test_plain_fir_equals_numpy_reference_bitwise(ch, s):
    rng = np.random.default_rng(s)
    v_ext = rng.standard_normal((ch, 15 + s, 64)).astype(np.float32)
    out = sf.synth_fir_torch(torch.from_numpy(v_ext), s)
    assert out.dtype == torch.float32 and out.shape == (ch, s, 32)
    np.testing.assert_array_equal(out.numpy(), _fir_reference(v_ext, s))


def test_plain_fir_halo_continuity():
    """Splitting a stream in two with the 15-step halo equals one pass."""
    rng = np.random.default_rng(1)
    s = 512
    v = torch.from_numpy(rng.standard_normal((1, 15 + 2 * s, 64))
                         .astype(np.float32))
    whole = sf.synth_fir_torch(v, 2 * s)
    halves = torch.cat([sf.synth_fir_torch(v[:, :15 + s], s),
                        sf.synth_fir_torch(v[:, s:], s)], dim=1)
    assert torch.equal(whole, halves)


@pytest.mark.parametrize("dtype,np_dtype", DTYPES)
@pytest.mark.parametrize("rows,t", [(2, 9), (1, 1), (3, 17)])
def test_plain_fused_equals_composition_of_parts(dtype, np_dtype, rows, t):
    blk = _blk(rows, t, rows * 100 + t, np_dtype)
    got = sf.synth_fused_torch(torch.from_numpy(blk))
    assert got.dtype == dtype and got.shape == (rows, t, 576)
    np.testing.assert_array_equal(got.numpy(), _fused_numpy(blk))


@pytest.mark.parametrize("dtype,np_dtype", DTYPES)
def test_rows_in_a_batch_equal_each_row_alone(dtype, np_dtype):
    blk = torch.from_numpy(_blk(2, 11, 4, np_dtype))
    both = sf.synth_fused_torch(blk)
    for r in range(2):
        assert torch.equal(both[r:r + 1], sf.synth_fused_torch(blk[r:r + 1]))
    i16 = sf.synth_fused_torch(blk, "int16", channels=2)
    assert torch.equal(i16[0, :, 0], sf.synth_fused_torch(
        blk[:1], "int16")[0, :, 0])


@pytest.mark.parametrize("fir", ["jnp", "pallas_interpret"])
def test_fused_float32_matches_jax_synth_from_blocks(fir, monkeypatch):
    """The JAX float32 synthesis sums V by einsum (HIGHEST) and, with the
    Pallas FIR, folds the even and odd taps in another order: 1e-5 of the
    peak bounds both on unit-scale blocks."""
    if fir == "pallas_interpret":
        monkeypatch.setattr(jdp, "_pallas_fir_enabled", lambda: True)
        monkeypatch.setattr(pk, "synth_fir_host", functools.partial(
            pk.synth_fir_host, interpret=True))
    blk = _blk(2, 16, 8, np.float32)
    want, _, _ = jdp.synth_from_blocks(jnp.asarray(blk), jnp.float32)
    want = np.asarray(want)
    got = sf.synth_fused_torch(torch.from_numpy(blk)).numpy()
    peak = float(np.abs(want).max())
    assert peak > 0.1
    assert np.abs(got - want).max() < 1e-5 * peak


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_takes_plain_version_on_cpu(dtype):
    blk = torch.from_numpy(_blk(2, 3, 5, np.float64)).to(dtype)
    before = sf.launches
    out = sf.synth_fused(blk)
    i16 = sf.synth_fused(blk, "int16", channels=2)
    assert sf.launches == before, "a CPU tensor must not count a launch"
    assert out.dtype == dtype and i16.dtype == torch.int16
    assert torch.equal(out, sf.synth_fused_torch(blk))
    assert torch.equal(i16, sf.synth_fused_torch(blk, "int16", 2))


@pytest.mark.parametrize("shape,s", [((2, 4, 32, 35), "wants"),
                                     ((2, 0, 32, 36), "wants"),
                                     ((4, 32, 36), "wants"),
                                     ((3, 2, 32, 36), "channels")])
def test_wrapper_rejects_bad_shapes(shape, s):
    with pytest.raises(ValueError, match=s):
        sf.synth_fused(torch.zeros(shape), "int16", channels=2)


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version: a tensor elsewhere that is
    not on a CUDA card raises instead of being computed somewhere else."""
    blk = torch.zeros((2, 3, 32, 36), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sf.synth_fused(blk)
    with pytest.raises(ValueError, match="float32 or float64"):
        sf.synth_fused(torch.zeros((2, 3, 32, 36), dtype=torch.float16))


def test_kernel_build_is_lazy():
    """Importing the port builds no kernel and imports no triton: nvcc runs
    at the first launch on a card, into the git-ignored build directory."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import mp3stego_tpu_torch; "
            "from mp3stego_tpu_torch.ops import _cuda, decode_plane, synth; "
            "assert not _cuda.builds and 'triton' not in sys.modules; "
            "print(_cuda.BUILD_DIR, ' '.join(_cuda.NVCC_FLAGS))")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "mp3stego_tpu_torch/_build" in r.stdout
    assert "arch=compute_90a,code=sm_90a" in r.stdout
    assert "--fmad=false" in r.stdout
