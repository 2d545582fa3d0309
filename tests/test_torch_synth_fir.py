"""Kernel K1 (synthesis FIR) of the torch port: its plain version and its
wrapper's routing, on the CPU.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py); here
the plain version is held bit for bit against the NumPy expression of
``tests/test_pallas.py`` (the JAX package's FIR reference), and the wrapper is
shown to take the plain version for CPU tensors without counting a launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_pallas import _fir_reference  # noqa: E402

from mp3stego_tpu_torch.ops import synth_fir as sf  # noqa: E402


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_takes_plain_version_on_cpu(dtype):
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((2, 15 + 36, 64))).to(dtype)
    before = sf.launches
    out = sf.synth_fir(v, 36)
    assert sf.launches == before, "a CPU tensor must not count a launch"
    assert out.dtype == dtype
    assert torch.equal(out, sf.synth_fir_torch(v, 36))


@pytest.mark.parametrize("shape,s", [((2, 15 + 36, 32), 36),
                                     ((2, 14 + 36, 64), 36),
                                     ((15 + 36, 64), 36),
                                     ((2, 15, 64), 0)])
def test_wrapper_rejects_bad_shapes(shape, s):
    with pytest.raises(ValueError, match="synth_fir wants"):
        sf.synth_fir(torch.zeros(shape), s)


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version: a tensor elsewhere that is
    not on a CUDA card raises instead of being computed somewhere else."""
    v = torch.zeros((2, 15 + 18, 64), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sf.synth_fir(v, 18)


def test_kernel_build_is_lazy():
    """Importing the port builds no kernel and imports no triton: nvcc runs
    at the first launch on a card, into the git-ignored build directory."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import mp3stego_tpu_torch; "
            "from mp3stego_tpu_torch.ops import _cuda, decode_plane, synth_fir; "
            "assert not _cuda.builds and 'triton' not in sys.modules; "
            "print(_cuda.BUILD_DIR, ' '.join(_cuda.NVCC_FLAGS))")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "mp3stego_tpu_torch/_build" in r.stdout
    assert "arch=compute_90a,code=sm_90a" in r.stdout
    assert "--fmad=false" in r.stdout
