"""Card tests of the torch port: the hand-written CUDA kernel and the device
decode plane. Marked ``cuda``; without a card every test skips.

This file imports no JAX and uses no conftest fixture (tests/conftest.py
imports JAX, which the card's machine does not have). Run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

S_SLICE = 18 * 18432        # sub-steps of a 240.7 s song (T = 18,432)


@pytest.fixture
def card():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _v(ch, s, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((ch, 15 + s, 64))
                            .astype(np.float32)).to(device)


@pytest.mark.parametrize("ch,s", [(2, S_SLICE), (2, 18), (1, 18 * 7),
                                  (2, 100001)])
def test_kernel_equals_plain_version_bitwise(card, ch, s):
    from mp3stego_tpu_torch.ops import synth_fir as sf
    v = _v(ch, s, s, card)
    before = sf.launches
    got = sf.synth_fir(v, s)
    want = sf.synth_fir_torch(v, s)
    torch.cuda.synchronize()
    assert sf.launches == before + 1
    assert got.shape == (ch, s, 32)
    assert torch.equal(got, want)


def test_kernel_halo_continuity(card):
    from mp3stego_tpu_torch.ops import synth_fir as sf
    s = 512
    v = _v(1, 2 * s, 1, card)
    whole = sf.synth_fir(v, 2 * s)
    halves = torch.cat([sf.synth_fir(v[:, :15 + s].contiguous(), s),
                        sf.synth_fir(v[:, s:].contiguous(), s)], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(whole, halves)


def test_kernel_wrapper_refuses_what_it_cannot_launch(card):
    from mp3stego_tpu_torch.ops import synth_fir as sf
    v = _v(2, 36, 3, card)
    with pytest.raises(ValueError, match="float32"):
        sf.synth_fir(v.double(), 36)
    with pytest.raises(ValueError, match="contiguous"):
        sf.synth_fir(v.transpose(0, 1).contiguous().transpose(0, 1), 36)


def test_card_plane_matches_host_float64(card):
    """Synthetic batch (short, start, mixed, MS, intensity, linbits): card
    float32 against the host float64 NumPy plane. The batch peaks far above
    full scale, so the float32 bound of tests/test_precision.py (1e-5 on
    unit-scale audio) scales with its peak."""
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.ops import synth_fir as sf
    prep = synthetic_prep(64)
    want = dp.decode_granules_np(prep)
    before = sf.launches
    got = dp.decode_granules(dp.prep_to_torch(prep, card), torch.float32)
    assert sf.launches == before + 1
    got = got.cpu().numpy()
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())


def test_card_plane_refuses_float64(card):
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.ops import decode_plane as dp
    prep = dp.prep_to_torch(synthetic_prep(4), card)
    with pytest.raises(ValueError, match="float32"):
        dp.decode_granules(prep, torch.float64)
