"""Card tests of the torch port: the hand-written CUDA kernel, the device
decode plane, and the encode planes (Q31 analysis, exact search, golden hide
bytes), each equal to the CPU torch result. Marked ``cuda``; without a card
every test skips.

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


def _square_noise_pcm(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sq = np.where((t // 50) % 2 == 0, 32767, -32768)
    pcm = np.stack([sq, np.roll(sq, 17)]).astype(np.int16)
    pcm[:, ::3] = rng.integers(-32768, 32768, size=pcm[:, ::3].shape)
    return pcm


def test_card_analysis_equals_cpu(card):
    """Full-scale input (the Q31 sums wrap), chunked as on a song."""
    from mp3stego_tpu_torch.ops import encode_plane as EP
    pcm = _square_noise_pcm(300 * 576, 8)
    got = EP.run_analysis_device(pcm, 300, card, chunk_g=128)
    want = EP.run_analysis_device(pcm, 300, "cpu")
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", ["clear", "hide"])
def test_card_search_rows_equal_cpu(card, mode):
    """The golden fixture's spectra plus loud seeded lanes (float64-fallback
    cells, escapes): every row and the ix plane, bit for bit."""
    import os
    from mp3stego_tpu_torch.ops import search_plane as SP
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    mdct = np.load(os.path.join(gold, "encode_golden.npz"))["mdct_freq"]
    rng = np.random.default_rng(12)
    loud = rng.integers(-2 ** 30, 2 ** 30, size=(48, 576)) \
        >> rng.integers(0, 24, size=(48, 1))
    xr = np.concatenate([mdct.transpose(1, 0, 2, 3).reshape(-1, 576),
                         loud]).astype(np.int32)
    mb = rng.integers(300, 4095, size=len(xr)).astype(np.int32)
    hide = {}
    if mode == "hide":
        hide = dict(hide_bits=rng.integers(0, 2, 300).astype(np.uint8),
                    hide_cur=np.cumsum(rng.integers(0, 3, len(xr))))
    got = SP.search_all(torch.from_numpy(xr).to(card), mb, 0, **hide)
    want = SP.search_all(torch.from_numpy(xr), mb, 0, **hide)
    for k in SP.ROWS + ("ix",):
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("key", ["hidden_short", "hidden_long",
                                 "hidden_toolong"])
def test_card_golden_hide_bytes(card, key, tmp_path):
    import os
    from mp3stego_tpu_torch import Encoder
    from mp3stego_tpu_torch.steganography import _frame_message
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "golden", "stego_golden.npz"))
    wav = tmp_path / "g.wav"
    wav.write_bytes(gold["wav_bytes"].tobytes())
    msg = {"hidden_short": "ddd", "hidden_toolong": "ddd" * 100,
           "hidden_long": gold["msg_long"].tobytes().decode()}[key]
    outs = {}
    for dev in (card, "cpu"):
        out = str(tmp_path / f"{torch.device(dev).type}.mp3")
        too_long = Encoder(str(wav), out, 320, hide_str=_frame_message(msg),
                           device=dev).encode()
        assert too_long is (key == "hidden_toolong")
        with open(out, "rb") as f:
            outs[torch.device(dev).type] = f.read()
    assert outs["cuda"] == outs["cpu"] == gold[key].tobytes()
