"""The torch decode plane on hand-crafted streams (tests/craft_mp3.py) that
reach the branches no encoder emits: intensity stereo (MPEG-1 and LSF, long
and short blocks, with and without MS), ISO mixed blocks at 44.1 kHz and the
8 kHz mixed-block middle region. (Linbits escapes are covered by the
synthetic batch of tests/test_torch_decode_plane.py.)

Each stream goes through the JAX package's host parse and ``host_prepare``;
the same numpy prep feeds the port's torch plane and the JAX package's
float64 NumPy plane (``decode_granules_np``):

* float64 torch plane: bit for bit (it follows ``decode_granules_np``
  operation for operation, its sums in the same ascending order), and its
  int16 WAV samples (the route the card's default decode takes) equal the
  host C++ plane's;
* float32 torch plane: ``max|d| < 1e-5``, the float bound of
  tests/test_precision.py (the streams are unit scale, no clipping).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from craft_mp3 import (Granule, build_stream, build_stream_lsf,  # noqa: E402
                       lsf_sfc, lsf_sfc_is)

from mp3stego_tpu.bitstream import decoder_host as jdh  # noqa: E402
from mp3stego_tpu.ops import decode_plane as jdp  # noqa: E402
from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402

GG = 186                              # 2^-6: crafted content stays unclipped
VALS = [1, -1] * 40
ISP = [0, 1, 2, 3, 4, 5, 6] * 3
_rng = np.random.default_rng(7)


def _vals(n=120, amp=6):
    v = _rng.integers(-amp, amp + 1, size=n)
    return [int(x) for x in v]


def _is_long(mode_ext):
    gl = lambda: Granule(values=VALS, global_gain=GG)           # noqa: E731
    gr = lambda: Granule(values=[1, -1] * 4, scalefac=ISP,      # noqa: E731
                         global_gain=GG)
    return build_stream([[(gl(), gr()), (gl(), gr())]] * 4, mode=1,
                        mode_ext=mode_ext)


def _is_short():
    gl = lambda: Granule(values=[1, -1] * 30, global_gain=GG,   # noqa: E731
                         short=True)
    isp = np.tile(np.array([0, 1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 4]), (3, 1))
    gr = lambda: Granule(values=[], scalefac=isp,                # noqa: E731
                         scalefac_compress=15, short=True)
    return build_stream([[(gl(), gr()), (gl(), gr())]] * 4, mode=1,
                        mode_ext=3)


def _mixed_44k():
    g = lambda: Granule(values=_vals(), global_gain=GG, mixed=True,  # noqa
                        scalefac_long=[1, 0, 2, 0, 1, 0, 3, 0],
                        scalefac=np.ones((3, 12), np.int32),
                        scalefac_compress=5, table=1,
                        sub_block_gain=(0, 1, 2))
    return build_stream([[(g(), g()), (g(), g())] for _ in range(4)],
                        mode=0, mode_ext=0)


def _mixed_8k():
    g = lambda: Granule(values=_vals(), global_gain=GG, lsf=True,  # noqa
                        mixed=True, scalefac_long=[0] * 6,
                        scalefac=np.zeros((3, 12), np.int32), table=1)
    return build_stream_lsf([(g(), g()) for _ in range(6)], bitrate=16,
                            samplerate=8000, mode=0, mode_ext=0)


def _lsf_is(scale, mode_ext):
    gl = lambda: Granule(values=VALS, global_gain=GG, lsf=True,  # noqa
                         scalefac_compress=lsf_sfc())
    gr = lambda: Granule(values=[], scalefac=ISP, lsf=True,      # noqa
                         i_stereo=True,
                         scalefac_compress=lsf_sfc_is(3, 3, 3, cls=0,
                                                      scale=scale))
    return build_stream_lsf([(gl(), gr()) for _ in range(4)], mode=1,
                            mode_ext=mode_ext)


STREAMS = {
    "is_long": lambda: _is_long(1),
    "is_ms_long": lambda: _is_long(3),
    "is_ms_short": _is_short,
    "mixed_44k": _mixed_44k,
    "mixed_8k_lsf": _mixed_8k,
    "lsf_is_scale0": lambda: _lsf_is(0, 1),
    "lsf_is_ms_scale1": lambda: _lsf_is(1, 3),
}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, build in STREAMS.items():
        mp3 = build()
        prep = jdp.host_prepare(jdh.parse_mp3(mp3, 0))
        out[name] = (mp3, prep, jdp.decode_granules_np(prep))
    return out


@pytest.mark.parametrize("name", list(STREAMS))
def test_crafted_stream_exercises_its_branch(name, cases):
    _, prep, ref = cases[name]
    want = {"is_long": "is", "is_ms_long": "is", "is_ms_short": "is",
            "lsf_is_scale0": "is", "lsf_is_ms_scale1": "is",
            "mixed_44k": "mixed", "mixed_8k_lsf": "mixed_lin"}[name]
    if want == "is":
        assert prep["is_mask"].any() and (prep["is_pos"] >= 0).any()
    elif want == "mixed":
        assert (prep["mode"] == 3).any()
    else:
        assert (prep["mode"] == 3).any() and prep["mix_lin_cols"].any()
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("name", list(STREAMS))
def test_torch_f64_plane_matches_numpy(name, cases):
    _, prep, ref = cases[name]
    got = pdp.decode_granules(pdp.prep_to_torch(prep, "cpu"), torch.float64)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", list(STREAMS))
def test_torch_f64_wav_samples_equal_host_plane(name, cases):
    """``decode_pcm_i16`` in float64 (the default decode's route on the
    card) against the host C++ plane, sample for sample."""
    mp3 = cases[name][0]
    parsed = pdh.parse_mp3(mp3, 0)
    got = pdp.decode_pcm_i16(parsed, "cpu", "float64")
    want = pdp.decode_pcm_i16_host(parsed)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(STREAMS))
def test_torch_f32_plane_within_float_bound(name, cases):
    _, prep, ref = cases[name]
    got = pdp.decode_granules(pdp.prep_to_torch(prep, "cpu"), torch.float32)
    assert np.abs(got.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("name", list(STREAMS))
def test_port_host_prep_matches_jax(name, cases):
    mp3, prep, _ = cases[name]
    pprep = pdp.host_prepare(pdh.parse_mp3(mp3, 0))
    for k in pdp.ALL_KEYS:
        assert np.array_equal(pprep[k], prep[k]), k


@pytest.mark.parametrize("name", list(STREAMS))
def test_crafted_golden_holds_these_streams(name, cases):
    """tests/golden/crafted_golden.npz (tools/gen_crafted_golden.py), which
    chip_smoke.py decodes on the card, holds exactly these streams."""
    import os
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "golden", "crafted_golden.npz"))
    assert set(gold.files) == set(STREAMS)
    assert gold[name].tobytes() == cases[name][0]
