"""The ``lame128`` configuration and the ``decode_f32`` mix on the CPU at a
small size: the writer's streams hold every feature of the configuration,
the port's float64 decode of one equals ``reference_lame`` sample for
sample, faults planted in the decoded answer read as not correct, and the
float32 check refuses a bfloat16 control."""

import numpy as np
import pytest

import core
import mp3gen_lame
import reference_lame

LAME = dict(pool=2, length_s=3.0)
F32 = dict(pool=2, length_s=1.5)
SEED = 2 ** 40 + 5


@pytest.fixture(scope="module")
def stream():
    pcm = mp3gen_lame.lame_pcm(3.0, SEED, "cpu")
    return mp3gen_lame.encode(pcm)


def _run(cell, over, **more):
    return core.run_cell(cell, SEED, 1.0, False, device="cpu",
                         overrides=dict(over, **more), log=lambda m: None)


def test_stream_holds_every_feature(stream):
    data, truth = stream
    assert set(np.unique(truth.block_type).tolist()) == {0, 1, 2, 3}
    assert 0 < truth.ms_frames < truth.frames
    assert truth.reservoir_frames > 0 and truth.scfsi_groups > 0
    assert truth.preflag.any() and truth.sf_scale.any()
    assert data[36:40] == b"Info" and truth.tag_frames == 1
    # every short run sits between a start and a stop window
    bt = truth.block_type[0]
    for t in np.flatnonzero(bt == 2):
        assert bt[t - 1] in (1, 2)
        assert t + 1 == len(bt) or bt[t + 1] in (2, 3)


def test_port_equals_the_reference(stream):
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    data, truth = stream
    got = np.asarray(dp.decode_pcm_i16(dh.parse_mp3(data), "cpu", "float64"))
    want = reference_lame.decode(truth, "cpu")
    assert got.shape == want.shape == (truth.frames * 1152, 2)
    assert np.array_equal(got, want)


def test_reference_blocks_join_seamlessly(stream, monkeypatch):
    _, truth = stream
    whole = reference_lame.decode(truth, "cpu")
    monkeypatch.setattr(reference_lame, "BLOCK", 7)
    assert np.array_equal(reference_lame.decode(truth, "cpu"), whole)


def test_cell_is_correct():
    r = _run("lame128.decode_lame", LAME)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["mismatched_samples"]["value"] == 0


def _planted(monkeypatch, fault):
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    real = dh.parse_mp3

    def parse(*a, **k):
        p = real(*a, **k)
        fault(p)
        return p
    monkeypatch.setattr(dh, "parse_mp3", parse)
    return _run("lame128.decode_lame", LAME)


def _flip_ms(p):
    f = p.num_frames // 2
    p.ms_stereo[2 * f:2 * f + 2] = ~p.ms_stereo[2 * f:2 * f + 2]


def _scalefactor(p):
    long_ = np.argwhere((p.block_type == 0) & (p.global_gain > 0))
    f, gr, ch = long_[len(long_) // 2]
    p.scale_fac_l[f, gr, ch, 3] += 1


def _keep_tag(p):
    p.skip_first_pcm = False


@pytest.mark.parametrize("fault", [_flip_ms, _scalefactor, _keep_tag],
                         ids=["ms_flag", "scalefactor", "tag_silence"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    r = _planted(monkeypatch, fault)
    assert r["correct"] is False and r["failed"] >= 1
    c = r["checks"]
    assert c["mismatched_samples"]["value"] > 0 \
        or c["length_errors"]["value"] > 0


def test_float32_cell_is_correct():
    r = _run("song320.decode_f32", F32)
    assert r["correct"] is True
    assert r["checks"]["max_abs_lsb"]["value"] <= 1


def test_float32_check_refuses_a_bfloat16_control():
    r = _run("song320.decode_f32", F32, control="bfloat16")
    assert r["correct"] is False
    assert r["checks"]["max_abs_lsb"]["value"] > 1
    assert r["checks"]["mismatched_share"]["value"] \
        > r["checks"]["mismatched_share"]["limit"]
