"""The generator: the same seed gives the same requests; another seed the
same sizes with other content and order; the files decode with the
program to what the reference decodes."""

import numpy as np
import pytest
import torch

import mp3gen
import pool
import reference

SMALL = dict(pool=3, length_s=2.0, bitrate_kbps=128)


def _schedule(kind, cfg, mix, seed, n):
    w = kind.Workload(cfg, mix, seed, torch.device("cpu"))
    try:
        it = w.schedule()
        ids = [next(it) for _ in range(n)]
        return [d.data for d in w.items], ids, \
            [getattr(w, "orders", {}).get(i) for i in ids]
    finally:
        w.close()


def test_every_input_has_the_configured_length():
    items = pool.make(dict(SMALL, length_s=1.3), 5, "cpu", keep_pcm=True)
    assert len(items) == 3
    for it in items:
        assert it.truth.frames == -(-round(1.3 * mp3gen.SR) // 1152)
        assert it.pcm.shape == (round(1.3 * mp3gen.SR), 2)
    assert all(it.pcm is None for it in pool.make(SMALL, 5, "cpu"))


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 5])
def test_same_seed_same_inputs(seed):
    a = pool.make(SMALL, seed, "cpu")
    b = pool.make(SMALL, seed, "cpu")
    assert [x.data for x in a] == [x.data for x in b]
    assert all((x.truth.ix == y.truth.ix).all() for x, y in zip(a, b))


def test_other_seed_same_sizes_other_content():
    a = pool.make(SMALL, 11, "cpu")
    b = pool.make(SMALL, 12, "cpu")
    assert [x.truth.frames for x in a] == [y.truth.frames for y in b]
    assert [len(x.data) for x in a] == [len(y.data) for y in b]
    assert all(x.data != y.data for x, y in zip(a, b))


def test_cbr_frames_and_sizes():
    pcm = mp3gen.song_pcm(1.0, 3, "cpu")
    data, truth = mp3gen.encode(pcm, 320)
    fb = mp3gen.frame_bytes(truth.frames, 320)
    assert len(data) == fb.sum() and set(fb) <= {1044, 1045}
    assert data[:2] == b"\xff\xfb"
    # stereo (mode 0, no mode extension), as the upstream encoder writes
    assert data[3] >> 4 == 0


def test_program_decodes_what_the_reference_decodes():
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    pcm = mp3gen.song_pcm(1.5, 21, "cpu")
    data, truth = mp3gen.encode(pcm, 320)
    parsed = dh.parse_mp3(data)
    raw = np.moveaxis(np.asarray(parsed.raw_samples), 2, 0).reshape(
        2, 2 * parsed.num_frames, 576)
    assert (raw == truth.ix).all()
    got = dp.decode_pcm_i16_host(parsed)
    assert got is not None
    assert (got == reference.decode(truth, "cpu")).all()


@pytest.mark.parametrize("mix", ["decode", "batch_decode"])
def test_schedule_repeats_for_a_seed(mix):
    import core
    _, cfg, m = core.find_cell({"decode": "song320.decode",
                                "batch_decode": "clip128.batch_decode"}[mix])
    kind = core.load("kinds", m["kind"])
    cfg = dict(cfg, **SMALL)
    a = _schedule(kind, cfg, m, 77, 7)
    b = _schedule(kind, cfg, m, 77, 7)
    assert a == b
