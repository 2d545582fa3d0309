"""A stream as LAME writes it by default (joint stereo, short blocks
between start and stop windows, scalefactors with scfsi and preflag, the
bit reservoir and an Info tag frame), made by the benchmark's writer
(``stegobench/mp3gen_lame.py``): the counts ``parse_mp3`` and
``prepare.tables`` record equal the writer's, the native light parse's
planes equal the Python parse's, and the decode equals the writer's own
spectra and side fields."""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "stegobench")

SEEDS = (2 ** 40 + 7, 11)


@functools.lru_cache(maxsize=None)
def _stream(seed):
    sys.path.insert(0, BENCH)
    try:
        import mp3gen_lame
    finally:
        sys.path.remove(BENCH)
    # a few intra-op threads: several test workers share the host, and
    # their thread pools stall one another when each takes every core
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return mp3gen_lame.encode(mp3gen_lame.lame_pcm(3.0, seed, "cpu"))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(params=SEEDS)
def stream(request):
    return _stream(request.param)


def _ct(a, tail=()):
    """(F, 2, 2, ...) [frame][granule][channel] -> (2, T, ...), the tag
    frame's two granules dropped."""
    g = a.shape[0] * 2
    return np.moveaxis(a, 2, 0).reshape((2, g) + tail)[:, 2:]


def test_stream_holds_every_feature(stream):
    _, truth = stream
    bt = truth.block_type
    assert {0, 1, 2, 3} <= set(np.unique(bt).tolist())
    assert 0 < truth.ms_frames < truth.frames
    assert truth.reservoir_frames > truth.frames // 2
    assert truth.scfsi_groups > 0 and truth.tag_frames == 1
    assert (truth.sfl > 0).any() and (truth.sfs > 0).any()
    assert truth.preflag.any() and truth.sf_scale.any()


def test_parse_and_prepare_count_what_the_writer_wrote(stream):
    data, truth = stream
    seen = len(profiling.spans())
    with profiling.recording():
        p = dh.parse_mp3(data)
        dp.host_prepare(p, raw=False)
    got = {s.name: s.counts for s in profiling.spans()[seen:]}
    assert got["parse_mp3"]["short_granules"] == truth.short_granules
    assert got["parse_mp3"]["ms_frames"] == truth.ms_frames
    assert got["parse_mp3"]["reservoir_frames"] == truth.reservoir_frames
    assert got["parse_mp3"]["tag_frames"] == truth.tag_frames == 1
    assert got["prepare.tables"]["short_granules"] == truth.short_granules
    assert got["prepare.tables"]["ms_granules"] == truth.ms_granules


def test_no_counts_off_the_recorder(stream):
    data, _ = stream
    seen = len(profiling.spans())
    dh.parse_mp3(data)
    assert len(profiling.spans()) == seen


def test_light_parse_planes_equal_the_python_parse(stream):
    data, truth = stream
    light = dh.parse_mp3_light_native(data)
    if light is None:
        pytest.skip("the native library does not load here")
    ref = dh.parse_mp3(data, backend="python")
    assert light.num_frames == ref.num_frames == truth.frames + 1
    for name, _ in dh._SIDE_PLANES:
        np.testing.assert_array_equal(getattr(light, name),
                                      getattr(ref, name), err_msg=name)
    np.testing.assert_array_equal(light.ms_stereo, ref.ms_stereo)
    np.testing.assert_array_equal(light.raw_samples, ref.raw_samples)


def test_parse_reads_the_writers_fields(stream):
    data, truth = stream
    p = dh.parse_mp3(data, backend="python")
    assert p.vbr_tag is not None and p.vbr_tag.kind == "info"
    assert p.skip_first_pcm
    np.testing.assert_array_equal(_ct(p.raw_samples, (576,)), truth.ix)
    np.testing.assert_array_equal(_ct(p.global_gain), truth.gg)
    np.testing.assert_array_equal(_ct(p.block_type), truth.block_type)
    np.testing.assert_array_equal(_ct(p.scale_fac_scale), truth.sf_scale)
    np.testing.assert_array_equal(_ct(p.pre_flag), truth.preflag)
    np.testing.assert_array_equal(_ct(p.sub_block_gain, (3,)), truth.sbg)
    np.testing.assert_array_equal(_ct(p.scale_fac_l, (22,)), truth.sfl)
    np.testing.assert_array_equal(_ct(p.scale_fac_s, (3, 13)), truth.sfs)
    np.testing.assert_array_equal(p.ms_stereo[2:], truth.ms)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_decode_drops_the_tag_frame(stream, precision):
    data, truth = stream
    pcm = np.asarray(dp.decode_pcm_i16(dh.parse_mp3(data), "cpu", precision))
    assert pcm.shape == (truth.frames * 1152, 2)
