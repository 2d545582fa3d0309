"""utils/profiling.py's span recorder, on the CPU: nesting, ``parent`` and
``root``; ``count``; ``bind`` across a thread pool; nothing recorded when
recording is off; spans recorded inside a CPU ``torch.profiler``, each a
``user_annotation`` of its trace nested as the spans nest; the bound on
kept spans and its dropped count; ``StageTimer``'s times, names, counts
and waits with spans inside its stages; and the spans the program records
where it works: the parse, ``host_prepare``, ``decode_pcm_i16``, the
batched decode's pools and the encoder's hide and host finish.
"""

import json
import os
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.models.encoder import MP3Encoder
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.parallel import decode_files_batched
from mp3stego_tpu_torch.steganography import _frame_message
from mp3stego_tpu_torch.utils import profiling as P
from mp3stego_tpu_torch.utils.wav import read_wav

CPU = torch.device("cpu")
GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _since(mark: int) -> list:
    """The spans recorded after the span id ``mark``."""
    return [s for s in P.spans() if s.id > mark]


def _mark() -> int:
    """An id below every span recorded from here on."""
    with P.recording(), P.span("mark") as s:
        pass
    return s.id


def _by_name(spans: list) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parent_and_root():
    m = _mark()
    with P.recording():
        with P.span("outer", files=2) as outer:
            with P.span("middle") as middle:
                with P.span("inner") as inner:
                    pass
            with P.span("second") as second:
                pass
        with P.span("next root") as other:
            pass
    got = _since(m)
    # kept as they close, innermost first
    assert [s.name for s in got] == ["inner", "middle", "second", "outer",
                                     "next root"]
    assert outer.parent is None and outer.root == outer.id
    assert middle.parent == outer.id and middle.root == outer.id
    assert inner.parent == middle.id and inner.root == outer.id
    assert second.parent == outer.id and second.root == outer.id
    assert other.parent is None and other.root == other.id
    assert outer.counts == {"files": 2} and inner.counts == {}
    me = threading.get_ident()
    for s in got:
        assert s.thread == me and s.t0 <= s.t1
    assert outer.t0 <= middle.t0 <= inner.t0 <= inner.t1 <= middle.t1 \
        <= second.t0 <= second.t1 <= outer.t1


def test_count_adds_to_the_innermost_open_span():
    with P.recording():
        P.count("orphan", 5)                      # no span open: nothing
        with P.span("outer", n=1) as outer:
            P.count("n", 2)
            with P.span("inner") as inner:
                P.count("n", 3)
                P.count("n")
            P.count("bytes", 7)
    assert outer.counts == {"n": 3, "bytes": 7}
    assert inner.counts == {"n": 4}


@pytest.mark.parametrize("workers", (1, 3))
def test_bind_carries_the_span_into_a_thread_pool(workers):
    def task(k):
        with P.span(f"task{k}") as s:
            P.count("k", k)
        return s

    with P.recording():
        with P.span("submit") as top:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                done = [f.result() for f in
                        [pool.submit(P.bind(task), k) for k in range(6)]]
                mapped = list(pool.map(P.bind(task), range(6, 9)))
    me = threading.get_ident()
    for k, s in enumerate(done + mapped):
        assert s.name == f"task{k}" and s.counts == {"k": k}
        assert s.parent == top.id and s.root == top.id
        assert s.thread != me
    # no span open: bind hands the function back
    assert P.bind(task) is task


def test_concurrent_spans_and_counts_lose_no_update(monkeypatch):
    monkeypatch.setattr(P, "_kept", deque(maxlen=P.SPAN_LIMIT))
    monkeypatch.setattr(P, "_dropped", 0)
    workers, tasks, steps = 8, 24, 200

    def work(k):
        for _ in range(steps):
            P.count("n")                          # on the shared span
            with P.span("w"):
                P.count("m")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.recording():
            with P.span("shared") as top:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    futs = [pool.submit(P.bind(work), k)
                            for k in range(tasks)]
                    for f in futs:
                        f.result()
    finally:
        sys.setswitchinterval(old)
    assert top.counts == {"n": tasks * steps}
    mine = [s for s in P.spans() if s.name == "w"]
    assert len(mine) == tasks * steps and P.dropped_spans() == 0
    assert len({s.id for s in mine}) == len(mine)
    assert all(s.counts == {"m": 1} and s.parent == top.id for s in mine)


def test_nothing_is_recorded_when_recording_is_off():
    assert not torch._C._autograd._profiler_enabled()
    m = _mark()
    n = len(P.spans())
    cm = P.span("off", files=3)
    with cm as s:
        P.count("files", 1)
        with P.span("inner") as t:
            pass
    assert s is None and t is None
    # one shared null context, and no span kept
    assert cm is P.span("other")
    assert _since(m) == [] and len(P.spans()) == n


def _annotations(path) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def test_spans_are_recorded_inside_a_cpu_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    m = _mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("p.outer", n=1):
            with P.span("p.middle"):
                torch.ones(8).add_(1)
                with P.span("p.inner"):
                    torch.ones(8).mul_(2)
            with P.span("p.second"):
                pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    got = _since(m)
    assert sorted(s.name for s in got) == ["p.inner", "p.middle", "p.outer",
                                          "p.second"]
    ann = _annotations(path)
    by_id = {s.id: s for s in got}
    for s in got:
        # one user_annotation a span, of the same name
        assert len(ann.get(s.name, ())) == 1, s.name
        if s.parent in by_id:
            # nested the same way: inside its parent's range
            (a, b), = ann[s.name]
            (pa, pb), = ann[by_id[s.parent].name]
            assert pa <= a and b <= pb, s.name
    (a, b), = ann["p.middle"]
    (c, d), = ann["p.second"]
    assert b <= c                                  # siblings do not overlap
    # off again once the profiler stops
    with P.span("after") as s:
        assert s is None


def test_trace_records_spans(tmp_path):
    m = _mark()
    with P.trace(str(tmp_path)):
        with P.span("t.outer"):
            with P.span("t.inner"):
                torch.ones(4).add_(1)
    names = {s.name for s in _since(m)}
    assert names == {"t.outer", "t.inner"}
    assert {"t.outer", "t.inner"} <= set(
        _annotations(str(tmp_path / "trace.json")))


@pytest.mark.parametrize("limit", (1, 4, 7))
def test_the_kept_spans_are_bounded_and_the_dropped_counted(monkeypatch,
                                                           limit):
    monkeypatch.setattr(P, "_kept", deque(maxlen=limit))
    monkeypatch.setattr(P, "_dropped", 0)
    with P.recording():
        for k in range(10):
            with P.span(f"s{k}"):
                pass
    assert [s.name for s in P.spans()] == [f"s{k}"
                                           for k in range(10 - limit, 10)]
    assert P.dropped_spans() == 10 - limit
    assert P.SPAN_LIMIT == 1 << 20


def _staged(timer):
    with timer.stage("host_prepare"):
        pass
    with timer.stage("h2d"):
        with timer.stage("inner"):
            pass
    with timer.stage("host_prepare"):
        pass


@pytest.mark.parametrize("recorded", (False, True))
def test_stage_timer_keeps_its_times_names_counts_and_waits(recorded):
    waits = []
    timer = P.StageTimer(sync=lambda: waits.append(1))
    m = _mark()
    if recorded:
        with P.recording():
            _staged(timer)
    else:
        _staged(timer)
    assert list(timer.times) == ["host_prepare", "inner", "h2d"]
    assert dict(timer.counts) == {"host_prepare": 2, "inner": 1, "h2d": 1}
    assert all(t >= 0.0 for t in timer.times.values())
    assert len(waits) == 8                        # two a stage, as before
    got = _since(m)
    if not recorded:
        assert got == []
        return
    assert [s.name for s in got] == ["host_prepare", "inner", "h2d",
                                     "host_prepare"]
    inner, h2d = got[1], got[2]
    assert inner.parent == h2d.id
    # a stage's span lasts no longer than the wall it adds to times
    assert h2d.t1 - h2d.t0 <= timer.times["h2d"]


@pytest.mark.parametrize("enabled", (True, False))
def test_a_stage_gives_its_span(enabled):
    timer = P.StageTimer(enabled=enabled)
    with timer.stage("off") as s:
        assert s is None                          # nothing recorded
    with P.recording():
        with timer.stage("on") as s:
            P.count("n", 2)
    assert s.name == "on" and s.counts == {"n": 2} and s.t0 <= s.t1
    assert ("on" in timer.times) == enabled


def test_a_disabled_stage_records_a_span_and_no_time():
    timer = P.StageTimer(enabled=False, sync=lambda: pytest.fail("waited"))
    m = _mark()
    with P.recording():
        with timer.stage("device plane"):
            pass
    assert not timer.times and not timer.counts
    assert [s.name for s in _since(m)] == ["device plane"]


def test_parse_prepare_and_decode_record_their_parts(fixture_mp3):
    with open(fixture_mp3, "rb") as f:
        data = f.read()
    m = _mark()
    timer = P.StageTimer()
    with P.recording():
        p = dh.parse_mp3(data)
        pcm = dp.decode_pcm_i16(p, CPU, "float64", timer=timer)
    assert np.array_equal(pcm, dp.decode_pcm_i16(p, CPU, "float64"))
    by = _by_name(_since(m))
    parse, = by["parse_mp3"]
    # the fixture as the upstream encoder writes it: long blocks, stereo
    # mode 0, no reservoir, no tag frame
    assert parse.counts == {"bytes": len(data), "frames": p.num_frames,
                            "short_granules": 0, "ms_frames": 0,
                            "reservoir_frames": 0, "tag_frames": 0}
    assert parse.parent is None
    for name in ("parse.walk", "parse.planes", "parse.native", "parse.tag"):
        s, = by[name]
        assert s.parent == parse.id and s.root == parse.id, name
    prep, = by["host_prepare"]
    for name in ("prepare.pack", "prepare.tables"):
        s, = by[name]
        assert s.parent == prep.id, name
    assert by["prepare.tables"][0].counts == {"short_granules": 0,
                                              "ms_granules": 0}
    # the parse deferred its samples; on the CPU the pack fills them
    fill, = by["parse.fill"]
    assert fill.parent == by["prepare.pack"][0].id
    assert fill.counts == {"frames": p.num_frames}
    assert "samples.device" not in by
    for name in ("host_prepare", "h2d", "device plane", "d2h",
                 "finish_inter"):
        assert len(by[name]) == 1, name
    assert list(timer.times) == ["host_prepare", "h2d", "device plane",
                                 "d2h"]


def test_the_scan_route_records_its_scan_and_no_fill(fixture_mp3,
                                                     monkeypatch):
    """The scan route (``parse_mp3``, then ``decode_pcm_i16`` with the scan,
    here its plain version on the CPU under a fake of ``scan_lanes``): the
    scan is the span ``samples.device`` inside ``device plane``, and no
    host fill runs."""
    monkeypatch.setattr(dp, "scan_lanes", lambda p, device: p.lanes)
    with open(fixture_mp3, "rb") as f:
        data = f.read()
    timer = P.StageTimer()
    m = _mark()
    with P.recording():
        with timer.stage("parse"):
            p = dh.parse_mp3(data)
        pcm = dp.decode_pcm_i16(p, CPU, "float64", timer=timer)
    assert p.samples_pending
    assert np.array_equal(pcm, dp.decode_pcm_i16(
        dh.parse_mp3(data, defer_samples=False), CPU, "float64"))
    by = _by_name(_since(m))
    scan, = by["samples.device"]
    assert scan.parent == by["device plane"][0].id
    assert scan.counts == {"frames": p.num_frames}
    assert "parse.fill" not in by
    native, = by["parse.native"]
    assert native.parent == by["parse_mp3"][0].id
    assert by["parse_mp3"][0].parent == by["parse"][0].id
    assert list(timer.times) == ["parse", "host_prepare", "h2d",
                                 "device plane", "d2h"]


@pytest.mark.parametrize("chunk_files", (1, 0))
def test_batched_decode_spans_on_its_pools(fixture_mp3, tmp_path,
                                           chunk_files):
    gold = np.load(os.path.join(GOLD, "multirate_golden.npz"))
    paths = [fixture_mp3]
    for tag in ("44100_128", "48000_96"):
        path = tmp_path / f"{tag}.mp3"
        path.write_bytes(gold[f"mp3_{tag}"].tobytes())
        paths.append(str(path))
    want = decode_files_batched(paths, out="int16", device="cpu",
                                chunk_files=chunk_files)
    m = _mark()
    with P.recording():
        outs = decode_files_batched(paths, out="int16", device="cpu",
                                    chunk_files=chunk_files)
    for a, b in zip(outs, want):
        assert np.array_equal(a, b)
    by = _by_name(_since(m))
    top, = by["decode_files_batched"]
    assert top.parent is None and top.counts == {"files": 3}
    me = threading.get_ident()
    assert top.thread == me
    files, parses = by["batch.file"], by["parse_mp3"]
    assert len(files) == len(paths) and len(parses) == len(paths)
    for f in files:
        assert f.thread != me and f.parent == top.id and f.root == top.id
    for s in parses:
        assert s.thread != me and s.root == top.id
        assert s.parent in {f.id for f in files}
    wait, = by["batch.parse_wait"]
    assert wait.thread == me and wait.parent == top.id
    # a chunk a file, or a chunk a samplerate
    chunks = 3 if chunk_files == 1 else 2
    for name in ("batch.prep", "batch.prep_wait", "batch.dispatch",
                 "batch.fetch_wait", "batch.unpack"):
        assert len(by[name]) == chunks, name
        for s in by[name]:
            assert s.root == top.id, name
            assert (s.thread != me) == (name == "batch.prep"), name
    assert sum(s.counts["files"] for s in by["batch.prep"]) == len(paths)
    assert sum(s.counts["granules"] for s in by["batch.prep"]) == sum(
        2 * dh.parse_mp3(open(p, "rb").read()).num_frames for p in paths)
    # the host_prepare passes run on the pool under their chunk's prep
    preps = {s.id for s in by["batch.prep"]}
    assert len(by["prepare.pack"]) == len(paths)
    assert all(s.parent in preps for s in by["prepare.tables"])


def test_the_hide_records_its_setup_and_finish_once(tmp_path):
    gold = np.load(os.path.join(GOLD, "stego_golden.npz"))
    wav = tmp_path / "fixture.wav"
    wav.write_bytes(gold["wav_bytes"].tobytes())
    enc = MP3Encoder(read_wav(str(wav), 320),
                     hide_str=_frame_message("ddd"), device="cpu")
    m = _mark()
    with P.recording():
        enc.encode()
    assert bytes(enc.out_buffer) == gold["hidden_short"].tobytes()
    by = _by_name(_since(m))
    top, = by["encode"]
    assert top.parent is None
    for name in ("hide.setup", "finish.scfsi", "finish.steps",
                 "finish.reservoir", "finish.serialize"):
        s, = by[name]
        assert s.root == top.id, name
    setup, = by["hide.setup"]
    clear, = by["hide clear pass (device)"]
    assert clear.parent == setup.id
    finish, = by["assemble+serialize (host)"]
    for name in ("finish.scfsi", "finish.steps", "finish.reservoir",
                 "finish.serialize"):
        assert by[name][0].parent == finish.id, name
    nf = by["finish.reservoir"][0].counts["frames"]
    assert nf == by["finish.serialize"][0].counts["frames"] > 0
    scans = by["hide scan (host)"]
    assert len(scans) == enc.hide_stats["blocks"]
    assert sum(s.counts["redo_lanes"] for s in scans) \
        == enc.hide_stats["redone"]
    assert all(s.counts["redo_s"] >= 0.0 for s in scans)
    assert set(enc.timer.times) >= {"hide scan (host)",
                                    "assemble+serialize (host)"}
