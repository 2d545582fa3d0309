"""The seven readers of the program's own spans (``program_spans.py`` and
``metrics/<name>.py``): each on a synthetic traced run and recorder gives
the value worked out by hand, and None where its spans are absent or the
program has no recorder; then each cell's traced run on the CPU, at a
small size, reads its new metrics."""

import json
import subprocess
import sys
import threading
import types

import pytest

import core
import program_spans
from conftest import BENCH, ROOT

ME = threading.get_ident()
OTHER = ME + 1


def _span(name, t0, t1, thread=ME):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, thread=thread,
                                 counts={})


def _run(*records, audio_s=10.0):
    """A traced run whose requests are (start, end) pairs, each of
    ``audio_s`` audio seconds."""
    recs = []
    for k, (a, b) in enumerate(records):
        r = core.Record(k)
        r.start, r.end, r.audio_s = a, b, audio_s
        recs.append(r)
    return core.Traced(recs, [{} for _ in recs], [], 0.0, 1.0)


# two requests, [10, 11] and [20, 22], 20 audio seconds in all; the spans
# of a request before the stretch and after it are not the run's
SPANS = [
    _span("parse_mp3", 5.0, 5.5),                       # before the stretch
    _span("encode", 10.0, 10.9),
    _span("parse_mp3", 10.0, 10.2),
    _span("parse.native", 10.05, 10.15),
    _span("host_prepare", 10.2, 10.3),
    _span("finish.reservoir", 10.5, 10.6),
    _span("finish.serialize", 10.6, 10.64),
    _span("batch.parse_wait", 10.3, 10.4),
    _span("batch.prep_wait", 10.4, 10.45),
    _span("batch.file", 10.05, 10.95, thread=OTHER),     # another thread
    _span("parse_mp3", 20.0, 20.5),
    _span("parse.native", 20.1, 20.3),
    _span("host_prepare", 20.5, 21.0),
    _span("finish.reservoir", 21.0, 21.2),
    _span("finish.serialize", 21.2, 21.26),
    _span("batch.prep_wait", 21.3, 21.35),
    _span("parse_mp3", 30.0, 31.0),                     # after it
]
RUN = ((10.0, 11.0), (20.0, 22.0))

WANT = {
    "decode.parse": (0.2 + 0.5) * 1e3 / 20,
    "decode.parse_native": (0.1 + 0.2) * 1e3 / 20,
    "encode.reservoir": (0.1 + 0.2) * 1e3 / 20,
    "encode.serialize": (0.04 + 0.06) * 1e3 / 20,
    "batch.parse_wait": 0.1 * 1e3 / 20,
    "batch.prep_wait": (0.05 + 0.05) * 1e3 / 20,
    # request 1: [10, 10.9] covered, 0.1 s open; request 2: covered
    # [20, 21.26] and [21.3, 21.35], 0.04 + 0.65 s open; of 3 s
    "request.unspanned": 100 * (0.1 + 0.04 + 0.65) / 3.0,
}
NAMES = {
    "decode.parse": "parse_mp3",
    "decode.parse_native": "parse.native",
    "encode.reservoir": "finish.reservoir",
    "encode.serialize": "finish.serialize",
    "batch.parse_wait": "batch.parse_wait",
    "batch.prep_wait": "batch.prep_wait",
}


@pytest.fixture
def recorder(monkeypatch):
    """The program's recorder, handing out the spans the test sets."""
    from mp3stego_tpu_torch.utils import profiling
    kept = []
    monkeypatch.setattr(profiling, "spans", lambda: list(kept))
    return kept


def test_the_new_metrics_are_in_the_benchmark():
    bench = core.load_bench()
    spec = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        assert spec[name]["source"] == "program_span"
        mod = core.load("metrics", name)
        assert mod.UNIT == spec[name]["unit"]
        assert mod.MOVES == spec[name]["moves"]


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_run(name, recorder):
    recorder.extend(SPANS)
    got = core.load("metrics", name).read(_run(*RUN))
    assert got == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_its_spans_is_none(name, recorder):
    read = core.load("metrics", name).read
    # no span at all
    assert read(_run(*RUN)) is None
    # spans, but none of its own (or, for the share, none of the
    # caller's thread)
    if name == "request.unspanned":
        recorder.extend(_span(s.name, s.t0, s.t1, thread=OTHER)
                        for s in SPANS)
    else:
        recorder.extend(s for s in SPANS if s.name != NAMES[name])
    assert read(_run(*RUN)) is None
    # its spans, but all outside the traced requests
    recorder[:] = SPANS
    assert read(_run((40.0, 41.0))) is None
    # no traced request
    assert read(_run()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_a_recorder_is_none(name, monkeypatch):
    # the program of a commit before the recorder: its profiling module
    # has no ``spans``
    bare = types.ModuleType("mp3stego_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "mp3stego_tpu_torch.utils.profiling",
                        bare)
    import mp3stego_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiling", bare, raising=False)
    assert core.load("metrics", name).read(_run(*RUN)) is None


def test_unspanned_counts_nested_and_overlapping_spans_once(recorder):
    recorder.extend([_span("a", 0.0, 0.6), _span("b", 0.1, 0.3),
                     _span("c", 0.5, 0.8), _span("d", 1.2, 5.0)])
    # open: [0.8, 1.2] of [0, 2]
    assert program_spans.unspanned_pct(_run((0.0, 2.0))) \
        == pytest.approx(20.0)
    assert program_spans.unspanned_pct(_run((0.0, 2.0)), thread=OTHER) \
        is None


SMALL = {"song320.decode": dict(pool=2, length_s=1.5),
         "clip128.batch_decode": dict(pool=3, length_s=1.0)}
CELL_METRICS = {
    "song320.decode": ("decode.parse", "decode.parse_native",
                       "request.unspanned"),
    "clip128.batch_decode": ("batch.parse_wait", "batch.prep_wait"),
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_cpu_run_reads_the_new_metrics(cell):
    # in a process of its own: the profiler hangs in a test worker that
    # runs other threads; a window of 4 s, so that a loaded host still
    # sends the second request, where the traced stretch starts
    code = ("import sys, json; sys.path[:0] = [%r, %r]; import core; "
            "print(core.result_line(core.run_cell(%r, 2 ** 33 + 5, 4.0, "
            "True, device='cpu', overrides=%r, log=lambda m: None)))"
            % (BENCH, ROOT, cell, SMALL[cell]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    for name in CELL_METRICS[cell]:
        value = line["metrics"][name]["value"]
        if name == "request.unspanned":
            assert 0.0 <= value < 100.0
        else:
            assert value > 0, name
