"""The reader of ``decode.scan_on_card`` (``metrics/decode.scan_on_card.py``):
on planted spans of the program's recorder it gives the share of frames
scanned on the card worked out by hand, and None where neither of its spans
is there, where they fall outside the traced requests, or where the program
has no recorder; its entry in ``BENCHMARK.json`` matches it."""

import sys
import types

import pytest

import core


def _span(name, t0, t1, frames):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, thread=0,
                                 counts={"frames": frames})


def _run(*records):
    recs = []
    for k, (a, b) in enumerate(records):
        r = core.Record(k)
        r.start, r.end, r.audio_s = a, b, 10.0
        recs.append(r)
    return core.Traced(recs, [{} for _ in recs], [], 0.0, 1.0)


RUN = ((10.0, 11.0), (20.0, 22.0))
# two requests scanned on the card (300 and 500 frames), one host fill in
# the second (200 frames); a fill before the stretch and a scan after it
SPANS = [
    _span("parse.fill", 5.0, 5.1, 999),
    _span("parse_mp3", 10.0, 10.1, 0),
    _span("samples.device", 10.2, 10.3, 300),
    _span("samples.device", 20.2, 20.3, 500),
    _span("parse.fill", 20.4, 20.6, 200),
    _span("samples.device", 30.0, 30.1, 999),
]


@pytest.fixture
def recorder(monkeypatch):
    from mp3stego_tpu_torch.utils import profiling
    kept = []
    monkeypatch.setattr(profiling, "spans", lambda: list(kept))
    return kept


def _read(run):
    return core.load("metrics", "decode.scan_on_card").read(run)


def test_the_metric_is_in_the_benchmark():
    spec = {m["name"]: m for m in core.load_bench()["per_layer"]}[
        "decode.scan_on_card"]
    mod = core.load("metrics", "decode.scan_on_card")
    assert spec["source"] == "program_span" and spec["unit"] == mod.UNIT
    assert spec["moves"] == mod.MOVES == "xrt"
    assert spec["layer"] == "decode host half"
    assert spec["workloads"] == ["song320.decode", "song320.hide"]


@pytest.mark.parametrize("spans,want", [
    (SPANS, 100.0 * 800 / 1000),
    ([s for s in SPANS if s.name != "parse.fill"], 100.0),
    ([s for s in SPANS if s.name != "samples.device"], 0.0),
], ids=["both", "card only", "host only"])
def test_reader_on_planted_spans(recorder, spans, want):
    recorder.extend(spans)
    assert _read(_run(*RUN)) == pytest.approx(want, rel=1e-12)


def test_reader_without_its_spans_is_none(recorder):
    assert _read(_run(*RUN)) is None
    recorder.append(_span("parse_mp3", 10.0, 10.1, 5))
    assert _read(_run(*RUN)) is None
    recorder[:] = SPANS
    assert _read(_run((40.0, 41.0))) is None
    assert _read(_run()) is None


def test_reader_without_a_recorder_is_none(monkeypatch):
    bare = types.ModuleType("mp3stego_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "mp3stego_tpu_torch.utils.profiling",
                        bare)
    import mp3stego_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiling", bare, raising=False)
    assert _read(_run(*RUN)) is None
