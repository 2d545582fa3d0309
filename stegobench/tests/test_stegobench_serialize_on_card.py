"""The reader of ``encode.serialize_on_card``
(``metrics/encode.serialize_on_card.py``): on planted spans of the program's
recorder it gives the share of frames serialized on the card worked out by
hand, and None where no span of its carries the ``card_frames`` count (as
a program without the card serializer records them), where its spans fall
outside the traced requests, or where the program has no recorder; its
entry in ``BENCHMARK.json`` matches it."""

import sys
import types

import pytest

import core


def _span(name, t0, t1, frames, card=None):
    counts = {"frames": frames}
    if card is not None:
        counts["card_frames"] = card
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, thread=0,
                                 counts=counts)


def _run(*records):
    recs = []
    for k, (a, b) in enumerate(records):
        r = core.Record(k)
        r.start, r.end, r.audio_s = a, b, 10.0
        recs.append(r)
    return core.Traced(recs, [{} for _ in recs], [], 0.0, 1.0)


RUN = ((10.0, 11.0), (20.0, 22.0))
# one request serialized on the card (300 frames), one on the host (100
# frames); a host span before the stretch and a card span after it
SPANS = [
    _span("finish.serialize", 5.0, 5.1, 999, 0),
    _span("finish.reservoir", 10.0, 10.1, 300),
    _span("finish.serialize", 10.2, 10.3, 300, 300),
    _span("finish.serialize", 20.2, 20.3, 100, 0),
    _span("finish.serialize", 30.0, 30.1, 999, 999),
]


@pytest.fixture
def recorder(monkeypatch):
    from mp3stego_tpu_torch.utils import profiling
    kept = []
    monkeypatch.setattr(profiling, "spans", lambda: list(kept))
    return kept


def _read(run):
    return core.load("metrics", "encode.serialize_on_card").read(run)


def test_the_metric_is_in_the_benchmark():
    spec = {m["name"]: m for m in core.load_bench()["per_layer"]}[
        "encode.serialize_on_card"]
    mod = core.load("metrics", "encode.serialize_on_card")
    assert spec["source"] == "program_span" and spec["unit"] == mod.UNIT
    assert spec["moves"] == mod.MOVES == "xrt"
    assert spec["better"] == "higher"
    assert spec["layer"] == "encoder host finish"
    assert spec["workloads"] == ["song320.hide"]


@pytest.mark.parametrize("spans,want", [
    (SPANS, 100.0 * 300 / 400),
    ([s for s in SPANS if s.counts.get("card_frames") != 0], 100.0),
    ([_span("finish.serialize", 10.2, 10.3, 300, 0)], 0.0),
], ids=["both", "card only", "host only"])
def test_reader_on_planted_spans(recorder, spans, want):
    recorder.extend(spans)
    assert _read(_run(*RUN)) == pytest.approx(want, rel=1e-12)


def test_reader_without_its_spans_is_none(recorder):
    assert _read(_run(*RUN)) is None
    recorder.append(_span("finish.reservoir", 10.0, 10.1, 5))
    assert _read(_run(*RUN)) is None
    # the spans of a program without the count: no reading, not 0 %
    recorder.append(_span("finish.serialize", 10.2, 10.3, 300))
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
