"""The harness finds each configuration, mix, kind and per-layer metric by
its name, and ``BENCHMARK.json`` keeps the contract's shape."""

import json
import os
import re

import pytest

import core
from conftest import BENCH, ROOT

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_resolves_by_name(cell):
    w, cfg, mix = core.find_cell(cell)
    assert w["name"] == cell and cfg["precision"] == "float64"
    kind = core.load("kinds", mix["kind"])
    assert hasattr(kind, "Workload")


@pytest.mark.parametrize("spec", BENCHMARK["per_layer"],
                         ids=lambda s: s["name"])
def test_metric_reader_found_by_name(spec):
    mod = core.load("metrics", spec["name"])
    assert mod.UNIT == spec["unit"] and mod.MOVES == spec["moves"]
    ends = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert spec["moves"] in ends
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    assert set(spec["workloads"]) <= cells


def test_unknown_names_are_refused():
    with pytest.raises(core.Refused):
        core.load("metrics", "no.such_metric")
    with pytest.raises(core.Refused):
        core.find_cell("song320.no_such_mix")


def test_benchmark_keeps_the_contract_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["stegobench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("stegobench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    ends = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in ends and ends["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(b)) <= 64 * 1024


class _Kind:
    """A request kind that records whether the collector ran in a call."""

    def __init__(self, n):
        self.n, self.seen = n, []

    def schedule(self):
        yield from range(self.n)

    def call(self, i, timer, spans):
        import gc
        self.seen.append(gc.isenabled())
        return 1.0

    def keep(self, i, n):
        pass


def test_window_runs_without_the_collector():
    import gc
    from mp3stego_tpu_torch.utils.profiling import StageTimer
    k = _Kind(3)
    records, window, stretch = core.drive(k, 0.0, False, StageTimer, None)
    assert len(records) == 1 and window >= 0 and stretch is None
    assert k.seen == [False] and gc.isenabled()
    k = _Kind(5)
    records, _, _ = core.drive(k, 60.0, False, StageTimer, None)
    assert [r.i for r in records] == list(range(5))
    assert k.seen == [False] * 5 and gc.isenabled()


def test_setup_leaves_out_the_references_seconds(monkeypatch):
    import time
    kind = core.load("kinds", "decode")
    real = kind.Workload.__init__

    def slow(self, *a, **k):
        real(self, *a, **k)
        time.sleep(4.0)
        self.reference_s = 4.0
    monkeypatch.setattr(kind, "Workload", type(
        "Slow", (kind.Workload,), {"__init__": slow}))
    monkeypatch.setattr(core, "load", lambda folder, name: kind)
    r = core.run_cell("song320.decode", 9, 0.2, False, device="cpu",
                      overrides=dict(pool=1, length_s=0.5),
                      log=lambda m: None)
    assert r["correct"] is True
    assert 0 < r["metrics"]["setup_s"]["value"] < 4.0
