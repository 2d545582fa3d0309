"""utils/profiling.py's device-trace readers, held on the CPU.

``stage_utilization`` against the JAX package's on the same seeded op
records; ``parse_device_trace`` and ``device_busy`` on a chrome trace the
test writes (nested ``gpu_user_annotation`` ranges on two streams,
kernels, memcpys, a memset, an unscoped kernel); ``trace()`` on the CPU,
which records no device work; ``StageTimer`` stages as scopes.
"""

import json

import numpy as np
import pytest
import torch

from mp3stego_tpu.utils import profiling as JP
from mp3stego_tpu_torch.utils import profiling as P

STAGES = ["requantize", "imdct", "synth", "search"]


def _seeded_ops(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    names = STAGES + ["outer", "inner", "unlisted"]
    cats = list(P.ROLLED_CATEGORIES) + ["fusion", "copy"]
    ops = []
    for i in range(n):
        depth = int(rng.integers(0, 4))
        ops.append(dict(
            name=f"op{i}",
            scope=[names[int(k)] for k in rng.integers(0, len(names), depth)],
            dur_us=float(rng.uniform(0.5, 900.0)),
            flops=int(rng.integers(0, 1 << 40)) if i % 3 else 0,
            bytes=int(rng.integers(0, 1 << 32)),
            category=cats[int(rng.integers(0, len(cats)))]))
    return ops


@pytest.mark.parametrize("rolled", (None, "synth"))
@pytest.mark.parametrize("runs", (1, 3))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_stage_utilization_equals_the_jax_package(monkeypatch, seed, runs,
                                                  rolled):
    # the JAX function's rolled categories are XLA's; hand it the port's
    # (device records) so that both claim the same unscoped records
    monkeypatch.setattr(JP, "ROLLED_CATEGORIES", P.ROLLED_CATEGORIES)
    ops = _seeded_ops(seed)
    got = P.stage_utilization(ops, STAGES, runs=runs, rolled_stage=rolled)
    assert got == JP.stage_utilization(ops, STAGES, runs=runs,
                                       rolled_stage=rolled)
    assert list(got) == list(JP.stage_utilization(
        ops, STAGES, runs=runs, rolled_stage=rolled))


def _x(name, cat, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _synthetic_trace() -> dict:
    ann = P.ANNOTATION_CAT
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        # host side: a cpu op and a host annotation, never device records
        _x("aten::add", "cpu_op", 0.0, 5000.0, pid=1, tid=1),
        _x("encode", "user_annotation", 0.0, 5000.0, pid=1, tid=1),
        # stream 7: encode > search > (kernel, memcpy); encode > kernel
        _x("encode", ann, 100.0, 900.0),
        _x("search", ann, 150.0, 300.0),
        _x("void rate_search_kernel(Args)", "kernel", 160.0, 200.0,
           grid=[132, 1, 1]),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 380.0, 50.0,
           bytes=4096),
        _x("analysis_kernel", "kernel", 600.0, 100.0),
        # a second top-level run on stream 7, and a memset in it
        _x("encode", ann, 2000.0, 100.0),
        _x("Memset (Device)", "gpu_memset", 2010.0, 5.0, bytes=64),
        # stream 9: an annotation of its own; a kernel at encode's time
        # on stream 9 lies in no scope of stream 7
        _x("d2h", ann, 170.0, 100.0, tid=9),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 180.0, 60.0,
           tid=9, bytes=1 << 20),
        _x("unscoped_kernel", "kernel", 400.0, 300.0, tid=9),
    ]}


def test_parse_device_trace_on_a_synthetic_trace(tmp_path):
    (tmp_path / "trace.json").write_text(json.dumps(_synthetic_trace()))
    got = P.parse_device_trace(str(tmp_path))
    want = [
        ("void rate_search_kernel(Args)", ["encode", "search"], 200.0, 0,
         "kernel"),
        ("Memcpy DtoH (Device -> Pinned)", ["encode", "search"], 50.0, 4096,
         "gpu_memcpy"),
        ("analysis_kernel", ["encode"], 100.0, 0, "kernel"),
        ("Memset (Device)", ["encode"], 5.0, 64, "gpu_memset"),
        ("Memcpy DtoH (Device -> Pinned)", ["d2h"], 60.0, 1 << 20,
         "gpu_memcpy"),
        ("unscoped_kernel", [], 300.0, 0, "kernel"),
    ]
    assert [(o["name"], o["scope"], o["dur_us"], o["bytes"], o["category"])
            for o in got["ops"]] == want
    assert all(o["flops"] == 0 for o in got["ops"])
    assert got["module_runs"] == {"encode": 2, "d2h": 1}
    # the same reader takes the file and the dict
    assert P.parse_device_trace(str(tmp_path / "trace.json")) == got
    assert P.parse_device_trace(_synthetic_trace()) == got
    util = P.stage_utilization(got["ops"], ["search", "encode", "d2h"],
                               runs=2, rolled_stage="unscoped")
    assert util["encode"]["ms"] == pytest.approx((200 + 50 + 100 + 5)
                                                 / 1e3 / 2, abs=1e-3)
    assert util["unscoped"]["ms"] == 0.15
    assert util["d2h"]["dominant"] == "gpu_memcpy"


def test_parse_device_trace_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        P.parse_device_trace(str(tmp_path))


def test_trace_on_the_cpu_has_no_device_records(tmp_path):
    timer = P.StageTimer()
    with P.trace(str(tmp_path)):
        with timer.stage("add"):
            torch.ones(64).add_(1).sum()
    got = P.parse_device_trace(str(tmp_path))
    assert got == {"ops": [], "module_runs": {}}
    busy = P.device_busy(str(tmp_path))
    assert busy["busy_ms"] == 0.0 and busy["idle_share"] is None
    assert busy["counts"] == {c: 0 for c in P.DEVICE_CATS}
    # the stage ran as a record_function scope of the trace
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "add"
               for e in events)


def test_device_busy_is_the_union_of_overlapping_intervals():
    trace = _synthetic_trace()
    busy = P.device_busy(trace)
    # device intervals: [160, 360], [380, 430], [600, 700], [2010, 2015],
    # [180, 240] and [400, 700] on stream 9: union [160, 360] + [380, 700]
    # + [2010, 2015]
    assert busy["busy_ms"] == pytest.approx((200 + 320 + 5) / 1e3)
    assert busy["counts"] == {"kernel": 3, "gpu_memcpy": 2, "gpu_memset": 1}
    assert busy["wall_ms"] == pytest.approx(5.0)        # every X event
    assert busy["idle_share"] == pytest.approx(1 - 0.525 / 5.0)
    assert [k["name"] for k in busy["top_kernels"]] == [
        "unscoped_kernel", "void rate_search_kernel(Args)",
        "analysis_kernel"]
    given = P.device_busy(trace, wall_ms=1.05)
    assert given["idle_share"] == pytest.approx(1 - 0.525 / 1.05)
