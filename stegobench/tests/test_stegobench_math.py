"""The copied trace and bound arithmetic, on a canned trace and known
shapes."""

import json

import pytest

import bounds
import trace_math as tm


def _trace(tmp_path):
    ev = [
        # a host scope over the whole stretch and one around a parse
        dict(ph="X", cat="user_annotation", name="request", ts=0, dur=100,
             pid=1, tid=1),
        dict(ph="X", cat="user_annotation", name="parse_mp3", ts=0, dur=40,
             pid=1, tid=1),
        # a device annotation holding the two kernels
        dict(ph="X", cat="gpu_user_annotation", name="device plane", ts=50,
             dur=30, pid=0, tid=7),
        dict(ph="X", cat="kernel", name="void granule_kernel<double, "
             "signed char>(Params)", ts=52, dur=10, pid=0, tid=7),
        dict(ph="X", cat="kernel", name="void synth_fused_kernel<double>()",
             ts=60, dur=15, pid=0, tid=7),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=45, dur=10,
             pid=0, tid=8),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=90, dur=5,
             pid=0, tid=8),
        dict(ph="i", cat="kernel", name="instant", ts=1),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_device_ops(tmp_path):
    evs = tm.events(_trace(tmp_path))
    ops = tm.device_ops(evs)
    assert [o["name"][:9] for o in ops] == ["void gran", "void synt",
                                            "Memcpy Ht", "Memcpy Dt"]
    assert [o["category"] for o in ops] == ["kernel", "kernel", "gpu_memcpy",
                                            "gpu_memcpy"]
    assert ops[1]["ts"] == 60.0 and ops[1]["dur"] == 15.0


def test_busy_is_the_union(tmp_path):
    ops = tm.device_ops(tm.events(_trace(tmp_path)))
    # [45, 55] U [52, 62] U [60, 75] U [90, 95] = 30 + 5
    assert tm.intervals(ops) == [(45.0, 75.0), (90.0, 95.0)]
    assert tm.busy_us(ops) == 35.0
    assert tm.kernel_us(ops, "granule_kernel") == 10.0
    assert tm.kernel_us(ops, "synth_fused_kernel") == 15.0
    assert tm.kernel_us(ops, "Memcpy") == 0.0


def test_top_ops_and_idle_gaps(tmp_path):
    evs = tm.events(_trace(tmp_path))
    ops = tm.device_ops(evs)
    top = tm.top_ops(ops)
    assert top[0][0].startswith("void synth") and top[0][1] == 15e-6
    gaps = tm.idle_gaps(evs, ops, 0.0, 100.0)
    # [0, 45] (the parse's scope is innermost at its middle), [75, 90]
    # and [95, 100] (only the request's)
    assert [round(g[1] * 1e6) for g in gaps] == [45, 15, 5]
    assert [g[0] for g in gaps] == ["parse_mp3", "request", "request"]
    assert tm.idle_gaps(evs, ops, 60.0, 100.0) == [["request", 15e-6],
                                                   ["request", 5e-6]]


def test_k1_bound_is_chip_smokes():
    # chip_smoke.fused_bound(2, 18432, float64, "int16"): 0.2036 ms by
    # operations (PERF.md's kernel table, the 240.74 s song)
    assert bounds.k1_s(18432) == pytest.approx(0.2036e-3, rel=1e-3)
    steps = 2 * 18432 * 18
    assert bounds.k1_s(18432) == steps * 5216 / 17e12


def test_k2_bound_from_shapes():
    t, esc = 18432, 85760
    lanes = 2 * t
    nbytes = lanes * 576 + esc * 4 + lanes * 16 + 8 * lanes * 32 * 36
    ops = lanes * 576 * 3 + lanes * 248 * 6 \
        + lanes * 32 * (36 * 18 * 2 + 36)
    assert nbytes / 3.35e12 > ops / 17e12          # bound by bytes
    assert bounds.k2_s(t, esc) == nbytes / 3.35e12
    # within 2 % of chip_smoke.granule_bound on the song's prep (0.1093 ms)
    assert bounds.k2_s(t, esc) == pytest.approx(0.1093e-3, rel=0.02)


def test_k3_bound_counts_one_imad_hi_a_product():
    # 66,816 products and 248 butterflies of 8 a (channel, granule), one
    # instruction each, at 64 INT32 lanes an SM a clock on 132 SMs
    t = 18432
    ops = 2 * t * (66816 + 248 * 8)
    assert bounds.k3_s(t) == ops / (132 * 64 * 1.98e9)
    # about half chip_smoke.analysis_bound's 0.2985 ms on the song, which
    # counts two pipe cycles a product
    assert bounds.k3_s(t) == pytest.approx(0.2985e-3 * 68800 / 135616,
                                           rel=2e-3)


def test_batch_readers(tmp_path):
    import core
    ops = tm.device_ops(tm.events(_trace(tmp_path)))
    work = dict(granules=40, escapes=3, launches=1)
    run = core.Traced([], [work], ops, tm.busy_us(ops) / 1e6, 1e-4,
                      run_audio_s=120.0, run_window_s=0.04)
    assert core.load("metrics", "batch.xrt").read(run) == 3000.0
    for k in (1, 2):
        mine = core.load("metrics", f"batch.k{k}_roofline").read(run)
        assert mine == core.load("metrics", f"kernel.k{k}_roofline").read(run)
        assert mine > 0
    # nothing to read: no window, no kernel
    empty = core.Traced([], [], [], 0.0, 0.0)
    assert core.load("metrics", "batch.xrt").read(empty) is None
    assert core.load("metrics", "batch.k2_roofline").read(empty) is None
