"""A run end to end on the CPU at a small size (the harness's look for a
card skipped by ``device="cpu"``): the last line's shape, the float32
control and the faults a decode cell can have, each read by the check as
not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import core
from conftest import BENCH, ROOT

SONG = dict(pool=2, length_s=1.5)
CLIP = dict(pool=3, length_s=1.0)
CELLS = {"song320.decode": SONG, "clip128.batch_decode": CLIP}


def _run(cell, seed=2 ** 40 + 3, traced=False, **over):
    return core.run_cell(cell, seed, 1.0, traced, device="cpu",
                         overrides=dict(CELLS[cell], **over),
                         log=lambda msg: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_last_line_shape(cell):
    r = _run(cell)
    line = json.loads(core.result_line(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    spec = [m for m in core.load_bench()["end_to_end"]
            if cell in m.get("workloads", [cell])]
    assert "setup_s" in {m["name"] for m in spec} and len(spec) >= 2
    # a CPU run has no device trace: only the host clock's metrics
    assert set(line["metrics"]) == {m["name"] for m in spec
                                    if m["source"] == "host_clock"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit", "op"}


def test_traced_line_shape():
    # in a process of its own: the profiler hangs in a test worker that
    # runs other threads
    code = ("import sys, json; sys.path[:0] = [%r, %r]; import core; "
            "print(core.result_line(core.run_cell('song320.decode', 5, 1.0, "
            "True, device='cpu', overrides=%r, log=lambda m: None)))"
            % (BENCH, ROOT, SONG))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"decode.host", "transfer.copies"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_float32_control_is_not_correct(cell):
    r = _run(cell, precision="float32")
    assert r["correct"] is False
    assert r["checks"]["mismatched_samples"]["value"] > 0


def test_answer_altered_where_produced(monkeypatch):
    from mp3stego_tpu_torch.ops import decode_plane as dp
    real = dp.decode_pcm_i16

    def altered(*a, **k):
        out = np.array(real(*a, **k))
        out[len(out) // 2, 0] += 1
        return out
    monkeypatch.setattr(dp, "decode_pcm_i16", altered)
    r = _run("song320.decode")
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["mismatched_samples"]["value"] >= 1


def test_file_of_the_batch_left_out(monkeypatch):
    import mp3stego_tpu_torch.parallel as par
    real = par.decode_files_batched

    def short(paths, **k):
        outs = real(paths, **k)
        outs[-1] = outs[0]          # one file's slot holds another's PCM
        return outs
    monkeypatch.setattr(par, "decode_files_batched", short)
    r = _run("clip128.batch_decode")
    assert r["correct"] is False


def test_request_that_raises_in_the_window(monkeypatch):
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    real, calls = dh.parse_mp3, []

    def broken(*a, **k):
        calls.append(1)
        if len(calls) == SONG["pool"] + 1:        # the window's first
            raise ValueError("broken parse")
        return real(*a, **k)
    monkeypatch.setattr(dh, "parse_mp3", broken)
    r = _run("song320.decode")
    assert r["correct"] is False
    assert r["checks"]["errors"]["value"] == 1 and r["failed"] >= 1


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "song320.decode", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA card" in p.stderr
