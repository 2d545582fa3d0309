"""On the card, at a size a test run holds: each cell's float64 run comes
out correct with every end-to-end metric and every per-layer metric it
lists, and its control, the program's float32 decode, comes out not
correct. Run on the chip:

    python -m pytest stegobench/tests -m cuda -q
"""

import pytest

import core

SMALL = {"song320.decode": dict(pool=2, length_s=20.0),
         "clip128.batch_decode": dict(pool=8),
         "song320.hide": dict(pool=2, length_s=20.0)}


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_float64_is_correct_and_traced(cell):
    _card()
    r = core.run_cell(cell, 2 ** 35 + 17, 3.0, True, overrides=SMALL[cell],
                      log=lambda m: None)
    assert r["correct"] is True
    spec = core.load_bench()["per_layer"]
    want = {m["name"] for m in spec if cell in m["workloads"]}
    assert set(r["metrics"]) == want
    for name in want:
        if name.endswith("_roofline"):
            assert 0 < r["metrics"][name]["value"] <= 100
    assert r["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_end_to_end_metrics_on_the_card(cell):
    _card()
    r = core.run_cell(cell, 2 ** 33 + 5, 3.0, False, overrides=SMALL[cell],
                      log=lambda m: None)
    assert r["correct"] is True
    spec = core.load_bench()["end_to_end"]
    want = {m["name"] for m in spec if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [101, 2 ** 40 + 9, 2 ** 31 + 77])
def test_float32_control_fails(cell, seed):
    _card()
    r = core.run_cell(cell, seed, 2.0, False,
                      overrides=dict(SMALL[cell], precision="float32"),
                      log=lambda m: None)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in r["checks"].items()
               if c["op"] == "<=")
