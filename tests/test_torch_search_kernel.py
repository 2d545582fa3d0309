"""The rate-control search's wrappers (``ops/search_plane``: ``search``,
``search_windows``, ``cost_step``) on the CPU, where they take the plain
PyTorch versions of the hand-written kernel ``csrc/search.cu``:

* a CPU tensor goes through the plain version and launches nothing;
* ``search_windows`` row ``w * N + i`` is ``search`` of lane ``i`` at cursor
  ``3 w`` over ``WINDOW_BITS``: every row, count and the ix plane;
* each lane's counts (which the kernel writes too, and the card run's
  bound reads) equal an independent count from the host oracle
  ``ops/quant_np.oracle_search``: its evaluations are the steps it
  quantizes at, each (phase, step) once, and its inner-loop rounds
  likewise; of them, those past quantize's quick reject, those it costs,
  and the count1 quads and big-values pairs of these;
* the kernel's tables are the plain version's, narrowed without loss, in
  the order and types of its arguments;
* the kernel's source itself, built for the host against a small
  emulation of the CUDA features it uses (one thread per CUDA thread),
  equals the plain versions on every row, count and the ix plane through
  the wrapper's own launch code;
* the wrappers refuse what the kernel cannot take.

The card tests (``tests/test_torch_cuda.py``) hold the kernel to these plain
versions bit for bit. Tolerance: exact everywhere.
"""

import ctypes
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cuda_host_shim  # noqa: E402
from chip_smoke import search_lanes as _case  # noqa: E402
from mp3stego_tpu_torch.ops import quant as Q  # noqa: E402
from mp3stego_tpu_torch.ops import quant_np  # noqa: E402
from mp3stego_tpu_torch.ops import search_plane as SP  # noqa: E402

CASES = ["fixture", "loud", "escape"]


@pytest.mark.parametrize("name", CASES)
def test_cpu_tensors_take_the_plain_version(name):
    xr, mb = _case(name)
    xr_t, mb_t = torch.from_numpy(xr), torch.from_numpy(mb)
    before = SP.launches
    got = SP.search(xr_t, mb_t, 0)
    want = SP.search_torch(xr_t, mb_t, 0)
    for k in SP.ROWS + SP.COUNTS + ("ix",):
        assert torch.equal(got[k], want[k]), k
    win = SP.search_windows(xr_t[:8].contiguous(), mb_t[:8].contiguous(), 0)
    assert win["ix"].shape == (64, 576)
    cost = SP.cost_step(xr_t, -40, 0)
    assert torch.equal(cost, SP.cost_step_torch(xr_t, -40, 0))
    assert cost.dtype == torch.int64
    assert SP.launches == before


@pytest.mark.parametrize("name", CASES)
def test_window_rows_are_the_search_at_cursor_3w(name):
    xr, mb = _case(name)
    n = len(xr)
    xr_t, mb_t = torch.from_numpy(xr), torch.from_numpy(mb)
    win = SP.to_host(SP.search_windows(xr_t, mb_t, 0))
    for w in range(8):
        at = SP.search_all(xr_t, mb, 0, SP.WINDOW_BITS,
                           np.full(n, 3 * w, np.int64))
        rows = slice(w * n, (w + 1) * n)
        for k in SP.ROWS + SP.COUNTS + ("ix",):
            assert np.array_equal(win[k][rows], at[k]), (w, k)
    assert win["rounds"] == max(
        SP.search_all(xr_t, mb, 0, SP.WINDOW_BITS,
                      np.full(n, 3 * w, np.int64))["rounds"]
        for w in range(8))


def _oracle_counts(xr_row, max_bits, monkeypatch):
    """``COUNTS`` of the host oracle's search of one lane from zero
    addresses. Its evaluations are the distinct (phase, step) pairs it
    quantizes at: the bisection calls quantize from its ``evaluate``; the
    inner loop first calls it from ``oracle_search`` itself (its ixmax
    probe), then evaluates at the same step. Of them, those where quantize
    does not bail; the evaluations it costs are its calls of
    ``_cost_exact``, whose count1 and big_values are the quads and pairs."""
    seen, phase = {}, ["bisect"]
    real, real_cost = Q.quantize, quant_np._cost_exact
    costed = []

    def spy(row, xrabs, xrmax, step):
        if sys._getframe(1).f_code.co_name == "oracle_search":
            phase[0] = "inner"
        out = real(row, xrabs, xrmax, step)
        seen[phase[0], int(step)] = out[0] is not None
        return out

    def spy_cost(ix, addr, sr_idx, hide):
        bits, gi = real_cost(ix, addr, sr_idx, hide)
        costed.append((gi.count1, gi.big_values))
        return bits, gi

    monkeypatch.setattr(Q, "quantize", spy)
    monkeypatch.setattr(quant_np, "_cost_exact", spy_cost)
    quant_np.oracle_search(xr_row, int(max_bits), (0, 0, 0), 0)
    monkeypatch.setattr(Q, "quantize", real)
    monkeypatch.setattr(quant_np, "_cost_exact", real_cost)
    return dict(evals=len(seen), inner=sum(p == "inner" for p, _ in seen),
                quantized=sum(seen.values()), costed=len(costed),
                quads=sum(c for c, _ in costed),
                pairs=sum(b for _, b in costed))


@pytest.mark.parametrize("name", ["fixture", "loud"])
def test_evaluation_counts_equal_the_host_oracle(name, monkeypatch):
    xr, mb = _case(name)
    if name == "loud":
        xr, mb = xr[:32], mb[:32]
    got = SP.search_all(torch.from_numpy(xr), mb, 0)
    assert not (got["flags"] & (SP.FLAG_OOB | SP.FLAG_ITER)).any()
    searched = 0
    for g in range(len(xr)):
        if got["xrmax0"][g]:
            assert all(got[k][g] == 0 for k in SP.COUNTS)
            continue
        want = _oracle_counts(xr[g], mb[g], monkeypatch)
        assert {k: got[k][g] for k in SP.COUNTS} == want, g
        searched += 1
    assert searched > 20
    # some evaluations bail at the quick reject
    assert (got["quantized"] < got["evals"]).any()
    assert (got["costed"] <= got["quantized"]).all()
    assert got["rounds"] == got["inner"].max()
    # the bisection takes 6 or 7 rounds (120 -> 60 -> 30 -> 15 -> 7|8 ..)
    bis = (got["evals"] - got["inner"])[got["xrmax0"] == 0]
    assert set(np.unique(bis)) <= {6, 7}


def test_counts_of_flagged_lanes():
    """A lane that never fits runs the bisection and all ``ITER_CAP`` inner
    rounds; a silent lane runs none."""
    xr, mb = _case("forced")
    got = SP.search_all(torch.from_numpy(xr), mb, 0)
    it = (got["flags"] & SP.FLAG_ITER) != 0
    assert it.any()
    assert (got["inner"][it] == SP.ITER_CAP).all()
    assert (got["evals"][it] - got["inner"][it] >= 6).all()
    assert got["evals"][0] == got["inner"][0] == 0 == got["flags"][0]


@pytest.mark.parametrize("sr_idx", [0, 8, 17])
def test_kernel_tables_pack_the_search_tables(sr_idx):
    """The kernel's tables are the plain version's, narrowed without loss:
    steptab, steptabi, the small tables (linmax, linbits, SUBDV_TABLE,
    TRANSFORM_HUF, the band row), int2idx and the Huffman lengths."""
    from mp3stego_tpu_torch import tables as T
    steptab, steptabi, small, int2idx, hlen = SP._kernel_tables(
        torch.device("cpu"), sr_idx)
    want_step, want_stepi, want_i2i = T.loop_tables()
    want_small = np.concatenate([
        T.HUFF_LINMAX, T.HUFF_LINBITS, T.SUBDV_TABLE.reshape(-1),
        T.TRANSFORM_HUF.reshape(-1), T.BAND_ALL[sr_idx]])
    for got, want, dtype in (
            (steptab, want_step, torch.float64),
            (steptabi, want_stepi, torch.int32),
            (small, want_small, torch.int32),
            (int2idx, want_i2i, torch.int16),
            (hlen, T.HUFF_LEN.reshape(-1), torch.uint8)):
        assert got.dtype == dtype and got.is_contiguous()
        assert np.array_equal(got.numpy(), want)


def test_kernel_tables_match_the_kernel_arguments():
    """``_kernel_tables`` gives the tables in the order, type and length of
    ``rate_search``'s table arguments (``Args`` in csrc/search.cu)."""
    tabs = SP._kernel_tables(torch.device("cpu"), 0)
    want = ((torch.float64, 128), (torch.int32, 128), (torch.int32, 201),
            (torch.int16, 10000), (torch.uint8, 34 * 256))
    assert [(t.dtype, t.numel()) for t in tabs] == list(want)
    assert all(t.dim() == 1 and t.is_contiguous() for t in tabs)
    argtypes = list(SP._SIGNATURES["rate_search"][1])
    # xr .. windows (5), hide (4), mode, step, big (3), then the tables,
    # the 3 outputs and the lane queue, each a pointer
    assert argtypes[11] is ctypes.c_longlong
    assert argtypes[12:12 + len(tabs) + 4] == [SP._P] * (len(tabs) + 4)
    assert argtypes[12 + len(tabs) + 4] is ctypes.c_int


def test_ptxas_resources_read_the_kept_build_log(monkeypatch):
    """``_cuda.ptxas_resources`` (phase 17's registers, shared memory and
    spills) reads the named kernel's lines of the ``-Xptxas -v`` log and
    sums the spills of every function."""
    from mp3stego_tpu_torch.ops import _cuda
    name = "_ZN12_GLOBAL__N_118rate_search_kernelENS_4ArgsE"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function 'other_kernel' for "
        "'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 40 registers, 100 bytes smem",
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 656 bytes "
        "cmem[0]"])
    monkeypatch.setitem(_cuda.builds, "search", {"log": log})
    assert _cuda.ptxas_resources("search", "rate_search_kernel") == dict(
        registers=80, smem=0, spill_stores=4, spill_loads=4)
    monkeypatch.setitem(_cuda.builds, "search", {"log": "(cached build)"})
    with pytest.raises(RuntimeError, match="rate_search_kernel"):
        _cuda.ptxas_resources("search", "rate_search_kernel")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/search.cu built for the host with g++ against the emulation of
    ``tests/cuda_host_shim.py``. Returns the loaded library."""
    return cuda_host_shim.build("search", tmp_path_factory.mktemp(
        "search_host"), SP._SIGNATURES)


def _on_host(lib, monkeypatch):
    """Route ``SP._launch`` to the host build: CPU tensors, stream 0, the
    occupancy the host build reports on a 2-SM grid."""
    import contextlib
    import threading
    import types
    from mp3stego_tpu_torch.ops import _cuda
    out = [ctypes.c_int(0) for _ in range(3)]
    assert lib.rate_search_occupancy(*(ctypes.addressof(v)
                                       for v in out)) == 0
    occ = dict(zip(("ctas", "warps", "smem"), (v.value for v in out)))
    assert occ["ctas"] >= 1 and occ["smem"] > 48 * 1024
    monkeypatch.setattr(_cuda, "load", lambda name, sig: lib)
    monkeypatch.setattr(SP, "occupancy", lambda dev: occ)
    monkeypatch.setattr(SP, "_grid_cap", lambda dev: 2 * occ["ctas"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def launch(*args, **kw):
        """``SP._launch`` in a daemon thread: a warp that missed a
        collective would hang, and then the test fails instead."""
        box = []
        th = threading.Thread(target=lambda: box.append(
            SP._launch(*args, **kw)), daemon=True)
        th.start()
        th.join(120)
        assert not th.is_alive(), "the host build of the kernel hung"
        return box[0]
    return launch


@pytest.mark.parametrize("name,sr_idx", [
    ("fixture", 0), ("loud", 0), ("escape", 0), ("forced", 0),
    ("loud", 5), ("fixture", 17)])
def test_kernel_source_on_the_host_equals_the_plain_version(
        name, sr_idx, host_kernel, monkeypatch):
    """csrc/search.cu, built for the host, through the wrapper's own launch
    code: clear, hide at ascending cursors, hide without message bits, the 8
    windows and ``cost_step`` at a few steps, every row, count and the ix
    plane bit for bit against the plain versions. Band row 5 has an odd
    boundary, so a pair's two samples can lie in two regions."""
    launch = _on_host(host_kernel, monkeypatch)
    xr, mb = _case(name)
    xr_t = torch.from_numpy(np.ascontiguousarray(xr[:48]))
    mb_t = torch.from_numpy(np.ascontiguousarray(mb[:48]))
    n = xr_t.shape[0]
    rng = np.random.default_rng(3)
    keys = SP.ROWS + SP.COUNTS + ("ix",)
    runs = [(launch(xr_t, mb_t, sr_idx, n), SP.search_torch(xr_t, mb_t,
                                                             sr_idx))]
    for hide in ((rng.integers(0, 2, size=3 * n // 2).astype(np.uint8),
                  np.cumsum(rng.integers(0, 4, size=n))),
                 (np.zeros(0, np.uint8), np.zeros(n, np.int64))):
        hb, hc, nb = SP._hide_tensors(hide, n, xr_t.device)
        runs.append((launch(xr_t, mb_t, sr_idx, n, hide=(hb, nb, hc)),
                     SP.search_torch(xr_t, mb_t, sr_idx, hide)))
    xs, ms = xr_t[:8].contiguous(), mb_t[:8].contiguous()
    wb = torch.from_numpy(SP.WINDOW_BITS)
    runs.append((launch(xs, ms, sr_idx, 64, windows=True,
                        hide=(wb, wb.shape[0], None)),
                 SP.search_windows_torch(xs, ms, sr_idx)))
    for got, want in runs:
        for k in keys:
            assert torch.equal(got[k], want[k]), k
    for s in (-110, -50, -20, 0):
        got = launch(xr_t, None, sr_idx, n, mode=1, step=s, big=1 << 20)
        assert torch.equal(got, SP.cost_step_torch(xr_t, s, sr_idx)), s
    if name == "forced":
        flags = runs[0][0]["flags"].numpy()
        for bit in (SP.FLAG_ADDR, SP.FLAG_OOB, SP.FLAG_ITER):
            assert (flags & bit).any(), bit


def test_wrappers_refuse_what_the_kernel_cannot_take():
    xr, mb = _case("loud")
    xr_t, mb_t = torch.from_numpy(xr), torch.from_numpy(mb)
    with pytest.raises(ValueError, match="int32"):
        SP.search(xr_t.to(torch.int64), mb_t, 0)
    with pytest.raises(ValueError, match="int32"):
        SP.search(xr_t, mb_t.to(torch.int64), 0)
    with pytest.raises(ValueError, match="576"):
        SP.search(xr_t[:, :288], mb_t, 0)
    with pytest.raises(ValueError, match="budgets"):
        SP.search_windows(xr_t, mb_t[:5], 0)
    with pytest.raises(ValueError, match="576"):
        SP.cost_step(xr_t.reshape(-1), -30, 0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        SP.search(xr_t.to("meta"), mb_t.to("meta"), 0)
    with pytest.raises(ValueError, match="cursors"):
        SP.search(xr_t, mb_t, 0, hide=(np.ones(4, np.uint8),
                                       np.zeros(3, np.int64)))
