"""The cost grid's wrapper (``ops/quant_batch.cost_all_steps``) on the CPU,
where it takes the plain PyTorch version of the hand-written kernel
``csrc/cost_grid.cu`` (K5):

* a CPU tensor goes through the plain version and launches nothing;
* the plain version's work counts (the card run's bound) are the cells,
  their big-values pairs and count1 quads, the samples they read and the
  pairs below their last region's end;
* the kernel's tables are the plain version's, narrowed without loss, in
  the order and types of its arguments;
* the kernel's source itself, built for the host against the small
  emulation of the CUDA features it uses (``tests/cuda_host_shim.py``, one
  thread per CUDA thread), equals the plain version on every row of every
  cell through the wrapper's own launch code, with and without the hide
  channels, on four band rows;
* the wrapper refuses what the kernel cannot take.

The card tests (``tests/test_torch_cuda.py``) hold the kernel to the plain
version bit for bit. Tolerance: exact everywhere.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cuda_host_shim  # noqa: E402
from chip_smoke import grid_lanes, search_lanes  # noqa: E402
from mp3stego_tpu_torch import tables as T  # noqa: E402
from mp3stego_tpu_torch.ops import quant_batch as QB  # noqa: E402


def _lanes() -> torch.Tensor:
    """The 16 edge lanes, 8 of the golden encode's and 8 loud ones."""
    return torch.from_numpy(np.ascontiguousarray(np.concatenate([
        grid_lanes(), search_lanes("fixture")[0][60:68],
        search_lanes("loud")[0][:8]])))


@pytest.mark.parametrize("with_hide", [False, True])
def test_cpu_tensors_take_the_plain_version(with_hide):
    xr = _lanes()[:8].contiguous()
    before = QB.launches
    got = QB.cost_all_steps(xr, 0, with_hide)
    packed = QB.cost_all_steps_torch(xr, 0, with_hide).numpy()
    want = QB._unpack(packed, with_hide)
    assert packed.shape == (27 if with_hide else 7, 8, 128)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert got["bail"].dtype == bool and got["ixmax"].dtype == np.int16
    if with_hide:
        assert got["choice"].dtype == np.int16
        assert got["choice"].shape == (8, 128, 3)
    empty = QB.cost_all_steps(xr[:0], 0, with_hide)
    assert all(v.shape[:2] == (0, 128) for v in empty.values())
    assert QB.launches == before


def test_numpy_spectra_move_to_the_named_device():
    xr = grid_lanes()[:4]
    got = QB.cost_all_steps(xr, 0, device="cpu")
    want = QB.cost_all_steps(torch.from_numpy(xr), 0)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_numpy_spectra_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QB.cost_all_steps(grid_lanes()[:2], 0)


def test_work_counts_are_the_cells_pairs_and_quads(monkeypatch):
    """``work`` gathers the cells, the big-values pairs (the grid's ``bv``),
    the count1 quads, the pairs below the end of the last region
    (max(bvr, a2)) and the samples below it or the quads' end, chunk by
    chunk: a grid of chunks of 7 lanes is the grid of one chunk, and so
    are its counts."""
    xr = _lanes()
    work, one = {}, {}
    packed = QB.cost_all_steps_torch(xr, 0, work=one)
    monkeypatch.setattr(QB, "CHUNK", 7)
    assert torch.equal(QB.cost_all_steps_torch(xr, 0, work=work), packed)
    assert work == one
    assert work["cells"] == xr.shape[0] * 128
    assert work["pairs"] == int(packed[QB._BASE_KEYS.index("bv")].sum())
    assert 0 < work["quads"] <= work["cells"] * 144
    bvr = 2 * packed[QB._BASE_KEYS.index("bv")].long()
    a2 = packed[QB._BASE_KEYS.index("a2")].long()
    assert work["region_pairs"] == int(
        ((torch.maximum(bvr, a2) + 1) >> 1).sum())
    assert work["region_pairs"] > work["pairs"]
    assert max(2 * work["region_pairs"], 2 * work["pairs"]
               + 4 * work["quads"]) <= work["samples"]
    assert work["samples"] < work["cells"] * 576


def test_need_bound_counts_what_the_cells_read():
    """The card run's bound (``chip_smoke.grid_need_bound``) charges each
    lane, cell, sample read, pair below the last region's end and count1
    quad its ``K5_NEED_*`` operations, fewer than PR 15's ``grid_bound``,
    which quantizes every sample of every cell; the bytes are the same."""
    import chip_smoke as cs
    xr = _lanes()
    work = {}
    QB.cost_all_steps_torch(xr, 0, work=work)
    n = xr.shape[0]
    need = cs.grid_need_bound(n, QB.ROWS_HIDE, work)
    pr15 = cs.grid_bound(n, QB.ROWS_HIDE, work)
    assert need[3] == (n * cs.K5_NEED_LANE + work["cells"] * cs.K5_NEED_CELL
                       + work["samples"] * cs.K5_NEED_SAMPLE
                       + work["region_pairs"] * cs.K5_NEED_PAIR
                       + work["quads"] * cs.K5_NEED_QUAD)
    assert need[2] == pr15[2] and 0 < need[3] < pr15[3]
    assert need[1] == "operations" and need[0] < pr15[0]


@pytest.mark.parametrize("sr_idx", [0, 5, 8, 13])
def test_kernel_tables_pack_the_grid_tables(sr_idx):
    """The kernel's tables are the plain version's, narrowed without loss:
    steptabi, SUBDV_TABLE, the two count1 length rows, the band row and
    the ESC rules as ``esc_table``; int2idx; the pair lengths of tables 13,
    15, 16 and 24."""
    small, int2idx, hlen = QB._kernel_tables(torch.device("cpu"), sr_idx)
    _, steptabi, want_i2i = T.loop_tables()
    want_small = np.concatenate([
        steptabi, T.SUBDV_TABLE.reshape(-1), T.HUFF_LEN[32, 0, :16],
        T.HUFF_LEN[33, 0, :16], T.BAND_ALL[sr_idx], QB.esc_table()])
    want_hlen = T.HUFF_LEN[[13, 15, 16, 24]].reshape(-1)
    for got, want, dtype, n in ((small, want_small, torch.int32, 1230),
                                (int2idx, want_i2i, torch.int16, 10000),
                                (hlen, want_hlen, torch.uint8, 1024)):
        assert got.dtype == dtype and got.shape == (n,)
        assert got.is_contiguous() and np.array_equal(got.numpy(), want)
    argtypes = list(QB._SIGNATURES["cost_grid"][1])
    assert argtypes[:3] == [QB._P, ctypes.c_int, ctypes.c_int]
    assert argtypes[3:7] == [QB._P] * 4 and argtypes[7] is ctypes.c_int


def test_esc_table_is_the_linmax_loops():
    """The kernel reads each region's ESC tables from ``QB.esc_table`` at
    its largest ix m: for every m that int2idx can give, t16 and t24 are
    the linmax loops of ``_cost_all_steps`` and the linbits beside them
    those of the clipped indices."""
    esc = QB.esc_table()
    int2idx = T.loop_tables()[2]
    assert esc.dtype == np.int32 and esc.shape == (int(int2idx.max()) + 1,)
    assert int(int2idx.max()) == 1000 and int(int2idx.min()) == 0
    lm, lb = T.HUFF_LINMAX.tolist(), T.HUFF_LINBITS.tolist()
    for m in range(esc.size):
        t16 = 15 + sum(lm[j] < m - 15 for j in range(15, 24))
        t24 = 24 + sum(lm[j] < m - 15 for j in range(24, 32))
        want = (t16 | t24 << 8 | lb[min(t16, 31)] << 16
                | lb[min(max(t24, 24), 31)] << 24)
        assert int(esc[m]) == want, m


def test_packed_sums_stay_in_their_fields():
    """One thread costs a cell and sums its pairs' channels in one 64-bit
    word: the lengths under tables 13, 15, 16 and 24 with the signs in
    13-bit fields (288 pairs of at most 21 bits stay under 2^13) and the
    escapes in a 10-bit field above them (at most 576); a count1 quad's
    index into the tables is at most 15 and its lengths at most 10 bits;
    ix (int2idx) stays under 2^10, int2idx's largest entry being the last
    index of ``QB.esc_table``."""
    lens = [int(T.HUFF_LEN[t].max()) for t in (13, 15, 16, 24)]
    assert 288 * (max(lens) + 2) < 1 << 13
    assert 576 < 1 << 10 and 4 * 13 + 10 <= 64
    assert int(T.HUFF_LEN[32:34, 0, :16].max()) + 4 <= 10
    int2idx = T.loop_tables()[2]
    assert int(int2idx.max()) < 1 << 10
    assert int(int2idx.max()) == QB.esc_table().size - 1


def test_int2idx_gives_the_thresholds_the_kernel_reads():
    """The kernel takes ixmax and approx from a lane's largest |x| and the
    run lengths from its chunk maxima: that needs int2idx nondecreasing (ln
    grows with |x|), ix != 0 iff ln >= 1 and ix > 1 iff ln >= 2."""
    int2idx = T.loop_tables()[2].astype(np.int64)
    assert (np.diff(int2idx) >= 0).all()
    assert int2idx[:3].tolist() == [0, 1, 2]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/cost_grid.cu built for the host with g++ against the emulation
    of ``tests/cuda_host_shim.py``. Returns the loaded library."""
    return cuda_host_shim.build("cost_grid", tmp_path_factory.mktemp(
        "cost_grid_host"), QB._SIGNATURES)


def _on_host(lib, monkeypatch):
    """Route ``QB._launch`` to the host build: CPU tensors, stream 0, the
    occupancy the host build reports on a 2-SM grid."""
    import contextlib
    import threading
    import types
    from mp3stego_tpu_torch.ops import _cuda
    out = [ctypes.c_int(0) for _ in range(3)]
    assert lib.cost_grid_occupancy(*(ctypes.addressof(v) for v in out)) == 0
    occ = dict(zip(("ctas", "warps", "smem"), (v.value for v in out)))
    assert occ["ctas"] >= 1 and occ["warps"] == 8
    # the layout of Smem in csrc/cost_grid.cu, under the 48 KB a CTA may
    # take without an opt-in, 4 CTAs an SM
    assert occ["smem"] == 46656 < 48 * 1024
    monkeypatch.setattr(_cuda, "load", lambda name, sig: lib)
    monkeypatch.setattr(QB, "occupancy", lambda dev: occ)
    monkeypatch.setattr(QB, "_grid_cap", lambda dev: 2 * occ["ctas"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def launch(*args):
        """``QB._launch`` in a daemon thread: a warp that missed a
        collective would hang, and then the test fails instead."""
        box = []
        th = threading.Thread(target=lambda: box.append(QB._launch(*args)),
                              daemon=True)
        th.start()
        th.join(120)
        assert not th.is_alive(), "the host build of the kernel hung"
        return box[0]
    return launch


@pytest.mark.parametrize("sr_idx", [0, 5, 8, 13])
def test_kernel_source_on_the_host_equals_the_plain_version(
        sr_idx, host_kernel, monkeypatch):
    """csrc/cost_grid.cu, built for the host, through the wrapper's own
    launch code: every row of every cell bit for bit the plain version's,
    clear (7 rows) and with the hide channels (27), on the edge, golden and
    loud lanes. Band row 5 has an odd edge (45), 13 is an ISO row."""
    launch = _on_host(host_kernel, monkeypatch)
    xr = _lanes()
    for rows, hide in ((QB.ROWS_CLEAR, False), (QB.ROWS_HIDE, True)):
        got = launch(xr, sr_idx, rows)
        want = QB.cost_all_steps_torch(xr, sr_idx, hide)
        assert got.shape == want.shape == (rows, xr.shape[0], 128)
        for r in range(rows):
            assert torch.equal(got[r], want[r]), r
    # the lanes reach every flag the replay reads, cells whose big values
    # fill the granule, regions that reach past bvr into the count1 quads,
    # and every table choice but 23
    cells = QB._unpack(want.numpy(), True)
    bvr = 2 * cells["bv"].astype(np.int64)
    assert cells["bail"].any() and cells["approx"].any()
    assert ((cells["bv"] == 0) & ~cells["bail"]).any()
    assert (cells["bv"] == 288).any()
    assert (cells["a2"] > bvr).any() and (cells["a1"] > bvr).any()
    assert set(range(13, 31)) - {14, 23} <= set(np.unique(cells["choice"]))
    assert launch(xr[:0], sr_idx, 7).shape == (7, 0, 128)


def test_kernel_source_folds_odd_region_edges(host_kernel):
    """A region maximum is over samples, so a pair across an odd region
    edge has its samples in two regions. No band row's subdivide picks an
    odd edge (band row 5's 45 never becomes a1 or a2), so this runs the
    host build and the plain version on a band row of odd edges: every row
    of every cell equal, with odd edges below bvr reached."""
    band = torch.tensor([0, 4, 8, 12, 17, 21, 25, 31, 37, 45, 53, 63, 75,
                         91, 111, 135, 163, 197, 239, 289, 343, 419, 576],
                        dtype=torch.int32)
    xr = _lanes()
    small, int2idx, hlen = QB._kernel_tables(torch.device("cpu"), 0)
    small = small.clone()
    small[206:229] = band
    out = torch.zeros((QB.ROWS_HIDE, xr.shape[0], 128), dtype=torch.int16)
    assert host_kernel.cost_grid(
        xr.data_ptr(), xr.shape[0], QB.ROWS_HIDE, small.data_ptr(),
        int2idx.data_ptr(), hlen.data_ptr(), out.data_ptr(), 5, None) == 0
    want = QB._cost_pack(xr, band, True, QB._consts(torch.device("cpu")))
    for r in range(QB.ROWS_HIDE):
        assert torch.equal(out[r], want[r]), r
    cells = QB._unpack(want.numpy(), True)
    bvr = 2 * cells["bv"].astype(np.int64)
    for a in (cells["a1"], cells["a2"]):
        assert ((a % 2 == 1) & (a < bvr)).any()


def test_wrapper_refuses_what_the_kernel_cannot_take():
    xr = _lanes()
    with pytest.raises(ValueError, match="int32"):
        QB.cost_all_steps(xr.to(torch.int64), 0)
    with pytest.raises(ValueError, match="576"):
        QB.cost_all_steps(xr[:, :288], 0)
    with pytest.raises(ValueError, match="576"):
        QB.cost_all_steps(xr.reshape(-1), 0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        QB.cost_all_steps(xr.to("meta"), 0)
    with pytest.raises(ValueError, match="int32"):
        QB.cost_all_steps_torch(xr.to(torch.int16), 0)
