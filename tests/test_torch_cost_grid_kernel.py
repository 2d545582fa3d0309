"""The cost grid's wrapper (``ops/quant_batch.cost_all_steps``) on the CPU,
where it takes the plain PyTorch version of the hand-written kernel
``csrc/cost_grid.cu`` (K5):

* a CPU tensor goes through the plain version and launches nothing;
* the plain version's work counts (the card run's bound) are the cells,
  their big-values pairs and count1 quads;
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
    """``work`` gathers the cells, the big-values pairs (the grid's ``bv``)
    and the count1 quads, chunk by chunk: a grid of chunks of 7 lanes is
    the grid of one chunk, and so are its counts."""
    xr = _lanes()
    work, one = {}, {}
    packed = QB.cost_all_steps_torch(xr, 0, work=one)
    monkeypatch.setattr(QB, "CHUNK", 7)
    assert torch.equal(QB.cost_all_steps_torch(xr, 0, work=work), packed)
    assert work == one
    assert work["cells"] == xr.shape[0] * 128
    assert work["pairs"] == int(packed[QB._BASE_KEYS.index("bv")].sum())
    assert 0 < work["quads"] <= work["cells"] * 144


@pytest.mark.parametrize("sr_idx", [0, 5, 8, 13])
def test_kernel_tables_pack_the_grid_tables(sr_idx):
    """The kernel's tables are the plain version's, narrowed without loss:
    steptabi, linmax, linbits, SUBDV_TABLE, the two count1 length rows and
    the band row; int2idx; the pair lengths of tables 13, 15, 16 and 24."""
    small, int2idx, hlen = QB._kernel_tables(torch.device("cpu"), sr_idx)
    _, steptabi, want_i2i = T.loop_tables()
    want_small = np.concatenate([
        steptabi, T.HUFF_LINMAX, T.HUFF_LINBITS, T.SUBDV_TABLE.reshape(-1),
        T.HUFF_LEN[32, 0, :16], T.HUFF_LEN[33, 0, :16], T.BAND_ALL[sr_idx]])
    want_hlen = T.HUFF_LEN[[13, 15, 16, 24]].reshape(-1)
    for got, want, dtype, n in ((small, want_small, torch.int32, 297),
                                (int2idx, want_i2i, torch.int16, 10000),
                                (hlen, want_hlen, torch.uint8, 1024)):
        assert got.dtype == dtype and got.shape == (n,)
        assert got.is_contiguous() and np.array_equal(got.numpy(), want)
    argtypes = list(QB._SIGNATURES["cost_grid"][1])
    assert argtypes[:3] == [QB._P, ctypes.c_int, ctypes.c_int]
    assert argtypes[3:7] == [QB._P] * 4 and argtypes[7] is ctypes.c_int


def test_packed_sums_stay_in_their_fields():
    """The kernel adds two region sums in one 32-bit word (16 bits each),
    the three regions' escapes in 10-bit fields and sum0 | sum1 << 16: a
    pair costs at most 21 bits under tables 13/15/16/24 with its signs,
    288 pairs stay under 2^16, 144 quads of at most 10 bits too, and ix
    (int2idx) stays under 2^10."""
    lens = [int(T.HUFF_LEN[t].max()) for t in (13, 15, 16, 24)]
    assert 288 * (max(lens) + 2) < 1 << 16
    assert 144 * (int(T.HUFF_LEN[32:34, 0, :16].max()) + 4) < 1 << 16
    assert 576 < 1 << 10
    assert int(T.loop_tables()[2].max()) < 1 << 10


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
    assert occ["smem"] > 48 * 1024
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
    # the lanes reach every flag the replay reads
    cells = QB._unpack(want.numpy(), True)
    assert cells["bail"].any() and cells["approx"].any()
    assert ((cells["bv"] == 0) & ~cells["bail"]).any()
    assert (cells["choice"] >= 16).any()
    assert launch(xr[:0], sr_idx, 7).shape == (7, 0, 128)


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
