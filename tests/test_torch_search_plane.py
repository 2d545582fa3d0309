"""The port's exact rate-control search against the JAX package's, on the CPU.

* ``quantize`` equals the JAX package's host oracle ``ops/quant.quantize``
  on every lane of the golden fixture's spectra and of seeded loud spectra,
  at every step of the 128-entry steptab, covering thousands of
  float64-fallback cells: this is what lets the port drop the JAX plane's
  approximate float32 path, its logs and its host re-check.
* The final per-lane rows (step, bits, bv, c1, a1..a3, r0c, r1c, ch0..ch2,
  cts) and the signed ix plane equal JAX ``search_all`` followed by the JAX
  encoder's ``_plane_redo``, on the fixture's spectra and on seeded
  loud/escape spectra, in clear and hide mode (pinned cursors).
* Lanes forced into ``FLAG_ADDR``, ``FLAG_OOB`` and ``FLAG_ITER`` carry the
  same flags as in the JAX plane.
* ``search_windows`` under the window at a cursor is the search at that
  cursor: the port's, row for row, and JAX ``search_all``'s on every lane
  neither plane flags.

Tolerance: exact everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU planes run many small ops: with several test workers on the
# machine, intra-op threads only contend (one worker's run is ~10x slower)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from chip_smoke import search_lanes  # noqa: E402
from mp3stego_tpu.models.encoder import MP3Encoder as JaxMP3Encoder  # noqa: E402
from mp3stego_tpu.ops import quant as JQ  # noqa: E402
from mp3stego_tpu.ops import search_plane as JSP  # noqa: E402
from mp3stego_tpu.utils.wav import WavFile as JaxWavFile  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.ops import search_plane as SP  # noqa: E402
from mp3stego_tpu_torch.utils.wav import WavFile  # noqa: E402

CMP = ("step", "bits", "bv", "c1", "a1", "a2", "a3", "r0c", "r1c", "ch0",
       "ch1", "ch2", "cts")
# the flags both planes send to the host oracle
HOST_FLAGS = SP.FLAG_ADDR | SP.FLAG_OOB | SP.FLAG_ITER


def _wav(cls, n_lanes: int):
    """A stereo 44.1 kHz WavFile whose encoder has n_lanes granule lanes."""
    return cls(file_path="lanes.wav", bitrate=320, num_of_channels=2,
               samplerate=44100, bits_per_sample=16,
               num_of_samples=n_lanes // 2 * 576,
               mpeg_mode=0, buffer=np.zeros(n_lanes * 576, np.int16))


def _case(name: str):
    """(spectra (N, 576) int32, budgets (N,) int32) of a test case: the
    golden fixture's spectra, or seeded loud or escape lanes
    (``chip_smoke.search_lanes``, which the card run shares)."""
    return search_lanes(name)


def _hide_ctx(n: int, seed: int):
    """Message bits and pinned cursors: ascending, some past the end."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=3 * n // 2).astype(np.uint8)
    cur = np.cumsum(rng.integers(0, 4, size=n)).astype(np.int64)
    return bits, cur


def _jax_final(xr, mb, hide=None):
    res = JSP.search_all(jnp.asarray(xr), mb, 0,
                         hide_bits=None if hide is None else hide[0],
                         hide_cur=None if hide is None else hide[1])
    enc = JaxMP3Encoder(_wav(JaxWavFile, xr.shape[0]))
    enc._plane_redo(res, jnp.asarray(xr), mb, xr.shape[0] // 2,
                    hide_ctx=hide)
    res["ix"] = JSP.dense_ix(res)
    return res


def _port_final(xr, mb, hide=None):
    xr_t = torch.from_numpy(xr)
    res = SP.search_all(xr_t, mb, 0,
                        hide_bits=None if hide is None else hide[0],
                        hide_cur=None if hide is None else hide[1])
    enc = MP3Encoder(_wav(WavFile, xr.shape[0]), device="cpu")
    enc._plane_redo(res, xr_t, mb, xr.shape[0] // 2, hide_ctx=hide)
    return res


@pytest.fixture(scope="module")
def jax_final():
    """JAX results per (case, mode), computed once per module."""
    cache = {}

    def get(name, mode):
        if (name, mode) not in cache:
            xr, mb = _case(name)
            hide = _hide_ctx(len(xr), 3) if mode == "hide" else None
            cache[name, mode] = _jax_final(xr, mb, hide)
        return cache[name, mode]
    return get


@pytest.mark.parametrize("name", ["fixture", "loud"])
def test_quantize_equals_host_oracle_at_every_step(name):
    xr, _ = _case(name)
    c = SP._consts(torch.device("cpu"))
    xr_t = torch.from_numpy(xr)
    labs64 = xr_t.to(torch.int64).abs()
    xrabs = np.abs(xr)
    xrmax = np.maximum(xrabs.max(axis=1), 0)
    xrmax64 = torch.from_numpy(xrmax.astype(np.int64))
    float_cells = 0
    for step in range(-127, 1):
        s = torch.full((len(xr),), step, dtype=torch.int32)
        ix, ixmax, oob, bail = SP.quantize(
            labs64, xr_t.abs().to(torch.float64), xrmax64, s, c)
        assert not oob.any()
        ix, ixmax, bail = ix.numpy(), ixmax.numpy(), bail.numpy()
        scalei = np.int64(JQ.STEPTABI[step + 127])
        ln = (np.abs(xr.astype(np.int64)) * scalei + 2 ** 31) >> 32
        for g in range(len(xr)):
            want, want_max = JQ.quantize(xr[g], xrabs[g], int(xrmax[g]),
                                         step)
            assert bail[g] == (want is None), (step, g)
            if want is None:                                   # bails
                assert ixmax[g] == 16384
                continue
            assert np.array_equal(ix[g], want), (step, g)
            assert ixmax[g] == want_max, (step, g)
            float_cells += int((ln[g] >= 10000).sum())
    assert float_cells > 10000


@pytest.mark.parametrize("mode", ["clear", "hide"])
@pytest.mark.parametrize("name", ["fixture", "loud", "escape"])
def test_final_rows_equal_jax(name, mode, jax_final):
    xr, mb = _case(name)
    hide = _hide_ctx(len(xr), 3) if mode == "hide" else None
    want = jax_final(name, mode)
    got = _port_final(xr, mb, hide)
    for k in CMP:
        assert np.array_equal(got[k], want[k]), k
    assert got["ix"].dtype == np.int32
    assert np.array_equal(got["ix"], want["ix"])
    assert np.array_equal(got["xrmax0"], want["xrmax0"])
    if name == "escape":       # linbits tables are really chosen
        assert (np.stack([got["ch0"], got["ch1"], got["ch2"]]) > 15).any()


@pytest.mark.parametrize("name", ["fixture", "loud"])
def test_hide_with_no_message_bits_is_the_clear_search(name):
    """An empty message, or cursors past its end, leaves every table as the
    transform-free search chose it."""
    xr, mb = _case(name)
    clear = SP.search_all(torch.from_numpy(xr), mb, 0)
    empty = SP.search_all(torch.from_numpy(xr), mb, 0,
                          np.zeros(0, np.uint8), np.zeros(len(xr), np.int64))
    past = SP.search_all(torch.from_numpy(xr), mb, 0, np.ones(8, np.uint8),
                         np.full(len(xr), SP.NO_CURSOR, np.int64))
    for other in (empty, past):
        for k in SP.ROWS:
            assert np.array_equal(other[k], clear[k]), k
        assert np.array_equal(other["ix"], clear["ix"])


def _forced_lanes():
    """Lanes that must reach the host oracle: quiet lanes whose first
    nonzero evaluation (the bisection's first step, -60) quantizes to 0/1
    only, so big_values == 0 with count1 > 0 (ADDR), and loud lanes under a
    negative budget that step past steptab (OOB) and never fit (ITER)."""
    return search_lanes("forced")


def test_forced_host_flags_equal_jax():
    xr, mb = _forced_lanes()
    want = JSP.search_all(jnp.asarray(xr), mb, 0)
    got = SP.search_all(torch.from_numpy(xr), mb, 0)
    assert np.array_equal(got["flags"], want["flags"] & HOST_FLAGS)
    assert (got["flags"][1:5] & SP.FLAG_ADDR).all()
    assert (got["flags"][5:7] & SP.FLAG_OOB).all()
    assert (got["flags"][5:7] & SP.FLAG_ITER).all()
    assert got["rounds"] == SP.ITER_CAP
    ok = (got["flags"] == 0) & (want["flags"] == 0)
    assert ok.sum() > 10
    for k in CMP:
        assert np.array_equal(got[k][ok], want[k][ok]), k
    assert np.array_equal(got["ix"][ok], JSP.dense_ix(want)[ok])


def test_addr_lanes_redone_with_the_slot_chain_equal_jax():
    """ADDR lanes are redone on the host with the addresses of the previous
    granule of their (gr, ch) slot, as in the JAX encoder."""
    xr, mb = _forced_lanes()
    mb[5:7] = 1500                                  # keep OOB out of redo
    want = _jax_final(xr, mb)
    got = _port_final(xr, mb)
    for k in CMP:
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["ix"], want["ix"])


@pytest.mark.parametrize("name", ["fixture", "loud"])
def test_window_search_is_the_search_at_the_cursor(name):
    """Each lane under the window of 3 message bits at its cursor equals its
    search at that cursor (all rows, flags and ix), and JAX ``search_all``
    at that cursor wherever neither plane flags the lane."""
    xr, mb = _case(name)
    n = len(xr)
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, size=2 * n).astype(np.uint8)
    cur = rng.integers(0, len(bits) - 2, size=n).astype(np.int64)
    xr_t = torch.from_numpy(xr)
    win = SP.to_host(SP.search_windows(xr_t, torch.from_numpy(mb), 0))
    pick = SP.window_of(bits, cur) * n + np.arange(n)
    at = SP.search_all(xr_t, mb, 0, bits, cur)
    for k in SP.ROWS:
        assert np.array_equal(win[k][pick], at[k]), k
    assert np.array_equal(win["ix"][pick], at["ix"])
    want = JSP.search_all(jnp.asarray(xr), mb, 0, hide_bits=bits,
                          hide_cur=cur)
    ok = (at["flags"] == 0) & (want["flags"] == 0) & (at["xrmax0"] == 0)
    assert ok.sum() > n // 2
    for k in CMP:
        assert np.array_equal(at[k][ok], want[k][ok]), k
    assert np.array_equal(at["ix"][ok], JSP.dense_ix(want)[ok])
