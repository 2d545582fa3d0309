"""The port's cost grid (``ops/quant_batch``) and cost-grid encode engine
against the JAX package's, on the CPU.

* ``cost_all_steps`` equals ``mp3stego_tpu.ops.quant_batch.cost_all_steps``
  key for key, dtype for dtype and value for value on every lane and step,
  clear and with the hide channels, on an MPEG-1 (44.1 kHz), an MPEG-2
  (16 kHz, whose reference band row has an odd edge) and an MPEG-2.5 (8
  kHz) band row. The lanes: the golden encode's spectra, seeded loud and
  escape lanes, the search's forced-flag lanes and the grid's edge lanes
  (all zeros, a lone INT32_MIN, full scale, approx cells, big_values 0).
  The JAX grid pads to 1,024 lanes whatever N, so it runs once a case.
* ``table_cost`` equals the JAX one for tables 0, 13, 15 and 16-31.
* The engine (``MP3STEGO_TPU_SEARCH_PLANE=0``, ``device="cpu"``) writes the
  bytes of the goldens, of the JAX package's cost-grid engine and of the
  port's plane and hide engines: clear, the hide of "ddd", the long and
  the too-long messages (with the same ``hide_str_offset``), VBR and a
  spec-valid LSF file; also with the NumPy oracle in place of the native
  twin.
* Both packages' ``progress`` hand back the plain iterable when disabled
  or without tqdm.

Tolerance: exact everywhere.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from chip_smoke import grid_lanes, search_lanes  # noqa: E402
from mp3stego_tpu.ops import quant_batch as JQ  # noqa: E402
from mp3stego_tpu_torch.models import encoder as E  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.ops import quant_batch as QB  # noqa: E402
from mp3stego_tpu_torch.steganography import _frame_message  # noqa: E402
from mp3stego_tpu_torch.utils.wav import WavFile, read_wav  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# (band row, with_hide): MPEG-1 44.1 kHz, MPEG-2 16 kHz, MPEG-2.5 8 kHz
GRID_CASES = [(0, False), (0, True), (5, True), (8, False), (8, True)]


@pytest.fixture(scope="module")
def lanes() -> np.ndarray:
    xr = np.concatenate([search_lanes(n)[0] for n in
                         ("fixture", "loud", "escape", "forced")]
                        + [grid_lanes()])
    assert xr.shape[0] <= 1024
    return np.ascontiguousarray(xr)


@pytest.fixture(scope="module")
def grids(lanes):
    """(band row, with_hide) -> (JAX grid, port grid), computed once."""
    cache = {}

    def get(sr_idx, with_hide):
        if (sr_idx, with_hide) not in cache:
            cache[sr_idx, with_hide] = (
                JQ.cost_all_steps(lanes, sr_idx, with_hide=with_hide),
                QB.cost_all_steps(torch.from_numpy(lanes), sr_idx,
                                  with_hide=with_hide))
        return cache[sr_idx, with_hide]
    return get


@pytest.mark.parametrize("sr_idx,with_hide", GRID_CASES)
def test_grid_equals_the_jax_grid(sr_idx, with_hide, grids, lanes):
    want, got = grids(sr_idx, with_hide)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), (k, np.argwhere(got[k] != v)[:5])
    # the lanes reach every case the replay treats apart
    n = lanes.shape[0]
    assert got["bail"].shape == (n, 128)
    assert got["bail"].any() and not got["bail"].all()
    assert got["approx"].any()
    assert ((got["bv"] == 0) & ~got["bail"] & ~got["approx"]).any()
    assert got["bail"][grid_lanes_rows(n)[4]].sum() == 58   # full scale
    lone = grid_lanes_rows(n)[1]                     # a lone INT32_MIN
    assert got["approx"][lone].any() and not got["bail"][lone].any()
    if with_hide:
        assert (got["choice"] >= 24).any() and (got["choice"] == 13).any()


def grid_lanes_rows(n: int) -> np.ndarray:
    """The rows of ``grid_lanes`` in the test lanes (they come last)."""
    return np.arange(n - 16, n)


@pytest.mark.parametrize("table", [0, 13, 15] + list(range(16, 32)))
def test_table_cost_equals_jax(table, grids, lanes):
    want, got = grids(0, True)
    rng = np.random.default_rng(table)
    for g, s, r in zip(rng.integers(0, lanes.shape[0], 64),
                       rng.integers(0, 128, 64), rng.integers(0, 3, 64)):
        assert QB.table_cost(got, g, s, r, table) == \
            JQ.table_cost(want, g, s, r, table)


def test_table_cost_refuses_other_tables(grids):
    _, got = grids(0, True)
    for table in (1, 14, 32):
        with pytest.raises(ValueError, match="table"):
            QB.table_cost(got, 0, 0, 0, table)


# ------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def gold():
    return {n: np.load(os.path.join(GOLD, f"{n}.npz"))
            for n in ("encode_golden", "stego_golden", "torch_lsf_golden",
                      "mpeg2_golden")}


@pytest.fixture(scope="module")
def fixture_wav(tmp_path_factory, gold):
    p = tmp_path_factory.mktemp("grid") / "fixture.wav"
    p.write_bytes(gold["stego_golden"]["wav_bytes"].tobytes())
    return str(p)


def _case(case, gold, fixture_wav):
    """(port WAV, JAX WAV, bits, vbr, lsf_compliant, golden or None)."""
    from mp3stego_tpu.utils import wav as jwav
    sg = gold["stego_golden"]
    if case == "lsf":
        pcm = gold["mpeg2_golden"]["mpeg2_22k05_80_pcm"]
        kw = dict(file_path="lsf.wav", bitrate=80, num_of_channels=2,
                  samplerate=22050, bits_per_sample=16,
                  num_of_samples=len(pcm) // 2, mpeg_mode=0, buffer=pcm)
        return (WavFile(**kw), jwav.WavFile(**kw), "", False, True,
                gold["torch_lsf_golden"]["mpeg2_22k05_80"])
    br = 160 if case == "vbr" else 320
    msg = {"short": "ddd", "long": sg["msg_long"].tobytes().decode(),
           "toolong": "ddd" * 100}.get(case)
    want = {"clear": gold["encode_golden"]["mp3_bytes"],
            "short": sg["hidden_short"], "long": sg["hidden_long"],
            "toolong": sg["hidden_toolong"]}.get(case)
    return (read_wav(fixture_wav, br), jwav.read_wav(fixture_wav, br),
            "" if msg is None else _frame_message(msg), case == "vbr",
            None, want)


def _grid_env(monkeypatch, on: bool):
    if on:
        monkeypatch.setenv("MP3STEGO_TPU_SEARCH_PLANE", "0")
    else:
        monkeypatch.delenv("MP3STEGO_TPU_SEARCH_PLANE", raising=False)


@pytest.mark.parametrize("case", ["clear", "short", "long", "toolong", "vbr",
                                  "lsf"])
def test_grid_engine_bytes(case, gold, fixture_wav, monkeypatch):
    """The port's cost-grid engine against the goldens, the JAX package's
    cost-grid engine and the port's plane (clear, VBR, LSF) or hide
    engine, with the stego cursor alike in all."""
    from mp3stego_tpu.models.encoder import MP3Encoder as JaxMP3Encoder
    wav, jwav, bits, vbr, lsf, want = _case(case, gold, fixture_wav)
    _grid_env(monkeypatch, True)
    grid = MP3Encoder(wav, hide_str=bits, vbr=vbr, lsf_compliant=lsf,
                      device="cpu")
    grid.encode()
    assert grid._cost is not None
    assert grid._cost["bail"].shape == (
        wav.num_of_channels * grid._tg, 128)
    assert ("sum0" in grid._cost) == bool(bits)
    jax = JaxMP3Encoder(jwav, hide_str=bits, vbr=vbr, lsf_compliant=lsf)
    jax.encode()
    assert jax._cost is not None                  # the JAX grid engine ran
    _grid_env(monkeypatch, False)
    plane = MP3Encoder(wav, hide_str=bits, vbr=vbr, lsf_compliant=lsf,
                       device="cpu")
    plane.encode()
    assert plane._cost is None
    got = bytes(grid.out_buffer)
    assert got == bytes(jax.out_buffer) == bytes(plane.out_buffer)
    assert grid.hide_str_offset == jax.hide_str_offset \
        == plane.hide_str_offset
    if want is not None:
        assert got == want.tobytes()
    if case == "toolong":
        assert grid.hide_str_offset < len(bits) - 1
    if vbr:
        assert got[36:40] == b"Xing"
        assert list(grid.vbr_steps) == list(plane.vbr_steps)


def test_grid_engine_stages_and_the_numpy_oracle(gold, fixture_wav,
                                                 monkeypatch):
    """Without the native twin the exact evaluations run in NumPy and the
    hide still writes its golden; the engine's stages are the analysis,
    the grid, the spectra's fetch and the host's frame loop."""
    _grid_env(monkeypatch, True)
    monkeypatch.setattr(E, "_native_rate_lib", lambda: None)
    enc = MP3Encoder(read_wav(fixture_wav, 320),
                     hide_str=_frame_message("ddd"), device="cpu")
    enc.encode()
    assert bytes(enc.out_buffer) == \
        gold["stego_golden"]["hidden_short"].tobytes()
    assert list(enc.timer.times) == [
        "analysis+mdct (device)", "step-cost grid (device)", "d2h",
        "rate control + serialize (host)"]


def test_replay_keeps_the_last_exact_step(tmp_path, monkeypatch):
    """Each granule's final state comes from one exact evaluation at its
    final step, skipped only where the search's last evaluation (always at
    that step) already ran exactly: a quiet 32 kbps WAV, whose granules end
    on count1-only cells (big_values 0) as well as on costed ones. The
    bytes equal the plane engine's."""
    from mp3stego_tpu_torch.utils.wav import write_wav
    rng = np.random.default_rng(4)
    t = np.arange(44100) / 44100
    sig = 0.02 * np.sin(2 * np.pi * 440 * t) * (1 + np.sin(7 * t)) \
        + 0.004 * rng.standard_normal(len(t))
    pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
    wav = str(tmp_path / "quiet.wav")
    write_wav(wav, 44100, np.stack([pcm, pcm[::-1]], axis=1))

    _grid_env(monkeypatch, True)
    log = []                      # per granule: [cached evals' exactness]
    real_cached, real_exact = MP3Encoder._cached_eval, MP3Encoder._exact_eval
    real_outer = MP3Encoder._outer_loop_cached
    state = {"exact": 0}

    def exact(self, *args):
        state["exact"] += 1
        return real_exact(self, *args)

    def cached(self, *args):
        before = state["exact"]
        bits = real_cached(self, *args)
        log[-1]["evals"].append((args[1], state["exact"] > before))
        return bits

    def outer(self, max_bits, xr, xrabs, xrmax, gr, ch, cod_info):
        log.append({"evals": [], "start": state["exact"]})
        out = real_outer(self, max_bits, xr, xrabs, xrmax, gr, ch, cod_info)
        log[-1]["end"] = state["exact"]
        log[-1]["step"] = cod_info.quantizerStepSize
        return out

    monkeypatch.setattr(MP3Encoder, "_exact_eval", exact)
    monkeypatch.setattr(MP3Encoder, "_cached_eval", cached)
    monkeypatch.setattr(MP3Encoder, "_outer_loop_cached", outer)
    enc = MP3Encoder(read_wav(wav, 32), device="cpu")
    enc.encode()
    skipped = 0
    for gran in log:
        last_step, last_exact = gran["evals"][-1]
        assert last_step == gran["step"]
        in_search = sum(e for _, e in gran["evals"])
        assert gran["end"] - gran["start"] == in_search + (not last_exact)
        skipped += last_exact
    assert 0 < skipped < len(log)
    _grid_env(monkeypatch, False)
    plane = MP3Encoder(read_wav(wav, 32), device="cpu")
    plane.encode()
    assert bytes(enc.out_buffer) == bytes(plane.out_buffer)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_progress_is_the_plain_iterable_when_off(package, monkeypatch):
    if package == "jax":
        from mp3stego_tpu.utils.profiling import progress
    else:
        from mp3stego_tpu_torch.utils.profiling import progress
    it = range(5)
    assert progress(it, desc="encoding", enabled=False) is it
    monkeypatch.setitem(sys.modules, "tqdm", None)    # no tqdm installed
    assert progress(it, desc="encoding", enabled=True) is it
