"""utils/calibrate.py: the engine choice's cost models against the JAX
package's, the probe's cache and its fallbacks, and the wiring at the
three call sites, on the CPU (the entry points follow the overrides only
and ask no model; the models ask none on the CPU unless an override
speaks)."""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mp3stego_tpu.bitstream import decoder_host as jdh
from mp3stego_tpu.ops import decode_plane as jdp
from mp3stego_tpu.utils import calibrate as JC
from mp3stego_tpu_torch import native
from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.models.encoder import MP3Encoder
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.parallel import batch_decode as BD
from mp3stego_tpu_torch.parallel import batch_encode as BE
from mp3stego_tpu_torch.utils import calibrate as C
from mp3stego_tpu_torch.utils.wav import read_wav

OVERRIDES = ("MP3STEGO_TPU_BATCH_HOST_G", "MP3STEGO_TPU_BATCH_ENC_HOST",
             "MP3STEGO_TPU_ENC_HOST")
# each override alone, and none
SETTINGS = [{}] + [{k: v} for k, vs in (
    ("MP3STEGO_TPU_BATCH_HOST_G", ("0", "2560", "1000000")),
    ("MP3STEGO_TPU_BATCH_ENC_HOST", ("0", "1")),
    ("MP3STEGO_TPU_ENC_HOST", ("0", "1"))) for v in vs]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in OVERRIDES:
        monkeypatch.delenv(k, raising=False)
    # the JAX models consult the device's health; the port has no such
    # route (a missing card raises before any model runs)
    monkeypatch.setenv("MP3STEGO_TPU_DEVICE_USABLE", "1")
    monkeypatch.setattr(C, "_probe_cache", None)
    monkeypatch.setattr(JC, "_probe_cache", None)


rates = st.floats(min_value=1.0, max_value=1e9, allow_nan=False,
                  allow_infinity=False)
probes = st.fixed_dictionaries(dict(
    link_out_mbps=rates, link_in_mbps=rates, host_plane_gps=rates,
    host_search_gps=rates, device_gps=rates, device_search_gps=rates,
    device_overhead_s=st.floats(min_value=0.0, max_value=2.0),
    h2d_bpg=st.floats(min_value=0.0, max_value=1e5),
    d2h_bpg=st.floats(min_value=0.0, max_value=1e5),
    device_path_gps=st.one_of(st.just(0.0), rates),
    xfer_overlap=st.floats(min_value=0.2, max_value=2.0),
    duplex_gain=st.floats(min_value=0.3, max_value=3.0),
    probed=st.booleans()))


@pytest.mark.parametrize("env", SETTINGS,
                         ids=lambda e: ",".join(f"{k[13:]}={v}"
                                                for k, v in e.items())
                         or "none")
@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(fields=probes, g=st.integers(min_value=1, max_value=10_000_000))
def test_engine_models_equal_the_jax_package(env, fields, g):
    saved = {k: os.environ.get(k) for k in OVERRIDES}
    try:
        for k in OVERRIDES:
            os.environ.pop(k, None)
        os.environ.update(env)
        p, jp = C.Probe(**fields), JC.Probe(**fields)
        assert C.batch_decode_engine(g, p) == JC.batch_decode_engine(g, jp)
        assert C.batch_encode_engine(g, p) == JC.batch_encode_engine(g, jp)
        assert C.single_encode_engine(p) == JC.single_encode_engine(jp)
        # the overrides hold on every device; without one the CPU asks no
        # model and keeps its plane
        cpu = [C.batch_decode_engine(g, p, "cpu"),
               C.batch_encode_engine(g, p, "cpu"),
               C.single_encode_engine(p, "cpu")]
        if not env:
            assert cpu == ["device"] * 3
        elif "MP3STEGO_TPU_BATCH_HOST_G" in env:
            assert cpu[0] == JC.batch_decode_engine(g, jp)
        elif "MP3STEGO_TPU_BATCH_ENC_HOST" in env:
            assert cpu[1:] == [JC.batch_encode_engine(g, jp),
                               JC.single_encode_engine(jp)]
        else:
            assert cpu[2] == JC.single_encode_engine(jp)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_the_probe_keeps_the_jax_fields_and_card_defaults():
    assert list(C.Probe.__dataclass_fields__) == list(
        JC.Probe.__dataclass_fields__)
    assert list(C._DEFAULTS) == list(JC._DEFAULTS)
    assert "H100" in C.DEFAULTS_CARD and " W" in C.DEFAULTS_CARD
    # no figure of the JAX package's TPU-link defaults carries over
    for k in ("link_out_mbps", "link_in_mbps", "device_gps",
              "device_search_gps", "device_overhead_s", "host_plane_gps",
              "host_search_gps", "h2d_bpg"):
        assert C._DEFAULTS[k] > 0 and C._DEFAULTS[k] != JC._DEFAULTS[k], k


def test_probe_zero_touches_no_device(monkeypatch):
    monkeypatch.setenv("MP3STEGO_TPU_PROBE", "0")

    def refuse(*a, **k):
        raise AssertionError("the probe touched the device")

    for name in ("is_available", "get_device_name", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(C, "measure_probe", refuse)
    p = C.get_probe()
    assert p.probed is False and p == C.Probe(**C._DEFAULTS)
    assert C.batch_decode_engine(1 << 20) in ("host", "device")


def test_the_cpu_asks_no_model(monkeypatch):
    monkeypatch.setattr(C, "get_probe", lambda: pytest.fail("consulted"))
    assert C.batch_decode_engine(10, device="cpu") == "device"
    assert C.batch_encode_engine(10, device=torch.device("cpu")) == "device"
    assert C.single_encode_engine(device="cpu") == "device"


def test_measure_probe_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        C.measure_probe("cpu")


def test_probe_cache_round_trip_and_corrupt_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("MP3STEGO_TPU_PROBE", "1")
    path = C._cache_path()
    assert path.startswith(str(tmp_path))
    fake = C.Probe(**dict(C._DEFAULTS, link_out_mbps=123.0, probed=True))
    monkeypatch.setattr(C, "measure_probe", lambda: fake)
    assert C.get_probe().link_out_mbps == 123.0
    with open(path) as f:
        assert json.load(f)["link_out_mbps"] == 123.0
    # a second process reads the file and never measures
    monkeypatch.setattr(C, "_probe_cache", None)
    monkeypatch.setattr(C, "measure_probe",
                        lambda: pytest.fail("measured again"))
    assert C.get_probe() == fake
    # a corrupt cache is measured again and rewritten
    with open(path, "w") as f:
        f.write("{not json")
    monkeypatch.setattr(C, "_probe_cache", None)
    fresh = C.Probe(**dict(C._DEFAULTS, link_in_mbps=7.0, probed=True))
    monkeypatch.setattr(C, "measure_probe", lambda: fresh)
    assert C.get_probe() == fresh
    with open(path) as f:
        assert json.load(f)["link_in_mbps"] == 7.0
    # force measures even with a cache; refresh_device_rates writes it
    monkeypatch.setattr(C, "_probe_cache", None)
    monkeypatch.setenv("MP3STEGO_TPU_PROBE", "force")
    monkeypatch.setattr(C, "measure_probe", lambda: fake)
    assert C.get_probe() == fake
    C.refresh_device_rates(device_gps=5.0, d2h_bpg=9.0)
    with open(path) as f:
        d = json.load(f)
    assert (d["device_gps"], d["d2h_bpg"]) == (5.0, 9.0)


def test_cache_path_is_not_the_jax_packages():
    ours, theirs = C._cache_path(), JC._cache_path()
    assert ours != theirs
    assert os.path.basename(ours).startswith("mp3stego_tpu_torch_probe-v")
    assert os.path.basename(theirs).startswith("mp3stego_tpu_probe-v")


def test_the_probe_measures_without_the_golden_stream(tmp_path,
                                                      monkeypatch):
    """An installed package has no tests/golden: the two plane rates fall
    back to their defaults (the JAX package's rule) and nothing raises."""
    monkeypatch.setattr(C, "_GOLD", str(tmp_path / "missing.npz"))
    assert C._golden_stream(2) is None
    assert C._measure_host_plane() == C._DEFAULTS["host_plane_gps"]
    assert C._measure_device_plane(torch.device("cpu")) == (
        C._DEFAULTS["device_gps"], C._DEFAULTS["h2d_bpg"])


@pytest.mark.parametrize("model", sorted(C._OVERRIDES))
def test_entry_points_follow_the_overrides_and_ask_no_model(model,
                                                            monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an entry point consulted the cost model")

    for name in ("get_probe", "measure_probe", "batch_decode_engine",
                 "batch_encode_engine", "single_encode_engine"):
        monkeypatch.setattr(C, name, refuse)
    # without an override the device's plane runs, at every size
    for g in (1, 14, 78, 1 << 20):
        assert C.entry_engine(model, g) == "device"
    env = C._OVERRIDES[model]
    if model == "batch_decode":
        # the override's crossover: the host up to that many granules
        monkeypatch.setenv(env, "78")
        assert [C.entry_engine(model, g) for g in (1, 78, 79, 1 << 20)] \
            == ["host", "host", "device", "device"]
        monkeypatch.setenv(env, "0")
        assert C.entry_engine(model, 1) == "device"
    else:
        monkeypatch.setenv(env, "1")
        assert C.entry_engine(model, 1 << 20) == "host"
        monkeypatch.setenv(env, "0")
        assert C.entry_engine(model, 1) == "device"


def test_the_models_can_pick_the_host_where_the_entry_points_do_not(
        monkeypatch):
    fast_host = C.Probe(**dict(C._DEFAULTS, host_plane_gps=1e12,
                               host_search_gps=1e12))
    assert C.batch_decode_engine(14, fast_host) == "host"
    assert C.batch_encode_engine(14, fast_host) == "host"
    assert C.single_encode_engine(fast_host) == "host"
    monkeypatch.setattr(C, "get_probe", lambda: fast_host)
    assert all(C.entry_engine(m, 14) == "device" for m in C._OVERRIDES)


# ------------------------------------------------------------------ wiring

def _needs_native():
    if native.get_lib() is None:
        pytest.skip("the port's native library did not build")


def test_batch_decode_host_engine_equals_the_jax_package(fixture_mp3,
                                                         tmp_path,
                                                         monkeypatch):
    _needs_native()
    mr = np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "multirate_golden.npz"))
    other = tmp_path / "b.mp3"
    other.write_bytes(mr["mp3_32000_64"].tobytes())
    paths = [fixture_mp3, str(other)]
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", str(1 << 30))
    monkeypatch.setattr(BD, "_decode_pipelined",
                        lambda *a, **k: pytest.fail("took the device plane"))
    got = BD.decode_files_batched(paths, out="int16", device="cpu")
    for path, pcm in zip(paths, got):
        with open(path, "rb") as f:
            data = f.read()
        jparsed = jdh.parse_mp3(data, 0, backend="python")
        want = jdp.decode_pcm_i16_host(jparsed)
        if want is None:                 # the JAX library is not loaded
            want = jdp.pcm_to_i16(jdp.decode_pcm(jparsed, "float64"))
        assert pcm.dtype == np.int16 and pcm.tobytes() == want.tobytes()
        assert pcm.tobytes() == dp.decode_pcm_i16_host(
            dh.parse_mp3(data, 0)).tobytes()
    # float PCM and float64 never take the host plane
    monkeypatch.setattr(BD, "_decode_pipelined", lambda metas, *a: [
        "plane"] * len(metas))
    assert BD.decode_files_batched(paths, device="cpu") == ["plane"] * 2
    assert BD.decode_files_batched(paths, out="int16", dtype="float64",
                                   device="cpu") == ["plane"] * 2
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", "0")
    assert BD.decode_files_batched(paths, out="int16",
                                   device="cpu") == ["plane"] * 2


def test_batch_encode_host_engine_writes_the_jax_bytes(stego_golden,
                                                       encode_golden,
                                                       tmp_path,
                                                       monkeypatch):
    _needs_native()
    wav = tmp_path / "g.wav"
    wav.write_bytes(stego_golden["wav_bytes"].tobytes())
    jobs = [(str(wav), str(tmp_path / "a.mp3")),
            (str(tmp_path / "missing.wav"), str(tmp_path / "m.mp3")),
            (str(wav), str(tmp_path / "b.mp3"))]
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_ENC_HOST", "1")
    monkeypatch.setattr(BE, "_run_sub_batch",
                        lambda *a, **k: pytest.fail("took the card path"))
    out = BE.encode_files_batched(jobs, device="cpu", errors="isolate")
    assert isinstance(out[1], FileNotFoundError)
    want = encode_golden["mp3_bytes"].tobytes()
    for i in (0, 2):
        assert out[i] == jobs[i][1]
        assert (tmp_path / os.path.basename(out[i])).read_bytes() == want


@pytest.mark.parametrize("flag,stage", (("1", "rate search (host C++)"),
                                        ("0", "rate search (device)")))
def test_single_encode_takes_the_engine_the_override_names(
        stego_golden, encode_golden, tmp_path, monkeypatch, flag, stage):
    _needs_native()
    wav = tmp_path / "g.wav"
    wav.write_bytes(stego_golden["wav_bytes"].tobytes())
    monkeypatch.setenv("MP3STEGO_TPU_ENC_HOST", flag)
    enc = MP3Encoder(read_wav(str(wav), 320), device="cpu")
    enc.encode()
    assert stage in enc.timer.times
    assert bytes(enc.out_buffer) == encode_golden["mp3_bytes"].tobytes()
    hide = MP3Encoder(read_wav(str(wav), 320), hide_str="0110" * 9,
                      device="cpu")
    hide.encode()
    assert stage in hide.timer.times or (
        flag == "0" and "hide window pass (device)" in hide.timer.times)
    monkeypatch.delenv("MP3STEGO_TPU_ENC_HOST")
    plane = MP3Encoder(read_wav(str(wav), 320), hide_str="0110" * 9,
                       device="cpu")
    plane.encode()
    assert bytes(hide.out_buffer) == bytes(plane.out_buffer)
    assert hide.hide_str_offset == plane.hide_str_offset
