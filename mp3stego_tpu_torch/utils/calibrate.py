"""The host-or-card cost models, from rates measured on the card, and the
entry points' engine overrides.

The port of the JAX package's ``utils/calibrate.py``: the same ``Probe``
fields, the same three cost models (``batch_decode_engine``,
``batch_encode_engine``, ``single_encode_engine``) with its formulas, and
the same overrides, which keep absolute priority. Each model weighs the
host C++ engine of a call against the card's: its transfers over the
measured link, a fixed cost per call, and the card's rate.

* ``link_out_mbps`` / ``link_in_mbps`` — host -> card / card -> host MB/s
  of 12 MB through ``utils.transfer`` (``put_pieces``, ``fetch_pieces``:
  pinned staging), best of 2; ``xfer_overlap`` — one upload, touch and
  fetch against the two alone; ``duplex_gain`` — not measured (its
  default): only the JAX package's threaded-fetch switch reads it, and the
  port always fetches on a side stream.
* ``device_overhead_s`` — a 4 KB round trip (upload, touch, fetch).
* ``device_gps`` — granules a second of the float32 decode plane (K2 +
  K1) on the golden stream tiled to 240.7 s, its prep resident
  (``_DEFAULTS``' rate, and with it ``host_plane_gps``'s, where the
  checkout's ``tests/golden`` is not there, as in an installed package).
* ``device_search_gps`` — lanes a second of the rate search K4 on seeded
  lanes.
* ``host_plane_gps`` / ``host_search_gps`` — the port's native float64
  plane and whole-file rate search, as the JAX package measures them.
* ``h2d_bpg`` / ``d2h_bpg`` — the decode's bytes up (its prep) and down
  (int16 PCM) a granule; ``device_path_gps`` — an end-to-end card rate
  that ``refresh_device_rates`` may record (0: the analytic model).

``get_probe()`` measures once per host and card and caches the record in
``~/.cache/mp3stego_tpu_torch_probe-v<N>-<host tag>-<card>.json``, a file
of the port's own (the JAX package's cache is another file).

The entry points (``MP3Encoder.encode``, ``decode_files_batched``,
``encode_files_batched``) do not consult the models: ``entry_engine``
gives the engine an override names, else "device", the plane where the
caller put it (the card by default). Measured on an NVIDIA H100 80GB
HBM3 (PERF.md, "Engine choice"), the single encode's model cannot pick
the host, and the decode model picked the card for a 1 s slice that the
host decodes faster: the card path's fixed host cost is not in it. So a
call's engine, and the bytes of an int16 float32 batch decode, never hang
on a probe's timings, and no call measures a probe. The models stand for
the JAX package's parity, ``tools/probe_card.py`` and ``chip_smoke.py``'s
phase 21, which price each input. They ask the probe only for a plane on
a CUDA device (None: the port's default, CUDA); off the card they answer
"device" unless an override speaks. The port has no host route for a
missing card: a CUDA device without one raises where the caller resolves
it.

Environment (as in the JAX package):

* ``MP3STEGO_TPU_PROBE=0`` — never measure: ``_DEFAULTS`` (what
  ``tests/conftest.py`` sets); ``=force`` — measure even if a cache exists.
* ``MP3STEGO_TPU_BATCH_HOST_G=<granules>`` — the batched int16 decode
  takes the host plane up to that many granules (0: always the card);
  ``MP3STEGO_TPU_BATCH_ENC_HOST=1/0`` and ``MP3STEGO_TPU_ENC_HOST=1/0`` —
  the batched and the single encode take the host C++ engine or the card.
  These apply on every device.
"""

import json
import os
import re
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

# The card the defaults were measured on, and its power limit
# (``nvidia-smi --query-gpu=name,power.limit``): ``measure_probe`` in
# chip_smoke.py phase 21 (PERF.md, "The probe"). Used under
# MP3STEGO_TPU_PROBE=0.
DEFAULTS_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
_DEFAULTS = dict(
    link_out_mbps=13820.1,      # 12 MB host -> card, put_pieces + touch
    link_in_mbps=34974.2,       # 12 MB card -> host, fetch_pieces
    host_plane_gps=70192.6,     # native float64 plane, granules/s
    host_search_gps=191780.4,   # native whole-file rate search, lanes/s
    device_gps=35103824.1,      # float32 plane (K2 + K1), granules/s
    device_search_gps=37934004.5,  # K4 on seeded lanes, lanes/s
    device_overhead_s=0.000293,  # a 4 KB round trip
    h2d_bpg=1435.1,             # the decode's prep bytes a granule
    d2h_bpg=2304.0,             # int16 stereo PCM bytes a granule
    device_path_gps=0.0,        # unmeasured: the analytic transfer model
    xfer_overlap=1.040,         # one round trip / (up alone + down alone)
    duplex_gain=1.0,            # not measured: nothing in the port reads it
    probed=False,
)


@dataclass
class Probe:
    link_out_mbps: float
    link_in_mbps: float
    host_plane_gps: float
    host_search_gps: float
    device_gps: float
    device_search_gps: float
    device_overhead_s: float
    h2d_bpg: float
    d2h_bpg: float
    device_path_gps: float
    xfer_overlap: float
    duplex_gain: float
    probed: bool


# bumped when an engine's rate changes materially or the probe changes
_PROBE_VERSION = 1
# the golden stream's copies for the card's plane rate: chip_smoke.py's
# song (one zero byte after each copy keeps the sync walk going)
_PLANE_COPIES = 256
# seeded lanes for K4's rate (the host search's 128 lanes, repeated)
_SEARCH_LANES = 8192
_LINK_BYTES = 12 << 20

_GOLD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden", "encode_golden.npz")


def _card_tag() -> str:
    """The card's name as a file-name part ("cpu" without a card)."""
    if not torch.cuda.is_available():
        return "cpu"
    return re.sub(r"[^A-Za-z0-9.]+", "_", torch.cuda.get_device_name(0))


def _cache_path() -> str:
    from mp3stego_tpu_torch import native
    return os.path.join(
        os.path.expanduser("~"), ".cache",
        f"mp3stego_tpu_torch_probe-v{_PROBE_VERSION}-{native._host_tag()}"
        f"-{_card_tag()}.json")


_probe_cache = None


def get_probe() -> Probe:
    """The calibration record for this host and card (measured, cached, or
    ``_DEFAULTS`` under ``MP3STEGO_TPU_PROBE=0``)."""
    global _probe_cache
    if _probe_cache is not None:
        return _probe_cache
    mode = os.environ.get("MP3STEGO_TPU_PROBE", "1")
    if mode == "0":
        _probe_cache = Probe(**_DEFAULTS)
        return _probe_cache
    path = _cache_path()
    if mode != "force" and os.path.exists(path):
        try:
            with open(path) as f:
                d = json.load(f)
            _probe_cache = Probe(**{k: d.get(k, v)
                                    for k, v in _DEFAULTS.items()})
            return _probe_cache
        except (OSError, ValueError, TypeError, AttributeError):
            pass                    # a corrupt cache: measure again
    _probe_cache = measure_probe()
    _save(_probe_cache)
    return _probe_cache


def _save(p: Probe) -> None:
    try:
        path = _cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(asdict(p), f)
    except OSError:
        pass                        # the cache is an optimisation only


def _best(fn, runs: int) -> float:
    """The shortest of ``runs`` timed calls of ``fn`` (one untimed first),
    in seconds: single shots swing."""
    fn()
    best = None
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        dt = max(1e-7, time.perf_counter() - t0)
        best = dt if best is None else min(best, dt)
    return best


def measure_probe(device=None) -> Probe:
    """Measure every rate of the record on ``device`` (None: the current
    CUDA device) and the host (a second or so, the song's parse included).
    Raises without a card: the probe measures the card, and the port has no
    host route for a missing one."""
    from mp3stego_tpu_torch.utils.transfer import fetch_pieces, put_pieces
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("measure_probe measures a CUDA card and torch "
                           "sees none")
    vals = dict(_DEFAULTS)
    vals["probed"] = True
    vals["host_plane_gps"] = _measure_host_plane()
    vals["host_search_gps"] = _measure_host_search()

    def sync():
        torch.cuda.synchronize(dev)

    buf = np.zeros(_LINK_BYTES, np.uint8)
    res = {}

    def up():
        res["out"] = put_pieces(buf, dev) + 1      # the card reads it
        sync()

    up()
    down = lambda: fetch_pieces([res["out"]])      # noqa: E731
    up_s, down_s = _best(up, 2), _best(down, 2)
    vals["link_out_mbps"] = buf.nbytes / up_s / 1e6
    vals["link_in_mbps"] = buf.nbytes / down_s / 1e6

    def both():
        up()
        down()

    # clamped as in the JAX package
    vals["xfer_overlap"] = min(2.0, max(0.2, _best(both, 2)
                                        / (up_s + down_s)))
    tiny = np.zeros(4096, np.uint8)
    vals["device_overhead_s"] = _best(
        lambda: fetch_pieces([put_pieces(tiny, dev) + 1]), 3)
    vals["device_gps"], vals["h2d_bpg"] = _measure_device_plane(dev)
    vals["device_search_gps"] = _measure_device_search(dev)
    return Probe(**vals)


def _golden_stream(copies: int):
    """The golden stream tiled ``copies`` times, or None where the checkout's
    ``tests/golden`` is not there (an installed package)."""
    if not os.path.exists(_GOLD):
        return None
    data = np.load(_GOLD)["mp3_bytes"].tobytes()
    return (data + b"\0") * copies


def _measure_host_plane() -> float:
    """Granules a second of the native float64 plane (parse excluded) on
    the golden stream tiled 8 times; ``_DEFAULTS``' rate without the native
    library or the golden stream."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    data = _golden_stream(8)
    if data is None:
        return _DEFAULTS["host_plane_gps"]
    parsed = dh.parse_mp3(data, 0)
    if dp.decode_pcm_i16_host(parsed) is None:
        return _DEFAULTS["host_plane_gps"]
    return parsed.num_frames * 2 / _best(
        lambda: dp.decode_pcm_i16_host(parsed), 3)


def _seeded_lanes(lanes: int) -> np.ndarray:
    """The JAX package's probe lanes: seed 0, |x| < 2^18, 576 a lane."""
    rng = np.random.default_rng(0)
    return rng.integers(-(1 << 18), 1 << 18, size=(lanes, 576)) \
        .astype(np.int32)


def _measure_host_search() -> float:
    """Lanes a second of the native whole-file rate search on 128 seeded
    lanes; ``_DEFAULTS``' rate without the native library."""
    from mp3stego_tpu_torch.models.encoder import _native_rate_lib
    lib = _native_rate_lib()
    if lib is None or not hasattr(lib, "rate_search_file"):
        return _DEFAULTS["host_search_gps"]
    lanes = 128
    xr = _seeded_lanes(lanes)
    maxb = np.full(lanes, 1631, np.int32)
    raw = np.zeros((lanes, 12), np.int64)
    ix = np.zeros((lanes, 576), np.int32)
    en_tot = np.zeros(lanes, np.int32)
    en21 = np.zeros((lanes, 21), np.int32)
    hide = np.zeros(1, np.uint8)
    chain = (np.zeros(2 * 2 * 12, np.int64), np.zeros(2 * 2 * 576, np.int32))
    return lanes / _best(lambda: lib.rate_search_file(
        xr, maxb, 1, lanes, 2, 0, hide, 0, 0, raw, ix, en_tot, en21, *chain,
        0), 3)


def _measure_device_plane(dev: torch.device) -> tuple:
    """(granules a second of the float32 plane, K2 + K1, on the resident
    prep of the golden stream tiled to 240.7 s; the prep's bytes a
    granule); ``_DEFAULTS``' pair without the golden stream."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    data = _golden_stream(_PLANE_COPIES)
    if data is None:
        return _DEFAULTS["device_gps"], _DEFAULTS["h2d_bpg"]
    parsed = dh.parse_mp3(data, 0)
    g = parsed.num_frames * 2
    prep = dp.prep_to_torch(dp.host_prepare(parsed), dev)
    h2d = sum(t.numel() * t.element_size() for t in prep.values())

    def plane():
        dp.decode_granules(prep, torch.float32)
        torch.cuda.synchronize(dev)

    return g / _best(plane, 3), h2d / g


def _measure_device_search(dev: torch.device) -> float:
    """Lanes a second of K4 (``search_plane.search``) on seeded lanes, the
    host search's budget, resident."""
    from mp3stego_tpu_torch.ops import search_plane as SP
    xr = torch.from_numpy(_seeded_lanes(_SEARCH_LANES)).to(dev)
    maxb = torch.full((_SEARCH_LANES,), 1631, dtype=torch.int32, device=dev)

    def search():
        SP.search(xr, maxb, 0)
        torch.cuda.synchronize(dev)

    return _SEARCH_LANES / _best(search, 3)


def refresh_device_rates(device_gps: float = None,
                         device_search_gps: float = None,
                         h2d_bpg: float = None,
                         d2h_bpg: float = None,
                         device_path_gps: float = None) -> None:
    """Record measured card rates and per-granule transfer volumes into the
    probe (and its cache file), so later choices use them."""
    p = get_probe()
    if device_gps:
        p.device_gps = float(device_gps)
    if device_search_gps:
        p.device_search_gps = float(device_search_gps)
    if h2d_bpg:
        p.h2d_bpg = float(h2d_bpg)
    if d2h_bpg:
        p.d2h_bpg = float(d2h_bpg)
    if device_path_gps:
        p.device_path_gps = float(device_path_gps)
    _save(p)


# --------------------------------------------------------------- cost models

# each model's override: the engine it names keeps absolute priority
_OVERRIDES = {"batch_decode": "MP3STEGO_TPU_BATCH_HOST_G",
              "batch_encode": "MP3STEGO_TPU_BATCH_ENC_HOST",
              "single_encode": "MP3STEGO_TPU_ENC_HOST"}


def _override(model: str, total_granules: int):
    """The engine ``model``'s override names for ``total_granules``
    granules ("host" or "device"), or None where it is unset."""
    env = os.environ.get(_OVERRIDES[model])
    if env is None:
        return None
    if model == "batch_decode":
        return "host" if total_granules <= int(env) else "device"
    return "host" if env != "0" else "device"


def entry_engine(model: str, total_granules: int = 0) -> str:
    """The engine an entry point runs for ``model`` ("batch_decode",
    "batch_encode" or "single_encode"): the one its override names, else
    "device", the plane where the caller put it. No model and no probe is
    consulted (see the module docstring)."""
    return _override(model, total_granules) or "device"


def _on_card(device) -> bool:
    """Whether a plane on ``device`` (None: the port's default, CUDA) asks
    the cost model."""
    return device is None or torch.device(device).type == "cuda"


def batch_decode_engine(total_granules: int, probe: Probe = None,
                        device=None) -> str:
    """"host" or "device" for the int16 batched decode of
    ``total_granules`` granules on ``device``.

    host   = G / host_plane_gps
    device = overhead + (G*h2d_bpg/link_out + G*d2h_bpg/link_in)
                        * xfer_overlap + G / device_gps
    (or overhead + G / device_path_gps where that was measured).
    ``MP3STEGO_TPU_BATCH_HOST_G=<granules>`` keeps absolute priority: the
    host up to that many granules (0: always the device). Off the card
    without it: "device" (the plane where the caller put it)."""
    env = _override("batch_decode", total_granules)
    if env is not None:
        return env
    if not _on_card(device):
        return "device"
    p = probe or get_probe()
    host_s = total_granules / p.host_plane_gps
    if p.device_path_gps:
        device_s = (p.device_overhead_s
                    + total_granules / p.device_path_gps)
    else:
        xfer = (total_granules * p.h2d_bpg / (p.link_out_mbps * 1e6)
                + total_granules * p.d2h_bpg / (p.link_in_mbps * 1e6))
        device_s = (p.device_overhead_s + xfer * p.xfer_overlap
                    + total_granules / p.device_gps)
    return "host" if host_s <= device_s else "device"


def batch_encode_engine(total_granules: int, probe: Probe = None,
                        device=None) -> str:
    """"host" or "device" for the batched encode without a mesh.

    host   = G / host_search_gps
    device = overhead + G*1152*2 B / link_out + G / device_search_gps
             + G*2400 B / link_in
    ``MP3STEGO_TPU_BATCH_ENC_HOST=1/0`` keeps absolute priority. Off the
    card without it: "device"."""
    env = _override("batch_encode", total_granules)
    if env is not None:
        return env
    if not _on_card(device):
        return "device"
    p = probe or get_probe()
    host_s = total_granules / p.host_search_gps
    device_s = (p.device_overhead_s
                + total_granules * 1152 * 2 / (p.link_out_mbps * 1e6)
                + total_granules / p.device_search_gps
                + total_granules * 2400 / (p.link_in_mbps * 1e6))
    return "host" if host_s <= device_s else "device"


def single_encode_engine(probe: Probe = None, device=None) -> str:
    """The single encode's engine: the batched model at 4,096 granules, as
    in the JAX package. ``MP3STEGO_TPU_ENC_HOST=1/0`` keeps absolute
    priority (0: the card's planes)."""
    return (_override("single_encode", 4096)
            or batch_encode_engine(4096, probe, device))
