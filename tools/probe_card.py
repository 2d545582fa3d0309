#!/usr/bin/env python3
"""The card's transfer rates and the engine choice's probe, on one CUDA card.

    python3 tools/probe_card.py [--out chiprun_out/probe_card.json]

Run from the root of a checkout. It measures, with the card's
``nvidia-smi`` name and power limit beside every number:

* fetches of the song's ``ix`` shape (36,864 x 576 int32, 84.9 MB) and of
  12 MB: pageable ``Tensor.cpu()`` against ``utils.transfer.fetch_pieces``
  at ``PIECE_BYTES`` of 1, 4 and 16 MB and whole buffers, in turns, the
  median of 5 each (host clock, the fetch's wait included);
* uploads of the song's WAV buffer (42.5 MB int16) and of 12 MB: pageable
  ``torch.from_numpy(a).to(card)`` against ``put_pieces`` at the same
  piece sizes, each followed by a synchronise;
* the song's decode prep: ``prep_to_torch``'s one staged copy
  (``put_tree``) against one pageable ``.to()`` a key;
* the first fetch into a cold pool (the pinned allocation);
* ``utils.calibrate.measure_probe()``.

It writes the record as JSON and prints a summary.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mp3stego_tpu_torch.bitstream import decoder_host as dh  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as dp  # noqa: E402
from mp3stego_tpu_torch.utils import calibrate as C  # noqa: E402
from mp3stego_tpu_torch.utils import transfer as X  # noqa: E402

PIECES = {"1 MB": 1 << 20, "4 MB": 4 << 20, "16 MB": 16 << 20,
          "whole": None}
RUNS = 5


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _turns(fns: dict) -> dict:
    """Each function once to warm up, then RUNS rounds in turns, the order
    reversed every other round: the median ms of each."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(RUNS):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(_ms(fns[k]))
    return {k: {"median_ms": sorted(v)[len(v) // 2], "ms": v}
            for k, v in times.items()}


def _with_pieces(fn, piece):
    def run():
        saved = X.PIECE_BYTES
        X.PIECE_BYTES = piece
        try:
            return fn()
        finally:
            X.PIECE_BYTES = saved
    return run


def fetch_case(t: torch.Tensor) -> dict:
    want = t.cpu().numpy()
    if not np.array_equal(X.fetch_pieces([t])[0], want):
        raise AssertionError("fetch_pieces != .cpu()")
    fns = {"pageable .cpu()": lambda: t.cpu().numpy()}
    fns.update({f"fetch_pieces {k}": _with_pieces(
        lambda: X.fetch_pieces([t]), v) for k, v in PIECES.items()})
    return _turns(fns)


def upload_case(a: np.ndarray, dev) -> dict:
    if not torch.equal(X.put_pieces(a, dev).cpu(), torch.from_numpy(a)):
        raise AssertionError("put_pieces != the array")
    fns = {"pageable .to()": lambda: torch.from_numpy(a).to(dev)}
    fns.update({f"put_pieces {k}": _with_pieces(
        lambda: X.put_pieces(a, dev), v) for k, v in PIECES.items()})
    return _turns(fns)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "probe_card.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    dev = torch.device("cuda")
    card = _card_line()
    rec = {"card": card, "torch": torch.__version__}
    rng = np.random.default_rng(0)

    cold = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    X.fetch_pieces([cold])
    rec["cold_fetch_4MB_ms"] = (time.perf_counter() - t0) * 1e3

    ix = torch.from_numpy(rng.integers(-30, 30, (36864, 576), np.int32)) \
        .to(dev)
    rec["fetch_ix_84.9MB"] = fetch_case(ix)
    rec["fetch_12MB"] = fetch_case(ix.view(-1)[:3 << 20])
    del ix
    rec["upload_wav_42.5MB"] = upload_case(
        rng.integers(-3000, 3000, 21233664, np.int16), dev)
    rec["upload_12MB"] = upload_case(
        rng.integers(0, 255, 12 << 20, np.uint8), dev)

    mp3 = np.load(os.path.join(REPO, "tests", "golden",
                               "encode_golden.npz"))["mp3_bytes"].tobytes()
    parsed = dh.parse_mp3((mp3 + b"\0") * 256, 0)
    host = dp.index_escapes(dp.host_prepare(parsed))
    keyed = {k: np.ascontiguousarray(host[k]) for k in dp.TORCH_KEYS}
    rec["prep_bytes"] = int(sum(a.nbytes for a in keyed.values()))
    rec["upload_prep"] = _turns({
        "pageable .to() a key": lambda: {
            k: torch.from_numpy(a).to(dev) for k, a in keyed.items()},
        "put_tree (prep_to_torch)": lambda: X.put_tree(keyed, dev)})

    p = C.measure_probe(dev)
    rec["probe"] = p.__dict__
    rec["pool_bytes"] = X.pool(dev).nbytes()

    def say(name, case):
        print(f"[{card}] {name}: " + "; ".join(
            f"{k} {v['median_ms']:.3f} ms" for k, v in case.items()),
            flush=True)

    for name in ("fetch_ix_84.9MB", "fetch_12MB", "upload_wav_42.5MB",
                 "upload_12MB", "upload_prep"):
        say(name, rec[name])
    print(f"[{card}] cold pool, first 4 MB fetch: "
          f"{rec['cold_fetch_4MB_ms']:.3f} ms; prep {rec['prep_bytes']} B; "
          f"pool {rec['pool_bytes']} B", flush=True)
    print(f"[{card}] measure_probe: {json.dumps(rec['probe'])}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {os.path.relpath(args.out, REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
