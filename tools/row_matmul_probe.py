#!/usr/bin/env python3
"""Row-count invariance and cost of the decode plane's blocked matmuls.

    python3 tools/row_matmul_probe.py [--out chiprun_out/row_matmul_probe.json]

Run from the root of a checkout, on one CUDA card. The float32 decode plane
runs its IMDCT matmuls through ``decode_plane._row_matmul`` (fixed 65,536-row
blocks of one batched matmul) so that a row rounds alike whatever the row
count: a file then decodes to the same bits alone and inside a batch (the
synthesis is row-local by construction: one fused kernel per (file,
channel) row). This script checks that claim and what it costs:

* invariance: for each of the two matmuls (long IMDCT (18, 36), short
  IMDCT (6, 12)), a seeded operand with the rows of a
  16-file stereo chunk of 30 s files (the batched decode's largest chunk);
  its first m rows multiplied alone against the same rows of the whole
  product, for m in 1,000, 70,000 and the song's row count, once through
  one plain ``torch.matmul`` and once through ``_row_matmul``: bitwise
  equal or not, and the largest difference;
* cost: each matmul alone at the song's row count, and the song's whole
  device plane (``decode_granules``), blocked against plain, CUDA events,
  in the order blocked, plain, plain, blocked.

The song is ``chip_smoke.py``'s: the 320 kbps golden re-encode with one zero
byte appended, 256 copies (240.7 s of 44.1 kHz stereo). It writes the record
as JSON and prints it with the card's ``nvidia-smi`` name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mp3stego_tpu_torch.bitstream import decoder_host as dh  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as dp  # noqa: E402

SONG_COPIES = 256
SONG_T = 2 * 36 * SONG_COPIES            # granules per channel of the song
CHUNK_T = 2298                           # t_max of a chunk of 30 s slices
# name, K, N, rows per granule and channel
MATMULS = (("imdct_long", 18, 36, 32), ("imdct_short", 6, 12, 96))


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def _time_ms(fn, iters: int = 10) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _ab(fns: dict, bind) -> dict:
    """Times of each variant in the order a, b, b, a; ``bind(name)`` returns
    the call for that variant."""
    out = {name: [] for name in fns}
    a, b = list(fns)
    for name in (a, b, b, a):
        out[name].append(_time_ms(bind(name)))
    return out


def invariance(dev) -> list:
    rows = []
    for name, k, n, per in MATMULS:
        rng = np.random.default_rng(k)
        song_m, chunk_m = 2 * SONG_T * per, 2 * 16 * CHUNK_T * per
        x = torch.from_numpy(rng.standard_normal((chunk_m, k))
                             .astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n))
                             .astype(np.float32)).to(dev)
        for fname, fn in (("plain", _plain), ("blocked", dp._row_matmul)):
            whole = fn(x, w)
            for m in (1000, 70000, song_m):
                part = fn(x[:m].clone(), w)
                d = (whole[:m] - part).abs()
                rows.append(dict(matmul=name, k=k, n=n, fn=fname,
                                 whole_rows=chunk_m, rows=m,
                                 equal=bool(torch.equal(whole[:m], part)),
                                 rows_differing=int((d.amax(1) > 0).sum()),
                                 max_abs_diff=float(d.max())))
            del whole
    return rows


def cost(dev) -> dict:
    out = {}
    for name, k, n, per in MATMULS:
        rng = np.random.default_rng(k)
        x = torch.from_numpy(rng.standard_normal((2 * SONG_T * per, k))
                             .astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n))
                             .astype(np.float32)).to(dev)
        fns = {"blocked": dp._row_matmul, "plain": _plain}
        out[name] = _ab(fns, lambda f: (lambda: fns[f](x, w)))
    mp3 = np.load(os.path.join(REPO, "tests", "golden", "encode_golden.npz"))
    song = (mp3["mp3_bytes"].tobytes() + b"\0") * SONG_COPIES
    prep = dp.prep_to_torch(dp.host_prepare(dh.parse_mp3(song)), dev)
    blocked = dp._row_matmul

    def plane(which):
        def run():
            dp._row_matmul = blocked if which == "blocked" else _plain
            try:
                dp.decode_granules(prep, torch.float32)
            finally:
                dp._row_matmul = blocked
        return run

    out["device_plane"] = _ab({"blocked": 0, "plain": 0}, plane)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "row_matmul_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    record = dict(card=card, torch=torch.__version__,
                  invariance=invariance(dev), cost_ms=cost(dev))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    for r in record["invariance"]:
        print(f"{r['matmul']} {r['fn']}: first {r['rows']} of "
              f"{r['whole_rows']} rows alone {'==' if r['equal'] else '!='}"
              f" in the whole product ({r['rows_differing']} rows differ, "
              f"max |d| {r['max_abs_diff']:.3e})")
    for name, t in record["cost_ms"].items():
        print(f"{name} ms: blocked {t['blocked']}, plain {t['plain']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
