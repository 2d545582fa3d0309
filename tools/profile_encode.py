#!/usr/bin/env python3
"""Device profile of the port's encode and hide on one CUDA card.

    python3 tools/profile_encode.py [--out chiprun_out/profile_encode.json]

Run from the root of a checkout. It builds ``chip_smoke.py``'s song (the
320 kbps golden re-encode with one zero byte appended, 256 copies: 240.7 s
of 44.1 kHz stereo), decodes it on the host in float64, and then, for a
clear encode and for a hide of 90 % of the song's stego channel, takes

* the untraced wall: the median of 3 runs after a warm-up;
* one run under ``torch.profiler`` with CUDA activity only, and from its
  trace the device's busy time (the union of kernel, memcpy and memset
  intervals), the count of each, the heaviest kernels, and that run's own
  wall and stages; the idle share is 1 - busy / traced wall, both numbers
  from the same traced run (``utils.profiling.device_busy``).

It writes the record as JSON and prints a summary with the card's
``nvidia-smi`` name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mp3stego_tpu_torch import Steganography  # noqa: E402
from mp3stego_tpu_torch.models.encoder import MP3Encoder  # noqa: E402
from mp3stego_tpu_torch.utils.profiling import device_busy  # noqa: E402
from mp3stego_tpu_torch.utils.wav import read_wav  # noqa: E402

SONG_COPIES = 256
HIDE_SHARE = 0.9


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _encode(wav: str, bits: str = "") -> MP3Encoder:
    enc = MP3Encoder(read_wav(wav, 320), hide_str=bits, device="cuda")
    enc.encode()
    return enc


def _profile_case(name: str, wav: str, bits: str, tmp: str) -> dict:
    _encode(wav, bits)                                   # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _encode(wav, bits)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc = _encode(wav, bits)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    path = os.path.join(tmp, f"{name}.json")
    prof.export_chrome_trace(path)
    rec = device_busy(path, wall_ms=traced * 1e3)
    rec["traced_wall_ms"] = rec.pop("wall_ms")
    rec.update(
        wall_ms=sorted(walls)[1] * 1e3, walls_ms=[w * 1e3 for w in walls],
        traced_stages_ms={k: v * 1e3 for k, v in enc.timer.times.items()},
        hide_stats=enc.hide_stats, redo_stats=enc.redo_stats)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "profile_encode.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    card = _card_line()
    mp3 = np.load(os.path.join(REPO, "tests", "golden", "encode_golden.npz"))[
        "mp3_bytes"]
    record = {"card": card, "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        song = os.path.join(tmp, "song.mp3")
        with open(song, "wb") as f:
            f.write((mp3.tobytes() + b"\0") * SONG_COPIES)
        wav = os.path.join(tmp, "song.wav")
        Steganography(quiet=True).decode_mp3_to_wav(song, wav)
        usable = _encode(wav).hide_str_offset
        bits = "".join(np.random.default_rng(10).choice(
            ["0", "1"], size=int(usable * HIDE_SHARE)))
        record["channel_bits"], record["hide_bits"] = usable, len(bits)
        for name, b in (("clear_encode", ""), ("hide", bits)):
            rec = record[name] = _profile_case(name, wav, b, tmp)
            idle = rec["idle_share"]
            print(f"[{card}] {name}: wall {rec['wall_ms']:.1f} ms (median "
                  f"of {[round(w, 1) for w in rec['walls_ms']]}); traced "
                  f"wall {rec['traced_wall_ms']:.1f} ms, device busy "
                  f"{rec['busy_ms']:.1f} ms over {rec['counts']}, idle "
                  f"{'not measured' if idle is None else f'{idle:.3f}'}",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {os.path.relpath(args.out, REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
