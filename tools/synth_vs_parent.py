#!/usr/bin/env python3
"""The fused synthesis kernel against the float32 synthesis path it replaced.

    git archive <parent commit> | tar -x -C build/parent
    python3 tools/synth_vs_parent.py --parent build/parent \
        [--out chiprun_out/synth_vs_parent.json]

Run from the root of a checkout, on one CUDA card. ``--parent`` is a copy of
a commit whose decode plane still synthesised in four steps: the overlap-add
and frequency inversion as torch ops, the V matmul as fixed 65,536-row
blocks of one batched cuBLAS matmul (``_row_matmul``, kept here), the
FIR-only kernel ``csrc/synth_fir.cu``, then the int16
conversion and the channel interleave as two more torch passes. This script
builds that commit's ``synth_fir.cu`` with the port's nvcc flags, rebuilds
the old path around it from the same operations, and times it beside the
fused kernel (``ops/synth.synth_fused``, int16 epilogue) on the song's own
IMDCT blocks in float32 (``chip_smoke.py``'s song: the 320 kbps golden
re-encode with one zero byte appended, 256 copies, 240.7 s of 44.1 kHz
stereo), CUDA events, in the order old, fused, fused, old. The old path is
timed in two parts: "overlap + synth V + K1" (float PCM) and the whole of
it to interleaved int16. It also counts the int16 samples on which the two
paths differ (another V summation order: at most 1 LSB). It writes the
record as JSON and prints it with the card's ``nvidia-smi`` name and power
limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mp3stego_tpu_torch.bitstream import decoder_host as dh  # noqa: E402
from mp3stego_tpu_torch.ops import _cuda  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as dp  # noqa: E402
from mp3stego_tpu_torch.ops import synth as sf  # noqa: E402

SONG_COPIES = 256


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _old_fir(parent: str, build_dir: str):
    """The parent's FIR-only kernel, built with the port's flags: a call
    (v_ext (ch, 15 + S, 64) float32, S) -> (ch, S, 32)."""
    src = os.path.join(parent, "mp3stego_tpu_torch", "csrc", "synth_fir.cu")
    so = os.path.join(build_dir, "libsynth_fir_parent.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.synth_fir_f32.restype = ctypes.c_int
    lib.synth_fir_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_void_p]
    window = sf._tables(torch.float32, torch.device("cuda"))[1]

    def fir(v_ext: torch.Tensor, s: int) -> torch.Tensor:
        out = torch.empty((v_ext.shape[0], s, 32), dtype=torch.float32,
                          device=v_ext.device)
        rc = lib.synth_fir_f32(v_ext.data_ptr(), window.data_ptr(),
                               out.data_ptr(), v_ext.shape[0], s,
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old synth_fir launch failed: CUDA error {rc}")
        return out

    return fir


def _row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` as 65,536-row blocks of one batched
    matmul, the last zero-padded: the parent plane's matmul."""
    rows = 1 << 16
    k, n = w.shape
    a = x.reshape(-1, k)
    m = a.shape[0]
    nb = -(-m // rows)
    a = torch.nn.functional.pad(a, (0, 0, 0, nb * rows - m))
    out = torch.bmm(a.reshape(nb, rows, k), w.expand(nb, k, n))
    return out.reshape(-1, n)[:m].reshape(x.shape[:-1] + (n,))


def old_path(blk: torch.Tensor, fir, to_int16: bool) -> torch.Tensor:
    """The parent's synthesis from IMDCT blocks (ch, T, 32, 36): overlap-add
    and inversion, V by ``_row_matmul``, 15 zero rows in front, the FIR
    kernel; with ``to_int16`` the saturating int16 pass and the interleave
    (T * 576, ch)."""
    ch, tt = blk.shape[0], blk.shape[1]
    n_t, _, inv = sf._tables(blk.dtype, blk.device)
    tail = blk[..., 18:]
    prev = torch.cat([torch.zeros_like(tail[:, :1]), tail[:, :-1]], dim=1)
    y = (blk[..., :18] + prev) * inv
    st = y.transpose(2, 3).reshape(ch, tt * 18, 32)
    v = _row_matmul(st, n_t)
    v_ext = torch.cat([v.new_zeros((ch, 15, 64)), v], dim=1)
    pcm = fir(v_ext, tt * 18).reshape(ch, tt, 576)
    if not to_int16:
        return pcm
    x = (pcm * 32767.0).clamp(-32768.0, 32767.0)
    i16 = x.to(torch.int32).to(torch.int16)
    return i16.permute(1, 2, 0).reshape(-1, ch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a copy of the commit with csrc/synth_fir.cu")
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "synth_vs_parent.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    with tempfile.TemporaryDirectory() as build_dir:
        fir = _old_fir(os.path.abspath(args.parent), build_dir)
        mp3 = np.load(os.path.join(REPO, "tests", "golden",
                                   "encode_golden.npz"))["mp3_bytes"]
        song = (mp3.tobytes() + b"\0") * SONG_COPIES
        prep = dp.prep_to_torch(dp.host_prepare(dh.parse_mp3(song)), dev)
        blk = dp.granule_blocks(prep, torch.float32)[:2].contiguous()
        fused = sf.synth_fused(blk, "int16", 2)[0]
        old = old_path(blk, fir, True)
        torch.cuda.synchronize()
        d = (fused.int() - old.int()).abs()
        fns = {"old_float": lambda: old_path(blk, fir, False),
               "old_int16": lambda: old_path(blk, fir, True),
               "fused_int16": lambda: sf.synth_fused(blk, "int16", 2)}
        times = {k: [] for k in fns}
        for which in ("old_float", "old_int16", "fused_int16", "fused_int16",
                      "old_int16", "old_float"):
            times[which].append(_time_ms(fns[which]))
    record = dict(card=card, torch=torch.__version__,
                  blk=list(blk.shape), times_ms=times,
                  int16_samples=int(d.numel()),
                  int16_differing=int((d != 0).sum()),
                  int16_max_diff=int(d.max()))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
