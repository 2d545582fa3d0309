#!/usr/bin/env python3
"""The port's encode paths on the card against a parent commit's, in turns.

    git archive <parent commit> | tar -x -C build/parent
    python3 tools/encode_vs_parent.py --parent build/parent \
        [--out chiprun_out/encode_vs_parent.json]

Run from the root of a checkout, on one CUDA card. It writes
``chip_smoke.py``'s song (the 320 kbps golden re-encode with one zero byte
appended, 256 copies: 240.7 s of 44.1 kHz stereo) and its WAV (the host C++
float64 decode), then runs a worker process on each tree in the order
parent, this checkout, this checkout, parent. Each worker imports
``mp3stego_tpu_torch`` from its tree, warms up with one encode, and times on
the card (host clock, each run ending in a synchronise): the clear encode,
the hide of 90 % of the song's channel bits (seeded), the VBR encode at 128
kbps (each the median of 3, with the median of its "analysis+mdct (device)"
stage), the batched encode of 4 stereo 30 s slices, and the streaming
encode, clear and hidden in 512-frame windows and clear in 7-frame windows
(each once). Beside the walls it times the rate-control search K4 alone
(CUDA events around each call, issued behind a spin of the card so that
they time the card alone; the median of 10 after a warm-up):
``search_plane.search`` on the song's 36,864 lanes at the clear encode's
budgets and ``search_plane.search_windows`` on the hide's first 4,096 lanes
in cursor order; it keeps the ``-Xptxas -v`` lines of K4's build and its
CTAs and warps an SM. Every output's SHA-256, K4's rows, counts and ix
included, must be the same in all four workers. It writes the record as
JSON and prints it with the card's ``nvidia-smi`` name and power limit
(``tools/vs_parent.py`` runs the turns).
"""

import hashlib
import json
import os
import statistics
import sys
import time

import vs_parent

SONG_COPIES = 256
HIDE_SHARE = 0.9


def search_alone(wav: str, dev, sha: dict) -> tuple:
    """K4 alone on the song's lanes: (ms of each shape, the build's ptxas
    lines, CTAs and warps an SM); each shape's results go into ``sha``."""
    import numpy as np
    import torch
    from mp3stego_tpu_torch.models.encoder import _HIDE_BLOCK, MP3Encoder
    from mp3stego_tpu_torch.ops import _cuda
    from mp3stego_tpu_torch.ops import search_plane as SP
    from mp3stego_tpu_torch.utils.wav import read_wav
    enc = MP3Encoder(read_wav(wav, 320), device=dev)
    nf = enc._num_frames()
    xr = enc._analysis_device(nf)
    mb = torch.from_numpy(enc._lane_budgets(enc._plane_framing(nf)[1])) \
        .to(dev)
    # the hide's cursor order f > ch > gr (lane g = ch * tg + f * gpf + gr)
    gpf = enc.granules_per_frame
    order = (np.arange(nf)[:, None, None] * gpf
             + np.arange(2)[None, :, None] * (nf * gpf)
             + np.arange(gpf)[None, None, :]).reshape(-1)
    blk = torch.from_numpy(order[:_HIDE_BLOCK]).to(dev)
    xb, mbb = xr[blk], mb[blk]
    band = enc.band_row
    ms = {}
    for name, fn in (
            ("clear search", lambda: SP.search(xr, mb, band)),
            ("hide window block", lambda: SP.search_windows(xb, mbb, band))):
        res = fn()
        h = hashlib.sha256()
        for k in SP.ROWS + SP.COUNTS + ("ix",):
            h.update(res[k].cpu().numpy().tobytes())
        sha[f"K4 {name}"] = h.hexdigest()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # the card spins while the host enqueues the call, so that the
            # events hold the kernel's time and not the host's
            torch.cuda._sleep(1_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms[name] = statistics.median(times)
    ptxas = [line.strip() for line in
             _cuda.builds["search"]["log"].splitlines()
             if "registers" in line or "spill" in line]
    # a tree from before the occupancy query fixed its grid by constants
    occ = (SP.occupancy(dev) if hasattr(SP, "occupancy")
           else dict(ctas=SP.CTAS_PER_SM, warps=SP._WARPS))
    return ms, dict(ptxas=ptxas, **occ)


def worker(root: str, tmp: str) -> dict:
    """Times every encode path of the tree at ``root`` on the card."""
    vs_parent.import_tree(root)
    import numpy as np
    import torch
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.models.streaming import encode_file_streaming
    from mp3stego_tpu_torch.parallel import encode_files_batched
    from mp3stego_tpu_torch.utils.wav import read_wav, write_wav
    dev = torch.device("cuda")
    wav = os.path.join(tmp, "song.wav")
    out, sha, stage = {}, {}, {}

    def encode(bits="", kbps=320, vbr=False):
        enc = MP3Encoder(read_wav(wav, kbps), hide_str=bits, device=dev,
                         vbr=vbr)
        enc.encode()
        torch.cuda.synchronize()
        return enc

    def timed(name, fn, runs):
        walls, res = [], None
        for _ in range(runs):
            t0 = time.perf_counter()
            res = fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = walls
        return res

    def stages(name, encs):
        ms = sorted(e.timer.times["analysis+mdct (device)"] * 1e3
                    for e in encs)
        stage[name] = ms[len(ms) // 2]

    usable = encode().hide_str_offset                       # warm-up
    k4_ms, k4_build = search_alone(wav, dev, sha)
    bits = "".join(np.random.default_rng(11).choice(
        ["0", "1"], size=int(usable * HIDE_SHARE)))
    encs = []
    timed("clear encode", lambda: encs.append(encode()), 3)
    stages("clear encode", encs)
    sha["clear encode"] = hashlib.sha256(encs[-1].out_buffer).hexdigest()
    encs = []
    timed("hide encode", lambda: encs.append(encode(bits)), 3)
    stages("hide encode", encs)
    sha["hide encode"] = hashlib.sha256(encs[-1].out_buffer).hexdigest()
    encs = []
    timed("VBR encode", lambda: encs.append(encode(kbps=128, vbr=True)), 3)
    stages("VBR encode", encs)
    sha["VBR encode"] = hashlib.sha256(encs[-1].out_buffer).hexdigest()

    pcm = read_wav(wav, 320).buffer.reshape(-1, 2)
    n30 = 30 * 44100
    jobs = []
    for k in range(4):
        a = k * (pcm.shape[0] - n30) // 3
        path = os.path.join(tmp, f"{os.getpid()}_{k}.wav")
        write_wav(path, 44100, pcm[a:a + n30])
        jobs.append((path, path[:-3] + "mp3"))
    timed("batched encode", lambda: (encode_files_batched(jobs, device=dev),
                                     torch.cuda.synchronize()), 1)
    h = hashlib.sha256()
    for _, mp3 in jobs:
        with open(mp3, "rb") as f:
            h.update(f.read())
    sha["batched encode"] = h.hexdigest()
    mp3 = os.path.join(tmp, f"{os.getpid()}_stream.mp3")
    for name, chunk, hide in (("streaming clear, 512-frame windows", 512, ""),
                              ("streaming hide, 512-frame windows", 512, bits),
                              ("streaming clear, 7-frame windows", 7, "")):
        timed(name, lambda: (encode_file_streaming(
            wav, mp3, 320, chunk, hide_str=hide, device=dev),
            torch.cuda.synchronize()), 1)
        with open(mp3, "rb") as f:
            sha[name] = hashlib.sha256(f.read()).hexdigest()
    return dict(root=root, walls_ms=out, analysis_stage_ms=stage,
                search_alone_ms=k4_ms, search_build=k4_build, sha=sha)


def _write_inputs(tmp: str) -> None:
    """The song and its WAV (the host C++ float64 decode)."""
    import numpy as np
    sys.path.insert(0, vs_parent.REPO)
    from mp3stego_tpu_torch import Steganography
    mp3 = np.load(os.path.join(vs_parent.REPO, "tests", "golden",
                               "encode_golden.npz"))["mp3_bytes"]
    song = os.path.join(tmp, "song.mp3")
    with open(song, "wb") as f:
        f.write((mp3.tobytes() + b"\0") * SONG_COPIES)
    Steganography(quiet=True, device="cpu").decode_mp3_to_wav(
        song, os.path.join(tmp, "song.wav"))


def main() -> int:
    args = vs_parent.parse_args(__doc__, "encode_vs_parent.json")
    if args.worker:
        print(json.dumps(worker(args.worker, args.tmp)))
        return 0
    card, runs, med = vs_parent.compare(__file__, args, _write_inputs)
    alone = {}
    for name in runs[0]["search_alone_ms"]:
        for which in ("parent", "change"):
            alone.setdefault(name, {})[which] = sorted(
                r["search_alone_ms"][name] for r in runs
                if r["tree"] == which)
    vs_parent.write(args.out, card, runs, med, analysis_stage_ms=[
        (r["tree"], r["analysis_stage_ms"]) for r in runs],
        search_alone_ms=alone, search_build={
            r["tree"]: r["search_build"] for r in runs[::-1]
            if r["search_build"]["ptxas"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
