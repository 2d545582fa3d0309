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

Each worker also times the Q31 analysis K3 alone at the three shapes its
launches take (CUDA events behind a card spin, the median of 10 after a
warm-up): the song's two channels of 18,432 granules, a 512-frame
streaming window and a 7-frame one (each sliced as ``models/streaming``
slices it: one granule of MDCT context, ``skip=1``), and, where the tree
has it, the song read from the WAV's interleaved buffer; each shape's
spectra must be the same in all four workers. It keeps K3's ``-Xptxas -v``
lines, its CTAs an SM (the runtime's query, or an estimate from the
registers and shared memory where the tree has no query) and writes the
kernel's SASS to ``chiprun_out/k3_<the tree's directory>.sass`` with a
count of each loop's instructions by pipe. ``--alone`` times only the
kernels alone.

Each worker also times the cost grid K5 alone (``quant_batch._launch``,
CUDA events behind a card spin, the median of 10 after a warm-up) on the
song's 36,864 lanes and on the seeded song's (``chip_smoke.seeded_song``,
as long as the song and repeating nothing), each clear (7 rows) and with
the hide channels (27 rows); the spectra are computed once, before the
workers, by this checkout's K3, and the bound of each (``chip_smoke.
grid_need_bound``, and PR 15's ``grid_bound``) from the plain version's
work counts on them. Each grid's SHA-256 must be the same in all four
workers. It keeps K5's ``-Xptxas -v`` lines and CTAs an SM and writes its
SASS to ``chiprun_out/k5_<the tree's directory>.sass`` with a count of
each loop's instructions by pipe. ``--alone --only grid`` times K5 alone
and nothing else.
"""

import collections
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import vs_parent

SONG_COPIES = 256
HIDE_SHARE = 0.9
GRID_DATA = ("song", "seeded song")


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


def _card_ms(fn, runs: int = 10) -> float:
    """The median card time of ``fn()`` by CUDA events, each call issued
    behind a spin of the card so that the events hold the card's time and
    not the host's enqueue."""
    import torch
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the pipe of each SASS opcode (by its first word): the integer
# multiply-adds issue to the FMA pipe, the other integer and logic
# operations to the ALU pipe, loads and stores to the memory pipe
PIPES = (("fma", ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "IDP")),
         ("alu", ("IADD3", "LOP3", "SHF", "SHL", "SHR", "ISETP", "SEL",
                  "PRMT", "MOV", "LEA", "IABS", "IMNMX", "VIADD", "ISCADD",
                  "P2R", "R2P", "PLOP3", "CS2R", "S2R", "S2UR", "SGXT",
                  "BMSK", "FLO", "POPC", "BREV", "VIMNMX", "UIADD3",
                  "ULDC", "UMOV", "ULOP3", "USHF", "UISETP", "UIMAD",
                  "ULEA", "USEL", "UPRMT", "USGXT", "R2UR")),
         ("mem", ("LDS", "STS", "LDG", "STG", "LDC", "LDGSTS", "LDSM",
                  "LD", "ST", "ATOMS", "ATOMG", "RED", "LDGDEPBAR",
                  "DEPBAR", "SHFL")))


# the loads from shared, global or local memory, and the floating-point
# products, by opcode
LOADS = ("LDS", "LDG", "LD", "LDL", "LDSM")
PRODUCTS = ("DMUL", "FMUL")


def _pipe(op: str) -> str:
    head = op.split(".")[0]
    for pipe, ops in PIPES:
        if head in ops:
            return pipe
    return "other"


def sass_loops(sass: str, kernel: str) -> dict:
    """``kernel``'s SASS (``cuobjdump -sass``) summed by opcode: the whole
    function, and each loop body (the instructions from a backward
    branch's target to the branch) by pipe, with its ``IMAD.HI``, load
    and floating-point product counts."""
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if inside and m:
            body.append((int(m[1], 16), m[3], m[4]))
    ops = collections.Counter(op.split(" ")[0] for _, op, _ in body)
    loops = []
    for i, (at, op, args) in enumerate(body):
        target = re.match(r"\s*(?:`?\()?\s*(0x[0-9a-f]+)", args)
        if op.startswith("BRA") and target and int(target[1], 16) <= at:
            lo = int(target[1], 16)
            part = [o for a, o, _ in body if lo <= a <= at]
            pipes = collections.Counter(_pipe(o) for o in part)
            loops.append(dict(
                first=hex(lo), last=hex(at), instructions=len(part),
                imad_hi=sum(o.startswith("IMAD.HI") for o in part),
                loads=sum(o.split(".")[0] in LOADS for o in part),
                products=sum(o.split(".")[0] in PRODUCTS for o in part),
                pipes=dict(pipes), opcodes=dict(collections.Counter(
                    o.split(".")[0] for o in part).most_common(12))))
    return dict(instructions=len(body),
                imad_hi=sum(n for o, n in ops.items()
                            if o.startswith("IMAD.HI")),
                pipes=dict(collections.Counter(_pipe(o) for _, o, _ in
                                               body)),
                opcodes=dict(collections.Counter(
                    o.split(".")[0] for _, o, _ in body).most_common()),
                loops=loops)


def _estimate_ctas(regs: int, smem: int, threads: int) -> int:
    """CTAs an SM from a kernel's registers a thread and shared memory a
    CTA on an H100 (65,536 registers in 4 quarters, allocated 8 a thread
    a warp; 233,472 B of shared memory, 1 KB of it reserved a CTA; 2,048
    threads): for a tree whose kernel has no occupancy query."""
    warps = threads // 32
    per_quarter = 16384 // (-(-regs // 8) * 8 * 32)
    return min(4 * per_quarter // warps, 233472 // (smem + 1024),
               2048 // threads, 32)


def analysis_alone(wav: str, dev, sha: dict, label: str) -> tuple:
    """K3 alone at its main path's shapes: (ms of each shape with its
    (channels, granules, skip), the build's ptxas lines and CTAs an SM,
    the SASS count); each shape's spectra go into ``sha``."""
    import numpy as np
    import torch
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.ops import _cuda
    from mp3stego_tpu_torch.ops import encode_plane as EP
    from mp3stego_tpu_torch.utils.wav import read_wav
    enc = MP3Encoder(read_wav(wav, 320), device=dev)
    nf = enc._num_frames()
    gpf = enc.granules_per_frame
    tg = nf * gpf
    full = torch.from_numpy(EP._padded_streams(
        enc._channel_streams_i16(nf), tg)).to(dev)
    shapes = {"song": (full, 0)}
    lo = 1 + tg // 8
    for frames in (512, 7):
        hi = lo + frames * gpf
        shapes[f"{frames}-frame window"] = (
            full[:, (lo - 1) * 576:hi * 576 + EP._PAST].contiguous(), 1)
    fns = {k: (lambda f=f, s=s: EP.analysis_stream(f, skip=s))
           for k, (f, s) in shapes.items()}
    dims = {k: (f.shape[0], (f.shape[1] - EP._PAST) // 576, s)
            for k, (f, s) in shapes.items()}
    if hasattr(EP, "analysis_interleaved"):
        nch = enc.wav.num_of_channels
        buf = torch.from_numpy(np.ascontiguousarray(
            enc.wav.buffer[:nch * tg * 576])).to(dev)
        fns["song, interleaved"] = lambda: EP.analysis_interleaved(
            buf, nch, tg)
        dims["song, interleaved"] = (nch, tg, 0)
    ms = {}
    for name, fn in fns.items():
        sha[f"K3 {name}"] = hashlib.sha256(
            fn().cpu().numpy().tobytes()).hexdigest()
        ms[name] = _card_ms(fn)
    info = _cuda.builds["analysis"]
    ptxas = [line.strip() for line in info["log"].splitlines()
             if "registers" in line or "spill" in line]
    if hasattr(EP, "occupancy"):
        occ = dict(EP.occupancy(dev), source="the runtime's query")
    else:
        g, smem = EP.tile()
        res = _cuda.ptxas_resources("analysis", "analysis_kernel")
        occ = dict(ctas=_estimate_ctas(res["registers"],
                                       smem + res["smem"], 256),
                   warps=8, smem=smem, source="estimated from ptxas")
    sass = _sass(info["path"], "analysis_kernel", f"k3_{label}.sass")
    return dict(ms=ms, dims=dims), dict(ptxas=ptxas, **occ), sass


def _sass(lib: str, kernel: str, name: str) -> dict:
    """``cuobjdump -sass`` of the library ``lib`` written to
    ``chiprun_out/<name>``, and ``kernel``'s counts (``sass_loops``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        return dict(error=(r.stdout + r.stderr)[-2000:])
    path = os.path.join(vs_parent.REPO, "chiprun_out", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(r.stdout)
    return sass_loops(r.stdout, kernel)


def _grid_file(tmp: str, data: str) -> str:
    return os.path.join(tmp, f"grid_{data.replace(' ', '_')}.npy")


def grid_alone(tmp: str, dev, sha: dict, label: str) -> dict:
    """K5 alone on the song's and the seeded song's spectra, clear and with
    the hide channels: the ms of each, the build's ptxas lines, CTAs and
    warps an SM, and the SASS count; each grid goes into ``sha``."""
    import numpy as np
    import torch
    from mp3stego_tpu_torch.ops import _cuda
    from mp3stego_tpu_torch.ops import quant_batch as QB
    with open(os.path.join(tmp, "grid.json")) as f:
        inputs = json.load(f)
    band = inputs["band"]
    ms = {}
    for data in GRID_DATA:
        xr = torch.from_numpy(np.load(_grid_file(tmp, data))).to(dev)
        for rows, what in ((QB.ROWS_CLEAR, "clear"),
                           (QB.ROWS_HIDE, "hide channels")):
            name = f"{data}, {what}"
            fn = lambda: QB._launch(xr, band, rows)  # noqa: E731
            sha[f"K5 {name}"] = hashlib.sha256(
                fn().cpu().numpy().tobytes()).hexdigest()
            ms[name] = _card_ms(fn)
        del xr
    info = _cuda.builds["cost_grid"]
    ptxas = [line.strip() for line in info["log"].splitlines()
             if "registers" in line or "spill" in line]
    return dict(ms=ms, ptxas=ptxas, bounds=inputs["bounds"],
                **QB.occupancy(dev),
                sass=_sass(info["path"], "cost_grid_kernel",
                           f"k5_{label}.sass"))


def worker(root: str, tmp: str, alone: bool = False,
           only: str = None) -> dict:
    """Times every encode path of the tree at ``root`` on the card; with
    ``alone`` the kernels alone only (``only="grid"``: K5 only)."""
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
    label = os.path.basename(os.path.abspath(root))
    if only == "grid":
        return dict(root=root, walls_ms={}, sha=sha,
                    grid_alone=grid_alone(tmp, dev, sha, label))

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
    k3, k3_build, k3_sass = analysis_alone(wav, dev, sha, label)
    alone_record = dict(root=root, search_alone_ms=k4_ms,
                        search_build=k4_build, analysis_alone=k3,
                        analysis_build=k3_build, analysis_sass=k3_sass,
                        grid_alone=grid_alone(tmp, dev, sha, label))
    if alone:
        return dict(walls_ms={}, analysis_stage_ms={}, sha=sha,
                    **alone_record)
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
    return dict(walls_ms=out, analysis_stage_ms=stage, sha=sha,
                **alone_record)


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
    _write_grid_inputs(tmp)


def _write_grid_inputs(tmp: str) -> None:
    """K5's inputs: the song's spectra and the seeded song's (this
    checkout's K3 on the card), and in ``grid.json`` their band row and the
    bounds of each from the plain version's work counts."""
    import numpy as np
    import torch
    from chip_smoke import grid_bound, grid_need_bound, seeded_song
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.ops import quant_batch as QB
    from mp3stego_tpu_torch.utils.wav import read_wav
    dev = torch.device("cuda")
    song = os.path.join(tmp, "song.wav")
    wavs = {"song": song, "seeded song": os.path.join(tmp, "seeded.wav")}
    seeded_song(wavs["seeded song"], read_wav(song, 320).num_of_samples
                / 44100)
    band, bounds = None, {}
    for data in GRID_DATA:
        enc = MP3Encoder(read_wav(wavs[data], 320), device=dev)
        xr = enc._analysis_device(enc._num_frames())
        band = enc.band_row
        np.save(_grid_file(tmp, data), xr.cpu().numpy())
        work = {}
        QB.cost_all_steps_torch(xr, band, False, work=work)
        for rows, what in ((QB.ROWS_CLEAR, "clear"),
                           (QB.ROWS_HIDE, "hide channels")):
            ms, by, nbytes, ops = grid_need_bound(xr.shape[0], rows, work)
            pr15 = grid_bound(xr.shape[0], rows, work)
            bounds[f"{data}, {what}"] = dict(
                lanes=xr.shape[0], bound_ms=ms, bound_by=by, bytes=nbytes,
                operations=ops, bound_pr15_ms=pr15[0],
                operations_pr15=pr15[3], **work)
        del xr
    torch.cuda.empty_cache()
    with open(os.path.join(tmp, "grid.json"), "w") as f:
        json.dump(dict(band=band, bounds=bounds), f)


def main() -> int:
    args = vs_parent.parse_args(__doc__, "encode_vs_parent.json",
                                alone=True, only=("grid",))
    if args.worker:
        print(json.dumps(worker(args.worker, args.tmp, args.alone,
                                args.only)))
        return 0
    if args.only and not args.alone:
        raise SystemExit("--only takes --alone")
    card, runs, med = vs_parent.compare(__file__, args, _write_inputs)
    k5 = {}
    for name, bound in runs[0]["grid_alone"]["bounds"].items():
        k5[name] = dict(bound)
        for which in ("parent", "change"):
            times = sorted(r["grid_alone"]["ms"][name] for r in runs
                           if r["tree"] == which)
            k5[name][which] = dict(ms=times, share_of_bound=[
                bound["bound_ms"] / t for t in times],
                share_of_bound_pr15=[bound["bound_pr15_ms"] / t
                                     for t in times])
    grid_build = {r["tree"]: {k: v for k, v in r["grid_alone"].items()
                              if k not in ("ms", "bounds")}
                  for r in runs[::-1]}
    if args.only == "grid":
        vs_parent.write(args.out, card, runs, med, grid_alone=k5,
                        grid_build=grid_build)
        return 0
    sys.path.insert(0, vs_parent.REPO)
    from chip_smoke import analysis_bound
    alone, k3 = {}, {}
    for which in ("parent", "change"):
        mine = [r for r in runs if r["tree"] == which]
        for name in runs[0]["search_alone_ms"]:
            alone.setdefault(name, {})[which] = sorted(
                r["search_alone_ms"][name] for r in mine)
        for name, dims in mine[0]["analysis_alone"]["dims"].items():
            bound = analysis_bound(*dims)
            bound1 = analysis_bound(*dims, per_product=1)
            times = sorted(r["analysis_alone"]["ms"][name] for r in mine)
            k3.setdefault(name, dict(
                dims=dims, bound_ms=bound[0], bound_by=bound[1],
                bound_ms_1_cycle_a_product=bound1[0]))[which] = dict(
                ms=times, share_of_bound=[bound[0] / t for t in times],
                share_of_bound_1_cycle=[bound1[0] / t for t in times])
    vs_parent.write(args.out, card, runs, med, analysis_stage_ms=[
        (r["tree"], r["analysis_stage_ms"]) for r in runs],
        search_alone_ms=alone, search_build={
            r["tree"]: r["search_build"] for r in runs[::-1]
            if r["search_build"]["ptxas"]},
        analysis_alone=k3, analysis_build={
            r["tree"]: r["analysis_build"] for r in runs[::-1]},
        grid_alone=k5, grid_build=grid_build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
