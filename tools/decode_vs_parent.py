#!/usr/bin/env python3
"""The port's decode paths on the card against a parent commit's, in turns.

    git archive <parent commit> | tar -x -C build/parent
    python3 tools/decode_vs_parent.py --parent build/parent \
        [--out chiprun_out/decode_vs_parent.json]

Run from the root of a checkout, on one CUDA card. It writes
``chip_smoke.py``'s song (the 320 kbps golden re-encode with one zero byte
appended, 256 copies: 240.7 s of 44.1 kHz stereo) and a batch of 32 files
(24 slices of 1,148 frames, 30 s, cut at frames spread over the song, the 5
multirate and the 3 MPEG-2/2.5 goldens), then runs a worker process on each
tree in the order parent, this checkout, this checkout, parent. Each worker
imports ``mp3stego_tpu_torch`` from its tree and times on the card, each
path after one untimed run: the façade decode of the song with the
defaults (float64) and in float32 (host clock, 3 runs, with the median of
each ``Decoder`` stage), the device plane alone on the song's prep
(``decode_granules_i16`` in both dtypes, CUDA events, 10 calls), the
batched decode of the 32 files to int16 in float64 and in float32 and the
streaming decode of the song (host clock, 3 runs, each ending in a
synchronise); and, on the host's CPU, the façade decode of the song in
float32 (``device="cpu"``, host clock, 3 runs after one untimed). The record
gives each path's median over both workers of a tree. The float64 outputs'
SHA-256 must be the same in all four workers; each worker holds its float32
outputs, the card's and the CPU's, within 1 int16 LSB of its float64 ones
(on fewer than 1e-3 of the song's and the slices' samples, 2e-3 of the tone
goldens'). It writes the record as JSON and prints it with the card's
``nvidia-smi`` name and power limit (``tools/vs_parent.py`` runs the
turns).

``--alone`` times only the kernels alone (CUDA events behind a card spin,
the median of 10 after a warm-up): the Huffman bit-scan and K2
(``--only scan`` or ``--only granule`` one of them). The scan runs on the
lanes (``huffman_device.pack``) of the song, of the song with 256 seeded
bit flips (``chip_smoke.flipped_song``) and of a 30 s mono stream
(``chip_smoke.mono_pcm`` encoded at 128 kbps by the host C++ engine), each
beside its bound (``chip_smoke.huffman_bound``) and, where the tree has
``scan_chain``, beside the same walk without the plane's stores. Each
plane's SHA-256 must be the same in all four workers. It keeps the
kernel's ``-Xptxas -v`` resources and resident warps an SM (the runtime's
query, or an estimate where the tree has none) and writes its SASS as
``scan_<the tree's directory>.sass`` into the default ``--out``'s
directory, with each loop's loads and the loads of the pair loop (the
loop of the most instructions; one codeword an iteration, every path
counted). K2 runs in float32 and
float64 on three inputs: the song's int8 plane with its escapes, the same
granules as the int32 plane the device Huffman decode hands over, and a
song-sized synthetic prep of every block type (``chip_smoke.synthetic_prep``
of 18,432 granules: short, start, mixed, MS, intensity, linbits), each
beside its bound (``chip_smoke.granule_bound``). Each output's SHA-256 must
be the same in all four workers. It keeps each instantiation's ``-Xptxas
-v`` resources and resident warps an SM (the runtime's query, or an
estimate from the registers and shared memory where the tree has none),
and writes the kernel's SASS as ``k2_<the tree's directory>.sass`` into
the default ``--out``'s directory, with, for each instantiation, the
loads and floating-point products of the innermost loop that holds the
most products (the IMDCT's).
"""

import hashlib
import importlib.util
import json
import os
import sys
import time

import vs_parent

SONG_COPIES = 256
SYNTH_T = 18432                      # the song's granules a channel
SLICES = 24
SLICE_FRAMES = 1148                  # 30.0 s of 1,152 samples at 44.1 kHz
MAX_LSB_RATE = 1e-3
TONE_MAX_LSB_RATE = 2e-3


def _lsb_rate(got, want) -> float:
    """The share of int16 samples off by one; raises past 1 LSB."""
    import numpy as np
    if got.shape != want.shape:
        raise AssertionError(f"{got.shape} samples vs {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if d.size and d.max() > 1:
        raise AssertionError(f"float32 off by {d.max()} LSB")
    return float((d != 0).mean()) if d.size else 0.0


def _chip_smoke():
    """This checkout's chip_smoke (a parent tree's may lack what the
    timings use), on the tree's package imported before."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(vs_parent.REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def granule_alone(tmp: str, dev, sha: dict, label: str,
                  out_dir: str) -> dict:
    """K2 alone on the song's two planes and the synthetic prep in both
    dtypes: the ms and bound of each, each instantiation's resources and
    the loads a product of its SASS (written into ``out_dir``); each
    output's digest goes into ``sha``."""
    import shutil
    import subprocess
    import torch
    import encode_vs_parent as evp
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import _cuda
    from mp3stego_tpu_torch.ops import decode_plane as dp
    chip_smoke = _chip_smoke()
    with open(os.path.join(tmp, "song.mp3"), "rb") as f:
        prep = dp.prep_to_torch(dp.host_prepare(dh.parse_mp3(f.read())), dev)
    preps = {"song, int8 plane": prep,
             "song, int32 plane": chip_smoke.dense_prep(prep),
             "synthetic, int8 plane": dp.prep_to_torch(
                 chip_smoke.synthetic_prep(SYNTH_T), dev)}
    ms, bound = {}, {}
    for name, pp in preps.items():
        for dtype in (torch.float32, torch.float64):
            key = f"{name}, {str(dtype).split('.')[-1]}"
            fn = (lambda pp=pp, dtype=dtype: dp.granule_blocks(pp, dtype))
            sha[f"K2 {key}"] = hashlib.sha256(
                fn().cpu().numpy().tobytes()).hexdigest()
            ms[key] = evp._card_ms(fn)
            bound[key] = chip_smoke.granule_bound(pp, dtype)[:2]
    info = _cuda.builds["granule"]
    sass_text = ""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", info["path"]], capture_output=True,
                       text=True, timeout=300)
    if r.returncode == 0:
        sass_text = r.stdout
        path = os.path.join(out_dir, f"k2_{label}.sass")
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(sass_text)
    kernels = {}
    for (dtype, wide), kern in chip_smoke.K2_INSTANCES.items():
        res = _cuda.ptxas_resources("granule", kern)
        if hasattr(dp, "occupancy"):
            occ = dict(dp.occupancy(dev, dtype, wide),
                       source="the runtime's query")
        else:
            occ = dict(ctas=evp._estimate_ctas(res["registers"], res["smem"],
                                               288),
                       warps=9, smem=0, source="estimated from ptxas")
        row = dict(res, ctas=occ["ctas"], warps=occ["warps"],
                   dynamic_smem=occ.get("smem", 0), source=occ["source"],
                   resident_warps=occ["ctas"] * occ["warps"])
        if sass_text:
            loops = evp.sass_loops(sass_text, kern)["loops"]
            span = [(int(lp["first"], 16), int(lp["last"], 16))
                    for lp in loops]
            inner = [lp for lp, (a, b) in zip(loops, span)
                     if not any((a, b) != (c, d) and a <= c and d <= b
                                for c, d in span)]
            top = max(inner, key=lambda lp: lp["products"], default=None)
            if top and top["products"]:
                row.update(imdct_loop=top, loads_a_product=top["loads"]
                           / top["products"])
        else:
            row["sass_error"] = (r.stdout + r.stderr)[-2000:]
        kernels[f"{str(dtype).split('.')[-1]}, "
                f"{'int32' if wide else 'int8'}"] = row
    return dict(ms=ms, bound=bound, kernels=kernels)


SCAN_INPUTS = ("song", "song, 256 bits flipped", "mono 30 s")


def _scan_file(tmp: str, name: str, part: str) -> str:
    return os.path.join(tmp, f"scan_{SCAN_INPUTS.index(name)}_{part}.npy")


def scan_alone(tmp: str, dev, sha: dict, label: str, out_dir: str) -> dict:
    """The Huffman bit-scan kernel alone on the song's lanes, the bit-flipped
    song's and the mono stream's: the ms and bound of each, the chain alone
    (where the tree has ``scan_chain``), the kernel's resources and warps an
    SM, and its SASS (written into ``out_dir``) with each loop's loads; each
    plane's digest goes into ``sha``."""
    import shutil
    import subprocess
    import numpy as np
    import torch
    import encode_vs_parent as evp
    from mp3stego_tpu_torch.ops import _cuda
    from mp3stego_tpu_torch.ops import huffman_device as hd
    chip_smoke = _chip_smoke()
    ms, chain_ms, bound = {}, {}, {}
    for name in SCAN_INPUTS:
        words, fields = (torch.from_numpy(np.load(_scan_file(tmp, name, p)))
                         .to(dev) for p in ("words", "fields"))
        fn = (lambda w=words, f=fields: hd.decode_samples(w, f))
        out = fn()
        sha[f"scan {name}"] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()
        ms[name] = evp._card_ms(fn)
        if hasattr(hd, "scan_chain"):
            chain_ms[name] = evp._card_ms(
                lambda w=words, f=fields: hd.scan_chain(w, f))
        bound[name] = chip_smoke.huffman_bound(fields, words, out)[:2]
    info = _cuda.builds["huffman"]
    kern = next(k for k in (chip_smoke.SCAN_KERNEL, "huffman_scan_kernelILb1",
                              "huffman_scan_kernel")
                if k in info["log"])
    res = _cuda.ptxas_resources("huffman", kern)
    if hasattr(hd, "occupancy"):
        occ = dict(hd.occupancy(dev), source="the runtime's query")
    else:
        occ = dict(ctas=evp._estimate_ctas(res["registers"], res["smem"],
                                           128),
                   warps=4, smem=0, source="estimated from ptxas")
    row = dict(res, ctas=occ["ctas"], warps=occ["warps"],
               dynamic_smem=occ["smem"], source=occ["source"],
               resident_warps=occ["ctas"] * occ["warps"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", info["path"]], capture_output=True,
                       text=True, timeout=300)
    if r.returncode == 0:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"scan_{label}.sass"), "w") as f:
            f.write(r.stdout)
        loops = evp.sass_loops(r.stdout, kern)
        row["instructions"] = loops["instructions"]
        row["loops"] = [{k: lp[k] for k in ("first", "last", "instructions",
                                            "loads", "opcodes")}
                        for lp in loops["loops"]]
        # the pair loop, one codeword an iteration: the loop that holds
        # the most instructions
        top = max(loops["loops"], key=lambda lp: lp["instructions"],
                  default=None)
        if top:
            row["loads_a_codeword"] = top["loads"]
            row["pair_loop_instructions"] = top["instructions"]
    else:
        row["sass_error"] = (r.stdout + r.stderr)[-2000:]
    return dict(ms=ms, chain_ms=chain_ms, bound=bound, kernel=row)


def worker(root: str, tmp: str, alone: bool = False,
           out_dir: str = "", only: str = None) -> dict:
    """Times every decode path of the tree at ``root`` on the card, and the
    float32 decode on the CPU; ``alone``: the kernels alone only, the scan
    and K2 (``only`` one of them)."""
    vs_parent.import_tree(root)
    if alone:
        import torch
        sha = {}
        label = os.path.basename(os.path.abspath(root))
        dev = torch.device("cuda")
        out = dict(root=root, walls_ms={}, sha=sha)
        if only != "granule":
            out["scan_alone"] = scan_alone(tmp, dev, sha, label, out_dir)
        if only != "scan":
            out["granule_alone"] = granule_alone(tmp, dev, sha, label,
                                                 out_dir)
        return out
    import numpy as np
    import torch
    from mp3stego_tpu_torch import Steganography
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.models.streaming import decode_file_streaming
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.parallel import decode_files_batched
    dev = torch.device("cuda")
    song = os.path.join(tmp, "song.mp3")
    with open(os.path.join(tmp, "batch.json")) as f:
        paths = json.load(f)
    wav = os.path.join(tmp, f"{os.getpid()}.wav")
    walls, stages, sha, rates = {}, {}, {}, {}

    def timed(name, fn, runs=3):
        out = fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        walls[name] = ms
        return out

    def wav_i16():
        with open(wav, "rb") as f:
            data = f.read()
        return data, np.frombuffer(data[44:], np.int16)

    s = {"float64": Steganography(quiet=True, precision="float64"),
         "float32": Steganography(quiet=True, precision="float32"),
         "float32 on the CPU": Steganography(quiet=True, precision="float32",
                                             device="cpu")}
    pcm = {}
    for precision, st in s.items():
        times = []

        def decode():
            st.decode_mp3_to_wav(song, wav)
            times.append(dict(st._last_decoder.timer.times))

        name = f"decode, {precision}"
        timed(name, decode)
        stages[name] = {k: sorted(t[k] * 1e3 for t in times[1:])[1]
                        for k in times[0]}
        data, pcm[precision] = wav_i16()
        sha[name] = hashlib.sha256(data).hexdigest()
    rates["song"] = _lsb_rate(pcm["float32"], pcm["float64"])
    rates["song on the CPU"] = _lsb_rate(pcm["float32 on the CPU"],
                                         pcm["float64"])

    with open(song, "rb") as f:
        prep = dp.prep_to_torch(dp.host_prepare(dh.parse_mp3(f.read())), dev)
    plane_ms = {}
    for dtype in (torch.float64, torch.float32):
        dp.decode_granules_i16(prep, dtype)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            dp.decode_granules_i16(prep, dtype)
        end.record()
        end.synchronize()
        plane_ms[str(dtype).split(".")[-1]] = start.elapsed_time(end) / 10
    del prep

    batch = {}
    for dtype in ("float64", "float32"):
        name = f"batched decode, {dtype}"
        batch[dtype] = timed(name, lambda: decode_files_batched(
            paths, dtype=dtype, out="int16", device=dev))
        h = hashlib.sha256()
        for a in batch[dtype]:
            h.update(np.ascontiguousarray(a).tobytes())
        sha[name] = h.hexdigest()
    for p, got, want in zip(paths, batch["float32"], batch["float64"]):
        kind = "slices" if os.path.basename(p).startswith("slice") \
            else "tones"
        rates[kind] = max(rates.get(kind, 0.0), _lsb_rate(got, want))

    timed("streaming decode, float64",
          lambda: decode_file_streaming(song, wav))
    sha["streaming decode, float64"] = hashlib.sha256(wav_i16()[0]) \
        .hexdigest()
    os.remove(wav)
    return dict(root=root, walls_ms=walls, stages_ms=stages,
                device_plane_ms=plane_ms, f32_lsb_rates=rates, sha=sha)


def _write_inputs(tmp: str, alone) -> None:
    """The song; with ``alone`` (True, or the kernel of --only) also the
    bit-scan's lanes (``SCAN_INPUTS``) unless it is "granule", else the 32
    batch files and the list of their paths."""
    import numpy as np
    sys.path.insert(0, vs_parent.REPO)
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    gold = os.path.join(vs_parent.REPO, "tests", "golden")
    mp3 = np.load(os.path.join(gold, "encode_golden.npz"))["mp3_bytes"]
    song_b = (mp3.tobytes() + b"\0") * SONG_COPIES
    with open(os.path.join(tmp, "song.mp3"), "wb") as f:
        f.write(song_b)
    if alone:
        if alone != "granule":
            _write_scan_inputs(tmp, song_b)
        return
    parsed = dh.parse_mp3(song_b)
    ends = np.cumsum(np.asarray(parsed.frame_sizes, np.int64))
    span = parsed.num_frames - SLICE_FRAMES
    blobs = []
    for k in range(SLICES):
        first = round(k * span / (SLICES - 1))
        start = 0 if first == 0 else int(ends[first - 1])
        blobs.append((f"slice{k}", song_b[start:int(
            ends[first + SLICE_FRAMES - 1])]))
    mr = np.load(os.path.join(gold, "multirate_golden.npz"))
    blobs += [(t, mr[f"mp3_{t}"].tobytes()) for t in (
        "32000_64", "32000_192", "44100_128", "48000_96", "48000_320")]
    lsf = np.load(os.path.join(gold, "torch_lsf_golden.npz"))
    blobs += [(n, lsf[n].tobytes()) for n in sorted(lsf.files)]
    paths = []
    for name, data in blobs:
        paths.append(os.path.join(tmp, f"{name}.mp3"))
        with open(paths[-1], "wb") as f:
            f.write(data)
    with open(os.path.join(tmp, "batch.json"), "w") as f:
        json.dump(paths, f)


def _write_scan_inputs(tmp: str, song_b: bytes) -> None:
    """The bit-scan's lanes (``huffman_device.pack``) of the song, of
    ``chip_smoke.flipped_song`` and of ``chip_smoke.mono_pcm`` encoded at
    128 kbps by the host C++ engine, as .npy files."""
    import numpy as np
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import huffman_device as hd
    from mp3stego_tpu_torch.utils.wav import write_wav
    chip_smoke = _chip_smoke()
    wav = os.path.join(tmp, "mono.wav")
    write_wav(wav, 44100, chip_smoke.mono_pcm())
    streams = (song_b, chip_smoke.flipped_song(song_b),
               chip_smoke._encode_bytes(wav, "cpu", kbps=128, host=True)[0])
    for name, data in zip(SCAN_INPUTS, streams):
        for part, a in zip(("words", "fields"),
                           hd.pack(dh.parse_mp3_light(data)[1])):
            np.save(_scan_file(tmp, name, part), a)


def main() -> int:
    args = vs_parent.parse_args(__doc__, "decode_vs_parent.json",
                                alone=True, only=("scan", "granule"))
    if args.worker:
        print(json.dumps(worker(args.worker, args.tmp, args.alone,
                                os.path.dirname(args.out), args.only)))
        return 0
    if args.alone:
        card, runs, med = vs_parent.compare(
            __file__, args, lambda tmp: _write_inputs(tmp, args.only or True))
        shown = {}
        if args.only != "granule":
            scan = {}
            for which in ("parent", "change"):
                mine = [r["scan_alone"] for r in runs if r["tree"] == which]
                for key, (bound, by) in mine[0]["bound"].items():
                    scan.setdefault(key, dict(bound_ms=bound, bound_by=by))[
                        which] = dict(
                            ms=sorted(r["ms"][key] for r in mine),
                            chain_ms=sorted(r["chain_ms"][key] for r in mine
                                            if key in r["chain_ms"]))
            shown.update(scan_alone=scan, scan_build={
                r["tree"]: {k: v for k, v in r["scan_alone"]["kernel"].items()
                            if k != "loops"} for r in runs[::-1]})
        if args.only != "scan":
            k2 = {}
            for which in ("parent", "change"):
                mine = [r["granule_alone"] for r in runs
                        if r["tree"] == which]
                for key, (bound, by) in mine[0]["bound"].items():
                    times = sorted(r["ms"][key] for r in mine)
                    k2.setdefault(key, dict(bound_ms=bound, bound_by=by))[
                        which] = dict(ms=times, share_of_bound=[
                            bound / t for t in times])
            shown.update(granule_alone=k2, granule_build={
                r["tree"]: r["granule_alone"]["kernels"] for r in runs[::-1]})
        vs_parent.write(args.out, card, runs, med, **shown)
        return 0
    card, runs, med = vs_parent.compare(
        __file__, args, lambda tmp: _write_inputs(tmp, False), same_bytes=[
            "decode, float64", "batched decode, float64",
            "streaming decode, float64"])
    for r in runs:
        for kind, rate in r["f32_lsb_rates"].items():
            limit = TONE_MAX_LSB_RATE if kind == "tones" else MAX_LSB_RATE
            if not rate < limit:
                raise AssertionError(f"{r['tree']}: float32 flips {rate} of "
                                     f"the {kind}' samples (limit {limit})")
    plane = {}
    for dtype in runs[0]["device_plane_ms"]:
        for which in ("parent", "change"):
            plane.setdefault(dtype, {})[which] = min(
                r["device_plane_ms"][dtype] for r in runs
                if r["tree"] == which)
    vs_parent.write(args.out, card, runs, med, device_plane_best_ms=plane,
                    stages_ms=[(r["tree"], r["stages_ms"]) for r in runs],
                    f32_lsb_rates=[(r["tree"], r["f32_lsb_rates"])
                                   for r in runs])
    return 0


if __name__ == "__main__":
    sys.exit(main())
