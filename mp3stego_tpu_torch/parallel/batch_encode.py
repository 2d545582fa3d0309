"""Batched encode: many WAV files through one search pass per group.

Files are grouped by samplerate (its band-table row) and channel count. For
each group the card runs the Q31 analysis of every file
(``ops/encode_plane.run_analysis_device``), then ONE rate-control search
(``ops/search_plane.search``) over the lanes of all its files, concatenated,
and one ``scfsi_sums`` pass for MPEG-1. The search treats every lane on its
own (fresh addresses, its own budget), so concatenating files changes no
lane's result. Each file's rows then come back to the host, its ``ix``
staying on the card for the frame serializer (``ops/serialize``), and a
thread pool runs that file's host redo and reservoir/serialization chain
(``MP3Encoder._plane_redo`` and ``_plane_finish``) on its own rows: a
redone lane's address chain never reaches into another file. The bytes
equal each file's own ``MP3Encoder`` run.

A group above ``MAX_LANES`` runs as sub-batches; the host finish of one
overlaps the card's work on the next. With a ``mesh``
(``parallel.make_mesh``) of n devices on its ``files`` axis, each group is
cut into sub-batches of at most ``ceil(files / n)`` files, whole mesh rows
as in the JAX package, and the sub-batches go round-robin over those
devices, one host thread a distinct device; the bytes do not change.

Engine choice without a mesh: ``MP3STEGO_TPU_BATCH_ENC_HOST=1`` sends
every file to the host C++ engine (``MP3Encoder._encode_host``, the same
bytes), on every device; otherwise, and always with a mesh, the card (or
the device the caller names) runs. The JAX package's cost model
(``utils/calibrate.batch_encode_engine``) is ported but not consulted here
(``utils/calibrate.entry_engine``).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mp3stego_tpu_torch.models.encoder import (MP3Encoder, _ix_home,
                                               _native_rate_lib)
from mp3stego_tpu_torch.ops import search_plane as SP
from mp3stego_tpu_torch.parallel.mesh import check_mesh
from mp3stego_tpu_torch.utils import calibrate
from mp3stego_tpu_torch.utils.profiling import StageTimer
from mp3stego_tpu_torch.utils.transfer import fetch_pieces, resolve_device
from mp3stego_tpu_torch.utils.wav import read_wav

# lanes (files x channels x granules) per search pass. The 240.7 s stereo
# song's 36,864 lanes peaked at 2,035.5 MiB on the H100 (PERF.md); 8 songs'
# worth, ~16 GiB, is a fifth of the card's 80 GB.
MAX_LANES = 8 * 36864


def encode_files_batched(jobs: list, bitrate: int = 320, mesh=None,
                         max_workers: int = None, errors: str = "raise",
                         device=None) -> list:
    """Encode many WAV files: ``jobs`` is a list of (wav_path, mp3_path).

    Returns one entry per job, in order: its mp3 path, or with
    ``errors="isolate"`` the exception that stopped it (a WAV that
    ``read_wav`` refuses raises ``SystemExit``, isolated too). The bytes of
    each file equal its own :class:`MP3Encoder` run on the same device.

    The arguments up to ``errors`` are the JAX package's, in its order.

    :param mesh: a ``parallel.make_mesh`` mesh: sub-batches go round-robin
        over its ``files`` devices; None runs them on ``device``. Any other
        object raises ``TypeError``.
    :param max_workers: threads for the host redo and serialization.
    :param device: the planes' device without a mesh; None means CUDA (a
        missing card raises). Passing it with a mesh raises.
    """
    devs = None if mesh is None \
        else list(check_mesh(mesh, device).devices[:, 0])
    if errors not in ("raise", "isolate"):
        raise ValueError(f"errors must be 'raise' or 'isolate', got "
                         f"{errors!r}")
    devs = devs or [resolve_device(device)]
    dev = devs[0]
    results = [None] * len(jobs)
    groups = {}
    for i, (wav_path, mp3_path) in enumerate(jobs):
        try:
            if not os.path.exists(wav_path):
                raise FileNotFoundError(wav_path)
            enc = MP3Encoder(read_wav(wav_path, bitrate), device=dev)
            nf = enc._num_frames()
            if nf == 0:
                raise ValueError(f"{wav_path}: no samples to encode")
        except (Exception, SystemExit) as e:
            if errors != "isolate":
                raise
            results[i] = e
            continue
        key = (enc.band_row, enc.wav.num_of_channels)
        groups.setdefault(key, []).append((i, mp3_path, enc, nf))

    items = [item for group in groups.values() for item in group]
    workers = max_workers or min(8, os.cpu_count() or 1)
    if (items and mesh is None
            and calibrate.entry_engine("batch_encode") == "host"
            and _host_engine()):
        return _encode_host_all(items, results, workers, errors)

    # sub-batch j on devs[j % n]; each distinct device's sub-batches in
    # order on a host thread of its own
    by_dev, j = {}, 0
    for group in groups.values():
        for sub in _sub_batches(group, -(-len(group) // len(devs))):
            by_dev.setdefault(devs[j % len(devs)], []).append(sub)
            j += 1

    def on_device(d, subs):
        return [f for sub in subs for f in _run_sub_batch(sub, d, pool)]

    with ThreadPoolExecutor(max_workers=workers) as pool, \
            ThreadPoolExecutor(max_workers=max(1, len(by_dev))) as cards:
        runs = [cards.submit(on_device, d, subs)
                for d, subs in by_dev.items()]
        futures = [f for run in runs for f in run.result()]
        for i, fut in futures:
            try:
                results[i] = fut.result()
            except Exception as e:  # noqa: BLE001 - isolation mode reports it
                if errors != "isolate":
                    raise
                results[i] = e
    return results


def _host_engine() -> bool:
    """Whether the native library holds the host C++ encode engine."""
    lib = _native_rate_lib()
    return (lib is not None and hasattr(lib, "rate_search_file")
            and hasattr(lib, "encode_analysis"))


def _encode_host_all(items: list, results: list, workers: int,
                     errors: str) -> list:
    """Every file through the host C++ engine on a thread pool, each
    written to its mp3 path; ``results`` filled in as
    :func:`encode_files_batched` returns them."""
    def host_one(item):
        _, mp3_path, enc, nf = item
        if not enc._encode_host(nf, StageTimer(enabled=False)):
            raise RuntimeError("the host C++ encode engine is unavailable")
        enc.write_mp3_file(mp3_path)
        return mp3_path

    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [(item[0], pool.submit(host_one, item)) for item in items]
        for i, fut in futures:
            try:
                results[i] = fut.result()
            except Exception as e:  # noqa: BLE001 - isolation mode reports it
                if errors != "isolate":
                    raise
                results[i] = e
    return results


def _lanes(item) -> int:
    _, _, enc, nf = item
    return enc.wav.num_of_channels * nf * enc.granules_per_frame


def _sub_batches(group: list, max_files: int) -> list:
    """Consecutive runs of at most ``max_files`` files and ``MAX_LANES``
    lanes (a file larger than that runs alone)."""
    subs, cur, lanes = [], [], 0
    for item in group:
        n = _lanes(item)
        if cur and (lanes + n > MAX_LANES or len(cur) == max_files):
            subs.append(cur)
            cur, lanes = [], 0
        cur.append(item)
        lanes += n
    return subs + [cur] if cur else subs


def _run_sub_batch(sub: list, dev: torch.device, pool) -> list:
    """The card's half of one sub-batch on ``dev`` (analysis per file, one
    search and one scfsi pass over all its lanes), then each file's host
    half on ``pool``. Returns (job index, future) pairs."""
    xrs, budgets, framing = [], [], []
    for _, _, enc, nf in sub:
        enc.device = dev
        xrs.append(enc._analysis_device(nf))
        paddings, mean_bits_f = enc._plane_framing(nf)
        framing.append((paddings, mean_bits_f))
        budgets.append(enc._lane_budgets(mean_bits_f))
    xr_all = torch.cat(xrs) if len(xrs) > 1 else xrs[0]
    mb = torch.from_numpy(np.concatenate(budgets)).to(dev)
    enc0 = sub[0][2]
    res_d = SP.search(xr_all, mb, enc0.band_row)
    scfsi = (SP.scfsi_sums(xr_all, enc0.band_row) if enc0.version == 3
             else None)

    futures, a = [], 0
    for (i, mp3_path, enc, nf), xr, fr, maxb in zip(sub, xrs, framing,
                                                    budgets):
        b = a + xr.shape[0]
        res = SP.rows_to_host({k: v[a:b] for k, v in res_d.items()})
        res["ix"] = _ix_home(res_d["ix"][a:b])
        en = (None, None) if scfsi is None else \
            tuple(fetch_pieces([s[a:b] for s in scfsi]))
        futures.append((i, pool.submit(_finish_file, enc, nf, res, xr, maxb,
                                       en, fr, mp3_path)))
        a = b
    return futures


def _finish_file(enc, nf, res, xr, maxb, en, framing, mp3_path) -> str:
    """One file's host half: redo its flagged lanes with its own slot
    chains, then its reservoir chain and serialization, then its file."""
    tg = nf * enc.granules_per_frame
    enc._plane_redo(res, xr, maxb, tg)
    enc._plane_finish(res, en[0], en[1], nf, *framing, tg)
    enc.write_mp3_file(mp3_path)
    return mp3_path
