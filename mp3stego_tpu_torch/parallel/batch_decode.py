"""Batched decode: many MP3 files through the decode plane, a chunk at a time.

The granule half of the decode plane (``decode_plane.granule_blocks``:
requantize, stereo, reorder, alias, windowed IMDCT; on the card kernel K2,
``csrc/granule.cu``, one launch per chunk) is granule-local, so a
chunk of files is one longer granule axis to it: ``prepare_batch_concat``
lays each file's granules at ``i * t_max`` and shifts its linbits escapes by
the same offset. The other half (IMDCT overlap, frequency inversion,
synthesis) carries state along each file, so it runs on one row per (file,
channel): the fused synthesis kernel (K1, ``csrc/synth.cu``) is one launch
per chunk over F * ch rows, and no file's IMDCT tail or V history reaches
the next file's first granule (``decode_plane.decode_granules`` with
``files=F``). With ``out="int16"`` the kernel writes each file's WAV
samples, interleaved.

Chunks group files of one samplerate (the walk and reorder tables are per
samplerate) and come back in input order. The files are parsed on a thread
pool first; while the card decodes chunk k, a worker thread prepares and
stacks chunk k+1 into pinned host memory, and the PCM of chunk k goes back
to pinned host memory on a side CUDA stream of its device.

With a ``mesh`` (``parallel.make_mesh``) the chunks go round-robin over the
devices of its ``files`` axis (its ``frames`` axis is not used here, as in
the JAX package), each device with its own side stream; the output is bit
for bit the output without one. ``prepare_batch`` and
``decode_batch_device`` are the JAX package's stacked file-axis layout
(files, ...) and its decode, the file axis split into one contiguous group
per ``files`` device, each group a concat batch there.

Engine choice (``out="int16"``, float32): ``MP3STEGO_TPU_BATCH_HOST_G=
<granules>`` sends a batch of at most that many granules to the native
float64 host plane per file (``decode_plane.decode_pcm_i16_host``,
bit-exact), on every device; otherwise the plane runs where the caller put
it (the card's within 1 LSB of the host's bytes). The JAX package's cost
model (``utils/calibrate.batch_decode_engine``) is ported but not consulted
here (``utils/calibrate.entry_engine``), so the output never depends on a
probe's timings. The JAX package's switch for a threaded fetch (its probe's
duplex gain) is not ported: the PCM always comes back on a side stream.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.bitstream.id3 import parse_id3
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.parallel.mesh import check_mesh
from mp3stego_tpu_torch.utils import calibrate
from mp3stego_tpu_torch.utils.profiling import bind, count, span
from mp3stego_tpu_torch.utils.transfer import resolve_device

# host threads for parsing and preparing files
_WORKERS = min(8, os.cpu_count() or 1)
OUTS = ("float", "int16")
# the stacked layout's escape padding: a granule index past any file
_EXC_PAD_T = 1 << 28


def prepare_batch(preps: list, t_pad_to: int = 1) -> dict:
    """Stack per-file ``host_prepare`` dicts into one padded batch with a
    file axis in front: (files, 2, T, ...) for ``T_AXIS1_KEYS``, (files, T,
    ...) for ``T_AXIS0_KEYS``, (files, E) escapes padded with
    ``_EXC_PAD_T`` (the others with 0), the constants stacked (files, ...),
    plus ``lengths`` and ``num_files``. Padded granules carry raw 0 and
    decode to silence; ``t_pad_to`` rounds T up to a multiple. Array for
    array the JAX package's ``prepare_batch``."""
    if not preps:
        raise ValueError("prepare_batch: no files to batch")
    n = len(preps)
    t_max = max(p["raw_i8"].shape[1] for p in preps)
    t_max += (-t_max) % max(1, t_pad_to)

    def stack(key, axis):
        shape = list(preps[0][key].shape)
        shape[axis] = t_max
        out = np.zeros([n] + shape, dtype=preps[0][key].dtype)
        for i, p in enumerate(preps):
            idx = [i] + [slice(None)] * p[key].ndim
            idx[1 + axis] = slice(0, p[key].shape[axis])
            out[tuple(idx)] = p[key]
        return out

    batch = {k: stack(k, 1) for k in dp.T_AXIS1_KEYS}
    batch.update({k: stack(k, 0) for k in dp.T_AXIS0_KEYS})
    e_max = max(1, max(len(p["exc_t"]) for p in preps))
    for k in dp.EXC_KEYS:
        out = np.full((n, e_max), _EXC_PAD_T if k == "exc_t" else 0,
                      dtype=preps[0][k].dtype)
        for i, p in enumerate(preps):
            out[i, :len(p[k])] = p[k]
        batch[k] = out
    batch.update({k: np.stack([p[k] for p in preps]) for k in dp.CONST_KEYS})
    batch["lengths"] = np.array([p["raw_i8"].shape[1] for p in preps])
    batch["num_files"] = n
    return batch


def _concat_of_stacked(batch: dict, a: int, b: int) -> dict:
    """Files ``[a, b)`` of a stacked batch (one set of constants) as one
    concat prep: file i's granules at ``(i - a) * T``, its escapes shifted
    alike and indexed (``index_escapes``)."""
    f, t = b - a, batch["raw_i8"].shape[2]
    prep = {}
    for k in dp.T_AXIS1_KEYS:
        x = batch[k][a:b]
        prep[k] = np.ascontiguousarray(np.moveaxis(x, 0, 1)).reshape(
            (x.shape[1], f * t) + x.shape[3:])
    for k in dp.T_AXIS0_KEYS:
        x = batch[k][a:b]
        prep[k] = x.reshape((f * t,) + x.shape[2:])
    exc_t = batch["exc_t"][a:b]
    keep = exc_t < t
    prep["exc_t"] = (exc_t.astype(np.int64)
                     + np.arange(f)[:, None] * t)[keep].astype(np.int32)
    for k in ("exc_ch", "exc_s", "exc_val"):
        prep[k] = batch[k][a:b][keep]
    prep.update({k: batch[k][a] for k in dp.CONST_KEYS})
    return dp.index_escapes(prep)


def _constant_runs(batch: dict, a: int, b: int) -> list:
    """Files ``[a, b)`` as maximal runs that share the constant tables (one
    samplerate each)."""
    runs = [[a, a + 1]]
    for i in range(a + 1, b):
        if all(np.array_equal(batch[k][i], batch[k][runs[-1][0]])
               for k in dp.CONST_KEYS):
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return runs


def decode_batch_device(batch: dict, mesh=None, dtype: str = "float32",
                        to_i16: bool = False, device=None) -> torch.Tensor:
    """Decode a stacked batch (``prepare_batch``): (files, 2, T, 576) float
    PCM in ``dtype``, or with ``to_i16`` the WAV's int16 samples in the same
    layout, on the first device of the mesh (or on ``device``).

    The file axis is split into contiguous groups, one per device of the
    mesh's ``files`` axis: F files over n devices give groups of ``ceil(F /
    n)``, the JAX package's ``_pad_files`` split (the padding files are not
    decoded: they come back nowhere). Each group runs on its device as one
    concat batch, one K2 and one K1 launch (one each per run of files of one
    samplerate). ``mesh`` None runs one group on ``device`` (None: CUDA)."""
    devs = [resolve_device(device)] if mesh is None \
        else list(check_mesh(mesh, device).devices[:, 0])
    if dtype not in dp.DTYPES:
        raise ValueError(f"dtype must be one of {tuple(dp.DTYPES)}, got "
                         f"{dtype!r}")
    n, t = batch["num_files"], batch["raw_i8"].shape[2]
    per = -(-n // len(devs))
    outs = []
    for i, dev in enumerate(devs):
        if i * per >= n:
            break
        for a, b in _constant_runs(batch, i * per, min(n, (i + 1) * per)):
            prep = _concat_of_stacked(batch, a, b)
            args = {k: torch.from_numpy(np.ascontiguousarray(prep[k])).to(dev)
                    for k in dp.TORCH_KEYS}
            pcm = dp.decode_granules(args, dp.DTYPES[dtype], files=b - a,
                                     out="int16" if to_i16 else "float")
            pcm = pcm.reshape(b - a, t, 576, 2).permute(0, 3, 1, 2) \
                if to_i16 else pcm.reshape(b - a, 2, t, 576)
            outs.append(pcm.to(devs[0]))
    return torch.cat(outs)


def prepare_batch_concat(preps: list) -> dict:
    """Stack ``host_prepare`` dicts as ONE granule axis of ``F * t_max``
    granules: file i's granules start at ``i * t_max`` and its padding
    granules are silent (raw 0). Every file must share the constant tables
    (one samplerate). Adds ``lengths``, ``num_files`` and ``t_max``."""
    if not preps:
        raise ValueError("prepare_batch_concat: no files to batch")
    n = len(preps)
    t_max = max(p["raw_i8"].shape[1] for p in preps)
    batch = {}
    for keys, axis in ((dp.T_AXIS1_KEYS, 1), (dp.T_AXIS0_KEYS, 0)):
        for k in keys:
            shape = list(preps[0][k].shape)
            shape[axis] = n * t_max
            out = np.zeros(shape, dtype=preps[0][k].dtype)
            for i, p in enumerate(preps):
                idx = [slice(None)] * out.ndim
                idx[axis] = slice(i * t_max, i * t_max + p[k].shape[axis])
                out[tuple(idx)] = p[k]
            batch[k] = out
    # escapes: shift each file's granule index into the concat axis; the
    # pad entries (index past the file) move past the whole axis
    t_all = n * t_max
    shifted = [np.where(p["exc_t"] < p["raw_i8"].shape[1],
                        p["exc_t"].astype(np.int64) + i * t_max, t_all)
               for i, p in enumerate(preps)]
    batch["exc_t"] = np.concatenate(shifted).astype(np.int32)
    for k in ("exc_ch", "exc_s", "exc_val"):
        batch[k] = np.concatenate([p[k] for p in preps])
    for k in dp.CONST_KEYS:
        for p in preps[1:]:
            if not np.array_equal(p[k], preps[0][k]):
                raise ValueError(
                    f"prepare_batch_concat: files disagree on constant {k} "
                    "(mixed samplerates must be grouped per batch)")
        batch[k] = preps[0][k]
    batch["lengths"] = np.array([p["raw_i8"].shape[1] for p in preps])
    batch["num_files"] = n
    batch["t_max"] = t_max
    return batch


def _read_parsed(path: str):
    with span("batch.file"):
        with open(path, "rb") as f:
            data = f.read()
        id3 = parse_id3(data)
        # the samples filled here, on the pool: this path packs them to
        # int8 for its chunks' K2 launches and scans nothing on the card
        parsed = dh.parse_mp3(data, id3.offset if id3.is_valid else 0,
                              defer_samples=False)
    if parsed.num_frames == 0:
        raise ValueError(f"{path}: no MP3 frames found")
    return parsed


def decode_files_batched(paths: list, mesh=None, dtype: str = "float32",
                         errors: str = "raise", out: str = "float",
                         device=None, chunk_files: int = 16) -> list:
    """Decode many MP3 files; one interleaved PCM array (samples, channels)
    per file, in input order, each equal to that file's own decode on the
    same device (``decode_plane.decode_pcm``, or ``decode_pcm_i16`` for
    ``out="int16"``).

    The arguments up to ``out`` are the JAX package's, in its order.

    :param mesh: a ``parallel.make_mesh`` mesh: chunks go round-robin over
        its ``files`` devices; None runs them on ``device``. Any other
        object raises ``TypeError``.
    :param dtype: the plane's float type, "float32" or "float64" (the
        bit-exact plane: its int16 equals each file's host decode).
    :param errors: "raise" propagates the first file that fails to parse;
        "isolate" decodes the others and puts the exception in its slot.
    :param out: "float" PCM, or "int16" WAV samples converted on the device
        (half the bytes back to the host); with float32,
        ``MP3STEGO_TPU_BATCH_HOST_G`` may send it to the host plane
        instead (see the module docstring).
    :param device: the plane's device without a mesh; None means CUDA (a
        missing card raises). Passing it with a mesh raises.
    :param chunk_files: files per chunk, one synthesis-kernel launch each;
        0 decodes each samplerate's files as one chunk.

    Recorded as the span ``decode_files_batched``, the root of the call's
    spans: ``batch.file`` a file on the pool (its read and ``parse_mp3``),
    ``batch.parse_wait`` for the parses, and a chunk's ``batch.prep`` on
    the prep thread and ``batch.prep_wait``, ``batch.dispatch``,
    ``batch.fetch_wait`` and ``batch.unpack`` on the caller's.
    """
    with span("decode_files_batched", files=len(paths)):
        return _decode_files(paths, mesh, dtype, errors, out, device,
                             chunk_files)


def _decode_files(paths, mesh, dtype, errors, out, device, chunk_files):
    devs = None if mesh is None \
        else list(check_mesh(mesh, device).devices[:, 0])
    if out not in OUTS:
        raise ValueError(f"out must be one of {OUTS}, got {out!r}")
    if dtype not in dp.DTYPES:
        raise ValueError(f"dtype must be one of {tuple(dp.DTYPES)}, got "
                         f"{dtype!r}")
    if errors not in ("raise", "isolate"):
        raise ValueError(f"errors must be 'raise' or 'isolate', got "
                         f"{errors!r}")
    devs = devs or [resolve_device(device)]
    metas, kept, results = [], [], [None] * len(paths)
    # the parse and host_prepare of many files run on a thread pool (the
    # native parser and the NumPy passes release the GIL)
    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        parsing = [pool.submit(bind(_read_parsed), path) for path in paths]
        with span("batch.parse_wait"):
            for i, fut in enumerate(parsing):
                try:
                    metas.append(fut.result())
                    kept.append(i)
                except Exception as e:  # noqa: BLE001 - isolation reports it
                    if errors != "isolate":
                        raise
                    results[i] = e
        decoded = None
        if (out == "int16" and dtype == "float32" and metas
                and calibrate.entry_engine(
                    "batch_decode",
                    sum(m.num_frames for m in metas) * 2) == "host"):
            decoded = list(pool.map(bind(dp.decode_pcm_i16_host), metas))
            if any(pcm is None for pcm in decoded):   # no native library
                decoded = None
        if metas and decoded is None:
            decoded = _decode_pipelined(metas, devs, dp.DTYPES[dtype],
                                        out == "int16", chunk_files, pool)
        for i, pcm in zip(kept, decoded or ()):
            results[i] = pcm
    return results


def _chunks(metas: list, chunk_files: int) -> list:
    """Lists of indices into ``metas``: one samplerate each, at most
    ``chunk_files`` long (unbounded when it is 0)."""
    by_sr = {}
    for idx, m in enumerate(metas):
        by_sr.setdefault(m.header.sr_idx, []).append(idx)
    step = chunk_files if chunk_files > 0 else len(metas)
    return [idxs[i:i + step] for idxs in by_sr.values()
            for i in range(0, len(idxs), step)]


def _unpack(planes: np.ndarray, batch: dict, metas: list) -> list:
    """(files, ch, t_max, 576) float planes, or (files, t_max * 576, ch)
    interleaved int16 -> each file's interleaved PCM
    (``decode_plane._finish_inter`` trims LSF virtual frames, repeats the
    stale last frame and drops a VBR tag frame)."""
    out = []
    for j, parsed in enumerate(metas):
        t = int(batch["lengths"][j])
        ch = parsed.header.channels
        if planes.dtype == np.int16:
            inter = np.array(planes[j, :t * 576, :ch])
        else:
            inter = np.array(planes[j, :ch, :t].transpose(1, 2, 0)
                             .reshape(t * 576, ch))
        out.append(dp._finish_inter(parsed, inter))
    return out


def _decode_pipelined(metas: list, devs: list, dtype, to_i16: bool,
                      chunk_files: int, workers) -> list:
    """Chunk by chunk, chunk k on ``devs[k % len(devs)]``: prep of chunk
    k+1 on a worker thread (its ``host_prepare`` calls spread over
    ``workers``) while the card runs chunk k; the PCM comes back on a side
    stream of its device and is unpacked one chunk later."""
    sides = {d: torch.cuda.Stream(d) for d in set(devs) if d.type == "cuda"}
    chunks = _chunks(metas, chunk_files)
    results = [None] * len(metas)

    def prep(idxs):
        with span("batch.prep", files=len(idxs)):
            batch = dp.index_escapes(prepare_batch_concat(list(workers.map(
                bind(dp.host_prepare), [metas[i] for i in idxs]))))
            host = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                    for k in dp.TORCH_KEYS}
            if sides:
                host = {k: v.pin_memory() for k, v in host.items()}
                count("pinned_bytes", sum(v.nbytes for v in host.values()))
            count("granules", int(batch["lengths"].sum()))
        return batch, host

    def dispatch(batch, host, idxs, dev):
        cuda = dev.type == "cuda"
        args = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
        channels = 1 if all(metas[i].header.channels == 1
                            for i in idxs) else 2
        files = batch["num_files"]
        pcm = dp.decode_granules(args, dtype, files=files, channels=channels,
                                 out="int16" if to_i16 else "float")
        if not to_i16:
            pcm = pcm.reshape(files, channels, -1, 576)
        if not cuda:
            return pcm, None
        fetched = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
        side = sides[dev]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fetched.copy_(pcm, non_blocking=True)
            done = side.record_event()
        pcm.record_stream(side)
        return fetched, done

    def finish(fetched, done, batch, idxs):
        with span("batch.fetch_wait"):
            if done is not None:
                done.synchronize()
        with span("batch.unpack", files=len(idxs)):
            for i, pcm in zip(idxs, _unpack(fetched.numpy(), batch,
                                            [metas[i] for i in idxs])):
                results[i] = pcm

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(bind(prep), chunks[0])
        pending = None
        for k, idxs in enumerate(chunks):
            with span("batch.prep_wait"):
                batch, host = fut.result()
            if k + 1 < len(chunks):
                fut = pool.submit(bind(prep), chunks[k + 1])
            with span("batch.dispatch"):
                fetched, done = dispatch(batch, host, idxs,
                                         devs[k % len(devs)])
            if pending is not None:
                finish(*pending)
            pending = (fetched, done, batch, idxs)
        finish(*pending)
    return results
