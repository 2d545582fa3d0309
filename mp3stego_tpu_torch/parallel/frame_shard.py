"""Sequence parallelism over the granule axis of one MP3 stream.

The reference decodes granules in order because of two carries: the IMDCT
overlap-add (one granule of lookback, Frame.py:150-154) and the synthesis
FIFO (15 sub-steps, less than a granule, Frame.py:80-101). Both are bounded
halos, so a time range needs nothing of the stream but the IMDCT blocks of
the two granules before it: granule -1's head and granule -2's tail give
granule -1's ``y``, whose last 15 V rows are the FIR's history, and granule
-1's tail is granule 0's overlap. ``decode_granules_sharded`` splits the
granule axis over a mesh's ``frames`` axis and runs, per shard, as the JAX
package's ``_shard_body`` (``mp3stego_tpu/parallel/frame_shard.py:28``):

1. kernel K2 (``decode_plane.granule_blocks``) on the shard's granules, on
   its device;
2. the shard's halo, the two granules before it, copied from the shards
   that hold them (two shards when a shard holds one granule) to its device
   with ``Tensor.to(non_blocking=True)``, the consumer's stream waiting on
   an event the producer's stream recorded after K2: no host sync;
3. kernel K1 (``synth.synth_fused``) with that halo.

Where the JAX design ships the boundary V rows and runs synthesis twice,
K1 recomputes granule -1's V from the halo, so every shard's K1 can launch
as soon as its halo has arrived. The PCM is bit for bit the unsharded
decode's in both dtypes, at any shard count.
"""

import numpy as np
import torch

from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.parallel.mesh import Mesh, check_mesh
from mp3stego_tpu_torch.utils.transfer import fetch_concat, put_tree


def _pad_t(prep: dict, t_pad: int) -> dict:
    """``prep`` with its granule axis padded with silent granules (every
    field 0) to ``t_pad``."""
    t = prep["raw_i8"].shape[1]
    if t_pad == t:
        return prep
    out = dict(prep)
    for keys, axis in ((dp.T_AXIS1_KEYS, 1), (dp.T_AXIS0_KEYS, 0)):
        for k in keys:
            width = [(0, 0)] * prep[k].ndim
            width[axis] = (0, t_pad - t)
            out[k] = np.pad(prep[k], width)
    return out


def shard_preps(prep: dict, mesh: Mesh) -> list:
    """``host_prepare``'s dict cut on its granule axis, T padded to a
    multiple of the ``frames`` axis: shard k's torch prep, granules ``[k *
    per, (k + 1) * per)`` on ``mesh.devices[0, k]``. Each keeps the int8
    plane with the escapes of its granules (``index_escapes`` sorts them by
    granule, so a shard's are one range), their granule shifted to the
    shard's."""
    devs = list(mesh.devices[0])
    t = prep["raw_i8"].shape[1]
    per = -(-t // len(devs))
    host = dp.index_escapes(_pad_t(prep, per * len(devs)))
    start = host["exc_start"]
    shards = []
    for k, dev in enumerate(devs):
        s, e = k * per, (k + 1) * per
        a, b = int(start[s]), int(start[e])
        sh = {key: host[key][:, s:e] for key in dp.T_AXIS1_KEYS}
        sh.update({key: host[key][s:e] for key in dp.T_AXIS0_KEYS})
        sh.update({key: host[key] for key in dp.CONST_KEYS})
        sh.update({key: host[key][a:b] for key in dp.EXC_KEYS})
        sh["exc_t"] = (sh["exc_t"] - s).astype(np.int32)
        sh["exc_start"] = (start[s:e + 1] - a).astype(np.int32)
        shards.append(put_tree(sh, dev))
    return shards


def _to(src: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``src`` on ``dev``, ordered after the work queued on its own device:
    on the card, ``dev``'s stream waits on an event recorded on ``src``'s
    stream and the copy is asynchronous."""
    if dev.type != "cuda":
        return src.to(dev)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(src.device))
    torch.cuda.current_stream(dev).wait_event(done)
    with torch.cuda.device(dev):
        return src.to(dev, non_blocking=True)


def _halo(blks: list, k: int, dev: torch.device):
    """Shard k's halo on ``dev``: the blocks (2, 2, 32, 36) of the two
    global granules before its first, from the shards that hold them
    (zeros before granule 0), C-contiguous; None for shard 0."""
    if k == 0:
        return None
    per = blks[0].shape[1]
    s = k * per
    pieces, g = [], s - 2
    while g < s:
        if g < 0:
            pieces.append(blks[0].new_zeros((blks[0].shape[0], 1, 32, 36),
                                            device=dev))
            g += 1
            continue
        j, a = divmod(g, per)
        b = min(per, a + s - g)
        pieces.append(_to(blks[j][:, a:b], dev))
        g += b - a
    return torch.cat(pieces, 1) if len(pieces) > 1 \
        else pieces[0].contiguous()


def shard_body(preps: list, dtype) -> list:
    """The device half of the sharded decode: K2 on every shard, then each
    shard's halo, then K1 on every shard. Returns each shard's float PCM
    (2, per, 576) on its device."""
    blks = [dp.granule_blocks(p, dtype) for p in preps]
    halos = [_halo(blks, k, dp._plane_device(p)) for k, p in enumerate(preps)]
    return [dp.synth_from_blocks(b, halo=h) for b, h in zip(blks, halos)]


def decode_granules_sharded(prep: dict, mesh: Mesh,
                            dtype: str = "float32") -> np.ndarray:
    """Decode one parsed stream (``host_prepare``'s dict) with its granule
    axis sharded over the mesh's ``frames`` axis (the first row of the
    mesh). Pads T up to a multiple of the axis size (padded granules decode
    as silence and are trimmed). Returns float PCM (2, T, 576) in
    ``dtype``: every shard fetched into its offset of one pinned output
    (``utils.transfer.fetch_concat``), no host concatenation."""
    check_mesh(mesh)
    if dtype not in dp.DTYPES:
        raise ValueError(f"dtype must be one of {tuple(dp.DTYPES)}, got "
                         f"{dtype!r}")
    t = prep["raw_i8"].shape[1]
    if t == 0:
        return np.zeros((2, 0, 576), np.dtype(dtype))
    pcm = shard_body(shard_preps(prep, mesh), dp.DTYPES[dtype])
    return fetch_concat(pcm, 1)[:, :t]
