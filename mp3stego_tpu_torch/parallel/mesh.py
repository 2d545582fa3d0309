"""The device mesh of the codec's two parallel axes.

Axes, as in the JAX package (``mp3stego_tpu/parallel/mesh.py``):

* ``files``  — data parallelism: independent MP3/WAV streams, each group
  of files on its own device, nothing exchanged;
* ``frames`` — sequence parallelism: granule ranges of one stream, each
  range on its own device; a range takes the IMDCT blocks of the two
  granules before it from its left neighbours as a halo
  (``parallel.frame_shard``).

A :class:`Mesh` is a (files, frames) grid of ``torch.device`` entries, and
an entry may repeat: a mesh of 4 entries that all name ``cuda:0`` runs 4
logical shards on one card (the same code spreads them over 4 cards when
there are 4). Repeated ``"cpu"`` entries take the place of the JAX
package's forced host device count in the CPU tests.
"""

import numpy as np
import torch

AXES = ("files", "frames")


class Mesh:
    """A (files, frames) grid of devices: ``devices`` is an object array of
    ``torch.device``, ``axis_names`` ``("files", "frames")`` and ``shape``
    ``{"files": F, "frames": M}``, read as JAX's ``mesh.shape["files"]``."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or 0 in devices.shape:
            raise ValueError(f"a mesh is a non-empty (files, frames) grid, "
                             f"got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))


def _device(d) -> torch.device:
    """``d`` as a mesh entry: a CPU device, or a CUDA device with its index
    (a bare ``"cuda"`` names the current card, so it is resolved here)."""
    dev = torch.device(d)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh holds CPU or CUDA devices, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the mesh names {dev}, and torch sees no "
                               f"CUDA card")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(files: int = 0, frames: int = 1, devices=None) -> Mesh:
    """Build a (files, frames) mesh. ``files=0`` means "use all remaining
    devices on the files axis".

    ``devices`` defaults to every visible CUDA card, each as ``cuda:i``;
    without a card that raises (there is no CPU fallback). An explicit list
    may repeat a device, e.g. ``["cuda:0"] * 4`` for 4 shards on one card
    or ``["cpu"] * 8`` for the CPU tests."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() spans the visible CUDA cards, and torch sees "
                "none; pass devices=['cpu'] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if files == 0:
        if n % frames:
            raise ValueError(f"{n} devices not divisible by frames={frames}")
        files = n // frames
    if files * frames > n:
        raise ValueError(f"mesh {files}x{frames} needs {files * frames} "
                         f"devices, have {n}")
    grid = np.empty(files * frames, dtype=object)
    grid[:] = [_device(d) for d in list(devices)[:files * frames]]
    return Mesh(grid.reshape(files, frames))


def check_mesh(mesh, device=None) -> Mesh:
    """``mesh`` if it is this package's :class:`Mesh` and no ``device`` was
    passed beside it (a mesh names its own devices); raises otherwise."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must come from mp3stego_tpu_torch.parallel."
                        f"make_mesh, got {type(mesh).__module__}."
                        f"{type(mesh).__qualname__}")
    if device is not None:
        raise ValueError("pass a mesh or a device, not both: the mesh names "
                         "the devices")
    return mesh
