"""Host <-> card transfers through page-locked staging.

The port of the JAX package's ``utils/transfer.py``, with its names. There
the TPU's host link moved ~4 MB pieces far faster than one large buffer;
on the H100 what decides a copy's rate is whether its host side is
page-locked: a copy from or to pageable memory goes through bounce
buffers and blocks the host, one from or to pinned memory is a DMA that
runs at the link's rate, on a stream.

* ``put_pieces(arr, device)`` — a NumPy array -> a tensor on ``device``:
  copied into a pinned staging buffer (by NumPy, on the calling thread),
  then ``copy_(non_blocking=True)`` on the current stream. The host may change ``arr`` as soon as the call
  returns; the staging buffer is reused once the copy has run.
* ``put_tree(prep, device)`` — a dict of arrays -> a dict of tensors, all
  staged in one buffer and moved in one copy; each tensor is a view of one
  device buffer, at an offset aligned to ``ALIGN`` bytes.
* ``fetch_pieces(tensors)`` — tensors -> NumPy arrays, in one call: a side
  stream of each device waits on an event recorded on the producer's
  (current) stream, copies every tensor into pinned memory, and the call
  synchronises once. The arrays live in pinned buffers of the pool.
* ``fetch_concat(tensors, dim)`` — tensors -> ONE array, their
  concatenation along ``dim``, each fetched straight into its offset.

The pool (``StagingPool``, one per device) keeps pinned host buffers,
reused across calls and grown on demand. An array handed to a caller owns
its buffer: the pool takes the buffer back only once every array (or view)
made from it is gone, so a later fetch never writes into an array a caller
still holds. An upload's buffer is taken back once its copy has run. Of
the buffers nobody holds, the pool keeps at most ``KEEP_BYTES``: each
``take`` drops the least recently used past that (to PyTorch's pinned host
allocator, which reuses them), and ``trim`` drops them on demand.

Every copy is split into pieces of ``PIECE_BYTES`` (None: whole buffers).
``resolve_device(device)`` is the port's one device rule: ``device``, or
CUDA when None, and a CUDA device without a card raises, so no entry point
moves to the CPU on its own.

On a CPU device, which only a caller asks for, the functions are plain
``torch.from_numpy`` / ``Tensor.numpy()``: no staging, no pinning.
"""

import contextlib
import itertools
import threading
import weakref

import numpy as np
import torch

# bytes a copy moves at once; None copies each buffer whole. On an NVIDIA
# H100 80GB HBM3 at 700 W (tools/probe_card.py, PERF.md) whole fetches beat
# 1, 4 and 16 MB pieces (84.9 MB: 1.678 ms whole, 1.707-2.042 ms in pieces,
# 6.647 ms pageable) and whole uploads were within their spread (42.5 MB:
# 2.07-2.83 ms, 4.37 ms pageable), so nothing is split; the parameter
# stays for that measurement
PIECE_BYTES = None
# each tensor of a put_tree starts at a multiple of this many bytes
ALIGN = 256
# a new staging buffer is a multiple of this many bytes
_GRAIN = 1 << 21
# bytes of free staging a pool keeps for reuse: a fetch of a 240 s song's
# int32 ix is 85 MB
KEEP_BYTES = 256 << 20


def resolve_device(device=None) -> torch.device:
    """The device a plane runs on: ``device``, or CUDA when None.

    A CUDA device without a card raises: nothing moves to the CPU on its
    own (the CPU is reached only by asking for it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device unless asked for the CPU, and "
            "torch sees none; pass device='cpu' to run it on the CPU")
    return dev


def _held() -> bool:
    return True


class _Slab:
    """One staging buffer (uint8, 1-d) and what holds it: ``busy()`` is
    true while an array handed out from it lives or a copy through it is
    in flight; ``used`` is the pool's count of takes when it was last
    taken."""

    __slots__ = ("buf", "busy", "used")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.busy = _held
        self.used = 0


class StagingPool:
    """Host staging buffers for one device, pinned when ``pin``, and the
    device's side stream for fetches (None off the card)."""

    def __init__(self, device: torch.device, pin: bool):
        self.device = device
        self.pin = pin
        self.side = torch.cuda.Stream(device) if device.type == "cuda" \
            else None
        self._slabs = []
        self._takes = 0
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> _Slab:
        """A free buffer of at least ``nbytes`` bytes, marked busy: the
        smallest that fits, else a new one, which replaces the largest free
        buffer too small for it. The free buffers past ``KEEP_BYTES`` go."""
        with self._lock:
            free = [s for s in self._slabs if not s.busy()]
            fits = [s for s in free if s.buf.numel() >= nbytes]
            if fits:
                slab = min(fits, key=lambda s: s.buf.numel())
            else:
                if free:
                    self._slabs.remove(max(free, key=lambda s: s.buf.numel()))
                size = max(_GRAIN, -(-nbytes // _GRAIN) * _GRAIN)
                slab = _Slab(torch.empty(size, dtype=torch.uint8,
                                         pin_memory=self.pin))
                self._slabs.append(slab)
            slab.busy = _held
            self._takes += 1
            slab.used = self._takes
            self._trim(KEEP_BYTES)
            return slab

    def _trim(self, keep: int) -> None:
        free = sorted((s for s in self._slabs if not s.busy()),
                      key=lambda s: s.used)
        total = sum(s.buf.numel() for s in free)
        for s in free:
            if total <= keep:
                break
            self._slabs.remove(s)
            total -= s.buf.numel()

    def trim(self, keep: int = 0) -> None:
        """Drop the least recently used free buffers until at most ``keep``
        bytes of free staging are left; buffers in use stay."""
        with self._lock:
            self._trim(keep)

    def nbytes(self) -> int:
        """Bytes of staging the pool holds."""
        with self._lock:
            return sum(s.buf.numel() for s in self._slabs)


_pools = {}
_pools_lock = threading.Lock()


def pool(device) -> StagingPool:
    """The staging pool of ``device`` (pinned on a CUDA device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _pools_lock:
        if dev not in _pools:
            _pools[dev] = StagingPool(dev, pin=dev.type == "cuda")
        return _pools[dev]


def _view(slab: _Slab, dtype, shape, offset: int = 0) -> torch.Tensor:
    """``shape`` elements of ``dtype`` in ``slab`` from byte ``offset``."""
    n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
        (), dtype=dtype).element_size()
    return slab.buf[offset:offset + n].view(dtype).view(shape)


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` between contiguous tensors of one shape, in
    pieces of ``PIECE_BYTES``, asynchronous where one side is on the card
    and the host side is pinned."""
    d, s = dst.view(-1), src.view(-1)
    per = d.numel() if not PIECE_BYTES else \
        max(1, PIECE_BYTES // max(1, d.element_size()))
    for i in range(0, d.numel(), max(1, per)):
        d[i:i + per].copy_(s[i:i + per], non_blocking=True)


def _host(arr) -> torch.Tensor:
    """A NumPy array as a C-contiguous CPU tensor of its shape (0-d
    included), sharing its memory where it already is one."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    return torch.from_numpy(arr)


def _release_after_copy(slab: _Slab, device: torch.device) -> None:
    """Hand ``slab`` back once the copies queued on ``device``'s current
    stream so far have run."""
    if device.type != "cuda":
        slab.busy = lambda: False
        return
    done = torch.cuda.current_stream(device).record_event()
    slab.busy = lambda: not done.query()


def _put_staged(arrays: list, device: torch.device,
                staging: StagingPool) -> list:
    """Arrays -> tensors on ``device``: staged in one buffer of
    ``staging`` at ``ALIGN``-ed offsets, moved in one copy into one device
    buffer, each tensor a view of it."""
    hosts = [_host(a) for a in arrays]
    offs, end = [], 0
    for h in hosts:
        offs.append(end)
        end += -(-h.numel() * h.element_size() // ALIGN) * ALIGN
    slab = staging.take(max(end, 1))
    for h, off in zip(hosts, offs):
        if h.numel():
            # NumPy's copy, a memcpy on this thread: ``Tensor.copy_`` would
            # spread it over torch's intra-op threads and wait for the
            # slowest, which on a host whose cores are shared sets the
            # upload's tail
            _view(slab, h.dtype, h.shape, off).numpy()[...] = h.numpy()
    whole = torch.empty(end, dtype=torch.uint8, device=device)
    with torch.cuda.device(device) if device.type == "cuda" \
            else contextlib.nullcontext():
        if end:
            _copy(whole, slab.buf[:end])
        _release_after_copy(slab, device)
    return [whole[off:off + h.numel() * h.element_size()]
            .view(h.dtype).view(h.shape) for h, off in zip(hosts, offs)]


def put_pieces(arr: np.ndarray, device=None) -> torch.Tensor:
    """``arr`` as a tensor on ``device`` (None: the current CUDA device):
    staged through pinned memory and copied without blocking on the card;
    ``torch.from_numpy`` on the CPU (sharing ``arr``'s memory)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return _host(arr)
    return _put_staged([arr], dev, pool(dev))[0]


def put_tree(prep: dict, device=None) -> dict:
    """Every array of a dict as a tensor on ``device``, keyed alike: one
    staging buffer and one copy on the card, each tensor a view of one
    device buffer; ``torch.from_numpy`` each on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    keys = list(prep)
    if dev.type == "cpu":
        return {k: _host(prep[k]) for k in keys}
    return dict(zip(keys, _put_staged([prep[k] for k in keys], dev,
                                      pool(dev))))


def _copy_out(pairs: list) -> None:
    """Each (source, host destination) pair copied, one side stream a
    card after the work queued on its current stream, then one wait for
    them all. CPU sources copy at once."""
    by_dev = {}
    for src, dst in pairs:
        if src.device.type != "cuda":
            dst.copy_(src)
            continue
        by_dev.setdefault(src.device, []).append((src, dst))
    done = []
    for dev, items in by_dev.items():
        side = pool(dev).side
        ready = torch.cuda.current_stream(dev).record_event()
        side.wait_event(ready)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            for src, dst in items:
                _copy(dst, src)
                src.record_stream(side)
            done.append(side.record_event())
    for ev in done:
        ev.synchronize()


def _hand_out(slab: _Slab, t: torch.Tensor) -> np.ndarray:
    """``t`` (a view of ``slab``) as the caller's array: the slab stays
    busy while the array, or any array made from it, lives."""
    arr = t.numpy()
    # a view of ``arr`` holds ``arr`` (its base), so ``arr`` lives as long
    # as anything made from it
    ref = weakref.ref(arr)
    slab.busy = lambda: ref() is not None
    return arr


def _fetch_staged(tensors: list, staging: StagingPool) -> list:
    """Tensors -> arrays in buffers of ``staging`` (each its own)."""
    srcs = [t.contiguous() for t in tensors]
    slabs = [staging.take(s.numel() * s.element_size()) if s.numel()
             else None for s in srcs]
    dsts = [_view(slab, s.dtype, s.shape) if slab is not None
            else torch.empty(s.shape, dtype=s.dtype)
            for s, slab in zip(srcs, slabs)]
    _copy_out([(s, d) for s, d, slab in zip(srcs, dsts, slabs) if slab])
    return [d.numpy() if slab is None else _hand_out(slab, d)
            for d, slab in zip(dsts, slabs)]


def fetch_pieces(tensors) -> list:
    """Tensors -> NumPy arrays, in order. Card tensors come back through
    pinned buffers of the pool, on a side stream that waits on the
    producer's stream, with one wait for the whole call; CPU tensors are
    ``Tensor.numpy()`` (sharing their memory)."""
    tensors = list(tensors)
    out = [None] * len(tensors)
    card = [i for i, t in enumerate(tensors) if t.device.type != "cpu"]
    for i, t in enumerate(tensors):
        if t.device.type == "cpu":
            out[i] = t.numpy()
    if card:
        got = _fetch_staged([tensors[i] for i in card],
                            pool(tensors[card[0]].device))
        for i, a in zip(card, got):
            out[i] = a
    return out


def _concat_staged(tensors: list, dim: int, staging: StagingPool):
    srcs = [t.contiguous() for t in tensors]
    shape = list(srcs[0].shape)
    shape[dim] = sum(s.shape[dim] for s in srcs)
    slab = staging.take(max(1, int(np.prod(shape)) * srcs[0].element_size()))
    whole = _view(slab, srcs[0].dtype, tuple(shape))
    pairs, off = [], 0
    for s in srcs:
        n = s.shape[dim]
        # one contiguous run per index of the dimensions before ``dim``
        for lead in itertools.product(*(range(k) for k in shape[:dim])):
            if n:
                pairs.append((s[lead], whole[lead].narrow(0, off, n)))
        off += n
    _copy_out(pairs)
    return _hand_out(slab, whole)


def fetch_concat(tensors, dim: int = 0) -> np.ndarray:
    """The concatenation of ``tensors`` along ``dim`` as one NumPy array,
    each fetched straight into its offset of one pinned buffer (no host
    concatenation); ``np.concatenate`` of their arrays when all are on the
    CPU. The tensors agree in dtype and in every other dimension."""
    tensors = list(tensors)
    if all(t.device.type == "cpu" for t in tensors):
        return np.concatenate([t.numpy() for t in tensors], axis=dim)
    first = next(t for t in tensors if t.device.type != "cpu")
    return _concat_staged(tensors, dim, pool(first.device))
