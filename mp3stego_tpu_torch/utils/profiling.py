"""Tracing / profiling utilities.

* ``StageTimer`` — per-stage wall-clock accounting for the decode pipeline
  (host parse, host_prepare, h2d, device plane, d2h, WAV write), printed
  when ``quiet=False`` or read programmatically. Given a ``sync`` callable
  (``torch.cuda.synchronize``) it waits for the device at each stage
  boundary, so asynchronous kernel launches are charged to the stage that
  made them.
* ``trace()`` — context manager around ``torch.profiler.profile``: writes a
  chrome/perfetto trace of the host and device work under a directory (set
  MP3STEGO_TPU_TRACE=<dir> to trace any pipeline without code changes). The
  decode plane's stages run under ``record_function`` scopes named like the
  JAX package's ``jax.named_scope``s, so the two packages' traces line up.
* ``progress()`` — tqdm-wrapped iterable (the encoder's frame loop) when
  available/enabled, else the plain iterable.
* ``byte_bar()`` — tqdm byte-progress bar when available/enabled.
"""

import contextlib
import os
import time
from collections import OrderedDict


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t.stage("host_parse"):
    ...     pass
    >>> _ = t.report()
    """

    def __init__(self, enabled: bool = True, sync=None):
        self.enabled = enabled
        self.sync = sync
        self.times = OrderedDict()
        self.counts = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'stage':<24}{'time':>10}  {'calls':>6}  {'share':>6}"]
        for name, t in self.times.items():
            share = (t / total * 100.0) if total else 0.0
            lines.append(f"{name:<24}{t * 1e3:>8.1f}ms  {self.counts[name]:>6}"
                         f"  {share:>5.1f}%")
        lines.append(f"{'total':<24}{total * 1e3:>8.1f}ms")
        return "\n".join(lines)

    def print_report(self):
        print(self.report())


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Wrap a block in a ``torch.profiler`` trace of CPU and (when a card is
    present) CUDA activity, exported as ``<log_dir>/trace.json``. No-op when
    no directory is given and MP3STEGO_TPU_TRACE is unset."""
    log_dir = log_dir or os.environ.get("MP3STEGO_TPU_TRACE")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def progress(iterable, desc: str = "", enabled: bool = True):
    """tqdm-wrapped iterable (the reference's progress observability,
    MP3_Encoder.py:607), degrading to the plain iterable when disabled or
    tqdm is missing."""
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc)


class _NullBar:
    def update(self, n=0):
        pass

    def close(self):
        pass


def byte_bar(total: int, enabled: bool = True, desc: str = "decoding"):
    """Byte-progress bar (the reference's per-byte decode tqdm,
    MP3_Parser.py:67); a no-op object when disabled or tqdm is missing."""
    if not enabled:
        return _NullBar()
    try:
        from tqdm import tqdm
    except ImportError:
        return _NullBar()
    return tqdm(total=total, unit="B", unit_scale=True, desc=desc)
