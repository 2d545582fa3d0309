"""Tracing / profiling utilities.

* ``span()`` / ``count()`` — the port's one span recorder. A span is a
  named stretch of host work with its id, its parent and root span (the
  enclosing span, carried by a ``contextvars`` variable, and across a
  thread pool by ``bind()``), its thread, ``t0`` and ``t1`` on
  ``time.perf_counter()`` and its counts (``count()`` adds to the
  innermost open span). Spans are recorded while a ``torch.profiler``
  runs, inside ``recording()`` and under ``trace()``; each is then also a
  ``record_function`` range of the same name where the profiler sees its
  thread, so it lands on the device trace's clock. Otherwise ``span`` is
  one check and a shared null context. ``spans()`` returns the last ``SPAN_LIMIT`` spans.
* ``StageTimer`` — per-stage wall-clock accounting for the decode pipeline
  (host parse, host_prepare, h2d, device plane, d2h, WAV write), printed
  when ``quiet=False`` or read programmatically. Given a ``sync`` callable
  (``torch.cuda.synchronize``) it waits for the device at each stage
  boundary, so asynchronous kernel launches are charged to the stage that
  made them. Each stage is a span, the trailing wait inside it.
* ``trace()`` — context manager around ``torch.profiler.profile``: writes a
  chrome/perfetto trace of the host and device work under a directory (set
  MP3STEGO_TPU_TRACE=<dir> to trace any pipeline without code changes). The
  decode plane's stages run under ``record_function`` scopes named like the
  JAX package's ``jax.named_scope``s, so the two packages' traces line up;
  while a profiler runs, every span is such a scope too.
* ``parse_device_trace()`` / ``stage_utilization()`` — the device records
  of that trace (kernels, memcpys, memsets) with the scopes that hold them,
  and their device time per stage: the JAX package's readers of its
  device timeline, with their signatures and return shapes.
* ``device_busy()`` — the union of the trace's device intervals, the
  traced wall and the device's idle share.
* ``progress()`` — tqdm-wrapped iterable (the encoder's frame loop) when
  available/enabled, else the plain iterable.
* ``byte_bar()`` — tqdm byte-progress bar when available/enabled.
"""

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque

from torch.autograd import profiler as _autograd_profiler

# the chrome trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the category of a ``record_function`` range on the device's timeline
ANNOTATION_CAT = "gpu_user_annotation"

# the most spans kept; older ones are dropped (and counted) past it
SPAN_LIMIT = 1 << 20


class Span:
    """One recorded span: ``name``, ``id``, ``parent`` (the id of the span
    open around it, None at a root), ``root`` (the id of its outermost
    ancestor, its own at a root), ``thread`` (``threading.get_ident()``),
    ``t0`` and ``t1`` (``time.perf_counter()`` seconds) and ``counts``
    (name → number)."""

    __slots__ = ("name", "id", "parent", "root", "thread", "t0", "t1",
                 "counts", "_token", "_range")

    def __enter__(self):
        up = _open.get()
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.thread = threading.get_ident()
        self._token = _open.set(self)
        self._range = _scope(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        self._range.__exit__(*exc)
        _open.reset(self._token)
        self._token = self._range = None
        global _dropped
        with _keep_lock:
            if len(_kept) == _kept.maxlen:
                _dropped += 1
            _kept.append(self)
        return False


_open = contextvars.ContextVar("mp3stego_tpu_torch_span", default=None)
_ids = itertools.count(1)
_kept = deque(maxlen=SPAN_LIMIT)
_keep_lock = threading.Lock()
_dropped = 0
_forced = 0                       # open ``recording()`` blocks
_NULL = contextlib.nullcontext()


def span(name: str, **counts):
    """A context manager that records a span named ``name`` with the
    starting ``counts`` (see ``Span``); ``with span(...) as s`` gives the
    ``Span``, or None when nothing is recorded. Recording is on while a
    ``torch.profiler`` runs, inside ``recording()`` and under ``trace()``;
    otherwise this is one check and a shared null context. A span never
    waits for the card."""
    # torch's flag is global: a profiler started in any thread
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _NULL
    s = Span()
    s.name, s.counts = name, counts
    return s


def count(name: str, n=1):
    """Add ``n`` to the count ``name`` of the innermost open span (of this
    thread, or the span ``bind`` carried into it); nothing when none is
    open."""
    s = _open.get()
    if s is not None:
        with _keep_lock:          # ``bind`` may share the span among threads
            s.counts[name] = s.counts.get(name, 0) + n


def bind(fn):
    """``fn`` to run on another thread (a ``ThreadPoolExecutor`` task) as if
    inside the span open here: spans it opens take that span as parent and
    share its root. ``fn`` itself when no span is open."""
    s = _open.get()
    if s is None:
        return fn

    def bound(*args, **kwargs):
        token = _open.set(s)
        try:
            return fn(*args, **kwargs)
        finally:
            _open.reset(token)
    return bound


@contextlib.contextmanager
def recording():
    """Record spans inside this block whether a profiler runs or not (for
    tests and operators; ``spans()`` reads them)."""
    global _forced
    with _keep_lock:
        _forced += 1
    try:
        yield
    finally:
        with _keep_lock:
            _forced -= 1


def spans() -> list:
    """The recorded spans, oldest first, each a ``Span``: the last
    ``SPAN_LIMIT`` closed ones."""
    with _keep_lock:
        return list(_kept)


def dropped_spans() -> int:
    """How many spans the bound on kept spans has dropped."""
    return _dropped


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
        """A span named ``name`` (``with t.stage(...) as s`` gives the
        ``Span``, or None when nothing is recorded); when enabled, also its
        wall added to ``times[name]`` (from after the leading wait for the
        card to after the trailing one, which the span holds too) and a
        call to ``counts[name]``."""
        if not self.enabled:
            with span(name) as s:
                yield s
            return
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        try:
            with span(name) as s:
                try:
                    yield s
                finally:
                    if self.sync is not None:
                        self.sync()
        finally:
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


def _scope(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs in
    this thread (the range costs ~10 us on the host), else nothing."""
    import torch
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Wrap a block in a ``torch.profiler`` trace of CPU and (when a card is
    present) CUDA activity, exported as ``<log_dir>/trace.json``, recording
    spans inside it. No-op when no directory is given and
    MP3STEGO_TPU_TRACE is unset."""
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
    with recording(), profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _events(trace) -> list:
    """The ``traceEvents`` of a chrome trace: ``trace`` is the dict, its
    file, or a directory holding ``trace.json`` (what :func:`trace`
    writes)."""
    if isinstance(trace, dict):
        return trace.get("traceEvents", [])
    path = os.path.join(trace, "trace.json") if os.path.isdir(trace) \
        else trace
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace at {path}")
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _spans(events: list, cat) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cat]


def parse_device_trace(log_dir: str) -> dict:
    """The device records of the trace that :func:`trace` wrote under
    ``log_dir`` (or of a chrome trace file or dict).

    Returns ``{"ops": [...], "module_runs": {name: count}}``. Each op record
    is one kernel, memcpy or memset on the device: ``name``, ``scope`` (the
    names of the ``gpu_user_annotation`` ranges of its device and stream
    that contain it, outermost first: the ``record_function`` scopes),
    ``dur_us`` (device time), ``flops`` and ``bytes`` (the trace's own
    ``flops`` and ``bytes`` args where it gives them, else 0) and
    ``category`` (the event's ``cat``). ``module_runs`` counts the
    top-level annotations (those no other annotation contains) by name, so
    callers can turn per-op sums into per-run numbers."""
    events = _events(log_dir)
    lanes = {}
    for a in _spans(events, (ANNOTATION_CAT,)):
        lanes.setdefault((a.get("pid"), a.get("tid")), []).append(
            (float(a["ts"]), float(a["ts"]) + float(a.get("dur", 0.0)),
             a["name"]))
    module_runs = {}
    for lane in lanes.values():
        lane.sort(key=lambda r: (r[0], -r[1]))
        for i, (a, b, name) in enumerate(lane):
            if not any(a0 <= a and b <= b0 for a0, b0, _ in lane[:i]):
                module_runs[name] = module_runs.get(name, 0) + 1
    ops = []
    for e in _spans(events, DEVICE_CATS):
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        args = e.get("args", {})
        ops.append(dict(
            name=e["name"],
            scope=[n for a, b, n in lanes.get((e.get("pid"), e.get("tid")),
                                              ()) if a <= t0 and t1 <= b],
            dur_us=float(e.get("dur", 0.0)),
            flops=int(args.get("flops", 0) or 0),
            bytes=int(args.get("bytes", 0) or 0),
            category=e["cat"],
        ))
    return {"ops": ops, "module_runs": module_runs}


# the categories of records that ``stage_utilization``'s ``rolled_stage``
# may claim when they fall in no scope: every device record
ROLLED_CATEGORIES = DEVICE_CATS


def stage_utilization(ops: list, stage_names: list, runs: int = 1,
                      rolled_stage: str = None) -> dict:
    """Aggregate device records (:func:`parse_device_trace`) per stage.

    ``stage_names`` are ``record_function`` names; a record whose scope
    contains one of them goes to the FIRST (outermost) match, a record in
    no scope to ``rolled_stage`` when given, everything else to
    ``"other"``. Returns per stage: device ms per run, time share, GFLOPs
    and GB per run (from the trace's counts, 0 where it gives none),
    TFLOP/s and GB/s, and the dominant (by time) category. The JAX
    package's function, line for line."""
    agg = {}
    for op in ops:
        stage = "other"
        for s in op["scope"]:
            if s in stage_names:
                stage = s
                break
        if (stage == "other" and rolled_stage and not op["scope"]
                and op["category"] in ROLLED_CATEGORIES):
            stage = rolled_stage
        a = agg.setdefault(stage, dict(us=0.0, flops=0, bytes=0, cats={}))
        a["us"] += op["dur_us"]
        a["flops"] += op["flops"]
        a["bytes"] += op["bytes"]
        a["cats"][op["category"]] = (a["cats"].get(op["category"], 0.0)
                                     + op["dur_us"])
    total_us = sum(a["us"] for a in agg.values()) or 1e-9
    out = {}
    for stage, a in sorted(agg.items(), key=lambda kv: -kv[1]["us"]):
        s = a["us"] / 1e6 / max(runs, 1)
        out[stage] = dict(
            ms=round(a["us"] / 1e3 / max(runs, 1), 3),
            share=round(a["us"] / total_us, 3),
            gflops=round(a["flops"] / 1e9 / max(runs, 1), 3),
            gbytes=round(a["bytes"] / 1e9 / max(runs, 1), 4),
            tflops_s=round(a["flops"] / max(runs, 1) / max(s, 1e-12) / 1e12,
                           2),
            gb_s=round(a["bytes"] / max(runs, 1) / max(s, 1e-12) / 1e9, 1),
            dominant=max(a["cats"], key=a["cats"].get) if a["cats"] else "",
        )
    return out


def device_busy(trace, wall_ms: float = None) -> dict:
    """The device's busy time in a chrome trace (``trace``: a directory
    holding ``trace.json``, the file, or its dict): the union of its
    kernel, memcpy and memset intervals (``busy_ms``), their count by
    category, the 12 kernels of most device time, the traced wall
    (``wall_ms``: given by the caller, else the span of every complete
    event of the trace) and the idle share, 1 - busy / wall (None when the
    trace holds no kernel)."""
    events = _events(trace)
    spans, counts, by_name = [], {c: 0 for c in DEVICE_CATS}, {}
    for e in _spans(events, DEVICE_CATS):
        counts[e["cat"]] += 1
        a = float(e["ts"])
        spans.append((a, a + float(e.get("dur", 0.0))))
        if e["cat"] == "kernel":
            name = e["name"][:96]
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + float(e.get("dur", 0.0)))
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy_us += b - max(a, end)
        end = b
    if wall_ms is None:
        every = [e for e in events if e.get("ph") == "X" and "ts" in e]
        wall_ms = (max(float(e["ts"]) + float(e.get("dur", 0.0))
                       for e in every)
                   - min(float(e["ts"]) for e in every)) / 1e3 \
            if every else 0.0
    busy_ms = busy_us / 1e3
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "counts": counts,
            "idle_share": (1.0 - busy_ms / wall_ms)
            if counts["kernel"] and wall_ms > 0 else None,
            "top_kernels": [{"name": k, "launches": n, "ms": us / 1e3}
                            for k, (n, us) in sorted(
                                by_name.items(), key=lambda kv: -kv[1][1])[
                                    :12]]}


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
