"""The harness: one cell of ``BENCHMARK.json``, run once.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names its request kind
(``kinds/<kind>.py``), and each per-layer metric is read by
``metrics/<metric>.py``. All are found by name, so a new configuration,
mix, kind or metric is a new file and an entry in ``BENCHMARK.json``.

A kind's module defines ``Workload(cfg, mix, seed, device)``, which makes
its inputs from the seed, and on it ``warm()``, ``schedule()`` (request
ids in the order the one caller sends them), ``call(i, timer, spans)``
(one request; returns its audio seconds), ``keep(i, n)`` (copies the
answer of the window's request n for the check, or drops it), ``work(i)``
(the shapes the kernel bounds read), ``check()`` (the compared numbers)
and ``close()``; it may set ``reference_s``, the seconds of the plain
reference's work in its set-up, which the set-up leaves out.
"""

import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load (compared whole: the
# program's own name begins with the last)
BANNED = ("jax", "jaxlib", "flax", "mp3stego_tpu")
# the traced stretch of a --trace 1 run: from the window's second request
# to the first request that ends this long after the window began, at most
# half the window
TRACE_SECONDS = 5.0


class Refused(Exception):
    """The run cannot be made here (no card, no program): exit non-zero
    and print no result."""


def load(folder: str, name: str):
    """The module ``stegobench/<folder>/<name>.py``."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.exists(path):
        raise Refused(f"no {folder[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"stegobench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(name: str, bench: dict = None) -> tuple:
    """(cell, configuration, traffic mix) of the workload ``name``."""
    bench = bench or read_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = read_json(ROOT, conf["file"])
    mix = read_json(HERE, "traffic", cell["traffic"] + ".json")
    return cell, cfg, mix


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Record:
    """One request: when it ran (host clock, seconds), its audio seconds,
    its stage and span seconds, and whether it raised."""

    def __init__(self, i):
        self.i, self.start, self.end = i, 0.0, 0.0
        self.audio_s = 0.0
        self.stages, self.spans = {}, {}
        self.error = None


def p90(values: list) -> float:
    """The 90th percentile as ``statistics.quantiles`` gives it
    (inclusive); the value itself for one sample."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def _profiler(card: bool, host: bool = True):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=([ProfilerActivity.CPU] if host else []) + (
        [ProfilerActivity.CUDA] if card else []))


def warm_profiler(card: bool):
    """Start and stop the profiler once, so that its own start-up (CUPTI's)
    falls in the set-up of a traced run and not in its stretch."""
    import torch
    with _profiler(card):
        torch.zeros(1, device="cuda" if card else "cpu").add_(1)


def export_ops(prof) -> list:
    """The device ops of a stopped profiler's chrome trace, read from a
    temporary file that is then removed."""
    from trace_math import device_ops, events
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        evs = events(path)
    finally:
        os.remove(path)
    return device_ops(evs)


def drive(work, seconds: float, traced: bool, timer_cls, sync):
    """One caller sends the kind's requests in ``schedule()``'s order, each
    as the last completes, until ``seconds`` have passed; the window closes
    when the last request completes. Python's cyclic garbage collector is
    off inside the window (what set-up made is frozen out of its reach
    first), so that no collection of the harness's objects lands in a
    request. Returns (records, window seconds less the harness's own
    bookkeeping between requests, the traced stretch or None)."""
    import torch
    records, stretch, prof = [], None, None
    held_s = 0.0

    def stop_trace():
        if sync is not None:
            sync()
        stretch[1] = time.perf_counter()
        stretch[3] = len(records)
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(path)
        stretch.append(path)
        return time.perf_counter() - stretch[1]

    gc.collect()
    gc.freeze()
    gc.disable()
    t0 = time.perf_counter()
    try:
        for i in work.schedule():
            if traced and len(records) == 1:
                prof = _profiler(sync is not None)
                prof.__enter__()
                stretch = [time.perf_counter(), None, 1, None]
            rec = Record(i)
            rec.start = time.perf_counter()
            timer = timer_cls(sync=sync) if traced else None
            try:
                with torch.profiler.record_function("request"):
                    rec.audio_s = work.call(i, timer, rec.spans)
            except Exception as e:  # noqa: BLE001 - a failed request counts
                rec.error = repr(e)
            rec.end = time.perf_counter()
            if timer is not None:
                rec.stages = dict(timer.times)
            records.append(rec)
            h0 = time.perf_counter()
            work.keep(i, len(records) - 1)
            held_s += time.perf_counter() - h0
            if prof is not None and (rec.end - t0
                                     >= min(TRACE_SECONDS, seconds / 2)):
                held_s += stop_trace()
                prof = None
            if rec.end - t0 >= seconds:
                break
        if prof is not None:                      # the window ended first
            stop_trace()
    finally:
        gc.enable()
        gc.unfreeze()
    window = records[-1].end - t0 - held_s
    return records, window, stretch


class Traced:
    """What a per-layer metric reads: the requests of the traced stretch
    with their stages, spans and kernel shapes, the device ops of the
    trace, the device's busy seconds and the stretch's wall seconds."""

    def __init__(self, records, works, ops, busy_s, window_s,
                 run_audio_s=0.0, run_window_s=0.0):
        self.records, self.works = records, works
        self.ops, self.busy_s, self.window_s = ops, busy_s, window_s
        # the whole window's audio seconds and seconds (as ``xrt`` takes
        # them), the traced stretch inside it
        self.run_audio_s, self.run_window_s = run_audio_s, run_window_s

    def stage_s(self, *names) -> float:
        return sum(r.stages.get(n, 0.0) for r in self.records for n in names)

    def span_s(self, *names) -> float:
        return sum(r.spans.get(n, 0.0) for r in self.records for n in names)

    def audio_s(self) -> float:
        return sum(r.audio_s for r in self.records)


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device=None, overrides: dict = None, log=None,
             t_setup: float = None) -> dict:
    """One run of the cell ``name``: set-up, warm-up, the window, then the
    check. ``device`` None means the card, and a missing card refuses the
    run; tests pass "cpu". ``overrides`` replaces configuration keys (tests
    run small pools; the control asks for float32). ``t_setup`` is when
    the process began (``time.perf_counter``), so that set-up counts the
    imports."""
    t_setup = time.perf_counter() if t_setup is None else t_setup
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = read_json(ROOT, "BENCHMARK.json")
    cell, cfg, mix = find_cell(name, bench)
    cfg = dict(cfg, **(overrides or {}))
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch sees no CUDA card")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['chips']} cards needed, "
                          f"{torch.cuda.device_count()} seen")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    from mp3stego_tpu_torch.utils.profiling import StageTimer
    kind = load("kinds", mix["kind"])
    work = kind.Workload(cfg, mix, seed, device)
    wanted = {m["name"]: m for m in bench["end_to_end"]
              if name in m.get("workloads", [name])}
    # an end-to-end metric read from the device's trace: the card's work
    # over the whole window, recorded by a profiler of device activity
    # alone (kernels, copies, sets), started before the window's first
    # request and stopped after its last
    whole = on_card and not traced and any(
        m["source"] == "device_trace" for m in wanted.values())
    try:
        work.warm()
        # the profiler's own start-up (CUPTI's, some seconds) is the
        # benchmark's instrument, not the program's set-up: left out of
        # ``setup_s`` as the reference's work is
        instrument_s = 0.0
        if traced or whole:
            p0 = time.perf_counter()
            warm_profiler(on_card)
            instrument_s = time.perf_counter() - p0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_setup - instrument_s \
            - getattr(work, "reference_s", 0.0)
        sync = (lambda: torch.cuda.synchronize(device)) if on_card else None
        prof = _profiler(on_card, host=False) if whole else None
        if prof is not None:
            prof.__enter__()
        records, window, stretch = drive(work, seconds, traced,
                                         StageTimer, sync)
        window_ops = None
        if prof is not None:
            sync()
            prof.__exit__(None, None, None)
            window_ops = export_ops(prof)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        banned = banned_modules()
        if banned:
            raise Refused(f"modules loaded that no run may load: {banned}")
        done = [r for r in records if r.error is None]
        errors = len(records) - len(done)
        result = dict(attempted=len(records))
        device_info = dict(
            platform="gpu" if on_card else "cpu",
            kind=torch.cuda.get_device_name(device) if on_card else "cpu",
            count=1, memory_peak_bytes=int(peak))
        metrics = {}
        audio = sum(r.audio_s for r in done)
        if not traced:
            from trace_math import busy_us
            lat = [(r.end - r.start) * 1e3 for r in done]
            # the card's compute: the union of its kernels' intervals (the
            # copies, on the copy engines, move with the host's memory
            # traffic from machine to machine)
            kernel_ms = busy_us([o for o in window_ops or ()
                                 if o["category"] == "kernel"]) / 1e3
            values = dict(xrt=audio / window if window > 0 else None,
                          p90_ms=p90(lat) if lat else None, setup_s=setup_s,
                          kernel_ms_per_audio_s=kernel_ms / audio
                          if kernel_ms and audio > 0 else None)
            for m, spec in wanted.items():
                if values.get(m) is not None:
                    metrics[m] = dict(value=values[m], unit=spec["unit"])
        else:
            _, _, first, last, path = stretch
            from trace_math import busy_us, device_ops, events, \
                idle_gaps, top_ops
            evs = events(path)
            os.remove(path)
            ops = device_ops(evs)
            # the stretch on the trace's clock: its requests' host scopes
            spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in evs if e.get("name") == "request"
                     and e.get("cat") == "user_annotation"]
            t_lo = min(a for a, _ in spans)
            t_hi = max(b for _, b in spans)
            recs = records[first:last]
            view = Traced([r for r in recs if r.error is None],
                          [work.work(r.i) for r in recs if r.error is None],
                          ops, busy_us(ops) / 1e6, (t_hi - t_lo) / 1e6,
                          run_audio_s=audio, run_window_s=window)
            for spec in bench["per_layer"]:
                if name not in spec.get("workloads", [name]):
                    continue
                value = load("metrics", spec["name"]).read(view)
                if value is not None:
                    metrics[spec["name"]] = dict(value=value,
                                                 unit=spec["unit"])
            device_info.update(busy_s=view.busy_s, window_s=view.window_s)
            result["breakdown"] = dict(device_ops=top_ops(ops),
                                       idle_gaps=idle_gaps(evs, ops, t_lo,
                                                           t_hi))
        del records
        failed, checks = work.check()
        failed = max(failed, 0) + errors
        checks = dict(errors=(errors, 0, "<="), **checks)
        ok = all((v <= lim) if op == "<=" else (v >= lim)
                 for v, lim, op in checks.values())
        for k, (v, lim, op) in checks.items():
            log(f"check {k} {v} limit {op} {lim}")
        result.update(correct=bool(ok and len(done) > 0), failed=failed,
                      metrics=metrics, device=device_info,
                      checks={k: dict(value=v, limit=lim, op=op)
                              for k, (v, lim, op) in checks.items()})
        return result
    finally:
        work.close()


def load_bench() -> dict:
    return read_json(ROOT, "BENCHMARK.json")


def result_line(result: dict) -> str:
    """The result as the last line of standard output: the contract's keys
    first, the compared numbers last."""
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: result[k] for k in keys if k in result})
