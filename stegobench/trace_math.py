"""Reading a ``torch.profiler`` chrome trace: the device's records, the
union of their intervals, and the host's scopes over the device's idle gaps.

``device_ops`` and ``busy_us`` are frozen copies of the arithmetic of
``mp3stego_tpu_torch/utils/profiling.py``'s ``parse_device_trace`` and
``device_busy`` at commit e1ac834 (the categories of device work, the
union of their intervals), cut to what the benchmark reads.
``idle_gaps`` is the benchmark's own.
"""

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SCOPE_CAT = "user_annotation"


def events(path: str) -> list:
    """The complete (``ph`` "X") events of the chrome trace at ``path``."""
    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X" and "ts" in e]


def device_ops(evs: list) -> list:
    """One dict a kernel, memcpy or memset: ``name``, ``category``, and
    ``ts`` and ``dur`` in microseconds."""
    return [dict(name=e["name"], category=e["cat"], ts=float(e["ts"]),
                 dur=float(e.get("dur", 0.0)))
            for e in evs if e.get("cat") in DEVICE_CATS]


def intervals(ops: list) -> list:
    """The union of the ops' intervals, as sorted disjoint (start, end)."""
    out = []
    for a, b in sorted((o["ts"], o["ts"] + o["dur"]) for o in ops):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_us(ops: list) -> float:
    """Microseconds in which at least one op ran on the device."""
    return sum(b - a for a, b in intervals(ops))


def kernel_us(ops: list, pattern: str) -> float:
    """Device microseconds of the kernels whose name contains
    ``pattern``."""
    return sum(o["dur"] for o in ops
               if o["category"] == "kernel" and pattern in o["name"])


def top_ops(ops: list, n: int = 10) -> list:
    """[name, seconds] of the ``n`` device op names of most time."""
    by = {}
    for o in ops:
        by[o["name"]] = by.get(o["name"], 0.0) + o["dur"]
    return [[k[:96], v / 1e6] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(evs: list, ops: list, t0: float, t1: float,
              n: int = 10) -> list:
    """[host scope, seconds] of the ``n`` longest stretches of [t0, t1]
    (microseconds) in which the device ran nothing, each named by the
    innermost host annotation (``record_function`` range) open at its
    middle, or "none"."""
    scopes = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
               e["name"]) for e in evs if e.get("cat") == HOST_SCOPE_CAT]
    gaps, at = [], t0
    for a, b in intervals(ops) + [(t1, t1)]:
        a, b = max(a, t0), min(b, t1)
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        inside = [s for s in scopes if s[0] <= mid <= s[1]]
        name = min(inside, key=lambda s: s[1] - s[0])[2] if inside \
            else "none"
        out.append([name, (b - a) / 1e6])
    return out
