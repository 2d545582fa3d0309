"""The program's own spans in a traced run: what the span metrics read
(``metrics/decode.parse.py`` and the others that import this).

The program records its spans (``mp3stego_tpu_torch.utils.profiling``:
``spans()``, each with ``name``, ``thread``, ``t0`` and ``t1`` on
``time.perf_counter()``) while a profiler runs,
as it does over a traced stretch. A span belongs to the run when its
``t0`` falls inside a traced request's ``[start, end]`` (``core.Record``,
the same clock). Where the program has no recorder, or recorded nothing
there, every reading is None.
"""

import bisect
import threading


def of(run):
    """The recorder's spans that start inside the traced requests of
    ``run``, or None when the program keeps none there."""
    try:
        from mp3stego_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    bounds = sorted((r.start, r.end) for r in run.records)
    if not bounds:
        return None
    starts = [a for a, _ in bounds]
    kept = []
    for s in spans():
        k = bisect.bisect_right(starts, s.t0) - 1
        if k >= 0 and s.t0 <= bounds[k][1]:
            kept.append(s)
    return kept or None


def ms_per_audio_s(run, *names):
    """The seconds of the spans named ``names``, in ms a second of the
    traced requests' audio; None when there are none."""
    got = of(run)
    audio = run.audio_s()
    if got is None or audio <= 0:
        return None
    picked = [s.t1 - s.t0 for s in got if s.name in names]
    if not picked:
        return None
    return sum(picked) * 1e3 / audio


def unspanned_pct(run, thread=None):
    """100 x the share of the traced requests' wall in which no program
    span was open on the caller's thread (``thread``; by default this one,
    which is the one the harness called the kind on); None when no span
    of that thread falls in the requests."""
    got = of(run)
    if got is None:
        return None
    thread = threading.get_ident() if thread is None else thread
    mine = sorted((s.t0, s.t1) for s in got if s.thread == thread)
    if not mine:
        return None
    wall = uncovered = 0.0
    for r in run.records:
        wall += r.end - r.start
        at = r.start
        for a, b in mine:
            a, b = max(a, r.start), min(b, r.end)
            if b <= a or b <= at:
                continue
            if a > at:
                uncovered += a - at
            at = b
        uncovered += max(0.0, r.end - at)
    return 100.0 * uncovered / wall if wall > 0 else None
