"""The program's own spans and counters, for the per-layer metrics that
read them.

``tpu_ray_torch`` marks its layers on the profiler's CPU timeline while a
profiler runs: ``cpu_op`` events named ``tpu_ray_torch.<span>``
(``tpu_ray_torch/utils/profiling.py`` lists every span), which
``trace.from_chrome`` keeps among ``Trace.cpu_ops`` on the device
operations' clock.  It also keeps counters (``profiling.counts()``: kernel
launches, the work queue's calls, path vertices and lane slots), read
here from the running program: totals over the whole run, warm-up
included.  A program without spans or counters (one older than them)
gives None from every function here, never an error.
"""
from __future__ import annotations

import sys

PREFIX = "tpu_ray_torch."


def intervals(tr, names) -> list:
    """The union of the intervals of the program spans ``names`` (without
    the prefix), clipped to the stretch, as [start, end] in time order."""
    want = {PREFIX + n for n in names}
    out = []
    for _, s, e in sorted((x for x in tr.cpu_ops if x[0] in want),
                          key=lambda x: x[1]):
        s, e = max(s, tr.t0), min(e, tr.t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_under(tr, names):
    """Seconds of the stretch inside the spans ``names`` in which no device
    operation ran; None without a trace or without such a span."""
    if tr is None:
        return None
    spans = intervals(tr, names)
    return idle_in(tr, spans) if spans else None


def idle_in(tr, spans) -> float:
    """Seconds inside ``spans`` ([start, end] in time order, disjoint) in
    which no device operation ran."""
    busy, j, overlap = tr.busy_intervals(), 0, 0.0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            overlap += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return (sum(e - s for s, e in spans) - overlap) / 1e6


def span_durations(tr, name: str) -> list:
    """Seconds of each span ``name`` that starts in the stretch."""
    if tr is None:
        return []
    return [(e - s) / 1e6 for n, s, e in tr.cpu_ops
            if n == PREFIX + name and tr.t0 <= s < tr.t1]


def counts():
    """The running program's counters (``profiling.counts()``), or None
    where it keeps none."""
    mod = sys.modules.get("tpu_ray_torch.utils.profiling")
    fn = getattr(mod, "counts", None)
    return fn() if fn is not None else None
