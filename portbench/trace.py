"""From a ``torch.profiler`` trace of a stretch of renders to device time.

The trace is the profiler's Chrome-trace export.  Device operations are
its ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; the stretch is
the span from the first to the last of the benchmark's own request
annotations (``portbench.request``); the host spans that label an idle gap
are the benchmark's annotations (``portbench.<span>``) and, inside them,
the innermost ``cpu_op`` open at the gap's middle.  Device busy time is the
union of the operations' intervals, so overlapping operations count once;
the idle share is one less busy over the stretch.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST = "portbench.request"
TOP = 10


@dataclass
class Trace:
    """Device operations and host spans of one traced stretch (times in
    microseconds of the trace's clock)."""

    ops: list                   # (name, start, duration)
    spans: list                 # (name, start, end) of portbench.* spans
    cpu_ops: list               # (name, start, end)
    t0: float
    t1: float
    n_renders: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        stretch, in time order."""
        out = []
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.t0), min(s + d, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_us(self, patterns) -> float:
        """Device microseconds of the operations whose name contains one of
        ``patterns``."""
        return sum(d for n, _, d in self.ops if any(p in n for p in patterns))

    def by_name(self) -> list:
        """(name, total seconds, count) of every device operation name, the
        most time first."""
        tot = {}
        for n, _, d in self.ops:
            t, c = tot.get(n, (0.0, 0))
            tot[n] = (t + d, c + 1)
        return sorted(((n, t / 1e6, c) for n, (t, c) in tot.items()),
                      key=lambda x: -x[1])

    def idle_gaps(self, top: int = TOP) -> list:
        """(label, seconds) of the ``top`` longest idle stretches between
        busy intervals, the longest first; the label is the host span open
        at its middle and the innermost host operation inside it."""
        edges = [self.t0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.t1)
        gaps = sorted(((s, e) for s, e in zip(edges[::2], edges[1::2])
                       if e > s), key=lambda g: g[0] - g[1])[:top]
        return [(self.label_at(0.5 * (s + e)), (e - s) / 1e6)
                for s, e in gaps]

    def label_at(self, t: float) -> str:
        def innermost(items):
            best = None
            for n, s, e in items:
                if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                    best = (n, s, e)
            return best
        sp = innermost([x for x in self.spans if x[0] != REQUEST])
        op = innermost(self.cpu_ops)
        span = sp[0].split(".", 1)[1] if sp else "between_requests"
        return f"{span}:{op[0] if op else 'python'}"

    def breakdown(self) -> dict:
        return dict(device_ops=[[n, s] for n, s, _ in self.by_name()[:TOP]],
                    idle_gaps=[[n, s] for n, s in self.idle_gaps()])


def from_chrome(events: list) -> Trace:
    """The stretch of a Chrome-trace event list (``traceEvents``)."""
    ops, spans, cpu = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((name, s, d))
        elif cat == "user_annotation" and name.startswith("portbench."):
            spans.append((name, s, s + d))
        elif cat == "cpu_op":
            cpu.append((name, s, s + d))
    req = [x for x in spans if x[0] == REQUEST]
    if not req:
        raise ValueError("the trace holds no request span")
    t0, t1 = min(x[1] for x in req), max(x[2] for x in req)
    return Trace(ops=[o for o in ops if t0 <= o[1] < t1], spans=spans,
                 cpu_ops=cpu, t0=t0, t1=t1, n_renders=len(req))


def from_file(path: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return from_chrome(data["traceEvents"] if isinstance(data, dict) else data)
