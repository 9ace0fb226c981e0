"""Where a traced benchmark run's idle device time falls, span by span.

    python3 tools/span_idle.py --workload nextweek.queue --seed 7 \\
        --seconds 30

from the root of a checkout, on a machine with the cell's CUDA card.  Runs
one traced run of the cell (``portbench/harness.py``, as ``run.py --trace
1`` does) and prints, from its traced stretch: the renders; device busy
and idle ms a render, and the idle inside the benchmark's request spans;
for each program span (``tpu_ray_torch/utils/profiling.py`` ``SPANS``)
the count a render, its mean host us and the idle ms a render under it;
the torch operations that take the most host time inside it; the share
of the in-request idle under ``render.setup``, ``render.finish``,
``queue.read`` and ``queue.iteration``; and the longest idle gaps, each
with the innermost program span and torch operation open at its middle.
The last line is the same as one JSON object, the run's result line
under ``result``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _k in ("TPU_RAY_SORT", "TPU_RAY_SWEEP_MXU", "TPU_RAY_CULL_STYLE",
           "TPU_RAY_CRASH_AFTER_WAVE"):
    os.environ.pop(_k, None)
os.environ["TPU_RAY_TORCH_BUILD_DIR"] = os.path.join(ROOT, "tpu_ray_torch",
                                                     "_build")
sys.path.insert(0, ROOT)

from portbench import harness, program, spec  # noqa: E402

COVER = ("render.setup", "render.finish", "queue.read", "queue.iteration")
TOP = 10


def innermost(items, t):
    """The name of the shortest (name, start, end) open at ``t``, or
    None."""
    best = None
    for n, s, e in items:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (n, s, e)
    return best[0] if best else None


def host_ops(tr, prog) -> dict:
    """{span: {torch operation: host seconds}}: each outermost torch
    operation, by the innermost program span open at its start."""
    ops = sorted((x for x in tr.cpu_ops if not x[0].startswith(
        program.PREFIX) and tr.t0 <= x[1] < tr.t1), key=lambda x: x[1])
    out, end = {}, -1.0
    for n, s, e in ops:
        if s < end:             # inside an operation already counted
            continue
        end = e
        sp = innermost(prog, s) or "none"
        out.setdefault(sp, {})
        out[sp][n] = out[sp].get(n, 0.0) + (e - s) / 1e6
    return out


def gap_labels(tr, prog, top: int = TOP) -> list:
    """(seconds, program span, torch operation) of the ``top`` longest
    idle stretches, the longest first, at each one's middle."""
    edges = [tr.t0]
    for s, e in tr.busy_intervals():
        edges += [s, e]
    edges.append(tr.t1)
    gaps = sorted(((e - s, 0.5 * (s + e)) for s, e in
                   zip(edges[::2], edges[1::2]) if e > s), reverse=True)
    ops = [x for x in tr.cpu_ops if not x[0].startswith(program.PREFIX)]
    return [(d / 1e6, innermost(prog, t) or "none",
             innermost(ops, t) or "python") for d, t in gaps[:top]]


def traced_run(cell, seed: int, seconds: float, device="cuda"):
    """(result line, the traced stretch's ``trace.Trace``) of one traced
    run of ``cell``."""
    kept = []
    stop = harness._stop_profile

    def keep(prof, tmp, parse=True):
        tr = stop(prof, tmp, parse)
        if tr is not None:
            kept.append(tr)
        return tr

    harness._stop_profile = keep
    try:
        result, _ = harness.run(cell, seed, seconds, True, device)
    finally:
        harness._stop_profile = stop
    return result, kept[-1]


def report(tr, result, name: str, seed: int) -> dict:
    """Print the stretch's idle by span; returns the same as a dict."""
    from tpu_ray_torch.utils.profiling import PREFIX, SPANS

    n = tr.n_renders
    busy = tr.busy_s()
    req = sorted([max(s, tr.t0), min(e, tr.t1)] for sp, s, e in tr.spans
                 if sp == harness.trace.REQUEST)
    in_req = program.idle_in(tr, req)
    spans = {}
    for sp in SPANS:
        d = program.span_durations(tr, sp)
        idle = program.idle_under(tr, [sp])
        spans[sp] = dict(per_render=len(d) / n,
                         mean_us=sum(d) / len(d) * 1e6 if d else None,
                         idle_ms_per_render=(idle or 0.0) * 1e3 / n)
    prog = [(x[0][len(PREFIX):], x[1], x[2]) for x in tr.cpu_ops
            if x[0].startswith(PREFIX)]
    by_span = host_ops(tr, prog)
    for sp, v in spans.items():
        ops = sorted(by_span.get(sp, {}).items(), key=lambda kv: -kv[1])
        v["host_ops_ms_per_render"] = [[k, t * 1e3 / n] for k, t in ops[:3]]
    covered = program.idle_under(tr, COVER) or 0.0
    out = dict(workload=name, seed=seed, renders=n, window_s=tr.window_s,
               busy_ms_per_render=busy * 1e3 / n,
               idle_ms_per_render=(tr.window_s - busy) * 1e3 / n,
               in_request_idle_ms_per_render=in_req * 1e3 / n,
               covered_share=covered / in_req if in_req else None,
               spans=spans, idle_gaps=gap_labels(tr, prog), result=result)
    print(f"{name} seed {seed}: {n} renders in {tr.window_s:.3f} s traced; "
          f"busy {out['busy_ms_per_render']:.3f} ms, idle "
          f"{out['idle_ms_per_render']:.3f} ms a render, "
          f"{out['in_request_idle_ms_per_render']:.3f} ms in requests, of "
          f"which {out['covered_share'] or 0:.4f} under {', '.join(COVER)}")
    for sp, v in spans.items():
        if v["per_render"]:
            print(f"  {PREFIX}{sp:<18} {v['per_render']:8.2f} a render, "
                  f"mean {v['mean_us']:10.1f} us, idle "
                  f"{v['idle_ms_per_render']:8.3f} ms a render; host ms "
                  + ", ".join(f"{k} {t:.3f}"
                              for k, t in v["host_ops_ms_per_render"]))
    for s, sp, op in out["idle_gaps"]:
        print(f"  gap {s * 1e3:8.3f} ms  {sp}:{op}")
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/span_idle.py")
    p.add_argument("--workload", default="nextweek.queue")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    a = p.parse_args(argv)
    result, tr = traced_run(spec.load_cell(a.workload), a.seed, a.seconds)
    report(tr, result, a.workload, a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
