"""Layer: the closest hit.  Device nanoseconds of the closest-hit kernels
(``closest_hit_ms_per_render``'s ``PATTERNS``) in the traced stretch per
path vertex traced there.  The vertices: the stretch's work-queue calls
(its ``queue.init`` program spans, one a ``trace_queue`` call) times the
program's ``QueueCounts.vertices`` per ``QueueCounts.calls`` over the run.
Moves ``msamples_per_s``."""
from portbench import program, spec

PATTERNS = spec.metric_reader("closest_hit_ms_per_render").PATTERNS


def read(run):
    c = program.counts()
    calls = len(program.span_durations(run.trace, "queue.init"))
    if not c or not c.get("queue_calls") or not calls:
        return None
    vertices = calls * c["vertices"] / c["queue_calls"]
    us = run.trace.kernel_us(PATTERNS)
    return us * 1e3 / vertices if us and vertices else None
