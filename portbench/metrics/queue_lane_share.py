"""Layer: the work queue (``integrator.trace_queue``).  The program's
counters (``integrator.QueueCounts``, read through ``profiling.counts()``):
path vertices (the sum over iterations of the lanes active at the closest
hit) over lane slots (the pool size summed over every dispatched
iteration), over every render of the traced run, warm-up included: the
share of the dispatched lane slots that traced a ray.  Moves
``msamples_per_s``."""
from portbench import program


def read(run):
    c = program.counts() if run.trace is not None else None
    if not c or not c.get("lane_slots"):
        return None
    return c["vertices"] / c["lane_slots"]
