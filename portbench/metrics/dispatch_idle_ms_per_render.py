"""Layer: the host loops (``integrator.trace_queue``).  Device milliseconds
idle a render under the program span ``queue.iteration``: the host issuing
one ``queue_body`` (path ids, closest hit, step, inject), in the traced
stretch.  Moves ``msamples_per_s``."""
from portbench import program

SPANS = ("queue.iteration",)


def read(run):
    s = program.idle_under(run.trace, SPANS)
    return None if s is None else s * 1e3 / run.trace.n_renders
