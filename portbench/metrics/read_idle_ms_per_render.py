"""Layer: the host loops (``integrator.trace_queue``).  Device milliseconds
idle a render under the program span ``queue.read``: the work queue's read
of (frontier, active lanes, census) once an epoch, the progress callback
and the exit test, in the traced stretch.  Moves ``msamples_per_s``."""
from portbench import program

SPANS = ("queue.read",)


def read(run):
    s = program.idle_under(run.trace, SPANS)
    return None if s is None else s * 1e3 / run.trace.n_renders
