"""Layer: the host loops (``integrator.trace_queue``).  The mean host
microseconds of the program span ``queue.iteration`` (one ``queue_body``
issued) in the traced stretch.  Moves ``msamples_per_s``."""
from portbench import program


def read(run):
    d = program.span_durations(run.trace, "queue.iteration")
    return sum(d) / len(d) * 1e6 if d else None
