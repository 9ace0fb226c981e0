"""Layer: the host loops (``integrator.trace_queue``).  The program's
counters (``integrator.QueueCounts``, read through ``profiling.counts()``):
the queue iterations run by an epoch's replay from a CUDA graph
(``replayed``) over the iterations dispatched (``iterations``), over every
render of the traced run, warm-up included: the share of the queue's work
that the host issued one graph launch an epoch for.  Moves
``msamples_per_s``."""
from portbench import program


def read(run):
    c = program.counts() if run.trace is not None else None
    if not c or not c.get("iterations") or "replayed" not in c:
        return None
    return c["replayed"] / c["iterations"]
