"""Layer: the host loops (``integrator.trace_pool_staged``,
``integrator.trace_queue``, ``ops/megakernel.trace_pool_mega``).  Device
operations (kernels, copies, fills) the profiler saw in the traced
stretch, per render: each costs the host a launch, and a loop that stays
on the device needs fewer.  Moves ``msamples_per_s``."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return len(tr.ops) / tr.n_renders
