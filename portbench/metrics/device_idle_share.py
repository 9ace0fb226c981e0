"""Layer: the device (one H100).  The share of the traced stretch in which
no device operation (kernel, copy or fill) ran: 1 - (union of the
operations' intervals) / stretch.  Moves ``msamples_per_s``: device time
the host leaves idle is wall time no sample uses."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 1.0 - tr.busy_s() / tr.window_s
