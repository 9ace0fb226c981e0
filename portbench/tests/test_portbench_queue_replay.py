"""``queue_replay_share``: the program's replay counters over its dispatched
queue iterations on a traced run, and None where there is nothing to read."""
import sys
import types

import pytest

from portbench import harness, spec, trace


def _trace():
    """One request of 100 us with one kernel on the device."""
    x = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts,
                                        dur=dur)
    return trace.from_chrome([
        x("user_annotation", "portbench.request", 0, 100),
        x("user_annotation", "portbench.render", 0, 100),
        x("kernel", "void bvh_kernel<1, false>(Args)", 10, 20)])


def _counts(monkeypatch, c):
    mod = types.ModuleType("tpu_ray_torch.utils.profiling")
    if c is not None:
        mod.counts = lambda: dict(c)
    monkeypatch.setitem(sys.modules, "tpu_ray_torch.utils.profiling", mod)


@pytest.mark.parametrize("counters,want", [
    (None, None), ({}, None),
    # a program older than the replay counters, or one that ran no queue
    (dict(queue_calls=4, vertices=400, lane_slots=1000), None),
    (dict(iterations=0, replayed=0), None),
    (dict(iterations=512, replayed=472), 472 / 512),
    (dict(iterations=128, replayed=0), 0.0)])
def test_queue_replay_share_reads_the_replay_counters(monkeypatch, counters,
                                                      want):
    """``replayed / iterations`` of the program's counters on a traced run;
    None without a trace, without counters or with no iteration counted."""
    _counts(monkeypatch, counters)
    reader = spec.metric_reader("queue_replay_share")
    assert reader.read(harness.RunData()) is None
    got = reader.read(harness.RunData(trace=_trace()))
    assert got == (None if want is None else pytest.approx(want))
