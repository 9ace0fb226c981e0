"""The program's spans and counters as the benchmark reads them, on a
synthetic Chrome trace: device idle under nested and repeated spans, the
idle gaps' labels with and without a program span, every number that was
read before left as it was, and each new metric's value, or None on a run
with nothing to read."""
import sys
import types

import pytest

from portbench import harness, program, spec, trace

NEW = ("render_idle_ms_per_render", "read_idle_ms_per_render",
       "dispatch_idle_ms_per_render", "host_us_per_iteration",
       "queue_lane_share", "closest_hit_ns_per_vertex")


def _x(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


def _base():
    """Two requests of 100 us; device idle in [0, 10), [30, 60), [85, 110)
    and [125, 200), a torch op in [40, 50)."""
    return [_x("user_annotation", "portbench.request", 0, 100),
            _x("user_annotation", "portbench.render", 0, 100),
            _x("user_annotation", "portbench.request", 100, 100),
            _x("user_annotation", "portbench.render", 100, 100),
            _x("kernel", "void bvh_kernel<1, false>(Args)", 10, 20),
            _x("gpu_memcpy", "Memcpy DtoH", 60, 25),
            _x("cpu_op", "aten::sum", 40, 10),
            _x("kernel", "void pool_step_kernel<0>()", 110, 15)]


def _program():
    """The program's spans over the base: set-up [0, 20) holding a plan
    [2, 8) and a queue init [12, 16); reads [20, 40) and [100, 105);
    iterations [40, 55), [55, 100) and [105, 150); finish [150, 200)."""
    p = "tpu_ray_torch."
    return [_x("cpu_op", p + "render.setup", 0, 20),
            _x("cpu_op", p + "render.plan", 2, 6),
            _x("cpu_op", p + "queue.init", 12, 4),
            _x("cpu_op", p + "queue.read", 20, 20),
            _x("cpu_op", p + "queue.iteration", 40, 15),
            _x("cpu_op", p + "queue.iteration", 55, 45),
            _x("cpu_op", p + "queue.read", 100, 5),
            _x("cpu_op", p + "queue.iteration", 105, 45),
            _x("cpu_op", p + "render.finish", 150, 50)]


def test_idle_under_nested_and_repeated_spans():
    tr = trace.from_chrome(_base() + _program())
    us = lambda names: program.idle_under(tr, names) * 1e6
    assert us(["render.setup"]) == pytest.approx(10)      # [0, 10)
    assert us(["render.setup", "render.plan"]) == pytest.approx(10)
    assert us(["render.plan"]) == pytest.approx(6)
    assert us(["queue.read"]) == pytest.approx(15)  # [30, 40), [100, 105)
    assert us(["queue.iteration"]) == pytest.approx(15 + 20 + 30)
    assert us(["render.finish"]) == pytest.approx(50)
    every = ["render.setup", "queue.read", "queue.iteration",
             "render.finish"]
    idle = tr.window_s - tr.busy_s()
    assert program.idle_under(tr, every) == pytest.approx(idle)
    assert program.idle_under(tr, ["queue.compact"]) is None
    assert program.idle_under(None, every) is None
    assert program.span_durations(tr, "queue.iteration") == pytest.approx(
        [15e-6, 45e-6, 45e-6])


def test_labels_gain_the_program_span_and_nothing_else_moves():
    old, new = trace.from_chrome(_base()), trace.from_chrome(
        _base() + _program())
    assert (old.t0, old.t1, old.n_renders) == (new.t0, new.t1, new.n_renders)
    assert old.ops == new.ops and old.spans == new.spans
    assert old.busy_s() == new.busy_s()
    assert old.kernel_us(("bvh_kernel",)) == new.kernel_us(("bvh_kernel",))
    assert old.by_name() == new.by_name()
    assert [s for _, s in old.idle_gaps()] == [s for _, s in new.idle_gaps()]
    assert old.breakdown()["device_ops"] == new.breakdown()["device_ops"]
    # the longest gap first: [125, 200), [30, 60), [85, 110), [0, 10)
    assert [n for n, _ in new.idle_gaps()] == [
        "render:tpu_ray_torch.render.finish", "render:aten::sum",
        "render:tpu_ray_torch.queue.iteration",
        "render:tpu_ray_torch.render.plan"]
    assert [n for n, _ in old.idle_gaps()] == [
        "render:python", "render:aten::sum", "render:python",
        "render:python"]
    # the innermost: the plan inside the set-up, a torch op inside a span
    assert new.label_at(9) == "render:tpu_ray_torch.render.setup"
    assert new.label_at(45) == "render:aten::sum"


def _counts(monkeypatch, c):
    mod = types.ModuleType("tpu_ray_torch.utils.profiling")
    if c is not None:
        mod.counts = lambda: dict(c)
    monkeypatch.setitem(sys.modules, "tpu_ray_torch.utils.profiling", mod)


def test_new_metrics_read_the_spans_and_counters(monkeypatch):
    _counts(monkeypatch, dict(queue_calls=4, vertices=400, lane_slots=1000))
    data = harness.RunData(trace=trace.from_chrome(_base() + _program()))
    got = {m: spec.metric_reader(m).read(data) for m in NEW}
    assert got["render_idle_ms_per_render"] == pytest.approx(60e-3 / 2)
    assert got["read_idle_ms_per_render"] == pytest.approx(15e-3 / 2)
    assert got["dispatch_idle_ms_per_render"] == pytest.approx(65e-3 / 2)
    assert got["host_us_per_iteration"] == pytest.approx(35)
    assert got["queue_lane_share"] == pytest.approx(0.4)
    # 20 us of bvh_kernel over one queue call of 100 vertices
    assert got["closest_hit_ns_per_vertex"] == pytest.approx(200)


@pytest.mark.parametrize("counters", [None, {}])
def test_new_metrics_are_none_with_nothing_to_read(monkeypatch, counters):
    """No trace; a trace without program spans (a program older than
    them); a program without ``counts`` or with no queue counted."""
    _counts(monkeypatch, counters)
    bare = harness.RunData(trace=trace.from_chrome(_base()))
    for m in NEW:
        reader = spec.metric_reader(m)
        assert reader.read(harness.RunData()) is None, m
        assert reader.read(bare) is None, m
