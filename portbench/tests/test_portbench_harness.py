"""The harness on the CPU: discovery by name, the import rule, the result
line, the names, the window's arithmetic, the trace reduction, and the
faults that ``correct`` must catch.  Nothing here needs a card; a run
drives ``harness.run`` on the CPU at a tiny size (``harness.main`` itself
refuses to run without one)."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness, spec, trace

ROOT = spec.root_of()
HERE = os.path.join(ROOT, "portbench")
BANNED = {"jax", "jaxlib", "flax", "tpu_ray"}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _tiny(name="nextweek.queue", spp=4, scene=None, engine=None):
    cell = spec.load_cell(name)
    cell.config.update(width=32, height=24, max_depth=8)
    cell.traffic["spp"] = spp
    if scene:
        cell.config["scene"] = scene
    if engine:
        cell.traffic["engine"] = engine
    return cell


def _book1(engine="auto"):
    """book1-final (485 spheres) through the pool, or with ``engine="mega"``
    the megakernel."""
    return _tiny(scene="book1-final", engine=engine)


def test_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and a
    cell as new files and new entries; nothing that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench/configs/cornell.json").write_text(json.dumps(
        dict(name="cornell", scene="cornell", width=500, height=500,
             max_depth=50)))
    (root / "portbench/traffic/same_scene_1000spp.json").write_text(
        json.dumps(dict(spp=1000, engine="auto", scene="same",
                        scene_seed=1024)))
    (root / "portbench/correct/cornell.pool.json").write_text(json.dumps(
        dict(renders=1, pixels=16, limits=dict(divergent_share=0.5))))
    (root / "portbench/metrics/answer.py").write_text(
        "PATTERNS = ('x_kernel',)\n\ndef read(run):\n    return 42.0\n")
    bench["configs"].append(dict(name="cornell", source="https://x",
                                 file="portbench/configs/cornell.json",
                                 reduced=[], why="w"))
    bench["workloads"].append(dict(name="cornell.pool", config="cornell",
                                   traffic="same_scene_1000spp", chips=1,
                                   why="w"))
    bench["per_layer"].append(dict(name="answer", unit="ms", better="lower",
                                   source="device_trace", layer="x",
                                   moves="msamples_per_s"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("cornell.pool", str(root))
    assert cell.config["scene"] == "cornell"
    assert cell.traffic["spp"] == 1000
    assert cell.correct["limits"] == dict(divergent_share=0.5)
    assert "answer" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("answer", str(root)).read(None) == 42.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_imports_compare_top_level_names_whole():
    """No module of the benchmark imports jax, jaxlib, flax or tpu_ray;
    tpu_ray_torch, whose name begins with tpu_ray's, is the program and
    allowed in the harness; the reference imports nothing of the port."""
    for path in _sources():
        assert not (_imports(path) & BANNED), path
    for path in _sources("reference"):
        assert "tpu_ray_torch" not in _imports(path), path
        assert not (_imports(path) & {"portbench"}), path
    assert "tpu_ray_torch" in _imports(os.path.join(HERE, "harness.py"))


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_ray_torch_x", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_ray.sub", sys)
    assert harness.banned_modules() == ["tpu_ray"]


def test_names_and_units_use_the_allowed_characters():
    bench = _bench()
    names = [c["name"] for c in bench["configs"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for w in bench["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert [n for n in names if not NAME.match(n)] == []
    assert [m["unit"] for m in metrics if not UNIT.match(m["unit"])] == []
    assert NAME.match("nextweek.queue") and not NAME.match("next week")
    assert not NAME.match("a/b")
    assert UNIT.match("Msamples/s") and not UNIT.match("per second")
    assert not UNIT.match("µs")


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "nextweek.queue", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    # the stretch starts at the window's third request: room for it on a
    # loaded CPU
    res, checked = harness.run(_book1(), 2**31 + 7,
                               8.0 if traced else 1.0, traced, "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[:5] == keys
    assert list(res)[-1] == "checked" and res["checked"] == checked
    assert ("breakdown" in res) == traced
    assert res["correct"] is True and res["failed"] == 0
    assert set(checked) == {"divergent_share", "mean_gap"}
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    if not traced:
        assert set(res["metrics"]) == {"msamples_per_s", "render_p95_s",
                                       "setup_s"}
    json.dumps(res)


def _fake_render(stall_every=0, stall_s=0.0):
    n = [0]

    def render(sc, cam, W, H, spp, **kw):
        n[0] += 1
        time.sleep(stall_s if stall_every and n[0] % stall_every == 0
                   else 0.005)
        return np.zeros((H, W, 3), np.float32)
    return render


def test_rate_and_tail_are_over_all_renders():
    """A stall in one request of ten moves the rate and the tail."""
    cell = _tiny()
    cell.correct["renders"] = 0
    res = [harness.run(cell, 11, 1.5, False, "cpu",
                       render=_fake_render(10, s))[0]["metrics"]
           for s in (0.005, 0.1)]
    assert res[1]["msamples_per_s"]["value"] < \
        0.7 * res[0]["msamples_per_s"]["value"]
    assert res[1]["render_p95_s"]["value"] > \
        5 * res[0]["render_p95_s"]["value"]


def test_p95_nearest_rank():
    assert harness.p95(range(1, 101)) == 95
    assert harness.p95([3.0]) == 3.0
    assert harness.p95(list(range(20))) == 18


def _real():
    from tpu_ray_torch.renderer import render
    return render


def test_half_the_samples_left_out_is_caught():
    real = _real()

    def render(sc, cam, W, H, spp, **kw):
        return real(sc, cam, W, H, spp // 2, **kw)
    for cell in (_book1(), _tiny()):
        res, _ = harness.run(cell, 3, 0.5, False, "cpu", render)
        assert res["correct"] is False, cell.traffic


def test_an_altered_answer_is_caught():
    """The image of another request's draws handed back for this one."""
    real = _real()

    def render(sc, cam, W, H, spp, seed, **kw):
        return real(sc, cam, W, H, spp, seed=seed + 1, **kw)
    for cell in (_book1("mega"), _tiny()):
        res, _ = harness.run(cell, 3, 0.5, False, "cpu", render)
        assert res["correct"] is False, cell.traffic


def test_a_failed_request_is_not_correct():
    """Every request of the window fails after a sound warm-up."""
    real, calls = _real(), [0]

    def render(*a, **kw):
        calls[0] += 1
        if calls[0] > 1:
            raise RuntimeError("planted")
        return real(*a, **kw)
    res, _ = harness.run(_book1(), 3, 0.3, False, "cpu", render)
    assert res["correct"] is False and res["failed"] == res["attempted"] > 0


def test_trace_reduction():
    ev = [dict(ph="X", cat="user_annotation", name="portbench.request",
               ts=0, dur=100),
          dict(ph="X", cat="user_annotation", name="portbench.render",
               ts=5, dur=90),
          dict(ph="X", cat="cpu_op", name="aten::copy_", ts=60, dur=30),
          dict(ph="X", cat="kernel", name="void bvh_kernel<1>(Args)",
               ts=10, dur=20),
          dict(ph="X", cat="kernel", name="void pool_step_kernel<0>()",
               ts=20, dur=20),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=80, dur=5),
          dict(ph="X", cat="kernel", name="late", ts=150, dur=5)]
    tr = trace.from_chrome(ev)
    assert (tr.t0, tr.t1, tr.n_renders) == (0, 100, 1)
    assert len(tr.ops) == 3
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.kernel_us(("bvh_kernel",)) == 20
    gaps = tr.idle_gaps()
    assert gaps[0] == ("render:aten::copy_", pytest.approx(40e-6))
    assert [g[0] for g in gaps[1:]] == ["render:python", "render:python"]
    assert sum(g[1] for g in gaps) == pytest.approx(65e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void bvh_kernel")
