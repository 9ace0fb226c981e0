"""Packaging of tpu_ray_torch: it stands alone (no JAX, no tpu_ray), its
CLI renders on the CPU, and its image writers produce valid files."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_ray_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ray")


def _port_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_no_jax_import_anywhere_in_the_port():
    """Every import statement of the package and of chip_smoke.py, at any
    depth (function-level imports too), names neither JAX nor tpu_ray."""
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path, node.module))
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel != "chip_smoke" and not rel.endswith("__main__"):
            mods.append(rel.removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_renders_a_ppm_on_the_cpu():
    w, h = 32, 24
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch", "--device", "cpu", "--scene",
         "cornell", "--width", str(w), "--height", str(h), "--spp", "8",
         "--max-depth", "6"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    words = r.stdout.split()
    assert words[:4] == ["P3", str(w), str(h), "255"]
    assert len(words) == w * h * 3 + 4
    vals = np.array(words[4:], int)
    assert vals.min() >= 0 and vals.max() <= 255 and vals.mean() > 5
    assert "Done." in r.stderr


def test_cli_lists_scenes_and_rejects_unknown():
    r = subprocess.run([sys.executable, "-m", "tpu_ray_torch",
                        "--list-scenes"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "cornell" in r.stdout
    from tpu_ray_torch.utils.cli import main

    assert main(["--scene", "nope", "--device", "cpu"]) == 2


def test_png_writer_round_trips(tmp_path):
    from tpu_ray_torch.core import film

    rgb8 = np.random.default_rng(1).integers(0, 256, (7, 5, 3), np.uint8)
    path = str(tmp_path / "x.png")
    film.write_png(rgb8, path)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # IHDR then one IDAT: inflate it and strip the per-row filter bytes
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]),
                        np.uint8).reshape(7, 1 + 15)
    assert not raw[:, 0].any()
    np.testing.assert_array_equal(raw[:, 1:].reshape(7, 5, 3), rgb8)


def test_film_matches_jax_tone_map_and_writers(tmp_path):
    from tpu_ray.core import film as jfilm
    from tpu_ray_torch.core import film

    img = np.random.default_rng(2).random((6, 4, 3)).astype(np.float32) * 2
    np.testing.assert_array_equal(film.to_rgb8(img), jfilm.to_rgb8(img))
    assert film.ppm_string(film.to_rgb8(img)) == \
        "P3\n4 6\n255\n" + jfilm.ppm_body_rows(jfilm.to_rgb8(img))
    for ext, jw, pw in ((".pfm", jfilm.write_pfm, film.write_pfm),
                        (".hdr", jfilm.write_hdr, film.write_hdr)):
        a, b = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
        jw(img, a)
        pw(img, b)
        assert open(a, "rb").read() == open(b, "rb").read()
