"""Progressive output on the port (tests/test_progressive.py; its banded
cases are in tests/test_torch_bands.py): these renders are unbanded, so no
row is final before the render is.

``render(on_partial=...)`` reports the current estimate after every wave
or chunk but the last, and ``film.ProgressiveOutput`` turns that into a
PPM streamed to stdout (the header at once, the rows at the end: byte for
byte the plain PPM) or an image file rewritten atomically."""
from __future__ import annotations

import zlib
from io import StringIO

import numpy as np
import pytest
from torch_port_common import cross_engine

from tpu_ray_torch import renderer
from tpu_ray_torch.core import film
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.renderer import render
from tpu_ray_torch.utils import cli

# two-spheres 8x6, 4 waves of one sample per pixel
KW = dict(spp=4, max_depth=3, seed=2, rays_per_wave=8 * 6,
          samples_per_wave=1, mode="pool")


def _scene():
    spec = SCENES["two-spheres"]
    return spec.build(), spec.camera(8, 6)


def _png_pixels(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG with one IDAT of filter-0 rows
    (what film.png_bytes writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = (int.from_bytes(data[16 + 4 * k:20 + 4 * k], "big")
            for k in range(2))
    i = data.index(b"IDAT")
    n = int.from_bytes(data[i - 4:i], "big")
    raw = np.frombuffer(zlib.decompress(data[i + 4:i + 4 + n]), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_on_partial_wave_estimates_match_jax():
    """Three partial estimates (waves 1-3 of 4), each the JAX package's
    partial of the same render under the cross-engine criterion."""
    from tpu_ray.models.scenes import SCENES as JSCENES
    from tpu_ray.renderer import render as jrender

    scene, cam = _scene()
    calls, jcalls = [], []
    img = render(scene, cam, 8, 6, device="cpu",
                 on_partial=lambda im, rf: calls.append((im.copy(), rf)),
                 **KW)
    jspec = JSCENES["two-spheres"]
    jrender(jspec.build(), jspec.camera(8, 6), 8, 6,
            on_partial=lambda im, rf: jcalls.append((np.asarray(im), rf)),
            **KW)
    assert len(calls) == len(jcalls) == 3
    for (im, rf), (jim, jrf) in zip(calls, jcalls):
        assert im.shape == (6, 8, 3) and np.isfinite(im).all()
        assert rf == jrf == 0
        cross_engine(jim, im)
    assert abs(calls[-1][0].mean() - img.mean()) < 0.2


def test_on_partial_queue_chunks(monkeypatch):
    scene, cam = _scene()
    monkeypatch.setattr(renderer, "QUEUE_PLANE_BYTES", 8 * 6 * 12)
    calls = []
    img = render(scene, cam, 8, 6, spp=4, max_depth=3, seed=2, mode="queue",
                 device="cpu", on_partial=lambda im, rf: calls.append(im))
    assert len(calls) == 3      # chunks of one sample
    assert abs(calls[-1].mean() - img.mean()) < 0.2


def test_progressive_stream_equals_plain_ppm():
    scene, cam = _scene()
    expected = film.ppm_string(film.to_rgb8(
        render(scene, cam, 8, 6, device="cpu", **KW)))
    po = film.ProgressiveOutput("-", 8, 6, fp=StringIO())
    img = render(scene, cam, 8, 6, device="cpu", on_partial=po.update, **KW)
    assert po.fp.getvalue() == "P3\n8 6\n255\n"   # no row final yet
    po.finish(img)
    assert po.fp.getvalue() == expected and po.rows_emitted == 6


def test_progressive_file_rewrites_are_whole_images(tmp_path):
    scene, cam = _scene()
    out = tmp_path / "p.png"
    po = film.ProgressiveOutput(str(out), 8, 6)
    seen = []

    def spy(im, rf):
        po.update(im, rf)
        seen.append(_png_pixels(out))

    img = render(scene, cam, 8, 6, device="cpu", on_partial=spy, **KW)
    po.finish(img)
    assert len(seen) == 3 and all(s.shape == (6, 8, 3) for s in seen)
    np.testing.assert_array_equal(_png_pixels(out), film.to_rgb8(img))
    assert not out.with_name("p.png.tmp").exists()


def test_cli_progressive_stdout_byte_identical(capsys):
    argv = ["--device", "cpu", "--scene", "two-spheres", "--width", "12",
            "--height", "8", "--spp", "4", "--max-depth", "3",
            "--samples-per-wave", "1", "--rays-per-wave", "96"]
    assert cli.main(argv) == 0
    plain = capsys.readouterr().out
    assert cli.main(argv + ["--progressive"]) == 0
    assert capsys.readouterr().out == plain and plain.startswith("P3\n12 8")


def test_adaptive_ignores_progressive(capsys, tmp_path):
    """Adaptive renders have no fixed wave schedule: ``render`` does not
    call on_partial, and the CLI says it ignores --progressive."""
    scene, cam = _scene()
    calls = []
    render(scene, cam, 8, 6, spp=32, max_depth=3, seed=2, adaptive=0.05,
           device="cpu", on_partial=lambda im, rf: calls.append(rf))
    assert calls == []
    out = str(tmp_path / "a.png")
    assert cli.main(["--device", "cpu", "--scene", "two-spheres", "--width",
                     "8", "--height", "6", "--spp", "32", "--max-depth", "3",
                     "--adaptive", "0.05", "--progressive", "--out",
                     out]) == 0
    assert "[progressive] ignoring --progressive" in capsys.readouterr().err
    assert _png_pixels(out).shape == (6, 8, 3)


@pytest.mark.parametrize("ext", [".pfm", ".hdr"])
def test_progressive_file_float_formats_keep_linear(tmp_path, ext):
    """A .pfm / .hdr destination gets the linear formats, not PNG bytes."""
    img = np.array([[[0.0, 0.5, 2.25], [1.0, 0.125, 0.0]],
                    [[3.5, 0.75, 0.25], [0.0, 0.0, 9.0]]], np.float32)
    out = tmp_path / f"p{ext}"
    po = film.ProgressiveOutput(str(out), 2, 2)
    po.update(img * 0.5, 0)
    po.finish(img)
    raw = out.read_bytes()
    if ext == ".pfm":
        assert raw.startswith(b"PF\n")
        a = np.frombuffer(raw.split(b"\n", 3)[3], "<f4").reshape(2, 2, 3)
        np.testing.assert_array_equal(a[::-1], img)
    else:
        assert raw.startswith(b"#?RADIANCE")
        ref = tmp_path / "ref.hdr"
        film.write_hdr(img, str(ref))
        assert raw == ref.read_bytes()
