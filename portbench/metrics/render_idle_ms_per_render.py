"""Layer: renderer.render (``tpu_ray_torch/renderer.py``).  Device
milliseconds idle a render under the program spans ``render.setup``
(``render`` from its entry to the first iteration of its loop:
``render.kernels``, ``render.plan``, ``render.config_tag``,
``render.step_config``, ``queue.init``) and ``render.finish`` (the loop's
end to the image on the host), in the traced stretch.  Moves
``msamples_per_s``."""
from portbench import program

SPANS = ("render.setup", "render.finish")


def read(run):
    s = program.idle_under(run.trace, SPANS)
    return None if s is None else s * 1e3 / run.trace.n_renders
