"""The benchmark of ``tpu_ray_torch``: one cell (a scene configuration under
a traffic mix) per run, its end-to-end metrics or, traced, its per-layer
metrics, and a check of the images against the plain reference in
``portbench/reference``.  ``python3 portbench/run.py --help``; the layout
and how to add a configuration, a mix, a cell or a metric are in
``portbench/README.md``."""
