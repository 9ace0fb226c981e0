"""Rendering over several devices (:mod:`tpu_ray_torch.parallel.mesh`)."""
