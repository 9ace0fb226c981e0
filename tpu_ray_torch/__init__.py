"""tpu_ray_torch: the PyTorch / CUDA port of the tpu_ray path tracer.

Entry points: ``tpu_ray_torch.renderer.render`` and ``python -m
tpu_ray_torch``.  They run on the card unless asked for ``device="cpu"``,
where the CUDA kernels' plain PyTorch versions run instead.  Importing the
package starts no build: the kernels compile with ``nvcc`` at first launch.
"""
