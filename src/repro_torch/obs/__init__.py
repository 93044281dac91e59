"""repro_torch.obs — the port's observability layer: copies of the
jax-free ``repro.obs`` modules (``clock``, ``metrics``, ``trace``) and
``profile`` on ``torch.profiler``."""
