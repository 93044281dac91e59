"""repro_torch.obs — the port's copy of the jax-free clock of ``repro.obs``
(tracing and metrics registries come with the observability slice)."""
