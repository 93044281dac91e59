"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Same layout as ``repro`` (configs, core, data, models, kernels, serve) so
each module's counterpart is found by path. The port imports torch and
numpy only: never jax and never ``repro``. Weights cross between the two
packages through ``repro_torch.bridge`` as numpy arrays.

Entry points (``init_params``, ``init_lm_cache``, ``CTRServer``) run on the
card unless the caller passes ``device="cpu"``; with no card and no
explicit device they raise (``repro_torch.device.resolve_device``).
"""
