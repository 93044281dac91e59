"""dti-llama — the paper's own setup: Llama-3.1-8B widths + LoRA + DTI.

Counterpart of ``repro.configs.dti_llama``. ``FULL`` serves on the port's
hand-written CUDA kernels (``attn_impl="cuda"``, the port's name for the
reference's ``"pallas"``); ``REPRO`` is the width-reduced variant on the
dense path. ``FULL`` trains with remat (each layer recomputed in the
backward), ``REPRO`` without, as the reference sets them.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="dti-llama-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128, attn_type="gqa",
    rope_theta=500000.0, window=1024, attn_impl="cuda",
    dti_sum_token=True, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, lora_rank=8,
)

REPRO = ModelConfig(
    name="dti-llama-repro", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=344, vocab_size=2048, head_dim=32, attn_type="gqa",
    rope_theta=10000.0, window=0, attn_impl="dense",
    dti_sum_token=True, remat=False,
)

SMOKE = REPRO


def spec() -> ArchSpec:
    return ArchSpec(
        name="dti-llama", family="lm", config=FULL, smoke=SMOKE,
        shapes=lm_shapes(), profile="tp", trainable="lora",
        source="arXiv:2407.21783 backbone; DTI paper appendix",
        notes="The paper's own arch; repro experiments use REPRO.",
    )


__all__ = ["FULL", "REPRO", "SMOKE", "spec"]
