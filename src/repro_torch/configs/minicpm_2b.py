"""minicpm-2b [arXiv:2404.06395; hf:openbmb/MiniCPM-2B] — dense llama-like LM.

Counterpart of ``repro.configs.minicpm_2b``: 40L d_model=2304 36H (kv=36,
i.e. full MHA) d_ff=5760 vocab=122753, head_dim 64, tied embeddings,
trained with the WSD schedule (the optimizer's "wsd" schedule reproduces
it). With ``attn_impl="cuda"`` it runs on the windowed kernels and the
decode kernel's GQA mode at head dim 64, n_rep 1.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab_size=122753, head_dim=64, attn_type="gqa",
    rope_theta=10000.0, window=1024, attn_impl="blocked",
    dti_sum_token=True, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, tie_embeddings=True,   # MiniCPM ties embeddings
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=512, head_dim=16, window=32, attn_impl="blocked",
    dti_sum_token=True, tie_embeddings=True,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="minicpm-2b", family="lm", config=FULL, smoke=SMOKE,
        shapes=lm_shapes(), profile="tp",
        source="arXiv:2404.06395; hf",
        notes="WSD schedule; tied embeddings; full MHA (kv=36).",
    )


__all__ = ["FULL", "SMOKE", "spec"]
