"""qwen2-1.5b [arXiv:2407.10671; hf:Qwen/Qwen2-1.5B] — dense GQA LM.

Counterpart of ``repro.configs.qwen2_1_5b``: 28L d_model=1536 12H (GQA
kv=2) d_ff=8960 vocab=151936, head_dim 128, QKV bias, tied embeddings.
With ``attn_impl="cuda"`` it runs on the windowed kernels and the decode
kernel's GQA mode at head dim 128, n_rep 6.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128, attn_type="gqa",
    qkv_bias=True, rope_theta=1000000.0, window=1024, attn_impl="blocked",
    dti_sum_token=True, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, tie_embeddings=True,   # Qwen2-1.5B ties embeddings
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=16, qkv_bias=True, window=32,
    attn_impl="blocked", dti_sum_token=True, tie_embeddings=True,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="qwen2-1.5b", family="lm", config=FULL, smoke=SMOKE,
        shapes=lm_shapes(), profile="tp",
        source="arXiv:2407.10671; hf",
        notes="GQA kv=2 with QKV bias; tied embeddings.",
    )


__all__ = ["FULL", "SMOKE", "spec"]
