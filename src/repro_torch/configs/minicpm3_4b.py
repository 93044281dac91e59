"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — dense LM with MLA attention.

Counterpart of ``repro.configs.minicpm3_4b``: 62L d_model=2560 40H
d_ff=6400 vocab=73448, MLA dims per the HF config (q_lora_rank=768,
kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32,
v_head_dim=64). ``FULL`` prefills on the blocked path at its defaults
(``attn_impl="blocked"``, as the reference sets it) and decodes on the
dense path; with ``attn_impl="cuda"`` it prefills on the windowed kernel
(Dqk 96, Dv 64) and decodes on the decode kernel's absorbed-MLA mode
(Dqk 288, Dv 256); it trains on kernels 1-3 at Dqk 96, Dv 64
(``repro_torch.launch.train --arch minicpm3-4b``).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448, attn_type="mla",
    q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
    v_head_dim=64, rope_theta=10000.0, window=1024, attn_impl="blocked",
    dti_sum_token=True, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=512, attn_type="mla",
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
    v_head_dim=16, window=32, attn_impl="blocked", dti_sum_token=True,
    tie_embeddings=True,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="minicpm3-4b", family="lm", config=FULL, smoke=SMOKE,
        shapes=lm_shapes(), profile="tp", source="hf:openbmb/MiniCPM3-4B",
        notes="MLA; decode uses the absorbed latent-cache path "
              "(repro.serve.engine).",
    )


__all__ = ["FULL", "SMOKE", "spec"]
