"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B] — MoE LM.

Counterpart of ``repro.configs.qwen2_moe_a2_7b``: 24L d_model=2048 16H
(kv=16) vocab=151936. 60 routed experts (top-4, moe_intermediate=1408) +
4 shared experts (5632 total shared intermediate = 4 x 1408).
norm_topk_prob=False in the public config. ``FULL`` prefills on the
blocked path at its defaults; with ``attn_impl="cuda"`` it prefills on the
windowed kernel (head dim 128, n_rep 1) and decodes on the decode kernel's
GQA mode, every layer's FFN through ``repro_torch.models.moe``.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=5632, vocab_size=151936, head_dim=128,
    attn_type="gqa", qkv_bias=True,
    moe=True, n_experts=60, n_shared_experts=4, top_k=4, moe_d_ff=1408,
    shared_d_ff=1408, first_dense_layers=0, norm_topk=False,
    rope_theta=1000000.0, window=1024, attn_impl="blocked",
    dti_sum_token=True, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16, qkv_bias=True,
    moe=True, n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=32,
    shared_d_ff=32, norm_topk=False, window=32, attn_impl="blocked",
    dti_sum_token=True,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="qwen2-moe-a2.7b", family="lm", config=FULL, smoke=SMOKE,
        shapes=lm_shapes(), profile="tp",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        notes="60 experts do not divide the 16-way model axis, so expert "
              "weights shard on moe_d_ff (1408 % 16 == 0) — TP-inside-expert "
              "instead of EP; deepseek-v2 exercises the EP layout.",
    )


__all__ = ["FULL", "SMOKE", "spec"]
