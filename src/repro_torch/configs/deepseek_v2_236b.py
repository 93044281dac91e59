"""deepseek-v2-236b [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2] — MoE+MLA.

Counterpart of ``repro.configs.deepseek_v2_236b``: 60L d_model=5120 128H
vocab=102400. MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
v_head=128. MoE: 160 routed top-6 + 2 shared, moe_intermediate=1536,
first layer dense (d_ff=12288), ``norm_topk=False``.

Training posture is LoRA PEFT (the paper's own setting), as in the
reference. ``FULL`` prefills on the blocked path at its defaults
(``attn_impl="blocked"``, as the reference sets it) and decodes on the
dense path; with ``attn_impl="cuda"`` it prefills on the windowed
kernel's wide head-dim class (Dqk 192, Dv 128, 128 heads) and decodes on
the decode kernel's absorbed-MLA mode at its wide geometry (Dqk 576, Dv
512, a rope span of 64). Its ~236B parameters (~470 GB in bf16) do not fit
one 80 GB card: the card runs it at full width with the depth cut. It
trains on the CPU at SMOKE size; kernels 2 and 3 stop at Dqk 128, so a
training call on the card raises (ROADMAP queue B item 2).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_ff=12288, vocab_size=102400, attn_type="mla",
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    moe=True, n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    shared_d_ff=1536, first_dense_layers=1, norm_topk=False,
    rope_theta=10000.0, window=1024, attn_impl="blocked",
    dti_sum_token=True, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, lora_rank=8,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=512, attn_type="mla",
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
    v_head_dim=16,
    moe=True, n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=32,
    shared_d_ff=32, first_dense_layers=1, norm_topk=False,
    window=32, attn_impl="blocked", dti_sum_token=True, lora_rank=4,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="deepseek-v2-236b", family="lm", config=FULL, smoke=SMOKE,
        # 60-layer scan carries at seq 4k need 16-way microbatching to fit
        # (1 seq/device/micro); prefill chunks its 32-prompt batch in two
        # sequential halves for the same reason. Smaller archs use 4 / 1.
        shapes=lm_shapes(grad_accum=16, prefill_chunks=2),
        profile="fsdp_tp", trainable="lora",
        source="arXiv:2405.04434; hf",
        notes="EP=16 (160 experts / 16), MLA absorbed decode; LoRA training "
              "(paper-faithful PEFT) keeps optimizer memory O(rank).",
    )


__all__ = ["FULL", "SMOKE", "spec"]
