"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8, GQA kv=8,
Adafactor with bf16 master params.

The reference's config (``repro/configs/kimi_k2_1t_a32b.py``), field for field.
"""
from repro_torch.configs import base, register


def config():
    return base.LMConfig(
        arch_id="kimi-k2-1t-a32b",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        vocab_size=163_840,
        moe=base.MoESpec(n_experts=384, top_k=8, d_ff_expert=2048),
        optimizer="adafactor",
        param_dtype="bfloat16",   # 1T params: bf16 master + Adafactor
    )


def shapes():
    return base.lm_shapes("kimi-k2-1t-a32b", full_attention_only=True)


register("kimi-k2-1t-a32b", config, shapes)
