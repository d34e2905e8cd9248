"""moonshot-v1-16b-a3b (Moonlight) — MoE 64 experts top-6, GQA kv=16.
[hf:moonshotai/Moonlight-16B-A3B]

The reference's config (``repro/configs/moonshot_16b_a3b.py``), field for field.
"""
from repro_torch.configs import base, register


def config():
    return base.LMConfig(
        arch_id="moonshot-v1-16b-a3b",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163_840,
        moe=base.MoESpec(n_experts=64, top_k=6, d_ff_expert=1408),
    )


def shapes():
    return base.lm_shapes("moonshot-v1-16b-a3b", full_attention_only=True)


register("moonshot-v1-16b-a3b", config, shapes)
