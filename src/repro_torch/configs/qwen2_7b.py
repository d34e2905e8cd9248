"""qwen2-7b — dense LM, GQA kv=4, QKV bias. [arXiv:2407.10671]."""
from repro_torch.configs import base, register


def config():
    return base.LMConfig(
        arch_id="qwen2-7b",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def shapes():
    return base.lm_shapes("qwen2-7b", full_attention_only=True)


register("qwen2-7b", config, shapes)
