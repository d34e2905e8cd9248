"""stablelm-1.6b — dense LM, MHA (kv=32). [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs import base, register


def config():
    return base.LMConfig(
        arch_id="stablelm-1.6b",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100_352,
        qkv_bias=True,
    )


def shapes():
    return base.lm_shapes("stablelm-1.6b", full_attention_only=True)


register("stablelm-1.6b", config, shapes)
