"""gemma3-27b — dense LM, 5:1 local:global sliding-window hybrid,
window 1024 for local layers, head_dim 128 (decoupled from d_model).
[hf:google/gemma-3-*]

The reference's config (``repro/configs/gemma3_27b.py``), field for field.
"""
from repro_torch.configs import base, register

_N_LAYERS = 62
# 5 local : 1 global, remainder local (62 = 10*6 + 2).
_PATTERN = tuple((["L"] * 5 + ["G"]) * 10 + ["L", "L"])


def config():
    return base.LMConfig(
        arch_id="gemma3-27b",
        n_layers=_N_LAYERS,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262_144,
        layer_pattern=_PATTERN,
        window_size=1024,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def shapes():
    # Hybrid sliding-window arch: long_500k RUNS (local KV bounded by window;
    # global layers decode linearly in cache length).
    return base.lm_shapes("gemma3-27b", full_attention_only=False)


register("gemma3-27b", config, shapes)
