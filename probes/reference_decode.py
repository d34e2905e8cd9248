#!/usr/bin/env python3
"""The JAX reference's own decode against its prefill, in bf16, at the
widths of ``chip_smoke.py``'s phase 10, on a GPU through jax: how far the
two paths of ``repro.models.transformer`` drift apart at full width. A
measurement aid, not part of the port (which imports no jax).

    PYTHONPATH=src python3 probes/reference_decode.py \
        [--batch B] [--prompt S] [arch ...]

For each arch (default ``gemma3-27b``, cut to one LLLLLG period of 6
layers as in phase 10, and ``qwen2-7b`` with its 28 layers): random f32
params from ``lm_init``, a prompt from ``LMStream`` (seed 0, batch ``B``
of ``S`` tokens, default 2 of 1,024), ``lm_prefill`` into a cache of
prompt + 32, 32 greedy
``lm_decode_step``s, then ``lm_prefill`` over the prompt and the 32 tokens
against the last step's logits: the largest and mean |Δ| and how many
logits lie beyond ``tests/test_decode_parity.py``'s 2e-2 / 2e-2, in bf16
and with ``compute_dtype="float32"``. Prints one JSON line with the card's
name and power limit. Exits 2 without a jax GPU device. jax may take 95%
of the card's memory (``XLA_PYTHON_CLIENT_MEM_FRACTION``, unless set):
``lm_init`` holds every block twice while it stacks them, ≈ 61 GB for
qwen2-7b.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.95")

STEPS = 32
LAYERS = {"gemma3-27b": 6, "qwen2-7b": None}


def divergence(params, cfg, toks):
    import jax.numpy as jnp
    import numpy as np
    from repro.models import transformer as tf
    b, prompt = toks.shape
    logits, cache = tf.lm_prefill(params, toks, cfg, max_len=prompt + STEPS)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    gen = [tok]
    for i in range(STEPS):
        logits, cache = tf.lm_decode_step(
            params, cache, tok, jnp.full((b,), prompt + i, jnp.int32), cfg)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        if i < STEPS - 1:
            gen.append(tok)
    want, _ = tf.lm_prefill(params, jnp.concatenate([toks] + gen, 1), cfg)
    got, want = np.asarray(logits), np.asarray(want)
    diff = np.abs(got - want)
    return dict(max_abs_err=float(diff.max()),
                mean_abs_err=float(diff.mean()),
                beyond_tol=int((diff > 2e-2 + 2e-2 * np.abs(want)).sum()),
                of=int(diff.size), logit_std=float(want.std()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("archs", nargs="*", default=list(LAYERS))
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        print(f"reference_decode: no jax GPU device ({jax.devices()})",
              file=sys.stderr)
        return 2
    from repro.configs import get_config
    from repro.data import LMStream
    from repro.models import transformer as tf
    out = {}
    for arch in args.archs:
        cfg = get_config(arch)
        n = LAYERS.get(arch)
        if n:
            cfg = dataclasses.replace(cfg, n_layers=n,
                                      layer_pattern=cfg.pattern()[:n])
        params = tf.lm_init(jax.random.PRNGKey(0), cfg)
        toks = jnp.asarray(LMStream(cfg.vocab_size, seed=0).batch(
            0, args.batch, args.prompt)["tokens"][:, :args.prompt])
        out[arch] = {dt: divergence(params, dataclasses.replace(
            cfg, compute_dtype=dt), toks) for dt in ("bfloat16", "float32")}
        out[arch]["layers"] = cfg.n_layers
        print(arch, out[arch], flush=True)
        del params
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(device=str(jax.devices()[0]), card=card,
                          batch=args.batch, prompt=args.prompt, steps=STEPS,
                          divergence=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
