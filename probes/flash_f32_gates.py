#!/usr/bin/env python3
"""The f32 flash forward's gates and their margins on the card, for the
tree whose root is the current directory (its ``chip_smoke.py`` and
``src/``): a measurement aid called by no other code, so that two trees
(a change and its parent, the script copied into each) can be read side
by side in one call.

    cd <tree root> && python3 <path to>/flash_f32_gates.py <tag>

Prints, as JSON lines and then one ``MARGINS`` line: the f32 forward's
largest |o − plain| and |lse − plain| over the f32 cases of
``chip_smoke.phase4_checks``, of ``test_cuda_flash_matches_plain`` and
phase 4's qwen2-7b layer (gate 2e-5), and at full width
(``chip_smoke.flash_f32_full_width``, where the tree has it); where the
forward's error comes from (``isolate``: the kernel and the plain
version against attention in f64 with one key tile and with 32, on f32
inputs, on inputs that are bf16 values — every product of their terms
kept — and with V = 1, where O is the sum of P's three terms times 1,
exact but for the accumulation); the f32 backward's gate over
``FLASH_BWD_SMALL`` (largest excess, the planted lse fault's least);
phase 12 (c)'s worst gradient over its tolerance per family; phase 10's
decode checks (the f32 twins' |Δ| against ``lm_prefill``, the logits
beyond ``DECODE_TOL`` and the planted faults). Needs the card (phase
10's models at full width, ~2 minutes a tree).
"""
import json, os, sys, time

sys.path.insert(0, os.getcwd())
import numpy as np
import chip_smoke as cs
sys.path.insert(0, str(cs.SRC))
cs.bind_bounds()
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.CARD = cs.card_line()
from repro_torch.kernels import flash_attention as fa
dev = torch.device("cuda")
out = {"card": cs.CARD, "tree": sys.argv[1]}
t0 = time.perf_counter()
g = torch.Generator(device=dev).manual_seed(7)
cases = [(2, 256, 4, 2, 32, True, 0), (1, 128, 4, 4, 64, True, 64),
         (2, 200, 2, 1, 16, True, 0), (1, 256, 8, 2, 32, True, 100),
         (1, 64, 2, 2, 32, False, 0), (1, 130, 4, 4, 128, False, 0),
         (1, 300, 8, 2, 128, True, 100), (1, 520, 4, 2, 128, True, 1),
         (2, 100, 7, 1, 64, True, 0), (1, 333, 7, 7, 16, True, 1),
         (1, 190, 14, 2, 32, False, 50), (1, 127, 8, 1, 128, True, 0),
         (2, 129, 4, 4, 64, True, 127), (1, 255, 16, 2, 128, False, 0),
         (1, 257, 8, 1, 32, True, 128), (1, 385, 4, 2, 128, True, 129),
         (1, 1, 2, 1, 64, True, 0),
         (2, 200, 4, 2, 32, True, 0), (1, 256, 8, 2, 64, True, 100),
         (1, 191, 7, 7, 128, True, 1), (1, 321, 14, 2, 32, False, 40),
         (1, 64, 2, 2, 64, True, 1), (2, 129, 7, 1, 128, True, 65),
         (1, 129, 7, 1, 32, False, 0), (1, 255, 4, 2, 128, True, 127),
         (1, 257, 8, 1, 128, True, 1), (2, 333, 7, 1, 16, True, 0),
         (1, 333, 4, 4, 64, False, 127), (1, 257, 16, 2, 128, False, 0),
         (1, 2048, 28, 4, 128, True, 0)]
eo = el = 0.0
for b, s, h, kv, d, causal, window in cases:
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=dev) for n in (h, kv, kv))
    o, lse = fa._launch(q, k, v, causal, window, True)
    want, wl = fa.flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    eo = max(eo, (o - want).abs().max().item()); el = max(el, (lse - wl).abs().max().item())
out["forward_f32"] = dict(max_o_err=eo, max_lse_err=el, gate=2e-5, cases=len(cases))
print(json.dumps(out["forward_f32"]), flush=True)
if hasattr(cs, "flash_f32_full_width"):
    out["forward_f32_full_width"] = cs.flash_f32_full_width(dev)
    print(json.dumps(out["forward_f32_full_width"]), flush=True)


def f64_attention(q, k, v):
    """Causal attention and its lse in f64, from the f32 inputs."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.double().reshape(b, s, kv, h // kv, d) / d ** 0.5
    sc = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.double())
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bkgqj,bjkd->bkgqd", torch.softmax(sc, -1), v.double())
    return (o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d),
            torch.logsumexp(sc, -1).reshape(b, h, s))


iso, gi = {}, torch.Generator(device=dev).manual_seed(8)
for d, s, kind in [(64, 64, "f32"), (64, 64, "bf16 values"), (64, 64, "V = 1"),
                   (64, 2048, "f32"), (64, 2048, "bf16 values"),
                   (64, 2048, "V = 1"), (128, 2048, "f32"),
                   (128, 2048, "V = 1")]:
    q, k, v = (torch.randn(1, s, n, d, generator=gi, device=dev)
               for n in (8, 2, 2))
    if kind != "f32":
        q, k, v = (x.bfloat16().float() for x in (q, k, v))
    if kind == "V = 1":
        v = torch.ones_like(v)
    o, lse = fa._launch(q, k, v, True, 0, True)
    po, pl = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    xo, xl = f64_attention(q, k, v)
    iso[f"D {d} S {s} {kind}"] = dict(
        kernel_o=(o.double() - xo).abs().max().item(),
        kernel_o_mean=(o.double() - xo).mean().item(),
        plain_o=(po.double() - xo).abs().max().item(),
        plain_o_mean=(po.double() - xo).mean().item(),
        kernel_lse=(lse.double() - xl).abs().max().item(),
        plain_lse=(pl.double() - xl).abs().max().item())
out["isolate"] = iso
print(json.dumps(iso), flush=True)
worst = fault = 0.0
fault = float("inf")
for case in cs.FLASH_BWD_SMALL:
    b, s, h, kv, d, causal, window = case
    q, k, v, do = (torch.randn(b, s, n, d, generator=g, device=dev) for n in (h, kv, kv, h))
    r, _ = cs.flash_bwd_gate(q, k, v, do, dict(causal=causal, window=window), str(case))
    worst = max(worst, max(r["excess"].values())); fault = min(fault, min(r["fault_excess"].values()))
out["backward_f32_small"] = dict(largest_excess=worst, planted_fault_min=fault)
print(json.dumps(out["backward_f32_small"]), flush=True)
out["grads"] = {a: r["worst_over_tol"] for a, r in cs.p12_grads(dev).items()}
print(json.dumps(out["grads"]), flush=True)
with torch.no_grad():
    for arch, plan in cs.LM_PLANS.items():
        r = cs.p10_lm(dev, arch, plan)["decode_vs_prefill"]
        out[f"decode_f32/{arch}"] = dict(max_abs_err=r["max_abs_err"], mean_abs_err=r["mean_abs_err"],
                                         beyond_tol=r["beyond_tol"], of=r["of"],
                                         faults={n: (f["max_abs_err"], f["beyond_tol"]) for n, f in r["faults"].items()})
        print(json.dumps(out[f"decode_f32/{arch}"]), flush=True)
        torch.cuda.empty_cache()
out["seconds"] = time.perf_counter() - t0
print("MARGINS " + json.dumps(out), flush=True)
