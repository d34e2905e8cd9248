"""Train the dual encoder with checkpoint/restart on the PyTorch/CUDA port
(the twin of ``train_dual_encoder.py``): the paper's relevance model on
the synthetic geo corpus, at a reduced geometry by default and at the
paper's 12L/768/12H (BERT-base towers, ~106M parameters for the pair)
with ``--full``. Runs on the CUDA device; ``--device cpu`` on the CPU.

The state ``{"params", "opt": {"step", "m", "v"}}`` is saved through
``CheckpointManager`` in the reference's layout, so a run of either
package's script resumes from the other's checkpoint.

    PYTHONPATH=src python examples/torch_train_dual_encoder.py --steps 300
    PYTHONPATH=src python examples/torch_train_dual_encoder.py --full --steps 200
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import convert
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import pipeline as pl
from repro_torch.core import relevance
from repro_torch.data.geotextual import GeoCorpus, GeoCorpusConfig
from repro_torch.device import require_device
from repro_torch.optim import linear_warmup_cosine, make_optimizer


def state_tree(rel, opt_state) -> dict:
    """The trainer's state in the reference's layout: the relevance
    params' pytree and AdamW's ``{"step", "m", "v"}`` with the moments in
    the params' own structure."""
    params = list(rel.parameters())
    m_of = {id(p): m for p, m in zip(params, opt_state["m"])}
    v_of = {id(p): v for p, v in zip(params, opt_state["v"])}
    return {"params": convert.relevance_to_tree(rel),
            "opt": {"step": torch.tensor(opt_state["step"],
                                         dtype=torch.int32),
                    "m": convert.relevance_to_tree(
                        rel, leaf=lambda p: m_of[id(p)]),
                    "v": convert.relevance_to_tree(
                        rel, leaf=lambda p: v_of[id(p)])}}


def from_state(state, cfg, device):
    """``(rel, opt_state)`` on ``device`` from a :func:`state_tree`; the
    moments line up with ``rel.parameters()`` because a model built from
    their pytree orders its parameters alike."""
    rel = convert.relevance_from_numpy(state["params"], cfg).to(device)
    moments = {name: [p.data for p in convert.relevance_from_numpy(
        state["opt"][name], cfg).to(device).parameters()]
        for name in ("m", "v")}
    return rel, {"step": int(state["opt"]["step"]), **moments}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="paper geometry (12L/768): ~106M params")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "list_dual_encoder_torch"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = get_config("list-dual-encoder")
    if not args.full:
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=128, n_heads=4,
                                  d_ff=512, vocab_size=8192, max_len=16)
    corpus = GeoCorpus(GeoCorpusConfig(
        n_objects=4000, n_queries=800, n_topics=24,
        vocab_size=cfg.vocab_size, max_len=min(cfg.max_len, 16), seed=0))

    opt_init, opt_update = make_optimizer(cfg.optimizer)

    def fresh():
        rel = relevance.relevance_init(cfg, torch.Generator().manual_seed(0))
        return state_tree(rel.to(dev), opt_init(list(rel.parameters())))

    mgr = CheckpointManager(args.ckpt_dir, every=100, keep=2)
    state, start, _ = mgr.restore_or_init(fresh)
    rel, opt_state = from_state(state, cfg, dev)
    params = list(rel.parameters())
    n_params = sum(p.numel() for p in params)
    print(f"dual encoder: {n_params/1e6:.1f}M params "
          f"({'paper' if args.full else 'reduced'} geometry), "
          f"resume from step {start}")

    sched = linear_warmup_cosine(args.lr, 20, args.steps)
    tr, va, te = corpus.split()
    m = None
    for step in range(start, args.steps):
        b = pl.batch_to(corpus.train_batch(step, args.batch, tr,
                                           b_neg=cfg.hard_neg_b), dev)
        t0 = time.time()
        m = pl.relevance_step(rel, params, opt_state, opt_update, b,
                              sched(step))
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step}: loss={float(m['loss']):.4f} "
                  f"acc={float(m['acc']):.3f} ({(time.time()-t0)*1e3:.0f}ms)")
        mgr.maybe_save(step + 1, state_tree(rel, opt_state),
                       meta={"loss": float(m["loss"])})
    mgr.maybe_save(args.steps, state_tree(rel, opt_state), force=True)
    print("done; checkpoints in", args.ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
