"""The training driver (reference: ``repro.launch.train``), on the card.

One driver for every family of the model substrate: the per-family init,
loss and deterministic synthetic stream (``_train_fns``), gradients
through ``launch.steps.loss_and_grads`` (on the card through the flash
and dot twins' backward kernels), global-norm clipping at 1.0, the
config's optimizer, microbatch accumulation, checkpoint / auto-resume
(``CheckpointManager``), a ``StragglerMonitor`` and ``watchdog_step``.
An LM config's ``remat`` checkpoints each block.

It runs on the CUDA device (``--device cuda``, the default; it raises
without one) or on the CPU with ``--device cpu``; ``--reduced`` (the
default) takes the family's small config, ``--full`` the real one. The
log lines are the reference's, ending in the "improved" verdict; a last
line ``summary {json}`` gives the per-step wall times and their split
into forward, backward and optimizer (CUDA events on the card, the host
clock on the CPU), the peak device memory and the kernels' launch
counts.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --device cpu --steps 20 --batch 4 --seq-len 64 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --full --steps 6 --batch 8 --seq-len 4096 --microbatch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
        --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data.graph_data import community_graph, molecule_batch
from repro_torch.data.lm_data import LMStream
from repro_torch.data.recsys_data import CTRStream, SeqRecStream
from repro_torch.device import full_f32_products, require_device
from repro_torch.distributed.resilience import StragglerMonitor, watchdog_step
from repro_torch.kernels import ops as kops
from repro_torch.launch import steps
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.optim import clip_by_global_norm, make_optimizer


def _train_fns(cfg, args, device):
    """``(init_fn(seed), loss_fn(params, batch), batch_fn(step) -> dict of
    numpy arrays)``, the reference's per family."""
    fam = cfg.family
    if fam == "lm":
        stream = LMStream(cfg.vocab_size, seed=args.seed)
        return (lambda seed: tf.lm_init(cfg, seed=seed, device=device),
                lambda p, b: tf.lm_loss(p, b),
                lambda s: stream.batch(s, args.batch, args.seq_len))
    if fam == "gnn":
        if args.gnn_shape == "molecule":
            g0 = molecule_batch(args.batch, 30, 64, 16, seed=args.seed)
            d_in, n_cls, d_e = 16, 1, 4
        else:
            g0 = community_graph(2708, 10556, 64, 7, seed=args.seed)
            d_in, n_cls, d_e = 64, 7, 0
        return (lambda seed: gnn_lib.gnn_init(cfg, d_in, n_cls, d_e,
                                              seed=seed, device=device),
                gnn_lib.gnn_loss, lambda s: g0)
    if fam == "recsys":
        if cfg.model == "dlrm":
            stream = CTRStream(cfg.n_dense, cfg.table_sizes, seed=args.seed)
            return (lambda seed: rs.dlrm_init(cfg, seed=seed, device=device),
                    lambda p, b: rs.dlrm_loss(p, b, cfg),
                    lambda s: stream.batch(s, args.batch))
        if cfg.model == "xdeepfm":
            stream = CTRStream(1, [cfg.vocab_per_field] * cfg.n_sparse,
                               seed=args.seed)

            def xb(s):
                b = stream.batch(s, args.batch)
                return {"sparse": b["sparse"], "label": b["label"]}
            return (lambda seed: rs.xdeepfm_init(cfg, seed=seed,
                                                 device=device),
                    lambda p, b: rs.xdeepfm_loss(p, b, cfg), xb)
        if cfg.model == "bert4rec":
            stream = SeqRecStream(cfg.n_items, seed=args.seed)
            return (lambda seed: rs.bert4rec_init(cfg, seed=seed,
                                                  device=device),
                    lambda p, b: rs.bert4rec_loss(p, b, cfg),
                    lambda s: stream.bert4rec_batch(
                        s, args.batch, cfg.seq_len, cfg.mask_prob))
        if cfg.model == "mind":
            stream = SeqRecStream(cfg.n_items, seed=args.seed)
            return (lambda seed: rs.mind_init(cfg, seed=seed, device=device),
                    lambda p, b: rs.mind_loss(p, b, cfg),
                    lambda s: stream.mind_batch(s, args.batch, cfg.hist_len))
    raise ValueError(f"use examples/torch_train_dual_encoder.py for {fam}")


def _state_tree(leaves, opt) -> dict:
    """The checkpointed state: the trainable leaves (``steps.param_leaves``
    order) and the optimizer's state, its step an int32 tensor."""
    return {"params": leaves,
            "opt": dict(opt, step=torch.tensor(opt["step"],
                                               dtype=torch.int32))}


@torch.no_grad()
def _load_state(leaves, opt, state) -> None:
    """Copy a restored :func:`_state_tree` into the live leaves and
    optimizer state."""
    for p, r in zip(leaves, state["params"]):
        p.copy_(r)
    opt.update(state["opt"])
    opt["step"] = int(state["opt"]["step"])


def _on_device(batch: dict, device) -> dict:
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in batch.items() if v is not None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient accumulation factor")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--gnn-shape", default="full_graph_sm")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    full_f32_products(dev)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "gnn" and args.microbatch > 1:
        raise ValueError("a graph batch does not split into microbatches")
    init_fn, loss_fn, batch_fn = _train_fns(cfg, args, dev)
    opt_init, _ = make_optimizer(cfg.optimizer)
    params = init_fn(args.seed)
    leaves = steps.param_leaves(params)
    opt = opt_init(leaves)
    opt_update = steps.make_update(cfg.optimizer, params)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        state, start_step, _ = mgr.restore_or_init(
            lambda: _state_tree(leaves, opt))
        if start_step:
            _load_state(leaves, opt, state)
            print(f"resumed from step {start_step}")
        del state
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kops.reset_launch_counts()
    timer = steps.StepSplit(dev)

    def step_fn(batch):
        timer.start()
        loss, metrics, grads = steps.loss_and_grads(
            loss_fn, params, batch, microbatch=args.microbatch, timer=timer)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        opt_update(grads, opt, leaves, args.lr)
        del grads
        timer.mark("optimizer")
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm})
        return metrics

    monitor = StragglerMonitor()
    host = "host0"
    losses, walls, splits = [], [], []
    for step in range(start_step, args.steps):
        batch = _on_device(batch_fn(step), dev)
        metrics, dt = watchdog_step(step_fn, batch, deadline_s=600.0)
        monitor.record(host, dt)
        splits.append(timer.split())
        walls.append(dt * 1e3)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step}: loss={loss:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} "
                  f"({dt*1000:.0f} ms)"
                  + (f" stragglers={monitor.flagged()}"
                     if monitor.flagged() else ""), flush=True)
        if mgr:
            mgr.maybe_save(step + 1, _state_tree(leaves, opt),
                           meta={"arch": args.arch, "loss": loss})
    if mgr:
        mgr.maybe_save(args.steps, _state_tree(leaves, opt), force=True,
                       meta={"arch": args.arch, "final": True})
    if losses:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"done: loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    summary = {
        "arch": args.arch, "device": str(dev), "start_step": start_step,
        "losses": losses, "step_ms": walls,
        "split_ms": {k: [s.get(k, 0.0) for s in splits]
                     for k in ("forward", "backward", "optimizer")},
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "launches": kops.launch_counts(),
        "n_params": sum(p.numel() for p in leaves)}
    if dev.type == "cuda":
        summary["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        summary["device_name"] = torch.cuda.get_device_name(dev)
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
