#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --compare     # timings only (see compare())

Needs one CUDA device and the CUDA toolkit (``nvcc``). Phases:

0. Print the card's name and power limit; build the four kernel libraries
   of ``src/repro_torch/kernels/csrc`` and the memory probes of
   ``probes/memory_rates.cu`` (one nvcc per source, sm_90a, side by side)
   and print each build's time and ptxas register/spill lines;
   ``cuobjdump -sass`` of the flash library must show HGMMA (``wgmma``)
   in each bf16 and fp16 instantiation of the forward
   (``flash_fwd_kernel``) and of the backward's two kernels, HGMMA and a
   TMA load (UTMALDG) in each f32 forward (``flash_fwd_f32_kernel``, D
   16–128) and in each f32 backward kernel (``flash_bwd_dkdv_f32_kernel``,
   ``flash_bwd_dq_f32_kernel``, D 16–128), and no ``flash_tc_kernel`` (the
   forward's old ``mma.sync`` body), ``flash_f32_kernel`` (its old
   CUDA-core f32 body) or ``flash_bwd_dkdv_f32`` / ``flash_bwd_dq_f32``
   (the old CUDA-core f32 backward); that of the
   scan library must show HGMMA and a TMA load (UTMALDG) in every
   instantiation of the engine scans' ``engine_scan_kernel`` (3 tiers ×
   filtered or not × 3 slot widths), and none of the earlier CUDA-core
   ``routed_kernel`` / ``cluster_major_kernel``; the scan library's own
   shared-memory layout (``fts_scan_smem``) must equal
   ``fused_topk_score.scan_smem`` at every launch shape of a grid.
1. Hold each kernel (routed, cluster-major) against its plain PyTorch
   version on the card: f32 / bf16 / int8 × unfiltered / filtered × cr 1, 2,
   at a small shape and at d = 768, at k = 20 and k > 32; then the chunked
   designs' edge cases in every tier, filtered and not (``random_case``
   with ``edge``): caps over several row chunks with exact integer scores
   tied across tile and chunk boundaries (ids must equal the plain
   version's), 32 and 48 pairs on one cluster (one and two slot groups of
   32), all-padding chunks, k above a chunk's live rows, a filter passing
   fewer than k rows; d 16 and d 1024; k 300 and 1024 (fewer query slots
   per item); the routed kernel at cr 17 and cr = c = 24.
2. Serve small snapshots built in memory from a seed through
   ``repro_torch.api.Searcher`` on the ``cuda``, ``cuda-cm`` and ``auto``
   backends against the ``dense`` backend on a CPU copy: every tier, a
   delta of 25 tombstones, one of 300 (at k 20 and k 300: tombstones are
   masked out of the scan, not over-fetched), and cr 17 and cr = c = 24
   on ``cuda``.
3. Full width: ``list-dual-encoder`` (12L / 768 / 12H / 3072, bf16 compute)
   with seeded random weights, 2,849,754 objects in c = 300 buffers at f32,
   bf16 and int8, 4,096 queries through ``Searcher.query`` (batch 256,
   k 20, cr 2) on ``cuda`` and ``auto``. The kernels' launch counters are
   read around this run; the first queries are checked against the plain
   versions. Then the route-skew axis on one 256-query chunk (``SKEWS``:
   the random router's routes, uniform, Zipf 1.05): for each skew × tier,
   U and the largest load, the bound, both kernels' ms and ×bound, the
   ``cuda`` and ``cuda-cm`` path times (plan and fold included), and both
   kernels against the plain routed scan on the full chunk; the plain
   versions are timed on the router's routes. Then 32 queries at full
   fan-out (cr = c = 300) on the int8 tier, ``cuda`` against ``cuda-cm``
   (ids equal up to ties, both timed), and the tombstone mask's build
   over the 5.7M ids at 300 tombstones.
4. The kernel entry point ``repro_torch.kernels.ops``: the gather-path
   scan, flash attention, dot interaction and embedding bag are first held
   against their plain versions at small shapes over the edge cases of
   ``tests/test_torch_ops.py``, then driven once each at full width with
   the launch counters zeroed around the run: the gather scan over the
   first 32 queries of phase 3's chunk (candidates ``buf[top_c]``, 38,144
   rows of d 768, f32 / bf16 / int8), also held against ``fts_routed`` on
   the same routes, with its ×bound; flash attention at ``qwen2-7b`` (H
   28, KV 4, D 128) in
   bf16 and f32 and a ``gemma3-27b`` local layer (H 32, KV 16, window
   1024) in bf16, S 2048; dot interaction and embedding bag at
   ``dlrm-mlperf`` widths (F 27, d 128; a 39,060-row table, bags of 16)
   for B 512 and 262,144. Each output is checked against the plain
   version, then kernel, plain version and one library call are timed.
   Flash's bound takes its FLOPs at the bf16 peak in both dtypes (the f32
   body's products run on ``wgmma`` in three bf16 terms); the f32 layer
   also prints the CUDA cores' 67 TFLOP/s bound and the split's floor (12
   products of 2·D flops a pair), and the f32 body must have launched.
   The f32 body is then launched whole at ``FLASH_F32_FULL``'s shapes
   (qwen2-7b 8 × 4,096, gemma3-27b's local layer 2 × 8,192, and qwen2-7b
   1 × 5,000, whose last chunk of heads is partial), its output and lse
   held against the plain version within ``FLASH_TOL``'s 2e-5 on the
   first and the last sequence.
   Flash attention in bf16 and fp16 must also stay within one rounding of
   the plain version on the inputs widened to f32 (``FLASH_ONE_ROUNDING``),
   at every small shape and both main shapes; SDPA's distance under the
   same rule is printed for the record. The flash library's forward launch
   (``flash_forward_shape``) must equal ``forward_launch_shape``'s and its
   backward launches (``flash_backward_shape``) ``backward_launch_shape``'s,
   the mirrors the CPU tests check. Dot interaction and bmm + triangle
   are timed in turns over several rounds, and the medians kept. The
   card's L2 and HBM read rates are measured (``memory_rates``, a
   streaming probe), and embedding bag gets an L2 bound: its gathered row
   bytes over the best L2 rate of the run -- the streaming probe's, a
   probe reading the same rows in the kernel's order with more rows in
   flight (``row_gather_rate``), or the kernel's own.

5. The write path at full width, on phase 3's index (the launch counters
   zeroed before (a) and read after (d)): (a) for every tier, 300 victims
   from the live top-k of 32 queries at cr = c, a delta of 1,024 fresh
   rows (32 of them the queries' own normalised embeddings at their
   locations) and the victims' tombstones, ``compact`` on the card (timed
   whole, its host placement timed alone on the same inputs and checked to
   be where ``compact`` put the rows; the rest is the device writes); the
   delta
   snapshot and its compaction must agree on ``cuda-cm`` at cr = c (ids up
   to ties), no victim may come back and every query must find its own
   row. (b) 4,096 queries (batch 256, k 20, cr 2) on ``cuda`` and ``auto``
   against the int8 snapshot with that delta, beside phase 3's delta-free
   walls; one routed delta scan per chunk. (c) ``api.save`` of the int8
   snapshot into a temporary directory, ``api.load`` onto the card, 256
   queries bit-equal, save and load rates. (d) ``scale_corpus`` at 131,072
   objects embedded by the full-width object tower (seeded random
   weights) with ``embed_objects``, placed by the random router into c =
   300 f32 buffers; ``cuda-cm`` at cr = c against ``brute_force`` (ids up
   to ties), and ``auto``'s recall@10 at cr 2 and 20. After the counts
   are read, the delta scan's routed launch is held against its plain
   version on one 256-query chunk of (b) (``delta_scan_check``).

6. Training and build at full width: ``api.build`` of
   ``list-dual-encoder`` (n_clusters 300) with the reference's defaults
   (relevance 200 steps, batch 64, 4 TkQ negatives, lr 1.5e-3; index
   400 steps, 8 pseudo-negatives from the window 50,000:55,000, lr 3e-3;
   spill 3, f32) on ``scale_corpus`` at 131,072 objects, then the trained
   snapshot served on every tier × ``cuda`` / ``cuda-cm`` / ``auto`` ×
   cr 2, 20 (the launch counters zeroed before the build, read after the
   serving). Records each stage's time (TkQ mining, relevance steps and
   tokens/s, the object tower's pass, Eq. 13 mining, index steps,
   packing), the first and last losses, cluster balance and peak memory.
   Checks: (a) the contrastive and MCL losses and every gradient leaf on
   the card equal the CPU's at a small config (f32 compute, TF32 off);
   (b) the trained snapshot's float32-compute twin on every tier and GPU
   backend equals ``dense`` on a CPU copy at cr 2 and 20 (ids up to ties);
   (c) ``brute_force`` equals ``cuda-cm`` at cr = c; (d) ``api.save`` →
   ``api.load`` answers bit-equal on 256 queries; (e) no loss, gradient
   norm or parameter is not finite. Records recall@10 against
   ``brute_force`` and the ground truth. Then the trained router's top-2
   routes of 256 held-out queries become the skew ``trained`` on phase
   3's full-width buffers (a row of the route-skew table), and are timed
   on the trained snapshot's own buffers; last, the relevance step split
   into forward / backward / optimizer by CUDA events.

7. The serving stack at full width: phase 3's int8 index behind
   ``Searcher.serve`` at the reference CLI's defaults (``SERVE_CFG``:
   batch 64, 2 ms, k 10, cr 1, cache 8,192, delta threshold 1,024), the
   launch counters zeroed before (a) and read after (f). (a) Warm-up on
   ``cuda``, ``cuda-cm`` and ``auto``; ``serve_all`` of 4,096 queries
   bit-equal to ``Searcher.query`` at batch 64. (b) ``closed_loop`` of
   16,384 Zipf(1.05) requests over the 4,096 at concurrency 64 on each
   backend, answers equal to (a)'s up to ties. (c) ``open_loop`` at 50%
   and 90% of (b)'s ``cuda`` rate (nothing shed), and of the 4,096
   distinct requests at 200% with max_queue 256 and a 50 ms deadline
   (answered + shed == arrivals). (d) 32 rounds of churn with the WAL on
   (fsync, a temporary directory): an insert of 64 rows (queries' own
   normalised embeddings at their locations), a delete of 16 ids, 128
   queries; two compactions on a loop tick; every acknowledged insert
   found at cr = c on ``cuda-cm``, no deleted id back. (e) Phase 6's
   trained snapshot saved once; two inserts and a delete acknowledged,
   then a crash at ``write.pre_publish``, ``write.post_publish``,
   ``wal.torn_tail`` and ``ckpt.mid_save`` (inside ``checkpoint``);
   ``api.recover(..., device="cuda")`` answers at cr = c on ``cuda-cm``
   bit-equal to a server that never crashed and applied the surviving
   records. (f) 256 standing queries; 8 insert batches of 64 notify
   the pairs a plain oracle on a CPU copy finds, scores within 1e-4.
   Every flush must launch one base scan plus one routed delta scan
   while the delta holds rows (``FlushProbe``); no breaker trips, no
   poisoned request.

8. The user's tools on the card. (a) The command line
   ``repro_torch.launch.serve.main`` in process, at the reference CLI's
   flags with 131,072 objects, 4,096 queries, c 16 (n / 10k), cr 2, int8,
   16,384 Zipf(1.05) requests closed loop at concurrency 64 and 32 churn
   rounds with the WAL (``CLI_ARGS``; the CLI's model is its own 4L / d 64),
   its training cut from the CLI's default 300 + 600 steps to 50 + 100
   for the script's time (``CLI_TRAIN_ARGS``);
   then a restart on the same directories that loads the snapshot, replays
   the WAL and runs an open loop at half the first run's QPS. Build s,
   recall@10, QPS and p50 / p95 / p99 are read from its report. (b) The
   dispatch path (``serving.cluster_dispatch_query``) on phase 3's index,
   one 256-query chunk at k 20, cr 2, every tier, at the default capacity
   (pairs dropped, recorded) and at the chunk's largest cluster load
   (nothing dropped, ids equal to ``cuda-cm`` up to ties): one
   cluster-major launch per call, nothing routed; its pair lists against
   the plain dispatch scan on the card (dropped pairs (-inf, -1) in both),
   the path timed beside ``cuda-cm`` and the scan beside its bound. (c)
   The paper's baselines on phase 6's trained retriever: IVF (c 300),
   IVF_S (α 0.5) and LSH (16 bits × 4 tables) reranked with ``score_fn``,
   recall@10 against ``ListRetriever.brute_force`` and the mean candidate
   count beside LIST's at cr 2; ``kmeans`` on the card held step by step
   against ``kmeans_step`` on a CPU copy. (d) ``python -m repro_torch.api``
   and (e) the four ``examples/torch_*.py`` as subprocesses side by side
   (the training example at ``--full``, 10 steps, then resumed to 15): each
   must exit 0, the server and the engine must agree. The launch counters
   are zeroed around (a) and around (b).

9. The sharded query phase on phase 3's index (``SHARD_COUNTS``: 1, 2,
   4 and 8 LOGICAL shards on this one card, placed by an explicit device
   list; overhead, not scale-out). The launch counters are zeroed before
   and read after the main path: 1,024 queries (``SHARD_QUERIES``, batch
   256, k 20, cr 2) through ``Searcher.query`` on each placement of the int8 tier on
   ``cuda``, ``cuda-cm`` and ``auto`` and of the f32 tier at S 4 on
   ``cuda``, ids equal to the unsharded searchers' up to ties, beside
   their walls; per S the parts' bytes and the device memory added (the
   global buffers must stay on the host). Then one chunk's scan per shard
   (CUDA events) summed against the unsharded scan; at S 4: a lost shard
   (``shard.device_lost``: coverage = the share of routes the others own,
   ids = a masked unsharded oracle), ``recover_shard`` (bit-equal to
   before the loss, timed), a straggler (``shard.scan_slow``) hedged onto
   its host replica (bit-equal; the replica scan timed beside the device
   scan); ``mine_negatives_sharded`` and ``_dense`` on phase 6's 131,072
   objects against ``mine_negatives`` (up to ties), timed; ``--mesh 1``
   through the command line at phase 8's flags (training cut to 10 + 10
   steps, 1,024 requests), and a mesh wider than the host's cards refused. With no fault
   injected no as-served run may hedge a scan (the hedge floor: a device
   scan is hedged only when it took longer than a scan of the shard's host
   replica would, the part's bytes at the measured pinned-to-card copy
   rate plus a median device scan).

10. The substrate's serving paths at full width, one model at a time, the
   launch counters zeroed before and read after each path. (a) qwen2-7b at
   its full config (28 layers, seeded f32 params ~30.5 GB): ``lm_prefill``
   of 1 × 32,768 tokens (``prefill_32k`` at batch 1), then of 8 × 4,096
   into a 32,768-slot cache (``decode_32k``'s cache at batch 8) and 32
   greedy ``lm_decode_step``s. (b) gemma3-27b at its full widths, one
   LLLLLG period (6 layers, tied embeddings): 2 × 8,192 (its local layers
   take the banded case) and 32 steps on the ring caches. Each prefill
   launches the flash twin once per layer; the first launch of each layer
   kind is held within one bf16 rounding of the plain version
   (``FLASH_ONE_ROUNDING``) on every sequence's first 4,096 query rows and,
   where the sequence is longer, its last 1,024, and timed beside SDPA; on
   the model's float32-compute twin (the same weights) the last of the 32
   decode steps equals ``lm_prefill`` over the prompt and those tokens
   within ``tests/test_decode_parity.py``'s 2e-2 / 2e-2; the served bf16
   run is held to ``DECODE_BF16_GATE`` (largest |Δ| and share of logits
   beyond 2e-2), which the sound last step alone must pass and planted
   faults (a cache slot off by one, a lost cache write, the neighbouring
   position's logits) must fail; every logit is finite. (c) dlrm-mlperf at its full widths, each table
   capped at 10,000,000 rows (~28 GB): ``dlrm_forward`` on ``CTRStream``
   batches at ``serve_p99`` and ``serve_bulk``, one dot launch each, held
   against the plain version and timed beside bmm + triangle; then
   ``recsys.embedding_bag`` on table 0 over 262,144 bags of 1–16 ids in
   ``sum`` and ``mean``, one bag launch each, held within 1e-5 relative
   and timed beside ``F.embedding_bag``. (d) xDeepFM at ``serve_p99``,
   BERT4Rec's ``score_all`` over 1M items at B 512 and MIND's
   ``score_candidates`` at ``retrieval_cand`` (plain torch): walls, rows/s
   and peaks.
11. The MoE LMs and GatedGCN at full width, one model at a time, and
   Adafactor. (a) moonshot-v1-16b-a3b at its full widths (64 experts
   top-6, f32 params) and the depth that fits (``MOE_PLANS``: two trial
   depths' ``max_memory_allocated``): 8 × 4,096 into a 4,128-slot cache
   (flash launches = layers, the first held within one bf16 rounding and
   timed beside SDPA), 32 greedy steps with the drop fractions summed over
   the layers, the served decode against ``lm_prefill`` (recorded: its
   prefill and decode group tokens differently and drop differently), a
   decode step's split into the expert stacks' casts and products, the
   first layer's dispatch on 1,024 tokens with nothing dropped against
   ``moe_dense_plain`` in f32 (``MOE_ORACLE_TOL``), and on the no-drop
   twin (capacity_factor = E, 2 × 512) decode against ``lm_prefill``
   under ``MOE_TWIN_GATE`` with the planted faults failing it. (b)
   kimi-k2-1t-a32b at its full widths, one layer (bf16, 38.8 GB): the
   same at 2 × 4,096 and a 1 × 128 twin. Each prefill is timed after an
   untimed one at its shape. (c) gatedgcn
   (16 layers, d 70): ``minibatch_lg`` (a reddit-size graph, its CSR and a
   1,024-seed (15, 10) sample, generation, CSR, sampling and forward timed
   apart), ``ogb_products`` full batch with the edges cut to what fits
   (every layer held against the CPU on its first 25,000 nodes) and a
   128-graph ``molecule`` batch, each forward and loss against the CPU.
   (d) one ``adafactor_update`` of a (64, 2,048, 1,408) leaf in f32 and
   bf16 against the CPU. Phase 3 also reads ``max_memory_allocated``
   around one routed scan: it must stay below ``COPY_RISE_LIMIT``, a
   small share of a (B, cr·cap, d) candidate copy.
12. The substrate's trainer (``repro_torch.launch``), its gradients through
   the flash and dot twins' backward kernels. (a) The flash backward
   kernel against its plain version on the inputs widened to f32, within
   ``FLASH_BWD_REL`` (one rounding in 16 bits) + ``FLASH_BWD_ATOL`` of
   each tensor's largest magnitude: f32 / bf16 / fp16 over
   ``FLASH_BWD_SMALL`` (causal, window, MHA and GQA up to 8 query heads a
   KV head, ragged S across several 128-row tiles, a window straddling
   tile boundaries, D 16 to 128), then stablelm-1.6b's layer (8 × 4,096, 32 / 32 heads, D 64) and
   gemma3-27b's local layer (2 × 8,192, window 1,024, D 128) in bf16 and
   in f32 (all bounds at the bf16 peak, the f32 kernels' products running
   on ``wgmma`` in three bf16 terms; the f32 rows also print the CUDA
   cores' 67 TFLOP/s bound and the split's floor, ``F32_BWD_PRODUCTS``
   products of 2·D flops a pair); the
   forward's output bit-equal with and without lse; the kernel given lse
   + ``FLASH_BWD_FAULT`` must fail the gate; once through
   ``FlashAttentionFn`` under autograd; timed beside the bound, the plain
   version and SDPA (forward + backward minus forward). (b) The dot
   backward at B 65,536, F 27, d 128 against its plain version, timed
   beside bmm with the symmetric matrix. (c) Every family's reduced config
   (LMs in f32, stablelm with remat): loss and every gradient leaf on the
   card against the same port code on the CPU (``GRAD_TOL``, TF32 off),
   every leaf's card gradient nonzero, the twins' forward and backward
   launched, the LMs' backward through the f32 kernels
   (``flash_attention_backward_f32``, one launch a layer). (d) ``python -m repro_torch.launch.train`` (``TRAIN_ARGS``:
   stablelm-1.6b full, 24 layers, remat, 8 × 4,096 in 2 microbatches, 6
   steps) as a subprocess: the loss falls, flash launches 2 forwards and
   one backward per layer and microbatch, step ms and its forward /
   backward / optimizer split (CUDA events), tokens/s, model FLOPs over
   989 TFLOP/s, peak GB from its ``summary`` line. (e) A 2-layer
   full-width stablelm run straight for 6 steps and stopped at 3 with
   ``--ckpt-dir`` and resumed: losses within ``RESUME_LOSS_RTOL``. (f)
   dlrm-mlperf at full widths and B 65,536, tables capped at
   ``DLRM_TRAIN_MAX_ROWS``: one dot forward and backward launch a step,
   rows/s. (g) gatedgcn, xdeepfm, bert4rec and mind at full widths and
   the recsys models at their train_batch of 65,536 (bert4rec at 16,384,
   cut for the script's time; ``OTHER_TRAIN``: microbatches where memory
   needs them), moonshot at full widths with 2
   of 48 layers at 8 × 4,096, a few steps each. (e)–(g)
   run ``launch.train.main`` in process. The launches of (d)–(g) are the
   backward kernels' main-path counts (``train_launches`` on the forward
   rows). Phase 0's SASS check also wants tensor-core instructions in
   every 16-bit backward instantiation.
13. The cell plans (``repro_torch.launch.steps``). (a) ``plan_cell`` for
   all 44 registered cells on the abstract (16, 16) and (2, 16, 16)
   meshes: 40 plans and 4 skips each, every argument a meta tensor, no
   device memory allocated; the counts and walls. (b) LIST's four cells
   through ``plan_cell`` on ``make_host_mesh()``, a world of one over
   NCCL (a ``file://`` store, destroyed at the phase's end), the meta
   arguments materialised from the seed and the parameters placed through
   their specs' DTensor placements: ``contrastive_train`` with remat at
   the plan's 4,096 × 64 (4 hard negatives), halved until one step fits
   (no microbatches), ``DE_TRAIN_STEPS`` steps (ms a step, tokens/s, peak,
   losses finite, parameters moved); ``encode_corpus`` at 16,384 × 64
   (tokens/s, the time it implies for 2,849,754 objects, bit-equal to
   ``encode_objects``); ``serve_queries`` (4,096 queries over seeded
   (300, 14,336, 768) f32 buffers: the cluster-major kernel's launches
   counted around it, ids against the dispatch path with
   ``dispatch_scan_plain`` up to ties, dropped pairs); ``mine_negatives``
   (1,024 queries over 2,849,754 seeded unit rows, window
   180,000:181,000, against ``mine_negatives`` up to ties). (c) One
   contrastive step at ``REMAT_BATCH`` with remat off and on: the loss
   equal, every gradient equal (or within ``REMAT_GRAD_TOL``; the count
   bit-equal reported), remat's peak lower. (d) On the same world: the
   expert-parallel MoE bit-equal to the local path at moonshot's experts
   (2 × 512 tokens; output, aux, gradients), ``compressed_psum`` of 4M
   values bit-equal to its arithmetic.
14. The dry-run and its analysis (``repro_torch.launch.dryrun``,
   ``repro_torch.analysis``). (a) Every cell counted on meta tensors on
   the abstract (16, 16) and (2, 16, 16) meshes (``DRYRUN_JOBS`` worker
   processes, no GPU visible to them): 40 OK and 4 SKIP a mesh, no device
   memory allocated. (b) LIST's four cells counted at phase 13's executed
   sizes (``contrastive_train`` at the batch that fitted, ``mine_negatives``
   per call of the block that fitted) on a (1, 1) mesh: each cell's FLOP
   share, its count over phase 13's measured seconds times the peak of its
   dtype (bf16 for the encoder's cells, f32 for mining). (c) Each kernel
   row's declared ``work()`` at the shapes of phases 3, 4 and 12 equal, as
   integers, to the bytes and FLOPs those phases' bounds counted. (d)
   ``analysis.op_top`` on one ``serve_queries`` call and one
   ``contrastive_train`` step at batch 256 under ``torch.profiler``: every
   twin launched appears under its name with as many launches as
   ``ops.launch_counts()`` gained.

Prints a JSON line of phase 3's numbers, one of the write path's
(``write_path``), one of the build's (``build``), one of the serving
stack's (``serving``), one of phase 8's (``tools``), one of phase 9's
(``sharded``), one of phase 10's (``substrate``), one of phase 11's
(``moe_gnn``), one of phase 12's (``train``), one of phase 13's
(``cell_plans``), one of phase 14's (``dryrun``), one of per-kernel
numbers
(flash attention, dot interaction and embedding bag with ``launches`` on
phase 10's and 11's paths and ``substrate_shapes``, and the two backward
kernels with ``launches`` on phase 12's), then as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero.

``--compare`` times, on trees that share its wrappers: the flash forward
at the model layers of phases 10–12 beside SDPA, in bf16 and (phase 4's
qwen2-7b layer and three of them) in f32, the flash and
dot backward kernels at phase 12's shapes, the gather scan on its full-width
copies, the two engine scans on one chunk at four route skews and the
int8 full fan-out, and the query wall of 4,096 queries against the int8
snapshot with and without a delta of 1,024 rows and 300 tombstones.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

# the H100's peaks and the bound of a launch, defined once in
# repro_torch/analysis/roofline.py; bound by bind_bounds() once the
# checkout's src/ is on the path
HBM_BYTES_PER_S = F32_FLOPS_PER_S = BF16_FLOPS_PER_S = roof = None


def bind_bounds():
    global HBM_BYTES_PER_S, F32_FLOPS_PER_S, BF16_FLOPS_PER_S, roof
    from repro_torch.analysis import roofline as rl
    HBM_BYTES_PER_S, F32_FLOPS_PER_S = rl.HBM_BYTES_PER_S, rl.F32_FLOPS_PER_S
    BF16_FLOPS_PER_S, roof = rl.BF16_FLOPS_PER_S, rl.roof


# kernel vs plain: f32 sums in another order over d ≤ 768 terms
ATOL, RTOL = 1e-4, 1e-5


def log(*a):
    print(*a, flush=True)


def record(*a):
    """``log`` with the card's name and power limit (``CARD``) appended:
    phase 6's records."""
    log(*a, f"[{CARD}]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def topk_match(ids, scores, want_ids, want_scores):
    """→ max |score error|; raises unless ids agree up to ties (a swap of
    near-equal scores, or another pick among entries tied with the k-th)."""
    import numpy as np
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    scores = np.asarray(scores, np.float64)
    want_scores = np.asarray(want_scores, np.float64)
    err = np.abs(scores - want_scores)
    tol = ATOL + RTOL * np.abs(want_scores)
    if (err > tol).any():
        i = np.unravel_index(np.argmax(err - tol), err.shape)
        raise AssertionError(f"score error {err[i]} > tol {tol[i]} at {i}")
    for q in range(ids.shape[0]):
        for p in np.flatnonzero(ids[q] != want_ids[q]):
            same = np.flatnonzero(want_ids[q] == ids[q, p])
            tied = np.abs(want_scores[q] - want_scores[q, p]) <= 2 * tol[q, p]
            edge = abs(scores[q, p] - want_scores[q, -1]) <= 2 * tol[q, -1]
            if not ((same.size and tied[same].any()) or edge):
                raise AssertionError(
                    f"row {q} pos {p}: id {ids[q, p]} vs {want_ids[q, p]} "
                    f"(scores {scores[q, p]} / {want_scores[q, p]}) no tie")
    return float(err.max()) if err.size else 0.0


def time_ms(fn, reps=5, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------


# rows on either side of the scans' boundaries: the engine scans' 64-row
# tiles and 1024-row chunks (fused_topk_score.launch_shape), the gather's
# 256-row tiles
BOUNDARY_ROWS = (255, 256, 1023, 1024, 2047, 2048)


def random_case(g, dev, *, c, cap, d, b, cr, precision, t=1000, pad=0.3,
                edge=False):
    """Random buffers (with padding rows), queries and routes on ``dev``.

    ``edge`` builds the chunked designs' edge cases: f32/bf16 data are small
    integers and every location is one point, so scores are exact and tie
    often; in clusters 2.. the rows at BOUNDARY_ROWS are all 2s against
    non-negative queries, the top score, tied across every chunk and tile
    boundary; cluster 0 is padding over rows [1024, 2048) (a whole routed
    chunk, half a cluster-major one) and cluster 1 has 5 live rows (fewer
    than k); the last filter passes a handful of rows."""
    import torch
    from repro_torch.core import index as index_lib
    ints = edge and precision != "int8"
    if ints:
        emb = torch.randint(-2, 3, (c, cap, d), generator=g, device=dev).float()
    else:
        emb = torch.nn.functional.normalize(
            torch.randn(c, cap, d, generator=g, device=dev), dim=-1)
    perm = torch.randperm(c * cap, generator=g, device=dev).reshape(c, cap)
    ids = torch.where(torch.rand(c, cap, generator=g, device=dev) < pad,
                      torch.full_like(perm, -1), perm).to(torch.int32)
    loc = torch.rand(c, cap, 2, generator=g, device=dev)
    if edge:
        rows = [r for r in BOUNDARY_ROWS if r < cap]
        emb[2:, rows] = 2.0
        ids[2:, rows] = perm[2:, rows].to(torch.int32)
        ids[0, 1024:2048] = -1
        ids[1, 5:] = -1
        loc[:] = 0.5
    emb = torch.where(ids[..., None] >= 0, emb, torch.zeros((), device=dev))
    st, scale = index_lib.quantize_rows(emb, precision)
    attrs = torch.stack([
        torch.randint(0, 3, (c, cap), generator=g, device=dev),
        torch.randint(0, 16, (c, cap), generator=g, device=dev),
        torch.randint(0, 1000, (c, cap), generator=g, device=dev)],
        dim=-1).to(torch.int32)
    if ints:
        q = torch.randint(0, 3, (b, d), generator=g, device=dev).float()
    else:
        q = torch.randn(b, d, generator=g, device=dev) * 0.5
    q_loc = (torch.full((b, 2), 0.5, device=dev) if edge
             else torch.rand(b, 2, generator=g, device=dev))
    w = torch.rand(b, 2, generator=g, device=dev) + 0.2
    top_c = torch.stack([torch.randperm(c, generator=g, device=dev)[:cr]
                         for _ in range(b)]).to(torch.int32)
    w_hat = torch.cumsum(torch.rand(t, generator=g, device=dev) * 0.2, 0)
    f = torch.tensor([[-1, 0, -2 ** 31, 2 ** 31 - 1], [1, 0, -2 ** 31, 2 ** 31 - 1],
                      [-1, 0b0101, -2 ** 31, 2 ** 31 - 1], [-1, 0, 200, 700],
                      [0, 0b0011, 100, 2 ** 31 - 1], [1, 0b1000, 500, 505]],
                     dtype=torch.int32, device=dev)
    q_filt = f[torch.arange(b, device=dev) % f.shape[0]].contiguous()
    return dict(q=q, q_loc=q_loc, w=w, top_c=top_c, emb=st, loc=loc, ids=ids,
                scale=scale if precision == "int8" else None, attrs=attrs,
                q_filt=q_filt, w_hat=w_hat, exact=ints)


def check_kernels(case, *, k, filtered, dist_max=1.4142):
    """Both kernels vs their plain versions on one case → max errors. On
    exact (integer) cases the ids must be equal, ties included."""
    import torch
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import serving as serving_lib
    from repro_torch.kernels import fused_topk_score as fts
    kw = dict(k=k, dist_max=dist_max, buf_scale=case["scale"],
              buf_attrs=case["attrs"] if filtered else None,
              q_filt=case["q_filt"] if filtered else None)
    args = (case["q"], case["q_loc"], case["w"], case["top_c"], case["emb"],
            case["loc"], case["ids"], case["w_hat"])
    want = fts.routed_topk_plain(*args, **kw)
    got = fts.fused_topk_score_routed(*args, **kw)
    e_r = topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                     want[0].cpu())
    b, cr = case["top_c"].shape
    u, roster, _ = serving_lib.cluster_major_plan(
        case["top_c"], n_clusters=case["emb"].shape[0])
    cm_args = (case["q"], case["q_loc"], case["w"], u, roster, case["emb"],
               case["loc"], case["ids"], case["w_hat"])
    want_p = fts.cluster_major_partials_plain(*cm_args, cr=cr, **kw)
    got_p = fts.fused_topk_score_cluster_major(*cm_args, cr=cr, **kw)
    e_p = topk_match(got_p[1].cpu(), got_p[0].cpu(), want_p[1].cpu(),
                     want_p[0].cpu())
    got_m = engine_lib.merge_cluster_major(*got_p, b=b, cr=cr, k=k)
    e_m = topk_match(got_m[1].cpu(), got_m[0].cpu(), want[1].cpu(),
                     want[0].cpu())
    if case.get("exact"):
        for name, x, y in (("routed", got, want), ("cluster_major", got_p,
                                                   want_p),
                           ("cluster_major merged", got_m, want)):
            if not (torch.equal(x[1], y[1]) and torch.equal(x[0], y[0])):
                raise AssertionError(f"{name}: exact case differs from the "
                                     f"plain version (tie order)")
    return e_r, max(e_p, e_m)


def phase1(dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    err = {"routed": 0.0, "cluster_major": 0.0}
    cases = []
    for precision in ("f32", "bf16", "int8"):
        for filtered in (False, True):
            for cr in (1, 2):
                cases.append(dict(precision=precision, filtered=filtered,
                                  cr=cr, c=16, cap=640, d=128, b=64, k=20))
    for precision in ("f32", "bf16", "int8"):
        cases.append(dict(precision=precision, filtered=precision == "int8",
                          cr=2, c=8, cap=256, d=768, b=16, k=20))
    cases += [dict(precision="f32", filtered=False, cr=2, c=16, cap=640,
                   d=128, b=64, k=52),
              dict(precision="int8", filtered=True, cr=2, c=8, cap=256,
                   d=768, b=16, k=84),
              dict(precision="bf16", filtered=True, cr=1, c=4, cap=64, d=32,
                   b=8, k=60)]
    # the chunked designs' edge cases (random_case(edge=True)): caps over
    # several chunks with ties at their boundaries, 32 and 48 pairs a
    # cluster (one and two slot groups), all-padding chunks, k above a
    # chunk's live rows, a filter passing fewer than k rows; and d 16 and
    # d 1024
    for precision in ("f32", "bf16", "int8"):
        for filtered in (False, True):
            cases += [dict(precision=precision, filtered=filtered, cr=2, c=4,
                           cap=2600, d=64, b=64, k=40, edge=True),
                      dict(precision=precision, filtered=filtered, cr=2, c=4,
                           cap=2600, d=768, b=96, k=20, edge=True),
                      dict(precision=precision, filtered=filtered, cr=2, c=4,
                           cap=2600, d=64, b=64, k=5, edge=True),
                      dict(precision=precision, filtered=filtered, cr=2, c=6,
                           cap=1500, d=16, b=24, k=20),
                      dict(precision=precision, filtered=filtered, cr=2, c=4,
                           cap=700, d=1024, b=20, k=24)]
    # k above the old limit of 256 (fewer slots per item), exact data with
    # boundary ties; the routed kernel past 16 routes and at cr = c
    for precision in ("f32", "bf16", "int8"):
        cases += [dict(precision=precision, filtered=True, cr=2, c=4,
                       cap=2600, d=64, b=24, k=300, edge=True),
                  dict(precision=precision, filtered=False, cr=2, c=4,
                       cap=2600, d=64, b=12, k=1024, edge=True),
                  dict(precision=precision, filtered=precision == "bf16",
                       cr=17, c=24, cap=640, d=128, b=32, k=20),
                  dict(precision=precision, filtered=precision == "int8",
                       cr=24, c=24, cap=640, d=128, b=32, k=20)]
    for cs in cases:
        case = random_case(g, dev, c=cs["c"], cap=cs["cap"], d=cs["d"],
                           b=cs["b"], cr=cs["cr"], precision=cs["precision"],
                           edge=cs.get("edge", False))
        e_r, e_c = check_kernels(case, k=cs["k"], filtered=cs["filtered"])
        torch.cuda.synchronize()
        err["routed"] = max(err["routed"], e_r)
        err["cluster_major"] = max(err["cluster_major"], e_c)
        log(f"phase 1 ok: {cs} max|err| routed {e_r:.3g} cm {e_c:.3g}")
    log(f"phase 1 ok: {len(cases)} cases, max |kernel - plain| {err} (tol "
        f"{ATOL} + {RTOL}·|s|)")
    return err


# ---------------------------------------------------------------------------
# Phase 2: Searcher on a small in-memory snapshot
# ---------------------------------------------------------------------------


def small_snapshot(dev, precision, *, with_delta=False, n_tomb=25,
                   n_clusters=12):
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import index as index_lib
    from repro_torch.core.snapshot import IndexSnapshot
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"), n_layers=2, d_model=128, n_heads=4,
        d_ff=256, vocab_size=4096, max_len=16, spatial_t=100,
        n_clusters=n_clusters, index_mlp_hidden=(64,),
        compute_dtype="float32")
    g = torch.Generator().manual_seed(SEED + 2)
    rel_p, idx_p = convert.random_params(cfg, n_clusters=n_clusters,
                                         generator=g, with_o_enc=False)
    rel, index = convert.params_from_numpy(rel_p, idx_p, cfg)
    n = 3000
    emb = torch.nn.functional.normalize(torch.randn(n, 128, generator=g), dim=-1)
    loc = torch.rand(n, 2, generator=g)
    attrs = torch.stack([torch.randint(0, 3, (n,), generator=g),
                         torch.randint(0, 16, (n,), generator=g),
                         torch.randint(0, 1000, (n,), generator=g)], -1)
    norm = index_lib.loc_normalizer(loc)
    top = index_lib.topk_stable(index(index_lib.build_features(emb, loc, norm)),
                                3)[1]
    buf = index_lib.build_cluster_buffers(top.numpy(), emb, loc,
                                          n_clusters=n_clusters,
                                          precision=precision,
                                          attrs=attrs.to(torch.int32))
    delta = None
    if with_delta:
        m = 40
        raw = torch.nn.functional.normalize(torch.randn(m, 128, generator=g), dim=-1)
        stored, scale = index_lib.quantize_rows(raw, precision)
        delta = delta_lib.DeltaSegment.from_leaves(128, precision, {
            "emb": stored, "scale": scale, "loc": torch.rand(m, 2, generator=g),
            "ids": torch.arange(n, n + m, dtype=torch.int32), "raw": raw,
            "attrs": torch.zeros(m, 3, dtype=torch.int32),
            "tombstones": torch.arange(0, 3 * n_tomb, 3)})
    snap = IndexSnapshot.from_parts(cfg, rel, index, norm, buf,
                                    dist_max=1.4142, delta=delta)
    return snap


def phase2(dev):
    """Searcher on small snapshots: every tier on cuda / cuda-cm / auto
    against the dense backend on a CPU copy, unfiltered and filtered; a
    delta of 25 tombstones, and one of 300 (k 20 and k 300: the port masks
    tombstones, so neither grows the scan's k); cr 17 and cr = c = 24 on
    ``cuda``. Compared on the rows whose routes agree on both devices."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import filters as filters_lib
    rng = np.random.default_rng(SEED + 3)
    n_q, k, cr = 200, 20, 2
    tok = rng.integers(1, 4096, (n_q, 16)).astype(np.int32)
    msk = np.ones((n_q, 16), bool)
    msk[:, 10:] = rng.uniform(size=(n_q, 6)) < 0.5
    tok[~msk] = 0
    loc = rng.uniform(size=(n_q, 2)).astype(np.float32)
    specs = [None, filters_lib.FilterSpec(tenant=1),
             filters_lib.FilterSpec(category_mask=0b0101)]
    filters = [specs[i % 3] for i in range(n_q)]
    picks = {}
    all_b = ("cuda", "cuda-cm", "auto")
    # name, tier, delta, tombstones, clusters, extra (k, cr, backends) runs
    snaps = (("f32", "f32", False, 0, 12, ()),
             ("bf16", "bf16", False, 0, 12, ()),
             ("int8", "int8", False, 0, 12, ()),
             ("int8-delta", "int8", True, 25, 12, ()),
             ("f32-tomb300", "f32", True, 300, 12, ((300, cr, all_b),)),
             ("bf16-c24", "bf16", False, 0, 24, ((k, 17, ("cuda",)),
                                                 (k, 24, ("cuda",)))))
    for name, precision, with_delta, n_tomb, n_c, extra in snaps:
        snap = small_snapshot(dev, precision, with_delta=with_delta,
                              n_tomb=n_tomb, n_clusters=n_c)
        cpu = api.Searcher(snap, backend="dense", device="cpu")
        s_gpu = {b: api.Searcher(snap, backend=b, device=dev) for b in all_b}
        runs = [(k, cr, all_b, filt) for filt in (None, filters)]
        runs += [(kk, rr, bs, None) for kk, rr, bs in extra]
        for kk, rr, backends, filt in runs:
            # rows whose routes agree on both devices (f32 compute: all but
            # near-ties of the router's softmax)
            r_cpu = cpu.engine.route(tok, msk, loc, cr=rr).numpy()
            r_gpu = s_gpu["cuda"].engine.route(tok, msk, loc,
                                               cr=rr).cpu().numpy()
            same = (r_cpu == r_gpu).all(axis=1)
            if same.mean() < 0.95:
                raise AssertionError(f"phase 2 {name}: routes at cr {rr} "
                                     f"agree on only {same.mean():.3f} of "
                                     f"rows")
            want = cpu.query(tok, msk, loc, k=kk, cr=rr, batch=64,
                             filters=filt)
            for b in backends:
                s = s_gpu[b]
                got = s.query(tok, msk, loc, k=kk, cr=rr, batch=64,
                              filters=filt)
                topk_match(got[0][same], got[1][same], want[0][same],
                           want[1][same])
                if snap.delta is not None and np.isin(
                        got[0], snap.delta.tombstone_array()).any():
                    raise AssertionError(f"phase 2 {name} {b}: a tombstoned "
                                         f"id came back")
                pick = s.engine.pick_backend(tok, msk, loc, cr=rr,
                                             batch=64) if b == "auto" else b
                picks[(name, b, kk, rr)] = pick
                log(f"phase 2 ok: {name} {b} -> {pick} k={kk} cr={rr} "
                    f"filtered={filt is not None} rows={int(same.sum())}"
                    + (f" tombstones={n_tomb}" if with_delta else ""))
        del snap, cpu, s_gpu
    torch.cuda.empty_cache()
    return picks


# ---------------------------------------------------------------------------
# Phase 3: full width
# ---------------------------------------------------------------------------


def int8_from_f32(buf, chunk=16):
    """The int8 tier of f32 buffers (ids, loc, attrs shared)."""
    import torch
    from repro_torch.core import index as index_lib
    c, cap, d = buf["emb"].shape
    emb = torch.empty((c, cap, d), dtype=torch.int8, device=buf["emb"].device)
    scale = torch.empty((c, cap), dtype=torch.float32, device=emb.device)
    for s in range(0, c, chunk):
        emb[s:s + chunk], scale[s:s + chunk] = index_lib.quantize_rows(
            buf["emb"][s:s + chunk], "int8")
    return dict(buf, emb=emb, scale=scale, precision="int8")


def bound(ids_buf, top_c, u, *, d, elem_bytes, k, b, dequant):
    """Least time for the scan on this run's routes: every input byte read
    once (queries; ids of the distinct routed clusters; emb, loc and
    scales of their live rows), outputs written once; 2·d flops per (query,
    live row) pair, plus d per live row for the int8 dequant (once per
    row, not per pair), what ``fused_topk_score.scan_work`` declares, at
    the bf16 tensor-core peak: the engine scans run their products there
    (``wgmma``), whatever the rows' stored type."""
    import torch
    live = (ids_buf[u.long()] >= 0).sum(dim=1)                 # per cluster
    live_rows = int(live.sum())
    pairs = int((ids_buf[top_c.long()] >= 0).sum())
    row_bytes = d * elem_bytes + 8 + (4 if dequant else 0)
    nbytes = (b * (d * 4 + 16) + int(u.numel()) * ids_buf.shape[1] * 4
              + live_rows * row_bytes + b * k * 8)
    flops = pairs * d * 2 + (live_rows * d if dequant else 0)
    return dict(roof(nbytes, flops, BF16_FLOPS_PER_S), live_rows=live_rows,
                pairs_scored=pairs)


SKEWS = ("router", "uniform", "zipf1.05")
TIERS = ("f32", "bf16", "int8")
ZIPF_S = 1.05                    # the reference's benchmarks/bench_kernels.py:57


def skew_routes(skew, top_router, *, c, seed):
    """``(B, cr)`` int32 routes of one chunk under a route skew: the random
    router's own (``router``), per query ``cr`` distinct clusters drawn
    uniformly (``uniform``) or with probability ∝ rank^-1.05 over a seeded
    permutation of the clusters (``zipf1.05``), from numpy seeded by
    ``seed``; or every query to the router's ``cr`` most loaded clusters
    (``two`` at cr 2: a stand-in for phase 6's trained routes, U = 2)."""
    import numpy as np
    import torch
    if skew == "router":
        return top_router
    b, cr = top_router.shape
    if skew == "two":
        loads = torch.bincount(top_router.reshape(-1).long(), minlength=c)
        hot = torch.topk(loads, cr).indices.to(torch.int32)
        return hot.expand(b, cr).contiguous()
    rng = np.random.default_rng(seed)
    p = None
    if skew == "zipf1.05":
        p = np.empty(c)
        p[rng.permutation(c)] = np.arange(1, c + 1, dtype=np.float64) ** -ZIPF_S
        p /= p.sum()
    elif skew != "uniform":
        raise ValueError(f"unknown skew {skew!r}")
    routes = np.stack([rng.choice(c, cr, replace=False, p=p)
                       for _ in range(b)]).astype(np.int32)
    return torch.from_numpy(routes).to(top_router.device)


def skew_row(skew, top_c, sc, *, plain=False):
    """One row of the route-skew table: routes ``top_c (B, cr)`` on the
    buffers ``sc["bufs"]`` (tier → buffers) with the chunk's ``q_emb``,
    ``ql`` and ``w``. Per tier: U and the loads, the bound, both kernels'
    ms and ×bound, the ``cuda`` and ``cuda-cm`` path times (plan and fold
    included), and both kernels against the plain routed scan on the full
    chunk; with ``plain``, the plain versions timed too (chunks of 32)."""
    import torch
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import serving as serving_lib
    from repro_torch.kernels import fused_topk_score as fts
    q_emb, ql, w, w_hat = sc["q_emb"], sc["ql"], sc["w"], sc["w_hat"]
    c, d, k, cr, batch = (sc[x] for x in ("c", "d", "k", "cr", "batch"))
    dist_max = sc.get("dist_max", 1.4142)
    u, roster, n_distinct = serving_lib.cluster_major_plan(top_c,
                                                            n_clusters=c)
    n_distinct = int(n_distinct)
    loads = torch.bincount(top_c.reshape(-1).long(), minlength=c)
    loads = sorted(loads[loads > 0].tolist(), reverse=True)
    log(f"skew {skew}: {batch * cr} (query, route) pairs over "
        f"U={n_distinct} distinct clusters; largest loads {loads[:8]}")
    rep = dict(U=n_distinct, max_load=loads[0], loads=loads)
    for p, buf in sc["bufs"].items():
        scale = buf["scale"] if p == "int8" else None
        args = (q_emb, ql, w, top_c, buf["emb"], buf["loc"], buf["ids"],
                w_hat)
        cm_args = (q_emb, ql, w, u, roster, buf["emb"], buf["loc"],
                   buf["ids"], w_hat)
        kw = dict(k=k, dist_max=dist_max, buf_scale=scale)
        r_ms = time_ms(lambda: fts.fused_topk_score_routed(*args, **kw))
        cm_ms = time_ms(lambda: fts.fused_topk_score_cluster_major(
            *cm_args, cr=cr, **kw))
        path = {b_name: time_ms(lambda: engine_lib._routed_topk(
            q_emb, ql, w, top_c, buf, w_hat, k=k, backend=b_name,
            dist_max=dist_max, precision=p))
            for b_name in ("cuda", "cuda-cm")}
        sub = 32
        # the full chunk: both kernels against the plain routed scan
        got_r = fts.fused_topk_score_routed(*args, **kw)
        ps, pi = fts.fused_topk_score_cluster_major(*cm_args, cr=cr, **kw)
        got_c = engine_lib.merge_cluster_major(ps, pi, b=batch, cr=cr, k=k)

        def plain_routed():
            return [fts.routed_topk_plain(*(a[s:s + sub] if i < 4 else a
                                            for i, a in enumerate(args)),
                                          **kw)
                    for s in range(0, batch, sub)]

        def plain_cm():
            for s in range(0, batch, sub):
                u_s, r_s, _ = serving_lib.cluster_major_plan(
                    top_c[s:s + sub], n_clusters=c)
                fts.cluster_major_partials_plain(
                    q_emb[s:s + sub], ql[s:s + sub], w[s:s + sub], u_s,
                    r_s, buf["emb"], buf["loc"], buf["ids"], w_hat,
                    cr=cr, **kw)

        want_all = plain_routed()
        ws = torch.cat([x[0] for x in want_all]).cpu()
        wi = torch.cat([x[1] for x in want_all]).cpu()
        e_r = topk_match(got_r[1].cpu(), got_r[0].cpu(), wi, ws)
        e_c = topk_match(got_c[1].cpu(), got_c[0].cpu(), wi, ws)
        bd = bound(buf["ids"], top_c, u[:n_distinct], d=d,
                   elem_bytes=buf["emb"].element_size(), k=k, b=batch,
                   dequant=p == "int8")
        rec = dict(routed=dict(ms=r_ms, x_bound=r_ms / bd["bound_ms"],
                               err=e_r),
                   cluster_major=dict(ms=cm_ms,
                                      x_bound=cm_ms / bd["bound_ms"],
                                      err=e_c),
                   path_ms=path, bound=bd)
        if plain:
            rec["routed"]["plain_ms"] = time_ms(plain_routed, reps=1,
                                                warmup=0)
            rec["cluster_major"]["plain_ms"] = time_ms(plain_cm, reps=1,
                                                       warmup=1)
        rep[p] = rec
        log(f"skew {skew} {p}: U={n_distinct} max load "
            f"{loads[0]}; bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}: "
            f"{bd['bytes'] / 1e9:.3f} GB, {bd['flops'] / 1e9:.2f} GFLOP); "
            f"routed {r_ms:.3f} ms ({r_ms / bd['bound_ms']:.2f}x bound), "
            f"cluster_major {cm_ms:.3f} ms "
            f"({cm_ms / bd['bound_ms']:.2f}x bound); paths cuda "
            f"{path['cuda']:.3f} ms, cuda-cm {path['cuda-cm']:.3f} ms "
            f"(plan and fold included); full-chunk max|err| routed "
            f"{e_r:.3g} cm {e_c:.3g}"
            + (f"; plain routed {rec['routed']['plain_ms']:.3f} ms, plain "
               f"cm {rec['cluster_major']['plain_ms']:.3f} ms (chunks of "
               f"{sub})" if plain else ""))
    return rep


def full_width_index(dev):
    """``list-dual-encoder`` at full width with seeded random weights,
    2,849,754 seeded random unit objects placed by its router into c = 300
    buffers at f32, bf16 and int8, and 4,096 seeded requests."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import SERVE_QUERIES, get_config
    from repro_torch.core import index as index_lib

    n, c = SERVE_QUERIES["n_objects"], SERVE_QUERIES["n_clusters"]
    n_q = SERVE_QUERIES["query_batch"]
    cfg = dataclasses.replace(get_config("list-dual-encoder"), n_clusters=c)
    d = cfg.d_model
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 4)
    rel_p, idx_p = convert.random_params(cfg, n_clusters=c, generator=g,
                                         with_o_enc=False)
    rel, index = convert.params_from_numpy(rel_p, idx_p, cfg)
    rel, index = rel.to(dev), index.to(dev)
    del rel_p, idx_p
    log(f"phase 3: list-dual-encoder weights ({cfg.n_layers}L/{d}/"
        f"{cfg.n_heads}H/{cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.compute_dtype} compute) from seed {SEED + 4} in "
        f"{time.perf_counter() - t0:.1f} s")
    log("phase 3: object embeddings are seeded random unit rows, not "
        "encoded (corpus encoding is the build path, a later slice)")
    t0 = time.perf_counter()
    gd = torch.Generator(device=dev).manual_seed(SEED + 5)
    emb = torch.empty((n, d), device=dev)
    step = 1 << 18
    for s in range(0, n, step):
        e = min(s + step, n)
        emb[s:e] = torch.nn.functional.normalize(
            torch.randn(e - s, d, generator=gd, device=dev), dim=-1)
    loc = torch.rand(n, 2, generator=gd, device=dev)
    norm = index_lib.loc_normalizer(loc)
    assign = torch.empty((n, 3), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for s in range(0, n, step):
            e = min(s + step, n)
            feats = index_lib.build_features(emb[s:e], loc[s:e], norm)
            assign[s:e] = index_lib.topk_stable(
                index_lib.cluster_logits(index, feats), 3)[1].to(torch.int32)
    torch.cuda.synchronize()
    t_route = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf32 = index_lib.build_cluster_buffers(assign.cpu().numpy(), emb, loc,
                                            n_clusters=c, spill=3)
    del emb, assign
    buf8 = int8_from_f32(buf32)
    buf16 = dict(buf32, emb=buf32["emb"].to(torch.bfloat16), precision="bf16")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    cap = buf32["capacity"]
    bufs = {"f32": buf32, "bf16": buf16, "int8": buf8}
    gb = lambda x: x.numel() * x.element_size() / 1e9  # noqa: E731
    log(f"phase 3: {n} objects in ({c}, {cap}) buffers, f32 "
        f"{gb(buf32['emb']):.2f} GB + bf16 {gb(buf16['emb']):.2f} GB + int8 "
        f"{gb(buf8['emb']):.2f} GB; routed on the card in {t_route:.1f} s, "
        f"placed (spill 3, {buf32['n_spilled']} spilled) in {t_build:.1f} s")
    rng = np.random.default_rng(SEED + 6)
    tok = rng.integers(1, cfg.vocab_size, (n_q, cfg.max_len)).astype(np.int32)
    msk = np.ones((n_q, cfg.max_len), bool)
    lens = rng.integers(8, cfg.max_len + 1, n_q)
    msk[np.arange(cfg.max_len)[None, :] >= lens[:, None]] = False
    tok[~msk] = 0
    q_loc = rng.uniform(size=(n_q, 2)).astype(np.float32)
    return dict(cfg=cfg, rel=rel, index=index, norm=norm, bufs=bufs, tok=tok,
                msk=msk, q_loc=q_loc)


N_FAN = 32                       # queries of the full fan-out (cr = c) run
# the routed scan's rise of max_memory_allocated: it reads 2.4 MB (its
# outputs and partial top-k, PERF.md §6) against a 30 GB (B, cr·cap, d)
# candidate copy; a copy of even 0.2% of the candidates passes this
COPY_RISE_LIMIT = 64 << 20


def candidate_copy_check(q_emb, ql, w, top_c, buf, w_hat, *, k):
    """The torch analogue of the reference's jaxpr test
    (``test_pallas_jaxpr_has_no_candidate_gather``): one routed scan of
    the chunk on the card, and the rise of ``max_memory_allocated`` over
    what was allocated before it; raises if it reaches
    ``COPY_RISE_LIMIT`` (recorded beside the bytes of a ``(B, cr·cap, d)``
    copy of the routed candidates)."""
    import torch
    from repro_torch.kernels import fused_topk_score as fts
    b, cr = top_c.shape
    cap, d = buf["emb"].shape[1:]
    copy_bytes = b * cr * cap * d * buf["emb"].element_size()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fts.fused_topk_score_routed(q_emb, ql, w, top_c, buf["emb"], buf["loc"],
                                buf["ids"], w_hat, k=k, dist_max=1.4142)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    rec = dict(queries=b, cr=cr, capacity=cap, d=d, rise_bytes=rise,
               limit_bytes=COPY_RISE_LIMIT, candidate_copy_bytes=copy_bytes,
               rise_share=rise / copy_bytes)
    if rise >= COPY_RISE_LIMIT:
        raise AssertionError(f"the routed scan's memory rose by {rise} B "
                             f"(limit {COPY_RISE_LIMIT} B; a (B, cr·cap, d) "
                             f"candidate copy is {copy_bytes} B)")
    log(f"phase 3 candidate-copy check: one routed f32 scan of {b} queries "
        f"(cr {cr}, cap {cap}, d {d}) raised max_memory_allocated by "
        f"{rise} B (limit {COPY_RISE_LIMIT} B), {rise / copy_bytes:.2e} of "
        f"a {copy_bytes / 1e9:.1f} GB candidate copy")
    return rec
N_TOMB = 300                     # tombstones of the mask build's timing


def phase3(dev):
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs import SERVE_QUERIES
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import engine as engine_lib
    from repro_torch.core.snapshot import IndexSnapshot
    from repro_torch.kernels import fused_topk_score as fts

    fi = full_width_index(dev)
    cfg, rel, index, norm, bufs = (fi[x] for x in ("cfg", "rel", "index",
                                                    "norm", "bufs"))
    tok, msk, q_loc = fi["tok"], fi["msk"], fi["q_loc"]
    buf32, buf8 = bufs["f32"], bufs["int8"]
    c, d = SERVE_QUERIES["n_clusters"], cfg.d_model
    n_q, k, cr, batch = SERVE_QUERIES["query_batch"], SERVE_QUERIES["topk"], 2, 256
    snaps = {p: IndexSnapshot.from_parts(cfg, rel, index, norm, b,
                                         dist_max=1.4142)
             for p, b in bufs.items()}

    # ---- the main path: Searcher.query, counters read around it ----------
    searchers = {(p, b): api.Searcher(s, backend=b, device=dev)
                 for p, s in snaps.items() for b in ("cuda", "auto")}
    for s in searchers.values():                       # warm the allocator
        s.query(tok[:batch], msk[:batch], q_loc[:batch], k=k, cr=cr,
                batch=batch)
    torch.cuda.synchronize()
    fts.reset_launch_counts()
    results, walls = {}, {}
    for key, s in searchers.items():
        t0 = time.perf_counter()
        results[key] = s.query(tok, msk, q_loc, k=k, cr=cr, batch=batch)
        walls[key] = time.perf_counter() - t0
    main_launches = dict(fts.launches)
    picks = {f"{p}/{b}": (s.engine.pick_backend(tok, msk, q_loc, cr=cr,
                                                batch=batch)
                          if b == "auto" else b)
             for (p, b), s in searchers.items()}
    log(f"phase 3 main path: {n_q} queries × {len(searchers)} searchers; "
        f"launches {main_launches}; picks {picks}")
    for key, (ids, sc) in results.items():
        if ids.shape != (n_q, k) or not np.isfinite(sc).all():
            raise AssertionError(f"phase 3 {key}: bad output {ids.shape}")
        if not (ids >= 0).all():
            raise AssertionError(f"phase 3 {key}: fewer than k results")
        log(f"phase 3 {key[0]} {key[1]}: {n_q} queries in "
            f"{walls[key] * 1e3:.1f} ms ({n_q / walls[key]:.0f} q/s), "
            f"backend {picks['/'.join(key)]}")
    for name in ("routed", "cluster_major"):
        if main_launches[name] == 0:
            raise AssertionError(f"kernel {name} not launched on the main path")

    # ---- per-kernel checks and timings: the route-skew axis ---------------
    prefix = engine_lib.make_prefix_fn(cr=cr)
    chunk = [torch.from_numpy(a[:batch]).to(dev) for a in (tok, msk, q_loc)]
    t_prefix = time_ms(lambda: prefix(rel, index, norm, *chunk))
    q_emb, w, top_router = prefix(rel, index, norm, *chunk)
    ql = chunk[2]
    n_check = 32
    want_first = {}
    for p, buf in bufs.items():                # the searchers' first answers
        scale = buf["scale"] if p == "int8" else None
        want = fts.routed_topk_plain(
            q_emb[:n_check], ql[:n_check], w[:n_check], top_router[:n_check],
            buf["emb"], buf["loc"], buf["ids"], snaps[p].w_hat, k=k,
            dist_max=1.4142, buf_scale=scale)
        err = 0.0
        for b_name in ("cuda", "auto"):
            ids, sc = results[(p, b_name)]
            err = max(err, topk_match(ids[:n_check], sc[:n_check],
                                      want[1].cpu(), want[0].cpu()))
        want_first[p] = err
        log(f"phase 3 {p}: first {n_check} queries match the plain "
            f"version (max |err| {err:.3g})")
    w_hat = snaps["f32"].w_hat
    skew_ctx = dict(bufs=bufs, q_emb=q_emb, ql=ql, w=w, w_hat=w_hat, c=c,
                    d=d, k=k, cr=cr, batch=batch)
    report = {}
    for skew in SKEWS:
        top_c = skew_routes(skew, top_router, c=c, seed=SEED + 10)
        rep = skew_row(skew, top_c, skew_ctx, plain=skew == "router")
        if skew == "router":
            for p in TIERS:
                for name in ("routed", "cluster_major"):
                    rep[p][name]["err"] = max(rep[p][name]["err"],
                                              want_first[p])
        report[skew] = rep
    log(f"phase 3: prefix {t_prefix:.3f} ms per {batch}-query chunk")

    # ---- full fan-out (cr = c) on the int8 tier: cuda against cuda-cm ------
    fq = [x[:N_FAN] for x in chunk]
    qe_f, w_f, top_all = engine_lib.make_prefix_fn(cr=c)(rel, index, norm,
                                                         *fq)
    fan = {}
    for b_name in ("cuda", "cuda-cm"):
        def run(b_name=b_name):
            return engine_lib._routed_topk(
                qe_f, fq[2], w_f, top_all, buf8, w_hat, k=k, backend=b_name,
                dist_max=1.4142, precision="int8")
        out = run()
        fan[b_name] = dict(out=out, ms=time_ms(run, reps=2, warmup=0))
    e_fan = topk_match(fan["cuda"]["out"][0].cpu(), fan["cuda"]["out"][1].cpu(),
                       fan["cuda-cm"]["out"][0].cpu(),
                       fan["cuda-cm"]["out"][1].cpu())
    bd_fan = bound(buf8["ids"], top_all, torch.arange(c, device=dev), d=d,
                   elem_bytes=1, k=k, b=N_FAN, dequant=True)
    fan_rec = dict(queries=N_FAN, cr=c, err=e_fan, bound=bd_fan,
                   **{f"{b_name}_ms": fan[b_name]["ms"] for b_name in fan})
    log(f"phase 3 full fan-out int8: {N_FAN} queries at cr = c = {c} "
        f"({c * fts.launch_shape(cap=buf8['capacity'], d=d, k=k, elem_size=1)['n_chunks']}"
        f" partial lists a query); cuda {fan['cuda']['ms']:.3f} ms "
        f"({fan['cuda']['ms'] / bd_fan['bound_ms']:.2f}x bound), cuda-cm "
        f"{fan['cuda-cm']['ms']:.3f} ms "
        f"({fan['cuda-cm']['ms'] / bd_fan['bound_ms']:.2f}x bound); bound "
        f"{bd_fan['bound_ms']:.3f} ms ({bd_fan['bound_by']}); ids equal up "
        f"to ties, max|Δ| {e_fan:.3g}")
    del fan

    # ---- no candidate copy in the routed scan (ROADMAP Queue C 5) ---------
    c5 = candidate_copy_check(q_emb, ql, w, top_router, buf32, w_hat, k=k)

    # ---- the tombstone mask's build at full width --------------------------
    held = buf32["ids"][buf32["ids"] >= 0]
    gt = torch.Generator(device=dev).manual_seed(SEED + 11)
    tomb = held[torch.randperm(held.numel(), generator=gt, device=dev)[
        :N_TOMB]].cpu().numpy()
    masked = delta_lib.mask_tombstones(buf32["ids"], tomb)
    n_masked = int((buf32["ids"] >= 0).sum() - (masked >= 0).sum())
    if n_masked != N_TOMB:
        raise AssertionError(f"mask_tombstones masked {n_masked} rows, "
                             f"want {N_TOMB}")
    mask_ms = time_ms(lambda: delta_lib.mask_tombstones(buf32["ids"], tomb))
    log(f"phase 3 tombstone mask: {N_TOMB} tombstones over "
        f"{buf32['ids'].numel()} ids in {mask_ms:.3f} ms (once per snapshot)")
    del held, masked

    return dict(report=report, launches=main_launches, fan_out=fan_rec,
                mask_ms=mask_ms, candidate_copy_check=c5,
                distinct_clusters=report["router"]["U"],
                route_loads=report["router"]["loads"], picks=picks,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                queries=n_q, batch=batch, k=k, cr=cr, prefix_ms=t_prefix,
                walls_ms={f"{p}/{b}": wall * 1e3
                          for (p, b), wall in walls.items()},
                qps={f"{p}/{b}": n_q / wall for (p, b), wall in walls.items()},
                ctx=dict(buf32=buf32, buf8=buf8, w_hat=w_hat, q_emb=q_emb,
                         ql=ql, w=w, top_c=top_router),
                skew_ctx=skew_ctx,
                write_ctx=dict(snaps=snaps, tok=tok, msk=msk, q_loc=q_loc,
                               q_emb=q_emb[:N_FAN]))


# ---------------------------------------------------------------------------
# Phase 4: the kernel entry point (repro_torch.kernels.ops) at full width
# ---------------------------------------------------------------------------

# published widths, from the reference's configs (src/repro/configs/):
# qwen2_7b.py, a local (sliding-window) layer of gemma3_27b.py, and
# dlrm_mlperf.py (26 sparse features + the bottom MLP's output; its second
# table, 39,060 rows, is in the TPU kernel's small-vocab regime)
FLASH_CFGS = {"qwen2-7b": dict(h=28, kv=4, d=128, window=0),
              "gemma3-27b-local": dict(h=32, kv=16, d=128, window=1024)}
FLASH_S = 2048
DLRM = dict(f=27, d=128, vocab=39_060, bag=16)
DLRM_BATCHES = {"serve_p99": 512, "serve_bulk": 262_144}
N_GATHER = 32                    # queries of phase 3's first chunk
# kernel vs plain, as the reference holds its kernels (tests/test_kernels.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
# half-precision outputs: kernel and plain round f32 sums once each, so
# they may differ by one unit in the last place, at most |x|·2^-mantissa
HALF_ULP = {"bfloat16": 2 ** -7, "float16": 2 ** -10}
# flash in 16 bits, one rounding: |kernel - plain_f32| ≤ rel·|plain_f32| +
# 1e-4, plain_f32 the plain version on the inputs widened to f32, not
# rounded; rel is half a unit in the last place of the output's type
FLASH_ONE_ROUNDING = {"bfloat16": 2 ** -8, "float16": 2 ** -11}
DOT_TOL = 1e-5                   # atol and rtol (f32)
DOT_ROUNDS, DOT_REPS = 5, 10     # dot vs bmm + triangle, timed in turns
EBAG_TOL = 1e-4


def median(xs):
    xs = sorted(xs)
    return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2


def gather_case(g, dev, *, b, n, d, precision, k, t=100, pad_from=None,
                ties=False, dead=None):
    """Random candidates ``(b, n, d)`` on ``dev`` in a precision tier;
    ``dead = (lo, hi)`` makes those rows padding for every query."""
    import torch
    from repro_torch.core import index as index_lib
    q = torch.randn(b, d, generator=g, device=dev)
    ql = torch.rand(b, 2, generator=g, device=dev)
    w = torch.rand(b, 2, generator=g, device=dev) + 0.5
    ce = torch.randn(b, n, d, generator=g, device=dev)
    cl = torch.rand(b, n, 2, generator=g, device=dev)
    ci = torch.randint(-1, 10_000, (b, n), generator=g, device=dev,
                       dtype=torch.int32)
    if pad_from is not None:
        ci[:, :pad_from] = torch.arange(pad_from, device=dev,
                                        dtype=torch.int32)
        ci[:, pad_from:] = -1
    if dead is not None:
        ci[:, dead[0]:dead[1]] = -1
    if ties:                     # exact integer scores in one spatial bucket
        q = torch.randint(-2, 3, (b, d), generator=g, device=dev).float()
        ce = torch.randint(-2, 3, (b, n, d), generator=g, device=dev).float()
        cl[:] = ql[:, None, :]
        w[:] = torch.tensor([1.0, 0.5], device=dev)
    w_hat = torch.cumsum(torch.rand(t, generator=g, device=dev) * 0.01, 0)
    scale = None
    if precision == "int8":
        ce, scale = index_lib.quantize_rows(ce, "int8")
    elif precision == "bf16":
        ce = ce.to(torch.bfloat16)
    return (q, ql, w, ce, cl, ci, w_hat), dict(k=k, dist_max=1.4142,
                                                cand_scale=scale)


def one_rounding_excess(out, q, k, v, *, causal, window):
    """max over elements of |out - plain_f32| / (rel·|plain_f32| + 1e-4),
    plain_f32 on q, k, v widened to f32 and not rounded: ≤ 1 passes."""
    from repro_torch.kernels import flash_attention as fa
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    rel = FLASH_ONE_ROUNDING[str(q.dtype).split(".")[1]]
    return ((out.float() - want).abs()
            / (rel * want.abs() + 1e-4)).max().item()


# the f32 body at full width, launched whole with lse: phase 10's qwen2-7b
# prompt (8 × 4,096; 8 chunks of 28 heads) and gemma3-27b's local layer
# (2 × 8,192, window 1,024; 16 chunks of 4), and qwen2-7b at 1 × 5,000,
# whose 28 heads go in chunks of 21 (the last one partial)
FLASH_F32_FULL = {"qwen2-7b/8x4096": (8, 4096, 28, 4, 128, 0),
                  "gemma3-27b-local/2x8192": (2, 8192, 32, 16, 128, 1024),
                  "qwen2-7b/1x5000": (1, 5000, 28, 4, 128, 0)}


def flash_f32_full_width(dev):
    """The f32 body at ``FLASH_F32_FULL``'s shapes, causal, its output and
    lse held against the plain version within ``FLASH_TOL`` (raises) on
    the first and the last sequence (the launch's first and last chunk of
    heads), a block of KV heads at a time with at most ``HELD_SCORES``
    scores → ``{shape: record}``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    tol = FLASH_TOL["float32"]
    out = {}
    for name, (b, s, h, kv, d, w) in FLASH_F32_FULL.items():
        q, k, v = (torch.randn(b, s, n, d, generator=g, device=dev)
                   for n in (h, kv, kv))
        o, lse = fa._launch(q, k, v, True, w, True)
        grp = h // kv
        per = max(1, HELD_SCORES // (grp * s * s))
        eo = el = 0.0
        for i in sorted({0, b - 1}):
            for j0 in range(0, kv, per):
                j1 = min(kv, j0 + per)
                hs = slice(j0 * grp, j1 * grp)
                want, want_lse = fa.flash_attention_plain(
                    q[i:i + 1, :, hs], k[i:i + 1, :, j0:j1],
                    v[i:i + 1, :, j0:j1], causal=True, window=w,
                    return_lse=True)
                eo = max(eo, (o[i:i + 1, :, hs] - want).abs().max().item())
                el = max(el, (lse[i:i + 1, hs] - want_lse).abs().max().item())
                del want, want_lse
        chunk = fa.forward_launch_shape(d, torch.float32).chunk(b, s, h, kv)
        out[name] = dict(shape=[b, s, h, kv, d], window=w, chunk=chunk,
                         max_abs_err=eo, lse_max_abs_err=el)
        log(f"phase 4 flash f32 at full width {name} (chunks of {chunk} of "
            f"{b * h} heads), sequences 0 and {b - 1} against the plain "
            f"version: max |Δ| o {eo:.3g}, lse {el:.3g} (gate {tol})")
        if not (eo < tol and el < tol):
            raise AssertionError(f"flash f32 {name}: max |Δ| o {eo}, lse "
                                 f"{el} >= {tol}")
        del q, k, v, o, lse
    return out


def one_rounding_check(out, q, k, v, *, causal, window, what):
    x = one_rounding_excess(out, q, k, v, causal=causal, window=window)
    if not x <= 1.0:
        raise AssertionError(f"{what}: |kernel - plain_f32| is {x:.3g}× the "
                             f"one-rounding bound")
    return x


def flash_sass_check(lib_path):
    """→ {kernel/dtype: HGMMA counts per head dim} for the flash forward
    and backward instantiations in the built library; raises unless each
    16-bit instantiation of the forward (``flash_fwd_kernel``) and of the
    backward's two kernels has HGMMA (``wgmma``) instructions, and each f32
    forward (``flash_fwd_f32_kernel``) and f32 backward
    (``flash_bwd_dkdv_f32_kernel``, ``flash_bwd_dq_f32_kernel``), D
    16–128, has both HGMMA and a TMA load (UTMALDG); or if the old
    ``mma.sync`` forward (``flash_tc_kernel``), the CUDA-core f32 forward
    (``flash_f32_kernel``) or the CUDA-core f32 backward
    (``flash_bwd_dkdv_f32``, ``flash_bwd_dq_f32``) is still built."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name and re.search(r"\bHGMMA\b", line):
            counts[name][0] += 1
        elif name and re.search(r"\bUTMALDG\b", line):
            counts[name][1] += 1
    old = [name for name in counts
           if "flash_tc_kernel" in name or "flash_f32_kernel" in name
           or re.search(r"flash_bwd_(dkdv|dq)_f32I", name)]
    if old:
        raise AssertionError(f"an earlier flash kernel is still built: {old}")
    found = {}
    for tag, mangled in (("bfloat16", "13__nv_bfloat16"), ("float16", "6__half")):
        for kern in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                     "flash_bwd_dq_kernel"):
            fns = {name: c[0] for name, c in counts.items()
                   if kern in name and mangled in name}
            if len(fns) != 4 or min(fns.values()) == 0:
                raise AssertionError(f"flash {kern} {tag}: HGMMA per "
                                     f"instantiation {fns}; want them in "
                                     f"all four head dims")
            found[f"{kern}/{tag}"] = sorted(fns.values())
    for kern in ("flash_fwd_f32_kernel", "flash_bwd_dkdv_f32_kernel",
                 "flash_bwd_dq_f32_kernel"):
        fns = {name: tuple(c) for name, c in counts.items() if kern in name}
        if len(fns) != 4 or min(min(c) for c in fns.values()) == 0:
            raise AssertionError(f"{kern} (HGMMA, UTMALDG) per "
                                 f"instantiation {fns}; want both in all "
                                 f"four head dims")
        found[f"{kern}/float32"] = sorted(fns.values())
    return found


def scan_sass_check(lib_path):
    """→ {instantiation: (HGMMA, UTMALDG) counts} for the engine scans in
    the built scan library; raises unless each of the 18
    ``engine_scan_kernel`` instantiations has both, or if the earlier
    CUDA-core ``routed_kernel`` / ``cluster_major_kernel`` is built."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name and re.search(r"\bHGMMA\b", line):
            counts[name][0] += 1
        elif name and re.search(r"\bUTMALDG\b", line):
            counts[name][1] += 1
    old = [n for n in counts if re.search(r"(routed|cluster_major)_kernel", n)]
    if old:
        raise AssertionError(f"the CUDA-core engine scans are still built: "
                             f"{old}")
    scans = {n: tuple(c) for n, c in counts.items()
             if "engine_scan_kernel" in n}
    if len(scans) != 18 or min(min(c) for c in scans.values()) == 0:
        raise AssertionError(f"engine_scan_kernel (HGMMA, UTMALDG) per "
                             f"instantiation {scans}; want both in all 18")
    return sorted(scans.values())


def scan_layout_check():
    """→ the number of launch shapes compared: for each shape
    ``fused_topk_score.launch_shape`` picks over a grid of width, k and
    tier, the scan library's own shared-memory layout (``fts_scan_smem``)
    equals the wrapper's mirror (``scan_smem``); raises on a difference."""
    from repro_torch.kernels import fused_topk_score as fts
    lib, n = fts._lib(), 0
    for d in (16, 64, 128, 768, 1024):
        for k in (1, 20, 84, 300, 1024, fts.K_MAX):
            for elem in (1, 2, 4):
                sh = fts.launch_shape(cap=19072, d=d, k=k, elem_size=elem)
                got = lib.fts_scan_smem(d, k, elem, sh["slots"], sh["stages"],
                                        sh["wgs"])
                if got != sh["smem_bytes"]:
                    raise AssertionError(f"scan layout d {d} k {k} elem "
                                         f"{elem}: library {got} B, mirror "
                                         f"{sh['smem_bytes']} B")
                n += 1
    return n


def phase4_checks(dev):
    """The four new kernels against their plain versions at small shapes,
    over the edge cases of tests/test_torch_ops.py → max |Δ| by kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_topk_score as fts
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    err = dict(gather=0.0, flash_attention=0.0, dot_interaction=0.0,
               embedding_bag=0.0)
    n_cases = dict.fromkeys(err, 0)
    for precision in ("f32", "bf16", "int8"):
        for cs in (dict(b=8, n=1024, d=32, k=5), dict(b=16, n=2048, d=64, k=10),
                   dict(b=4, n=512, d=128, k=20), dict(b=4, n=4000, d=768, k=20),
                   dict(b=6, n=300, d=64, k=84),
                   dict(b=4, n=256, d=32, k=12, pad_from=7),
                   dict(b=4, n=16, d=32, k=20),              # k > N
                   dict(b=3, n=512, d=16, k=40, ties=precision != "int8"),
                   # three chunks of 1024, ties across their boundaries,
                   # the middle one all padding; k above the old 256
                   dict(b=3, n=3000, d=64, k=40, ties=precision != "int8",
                        dead=(1024, 2048)),
                   dict(b=5, n=2500, d=768, k=300),
                   dict(b=2, n=1100, d=16, k=1024,
                        ties=precision != "int8")):
            args, kw = gather_case(g, dev, precision=precision, **cs)
            got = kops.fused_topk_score(*args, **kw)
            want = fts.gather_topk_plain(*args, **kw)
            torch.cuda.synchronize()
            e = topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                           want[0].cpu())
            if cs.get("ties") or cs.get("pad_from") or cs.get("dead"):
                if not torch.equal(got[1], want[1]):
                    raise AssertionError(f"gather {precision} {cs}: "
                                         f"positions differ")
            if cs.get("pad_from") and not (got[1][:, 7:] == -1).all():
                raise AssertionError("gather: padding tail not -1")
            err["gather"] = max(err["gather"], e)
            n_cases["gather"] += 1
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dt = str(dtype).split(".")[1]
        tol = FLASH_TOL[dt]
        for b, s, h, kv, d, causal, window in (
                (2, 256, 4, 2, 32, True, 0), (1, 128, 4, 4, 64, True, 64),
                (2, 200, 2, 1, 16, True, 0), (1, 256, 8, 2, 32, True, 100),
                (1, 64, 2, 2, 32, False, 0), (1, 130, 4, 4, 128, False, 0),
                (1, 300, 8, 2, 128, True, 100), (1, 520, 4, 2, 128, True, 1),
                (2, 100, 7, 1, 64, True, 0), (1, 333, 7, 7, 16, True, 1),
                (1, 190, 14, 2, 32, False, 50),
                # the 16-bit body's 128-row, 128-key tiles: S on either
                # side of them, a window one key under a tile, GQA 8
                (1, 127, 8, 1, 128, True, 0), (2, 129, 4, 4, 64, True, 127),
                (1, 255, 16, 2, 128, False, 0), (1, 257, 8, 1, 32, True, 128),
                (1, 385, 4, 2, 128, True, 129), (1, 1, 2, 1, 64, True, 0)):
            q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
            got = kops.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            case = (b, s, h, kv, d, causal, window)
            if not e < tol or got.dtype != dtype:
                raise AssertionError(f"flash {dtype} {case}: max |err| {e} "
                                     f">= {tol}")
            if dtype != torch.float32:
                one_rounding_check(got, q, k, v, causal=causal,
                                   window=window, what=f"flash {dt} {case}")
            err["flash_attention"] = max(err["flash_attention"], e)
            n_cases["flash_attention"] += 1
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in fa.HEAD_DIMS:          # the library's launch = the mirror
            sh = fa.forward_launch_shape(d, dtype)
            got = fa.kernel_forward_shape(d, dtype)
            if got != (sh.rows, sh.key_tile, sh.stages, sh.threads,
                       sh.smem_bytes):
                raise AssertionError(f"flash forward {dtype} D {d}: the "
                                     f"library's launch {got} is not "
                                     f"forward_launch_shape's {sh}")
            want = tuple((x.rows, x.tile, x.stages, x.threads, x.smem_bytes,
                          int(x.split))
                         for x in fa.backward_launch_shape(d, dtype))
            got = fa.kernel_backward_shape(d, dtype)
            if got != want:
                raise AssertionError(f"flash backward {dtype} D {d}: the "
                                     f"library's launches {got} are not "
                                     f"backward_launch_shape's {want}")
    for dtype, shapes in ((torch.float32, ((128, 27, 16), (256, 27, 128),
                                           (64, 8, 8), (32, 5, 6),
                                           (70, 2, 128), (70, 3, 36),
                                           (70, 26, 128), (70, 28, 64),
                                           (70, 33, 130), (9, 27, 7))),
                          (torch.bfloat16, ((300, 27, 128), (64, 27, 16),
                                            (70, 33, 12), (70, 2, 8))),
                          (torch.float16, ((300, 27, 128), (70, 26, 6)))):
        for b, f, d in shapes:
            x = torch.randn(b, f, d, generator=g, device=dev).to(dtype)
            got = kops.dot_interaction(x).float()
            want = di.dot_interaction_plain(x).float()
            torch.cuda.synchronize()
            tol = (DOT_TOL + DOT_TOL * want.abs() if dtype == torch.float32
                   else want.abs() * HALF_ULP[str(dtype).split(".")[1]]
                   + 1e-6)
            if ((got - want).abs() > tol).any():
                raise AssertionError(f"dot_interaction {dtype} {(b, f, d)}")
            err["dot_interaction"] = max(err["dot_interaction"],
                                         (got - want).abs().max().item())
            n_cases["dot_interaction"] += 1
    rng = np.random.default_rng(SEED + 8)
    for v, d, b, p, dtype in ((1000, 32, 128, 8, torch.float32),
                              (500, 16, 64, 4, torch.float32),
                              (4096, 64, 256, 16, torch.float32),
                              (4096, 128, 256, 16, torch.bfloat16),
                              (300, 12, 64, 5, torch.bfloat16),
                              (1000, 64, 128, 8, torch.float16)):
        tab = torch.randn(v, d, generator=g, device=dev).to(dtype)
        idx = rng.integers(-1, v + 50, (b, p)).astype(np.int32)  # -1 and >= V
        idx[0] = [3] * (p - 1) + [-1]                            # duplicates
        idx = torch.from_numpy(idx).to(dev)
        got = kops.embedding_bag(tab, idx)
        want = eb.embedding_bag_plain(tab, idx)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if ((got - want).abs() > EBAG_TOL + EBAG_TOL * want.abs()).any():
            raise AssertionError(f"embedding_bag {(v, d, b, p, dtype)}: {e}")
        err["embedding_bag"] = max(err["embedding_bag"], e)
        n_cases["embedding_bag"] += 1
    log(f"phase 4 checks ok: {n_cases} cases, max |kernel - plain| {err}")
    return err


def gather_inputs(ctx):
    """The gather scan's full-width inputs from phase 3's index: the first
    ``N_GATHER`` queries of its chunk and their candidate copies
    ``buf[top_c]`` (38,144 rows of d 768) in f32, bf16 and int8."""
    import torch
    buf32, buf8 = ctx["buf32"], ctx["buf8"]
    tc = ctx["top_c"][:N_GATHER].long()
    qa = tuple(x[:N_GATHER].contiguous()
               for x in (ctx["q_emb"], ctx["ql"], ctx["w"]))
    cap, d = buf32["emb"].shape[1:]
    n_cand = tc.shape[1] * cap

    def copy_of(buf, dtype=None):
        """The candidate copy the reference's caller materializes."""
        emb = buf["emb"][tc].reshape(N_GATHER, n_cand, d)
        scale = (buf["scale"][tc].reshape(N_GATHER, n_cand)
                 if buf["emb"].dtype == torch.int8 else None)
        return ((emb if dtype is None else emb.to(dtype)), scale,
                buf["loc"][tc].reshape(N_GATHER, n_cand, 2),
                buf["ids"][tc].reshape(N_GATHER, n_cand))

    ce32, _, cl, ci = copy_of(buf32)
    cand = {"f32": (ce32, None), "bf16": (ce32.to(torch.bfloat16), None),
            "int8": copy_of(buf8)[:2]}
    copy_src = {"f32": (buf32, None), "bf16": (buf32, torch.bfloat16),
                "int8": (buf8, None)}
    return qa, cand, cl, ci, copy_of, copy_src


def gather_times(qa, ce, sc, cl, ci, w_hat):
    """The gather kernel's and its plain version's ms on one tier, and the
    bound: live rows' bytes (each read once) and their flops."""
    from repro_torch.kernels import fused_topk_score as fts
    from repro_torch.kernels import ops as kops
    args = (*qa, ce, cl, ci, w_hat)
    kw = dict(k=20, dist_max=1.4142, cand_scale=sc)
    rec = dict(ms=time_ms(lambda: kops.fused_topk_score(*args, **kw)),
               plain_ms=time_ms(lambda: fts.gather_topk_plain(*args, **kw),
                                reps=3))
    d = ce.shape[-1]
    live = int((ci >= 0).sum())
    nbytes = (live * d * ce.element_size()
              + ci.numel() * (8 + 4 + (4 if sc is not None else 0))
              + N_GATHER * (d * 4 + 16) + w_hat.numel() * 4
              + N_GATHER * 20 * 8)
    flops = live * 2 * d + (live * d if sc is not None else 0)
    rec.update(roof(nbytes, flops, F32_FLOPS_PER_S), live_rows=live)
    rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    return rec


# the memory read-rate probes (probes/memory_rates.cu): a measurement aid
# built beside the port's kernels, its own library, called only here
def _bind_probes(lib):
    import ctypes
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stream_read.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr,
                                ctypes.POINTER(i32)]
    lib.row_gather_read.argtypes = [ptr, ptr, i32, i32, i32, ptr, i32, ptr,
                                    ctypes.POINTER(i32)]
    lib.stream_read.restype = lib.row_gather_read.restype = i32


def probe_library():
    from repro_torch.kernels import build
    return build.KernelLibrary("memory_rates", ["memory_rates.cu"],
                               _bind_probes, csrc=ROOT / "probes")


PROBES = None                   # the probe library, built in phase 0
CARD = None                     # nvidia-smi's name and power limit
PROBE_OUT = 8 * 256 * 132       # floats of a probe's out: 8 blocks/SM
_probe_out = {}                 # device -> its probe out buffer


def _probe_call(fn, *args, dev):
    """Run one probe launch; ``fn`` is the C function, ``args`` all of its
    arguments before ``out``. A failed launch raises."""
    import ctypes
    import torch
    if dev not in _probe_out:
        _probe_out[dev] = torch.empty(PROBE_OUT, device=dev)
    out = _probe_out[dev]
    grid = ctypes.c_int(0)
    err = fn(*args, out.data_ptr(), PROBE_OUT,
             torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(grid))
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: {err}")

# stream_read over a buffer that stays in the 50 MB L2, and one far past it
# (the same probe then reads HBM): bytes, passes
STREAM_PROBE = dict(l2=(16 << 20, 200), hbm=(2 << 30, 2))
PROBE_ROUNDS = 3


def memory_rates(dev):
    """Bytes/s the card reads from L2 and from HBM: ``stream_read`` over a
    16 MB buffer (200 passes) and a 2 GB one (2 passes), with 8 and 16
    loads in flight per thread, as many blocks as fit the card; CUDA
    events over 10 launches a round. The best variant and round."""
    import torch
    lib = PROBES()
    rates = {}
    for name, (nbytes, passes) in STREAM_PROBE.items():
        buf = torch.ones(nbytes // 4, device=dev)
        ms = min(time_ms(lambda: _probe_call(
            lib.stream_read, buf.data_ptr(), buf.numel() // 4, passes, loads,
            dev=dev), reps=10)
            for loads in (8, 16) for _ in range(PROBE_ROUNDS))
        rates[name] = passes * nbytes / (ms / 1e3)
        del buf
    log(f"phase 4 memory rates (probes/memory_rates.cu stream_read): L2 "
        f"{rates['l2'] / 1e12:.3f} TB/s over a 16 MB buffer, HBM "
        f"{rates['hbm'] / 1e12:.3f} TB/s over 2 GB")
    return rates


def row_gather_rate(table, rows, dev):
    """Bytes/s at which the card reads ``table[rows]`` (f32, 16-byte rows
    multiple) in embedding bag's own order and load: ``row_gather_read``
    with 4, 8 and 16 rows in flight per warp, best variant and round."""
    d4 = table.shape[1] // 4
    ms = min(time_ms(lambda: _probe_call(
        PROBES().row_gather_read, table.data_ptr(), rows.data_ptr(),
        rows.numel(), d4, r, dev=dev), reps=10)
        for r in (4, 8, 16) for _ in range(PROBE_ROUNDS))
    return rows.numel() * table.shape[1] * 4 / (ms / 1e3)


def phase4(dev, ctx):
    """Drive ``repro_torch.kernels.ops`` once per full-width shape with the
    launch counters zeroed around the run, then hold each output against
    the plain version and time kernel, plain version and library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_topk_score as fts
    from repro_torch.kernels import ops as kops

    err = phase4_checks(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    # ---- full-width inputs ------------------------------------------------
    buf32, buf8, w_hat = ctx["buf32"], ctx["buf8"], ctx["w_hat"]
    qa, cand, cl, ci, copy_of, copy_src = gather_inputs(ctx)
    ce32 = cand["f32"][0]
    n_cand, d = ce32.shape[1:]
    flash_in = {}
    for name, c in FLASH_CFGS.items():
        for dtype in ((torch.bfloat16, torch.float32) if name == "qwen2-7b"
                      else (torch.bfloat16,)):
            flash_in[(name, str(dtype).split(".")[1])] = tuple(
                torch.randn(1, FLASH_S, hh, c["d"], generator=g,
                            device=dev).to(dtype)
                for hh in (c["h"], c["kv"], c["kv"]))
    table = torch.randn(DLRM["vocab"], DLRM["d"], generator=g, device=dev)
    dlrm_in = {}
    for shape, b in DLRM_BATCHES.items():
        x = torch.randn(b, DLRM["f"], DLRM["d"], generator=g, device=dev)
        idx = torch.randint(0, DLRM["vocab"], (b, DLRM["bag"]), generator=g,
                            device=dev, dtype=torch.int32)
        pad = torch.rand(b, DLRM["bag"], generator=g, device=dev) < 0.25
        dlrm_in[shape] = (x, torch.where(pad, torch.full_like(idx, -1), idx))
    torch.cuda.synchronize()
    log(f"phase 4 inputs: gather copy ({N_GATHER}, {n_cand}, {d}) "
        f"{ce32.numel() * 4 / 1e9:.2f} GB f32; flash S {FLASH_S} "
        f"{list(flash_in)}; dlrm F {DLRM['f']} d {DLRM['d']} B "
        f"{list(DLRM_BATCHES.values())}, table ({DLRM['vocab']}, "
        f"{DLRM['d']}) P {DLRM['bag']}")

    # ---- the main path: every entry point at full width, counted --------
    kops.reset_launch_counts()
    out = {}
    for p, (ce, sc) in cand.items():
        out[("gather", p)] = kops.fused_topk_score(
            *qa, ce, cl, ci, w_hat, k=20, dist_max=1.4142, cand_scale=sc)
    for key, (q, k, v) in flash_in.items():
        out[("flash", key)] = kops.flash_attention(
            q, k, v, causal=True, window=FLASH_CFGS[key[0]]["window"])
    for shape, (x, idx) in dlrm_in.items():
        out[("dot", shape)] = kops.dot_interaction(x)
        out[("ebag", shape)] = kops.embedding_bag(table, idx)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    log(f"phase 4 main path: launches {counts}")
    for name in ("gather", "flash_attention", "flash_attention_f32",
                 "dot_interaction", "embedding_bag"):
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} not launched on the main path")
    for key, o in out.items():
        for t in (o if isinstance(o, tuple) else (o,)):
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"phase 4 {key}: non-finite output")

    rep = {}
    # ---- gather: vs plain, vs the routed kernel, timings ------------------
    gk = {}
    for p, (ce, sc) in cand.items():
        args = (*qa, ce, cl, ci, w_hat)
        kw = dict(k=20, dist_max=1.4142, cand_scale=sc)
        got = out[("gather", p)]
        want = fts.gather_topk_plain(*args, **kw)
        e = topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                       want[0].cpu())
        rec = dict(err=e)
        if p != "bf16":                # the routed kernel on the same routes
            buf = buf32 if p == "f32" else buf8
            rs, ri = fts.fused_topk_score_routed(
                *qa, ctx["top_c"][:N_GATHER].contiguous(), buf["emb"],
                buf["loc"], buf["ids"], w_hat, k=20, dist_max=1.4142,
                buf_scale=buf["scale"] if p == "int8" else None)
            ids = torch.where(got[1] >= 0, torch.gather(
                ci, 1, got[1].clamp(min=0).long()), -1)
            e_r = topk_match(ids.cpu(), got[0].cpu(), ri.cpu(), rs.cpu())
            rec.update(routed_err=e_r, routed_bit_equal=bool(
                torch.equal(ids, ri) and torch.equal(got[0], rs)))
        rec.update(gather_times(qa, ce, sc, cl, ci, w_hat))
        rec["copy_ms"] = time_ms(lambda: copy_of(*copy_src[p]), reps=3)
        gk[p] = rec
        log(f"phase 4 gather {p}: {rec['ms']:.3f} ms (copy {rec['copy_ms']:.3f} "
            f"ms) vs plain {rec['plain_ms']:.3f} ms; bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
            f"{rec['x_bound']:.2f}x bound; max|err| "
            f"{e:.3g}; vs routed {rec.get('routed_err', 'n/a')} "
            f"bit-equal {rec.get('routed_bit_equal', 'n/a')}")
    err["gather"] = max(err["gather"], *(r["err"] for r in gk.values()),
                        *(r.get("routed_err", 0.0) for r in gk.values()))
    rep["gather"] = dict(main="f32", shapes=gk, library_ms=None,
                         library_note="no single PyTorch call computes a "
                                      "fused score + top-k")
    del cand, copy_src, ce32, cl, ci, ctx, buf32, buf8
    torch.cuda.empty_cache()
    rates = memory_rates(dev)

    # ---- flash attention ------------------------------------------------------
    fk = {}
    for (name, dt), (q, k, v) in flash_in.items():
        c = FLASH_CFGS[name]
        got = out[("flash", (name, dt))]
        want = fa.flash_attention_plain(q, k, v, causal=True,
                                        window=c["window"])
        e = (got.float() - want.float()).abs().max().item()
        if not e < FLASH_TOL[dt]:
            raise AssertionError(f"flash {name} {dt}: max |err| {e}")
        del want
        rec = dict(err=e)
        if dt != "float32":
            rec["one_rounding"] = one_rounding_check(
                got, q, k, v, causal=True, window=c["window"],
                what=f"flash {name} {dt}")
        rec["ms"] = time_ms(lambda: kops.flash_attention(
            q, k, v, causal=True, window=c["window"]), reps=20)
        rec["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=c["window"]), reps=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = fa.attention_mask(FLASH_S, FLASH_S, causal=True,
                                 window=c["window"], device=dev)
        if c["window"]:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        rec["library_ms"] = time_ms(lib, reps=20)
        lib_out = lib().transpose(1, 2)
        lib_err = (lib_out.float() - got.float()).abs().max().item()
        if dt != "float32":        # for the record: SDPA rounds P once
            rec["library_one_rounding"] = one_rounding_excess(
                lib_out, q, k, v, causal=True, window=c["window"])
        del lib_out
        pairs = int(mask.sum()) * c["h"]
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        # both bodies' products run on wgmma: the bound at the bf16 peak
        rec.update(roof(nbytes, 4 * c["d"] * pairs, BF16_FLOPS_PER_S),
                   library_err=lib_err)
        if dt == "float32":
            # beside it the CUDA cores' bound the earlier f32 body was read
            # against, and the floor of the three-term split: 12 products
            # of 2·D flops a pair at the wgmma rate
            rec["bound_cuda_core_ms"] = roof(
                nbytes, 4 * c["d"] * pairs, F32_FLOPS_PER_S)["bound_ms"]
            rec["split_floor_ms"] = 24 * c["d"] * pairs / BF16_FLOPS_PER_S \
                * 1e3
        fk[f"{name}/{dt}"] = rec
        f32_bounds = (f"; at 67 TFLOP/s {rec['bound_cuda_core_ms']:.4f} ms,"
                      f" the split's floor {rec['split_floor_ms']:.4f} ms"
                      if dt == "float32" else "")
        log(f"phase 4 flash {name} {dt}: {rec['ms']:.3f} ms vs plain "
            f"{rec['plain_ms']:.3f} ms, SDPA {rec['library_ms']:.3f} ms "
            f"(|Δ| {lib_err:.3g}); bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {rec['flops'] / 1e9:.2f} GFLOP{f32_bounds});"
            f" max|err| "
            f"{e:.3g}; |err| / one-rounding bound: kernel "
            f"{rec.get('one_rounding', 'n/a')}, SDPA "
            f"{rec.get('library_one_rounding', 'n/a')}")
        del qt, kt, vt, mask
    f32_full = flash_f32_full_width(dev)
    err["flash_attention"] = max(
        err["flash_attention"], *(r["err"] for r in fk.values()),
        *(max(r["max_abs_err"], r["lse_max_abs_err"])
          for r in f32_full.values()))
    rep["flash_attention"] = dict(
        main="qwen2-7b/bfloat16", shapes=fk,
        f32_launches=counts["flash_attention_f32"], f32_full_width=f32_full)

    # ---- dot interaction and embedding bag ------------------------------------
    dk, ek = {}, {}
    iu, ju = di.triu_pairs(DLRM["f"], dev)
    table_pad = torch.cat([table, table.new_zeros(1, DLRM["d"])])
    for shape, (x, idx) in dlrm_in.items():
        b = x.shape[0]
        got = out[("dot", shape)]
        want = di.dot_interaction_plain(x)
        if ((got - want).abs() > DOT_TOL + DOT_TOL * want.abs()).any():
            raise AssertionError(f"dot_interaction {shape}")
        rec = dict(err=(got - want).abs().max().item())
        del want
        # kernel and bmm + triangle in turns, DOT_ROUNDS rounds of
        # DOT_REPS launches each: the medians, and the ratio per round
        ks, ls = [], []
        for _ in range(DOT_ROUNDS):
            ks.append(time_ms(lambda: kops.dot_interaction(x), reps=DOT_REPS))
            ls.append(time_ms(lambda: torch.bmm(x, x.mT)[:, iu, ju],
                              reps=DOT_REPS))
        rec["ms"], rec["library_ms"] = median(ks), median(ls)
        rec["rounds_ms"], rec["rounds_library_ms"] = ks, ls
        rec["library_over_kernel"] = sorted(b_ / a_ for a_, b_ in zip(ks, ls))
        rec["plain_ms"] = time_ms(lambda: di.dot_interaction_plain(x), reps=3)
        n_pairs = iu.numel()
        rec.update(roof(x.numel() * 4 + b * n_pairs * 4,
                        b * n_pairs * 2 * DLRM["d"], F32_FLOPS_PER_S), batch=b)
        dk[shape] = rec
        log(f"phase 4 dot_interaction {shape} (B {b}): {rec['ms']:.3f} ms vs "
            f"plain {rec['plain_ms']:.3f} ms, bmm+triu {rec['library_ms']:.3f} "
            f"ms (per round {[round(r, 3) for r in rec['library_over_kernel']]}"
            f"× the kernel); bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
            f"max|err| {rec['err']:.3g}")

        got = out[("ebag", shape)]
        want = eb.embedding_bag_plain(table, idx)
        e = (got - want).abs().max().item()
        if ((got - want).abs() > EBAG_TOL + EBAG_TOL * want.abs()).any():
            raise AssertionError(f"embedding_bag {shape}: {e}")
        rec = dict(err=e)
        rec["ms"] = time_ms(lambda: kops.embedding_bag(table, idx))
        rec["plain_ms"] = time_ms(lambda: eb.embedding_bag_plain(table, idx),
                                  reps=3)
        idx_lib = torch.where(idx >= 0, idx, DLRM["vocab"]).long()
        rec["library_ms"] = time_ms(lambda: F.embedding_bag(
            idx_lib, table_pad, mode="sum", padding_idx=DLRM["vocab"]), reps=3)
        lib_err = (F.embedding_bag(idx_lib, table_pad, mode="sum",
                                   padding_idx=DLRM["vocab"]) - got
                   ).abs().max().item()
        valid = idx[idx >= 0]
        rows = int(torch.unique(valid).numel())
        rec.update(roof(rows * DLRM["d"] * 4 + idx.numel() * 4
                        + b * DLRM["d"] * 4, int(valid.numel()) * DLRM["d"],
                        F32_FLOPS_PER_S), batch=b, rows_touched=rows,
                   valid_indices=int(valid.numel()),
                   library_err=lib_err)
        # every (bag, index) pair reads its row, from L2 (the table stays
        # there): those bytes over the best L2 read rate this run shows --
        # the streaming probe's, the row-gather probe's on these very rows,
        # or the kernel's own -- so the share cannot pass 1
        gathered = int(valid.numel()) * DLRM["d"] * 4
        l2_rates = dict(stream=rates["l2"],
                        row_gather=row_gather_rate(
                            table, valid.to(torch.int32).contiguous(), dev),
                        kernel=gathered / (rec["ms"] / 1e3))
        l2_by = max(l2_rates, key=l2_rates.get)
        rec.update(gathered_bytes=gathered, l2_rates=l2_rates,
                   l2_rate=l2_rates[l2_by], l2_rate_by=l2_by,
                   l2_bound_ms=gathered / l2_rates[l2_by] * 1e3)
        rec["share_of_bound"] = (max(rec["bound_ms"], rec["l2_bound_ms"])
                                 / rec["ms"])
        ek[shape] = rec
        log(f"phase 4 embedding_bag {shape} (B {b}): {rec['ms']:.3f} ms vs "
            f"plain {rec['plain_ms']:.3f} ms, F.embedding_bag "
            f"{rec['library_ms']:.3f} ms (|Δ| {lib_err:.3g}); bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {rows} rows); L2 "
            f"bound {rec['l2_bound_ms']:.4f} ms ({gathered / 1e9:.3f} GB of "
            f"gathered rows at {rec['l2_rate'] / 1e12:.3f} TB/s, the "
            f"{l2_by} rate; L2 rates TB/s stream "
            f"{l2_rates['stream'] / 1e12:.3f}, row gather "
            f"{l2_rates['row_gather'] / 1e12:.3f}, kernel "
            f"{l2_rates['kernel'] / 1e12:.3f}); share of max(HBM, L2 bound) "
            f"{rec['share_of_bound']:.3f}; max|err| {e:.3g}")
    err["dot_interaction"] = max(err["dot_interaction"],
                                 *(r["err"] for r in dk.values()))
    err["embedding_bag"] = max(err["embedding_bag"],
                               *(r["err"] for r in ek.values()))
    rep["dot_interaction"] = dict(main="serve_bulk", shapes=dk)
    rep["embedding_bag"] = dict(main="serve_bulk", shapes=ek)
    return dict(report=rep, launches=counts, err=err, rates=rates,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


# ---------------------------------------------------------------------------
# Phase 5: the write path at full width
# ---------------------------------------------------------------------------

N_INSERT = 1024                  # fresh rows of the delta
N_VICTIM = 300                   # tombstones, from the live top-k
N_OWN = 32                       # queries whose own row is inserted
N_SAVE_QUERIES = 256
N_CORPUS = 131_072               # objects of the brute-force corpus
N_BF_QUERIES = 256
BF_BATCH = 256                   # one batch for the towers and brute_force


def write_delta(snap, precision, victims, q_emb, q_loc, *, n_objects):
    """The phase's delta at ``precision``: ``N_INSERT`` fresh rows (ids
    ``n_objects`` up; seeded unit rows at seeded locations, the first
    ``N_OWN`` replaced by the queries' own normalised ``q_emb`` at their
    locations) and ``victims`` tombstoned."""
    import torch
    from repro_torch.core import delta as delta_lib
    d = q_emb.shape[1]
    g = torch.Generator().manual_seed(SEED + 12)
    rows = torch.nn.functional.normalize(torch.randn(N_INSERT, d, generator=g),
                                         dim=-1)
    locs = torch.rand(N_INSERT, 2, generator=g)
    rows[:N_OWN] = torch.nn.functional.normalize(q_emb[:N_OWN].cpu(), dim=-1)
    locs[:N_OWN] = torch.from_numpy(q_loc[:N_OWN])
    ids = torch.arange(n_objects, n_objects + N_INSERT)
    return (delta_lib.DeltaSegment.empty(d, precision)
            .insert(rows, locs, ids).delete(victims))


def host_placement(snap):
    """``compact``'s host steps alone, timed on its own inputs: the new
    rows' spill hops (``route_inserts``: routed on the card, the hops
    copied back) and the walk (``place_inserts``) over ``ids`` and
    ``counts`` copied to the host, the tombstones already padding
    (``scan_view``'s ids: those ``compact``'s delete leaves). →
    ``(cluster, slot, s)``."""
    import torch
    from repro_torch.core import index as index_lib
    ids_d = snap.scan_view.buffers["ids"]
    counts_d = (ids_d >= 0).sum(dim=-1)
    arrs = snap.delta.arrays()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hops = index_lib.route_inserts(snap.index, snap.norm, arrs["raw"],
                                   arrs["loc"], n_clusters=ids_d.shape[0])
    t1 = time.perf_counter()
    counts = counts_d.cpu().numpy().astype("int64")
    cluster, slot = index_lib.place_inserts(ids_d.cpu().numpy(), counts, hops,
                                            capacity=snap.buffers["capacity"])
    t2 = time.perf_counter()
    return cluster, slot, dict(route=t1 - t0, place=t2 - t1)


def write_parity(dev, wctx):
    """(a) every tier: victims from the live top-k of ``N_OWN`` queries at
    cr = c, the delta of ``write_delta``, ``compact`` on the card; the
    delta snapshot and its compaction on ``cuda-cm`` at cr = c must agree
    (ids up to ties), no victim may come back and each query finds its own
    row. Returns per-tier records and the int8 delta snapshot."""
    import numpy as np
    import torch
    from repro_torch import api
    tok, msk, q_loc = wctx["tok"], wctx["msk"], wctx["q_loc"]
    q = [a[:N_OWN] for a in (tok, msk, q_loc)]
    own_ids = None
    out, keep = {}, None
    for p, snap in wctx["snaps"].items():
        c = snap.buffers["emb"].shape[0]
        n_obj = snap.meta.n_objects
        s = api.Searcher(snap, backend="cuda-cm", device=dev)
        ids0, _ = s.query(*q, k=20, cr=c, batch=N_OWN)
        victims = np.unique(ids0[ids0 >= 0])[:N_VICTIM]
        seg = write_delta(snap, p, victims, wctx["q_emb"], q_loc,
                          n_objects=n_obj)
        snap_d = snap.with_delta(seg)
        own_ids = np.arange(n_obj, n_obj + N_OWN)
        cluster, slot, steps = host_placement(snap_d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap_c = snap_d.compact()
        torch.cuda.synchronize()
        t_compact = time.perf_counter() - t0
        placed = snap_c.buffers["ids"][torch.from_numpy(cluster).to(dev),
                                       torch.from_numpy(slot).to(dev)]
        if not np.array_equal(placed.cpu().numpy(),
                              seg.arrays()["ids"].numpy()):
            raise AssertionError(f"phase 5 {p}: compact() placed the rows "
                                 f"elsewhere than its host steps timed alone")
        if snap.buffers["ids"].data_ptr() == snap_c.buffers["ids"].data_ptr():
            raise AssertionError("phase 5: compact wrote its predecessor")
        ids_d, sc_d = s.engine.query(*q, k=20, cr=c, batch=N_OWN,
                                     snapshot=snap_d)
        ids_c, sc_c = s.engine.query(*q, k=20, cr=c, batch=N_OWN,
                                     snapshot=snap_c)
        err = topk_match(ids_c, sc_c, ids_d, sc_d)
        for name, ids in (("delta", ids_d), ("compacted", ids_c)):
            if np.isin(ids, victims).any():
                raise AssertionError(f"phase 5 {p} {name}: a victim came back")
            if not (ids == own_ids[:, None]).any(axis=1).all():
                raise AssertionError(f"phase 5 {p} {name}: a query lost its "
                                     f"own inserted row")
        n_live = int(snap_c.buffers["counts"].sum())
        if n_live != n_obj - len(victims) + N_INSERT:
            raise AssertionError(f"phase 5 {p}: {n_live} live rows after "
                                 f"compaction")
        host = steps["route"] + steps["place"]
        rest = t_compact - host
        out[p] = dict(compact_ms=t_compact * 1e3, host_placement_ms=host * 1e3,
                      device_writes_ms=rest * 1e3,
                      steps_ms={k: v * 1e3 for k, v in steps.items()},
                      victims=int(len(victims)), max_abs_err=err,
                      own_row_rank0=float((ids_d[:, 0] == own_ids).mean()))
        log(f"phase 5 (a) {p}: {N_INSERT} inserts + {len(victims)} tombstones;"
            f" compact {t_compact * 1e3:.1f} ms: host placement "
            f"{host * 1e3:.1f} ms (timed alone on its inputs: route "
            f"{steps['route'] * 1e3:.1f} + walk {steps['place'] * 1e3:.1f}), "
            f"the rest {rest * 1e3:.1f} ms (clone, delete and row writes on "
            f"the card); cuda-cm at cr = c = {c}: delta == compacted up to "
            f"ties (max|Δ| {err:.3g}), no victim back, every query finds its "
            f"own row ({out[p]['own_row_rank0']:.2f} at rank 0)")
        if p == "int8":
            keep = snap_d
        del s, snap_d, snap_c, placed
        torch.cuda.empty_cache()
    return out, keep


def write_walls(dev, wctx, snap_d, base_walls):
    """(b) 4,096 queries at batch 256, k 20, cr 2 against the int8 snapshot
    with the delta, on ``cuda`` and ``auto``; each run's launches counted:
    one base scan (routed or cluster-major) and one routed delta scan per
    chunk."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.kernels import fused_topk_score as fts
    tok, msk, q_loc = wctx["tok"], wctx["msk"], wctx["q_loc"]
    walls, launches = {}, {}
    for b in ("cuda", "auto"):
        s = api.Searcher(snap_d, backend=b, device=dev)
        s.query(tok[:256], msk[:256], q_loc[:256], k=20, cr=2, batch=256)
        torch.cuda.synchronize()
        before = dict(fts.launches)
        t0 = time.perf_counter()
        ids, sc = s.query(tok, msk, q_loc, k=20, cr=2, batch=256)
        walls[b] = (time.perf_counter() - t0) * 1e3
        launches[b] = {k: fts.launches[k] - before[k] for k in before}
        if ids.shape != (len(tok), 20) or not np.isfinite(sc).all() or \
                not (ids >= 0).all():
            raise AssertionError(f"phase 5 (b) {b}: bad output")
        if np.isin(ids, snap_d.delta.tombstone_array()).any():
            raise AssertionError(f"phase 5 (b) {b}: a tombstone came back")
        chunks = -(-len(tok) // 256)
        delta_scans = (launches[b]["routed"] + launches[b]["cluster_major"]
                       - chunks)
        if delta_scans != chunks:
            raise AssertionError(f"phase 5 (b) {b}: {delta_scans} routed "
                                 f"launches for the delta, want {chunks}")
        log(f"phase 5 (b) int8 + delta ({snap_d.delta.n_rows} rows, "
            f"{snap_d.delta.n_tombstones} tombstones) {b}: {len(tok)} queries "
            f"in {walls[b]:.1f} ms (delta-free, phase 3: "
            f"{base_walls['int8/' + b]:.1f} ms); launches {launches[b]}")
    return dict(walls_ms=walls, launches=launches,
                delta_free_walls_ms={b: base_walls["int8/" + b]
                                     for b in walls})


def delta_scan_check(dev, wctx, snap_d):
    """The delta scan's routed launch against its plain version
    (``engine.delta_scan_plain``) on the same card tensors, at the shape
    (b) gives it: one 256-query chunk of the int8 snapshot with the delta,
    every query routed to one cluster of the padded delta rows (cr 1),
    the prefix run once for both. Ids equal up to ties, scores within
    ATOL + RTOL·|s|; both timed."""
    import torch
    from repro_torch.core import engine as engine_lib
    from repro_torch.kernels import fused_topk_score as fts
    chunk = [torch.from_numpy(a[:256]).to(dev)
             for a in (wctx["tok"], wctx["msk"], wctx["q_loc"])]
    q_emb, w, _ = engine_lib.make_prefix_fn(
        cr=2, weight_mode=snap_d.meta.weight_mode)(
        snap_d.rel, snap_d.index, snap_d.norm, *chunk)
    rows, w_hat = snap_d.delta_rows, snap_d.w_hat
    kw = dict(k=20, dist_max=snap_d.dist_max, precision="int8")
    scan = engine_lib.make_delta_scan_fn(**kw)
    args = (q_emb, chunk[2], w, w_hat, rows)
    before = fts.launches["routed"]
    ids, sc = scan(*args)
    if fts.launches["routed"] != before + 1:
        raise AssertionError("phase 5: the delta scan did not launch the "
                             "routed kernel")
    want_ids, want_sc = engine_lib.delta_scan_plain(*args, **kw)
    err = topk_match(ids.cpu().numpy(), sc.cpu().numpy(),
                     want_ids.cpu().numpy(), want_sc.cpu().numpy())
    rec = dict(queries=int(q_emb.shape[0]), rows=int(rows["ids"].shape[1]),
               max_abs_err=err, ms=time_ms(lambda: scan(*args)),
               plain_ms=time_ms(lambda: engine_lib.delta_scan_plain(
                   *args, **kw)))
    log(f"phase 5 delta scan: {rec['queries']} queries x {rec['rows']} "
        f"padded delta rows (int8, cr 1): routed kernel {rec['ms']:.3f} ms, "
        f"plain {rec['plain_ms']:.3f} ms, ids equal up to ties (max|Δ| "
        f"{err:.3g})")
    return rec


def save_load(dev, wctx):
    """(c) ``api.save`` of the int8 snapshot into a temporary directory,
    ``api.load`` onto the card, 256 queries bit-equal."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.checkpoint import ckpt
    snap = wctx["snaps"]["int8"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_save_")
    try:
        free = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        path = api.save(snap, tmp)
        t_save = time.perf_counter() - t0
        sizes = {f: os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path)}
        nbytes = sum(sizes.values())
        # the checksum pass alone, over the largest leaf (the rows)
        largest = max(sizes, key=sizes.get)
        t0 = time.perf_counter()
        ckpt._crc_file(os.path.join(path, largest))
        crc_gb_s = sizes[largest] / (time.perf_counter() - t0) / 1e9
        t0 = time.perf_counter()
        loaded = api.load(tmp, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        q = [a[:N_SAVE_QUERIES] for a in (wctx["tok"], wctx["msk"],
                                          wctx["q_loc"])]
        want = api.Searcher(snap, backend="cuda", device=dev).query(
            *q, k=20, cr=2, batch=256)
        got = api.Searcher(loaded, backend="cuda", device=dev).query(
            *q, k=20, cr=2, batch=256)
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError("phase 5 (c): the loaded snapshot's answers "
                                 "differ from the saved one's")
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    rec = dict(bytes=nbytes, free_bytes_before=free, save_s=t_save,
               load_s=t_load, save_gb_s=nbytes / t_save / 1e9,
               load_gb_s=nbytes / t_load / 1e9, crc_gb_s=crc_gb_s)
    log(f"phase 5 (c) int8 save -> load: {nbytes / 1e9:.3f} GB on disk "
        f"({free / 1e9:.0f} GB free); save {t_save:.2f} s "
        f"({rec['save_gb_s']:.2f} GB/s), load onto the card {t_load:.2f} s "
        f"({rec['load_gb_s']:.2f} GB/s); the crc32 pass alone "
        f"{crc_gb_s:.2f} GB/s; {N_SAVE_QUERIES} queries on cuda "
        f"bit-equal (ids and scores)")
    return rec


def recall_at(ids, want, k):
    import numpy as np
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k
                          for a, b in zip(ids, want)]))


def brute_force_recall(dev):
    """(d) ``scale_corpus`` at ``N_CORPUS`` objects (16 tokens), the
    full-width towers with seeded random weights; objects embedded with
    ``embed_objects`` on the card and placed by the random router into
    c = 300 f32 buffers (spill 3); ``cuda-cm`` at cr = c against
    ``brute_force``, and ``auto``'s recall@10 at cr 2 and 20."""
    import numpy as np
    import torch
    from repro_torch import api, convert
    from repro_torch.configs import SERVE_QUERIES, get_config
    from repro_torch.core import index as index_lib
    from repro_torch.core import pipeline as pipeline_lib
    from repro_torch.core import relevance
    from repro_torch.core.snapshot import IndexSnapshot
    from repro_torch.data import geotextual as geo
    c = SERVE_QUERIES["n_clusters"]
    cfg = dataclasses.replace(get_config("list-dual-encoder"), n_clusters=c)
    t0 = time.perf_counter()
    corpus = geo.GeoCorpus(geo.scale_corpus(geo.GeoCorpusConfig(seed=SEED),
                                            N_CORPUS))
    t_corpus = time.perf_counter() - t0
    g = torch.Generator().manual_seed(SEED + 13)
    rel_p, idx_p = convert.random_params(cfg, n_clusters=c, generator=g,
                                         with_o_enc=True)
    rel, index = convert.params_from_numpy(rel_p, idx_p, cfg)
    rel, index = rel.to(dev), index.to(dev)
    del rel_p, idx_p
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = pipeline_lib.embed_objects(rel, corpus, batch=BF_BATCH)
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t0
    tokens = int(corpus.object_tokens()[1].sum())
    emb_d = torch.from_numpy(emb).to(dev)
    loc_d = torch.from_numpy(corpus.obj_loc.astype(np.float32)).to(dev)
    norm = index_lib.loc_normalizer(loc_d)
    with torch.no_grad():
        assign = index_lib.assign_clusters(
            index, index_lib.build_features(emb_d, loc_d, norm), top=3)
    buf = index_lib.build_cluster_buffers(assign.cpu().numpy(), emb_d, loc_d,
                                          n_clusters=c, spill=3)
    snap = IndexSnapshot.from_parts(cfg, rel, index, norm, buf,
                                    dist_max=corpus.dist_max)
    qids = np.arange(N_BF_QUERIES)
    t0 = time.perf_counter()
    bf_ids, bf_sc = api.brute_force(snap, corpus, qids, k=20, batch=BF_BATCH)
    t_bf = time.perf_counter() - t0
    # the scoring alone: one 256-query chunk over the embedded corpus
    qe = torch.from_numpy(pipeline_lib.embed_queries(
        rel, corpus, qids, batch=BF_BATCH)).to(dev)
    ql = torch.from_numpy(corpus.q_loc[qids].astype(np.float32)).to(dev)
    score_ms = time_ms(lambda: index_lib.topk_stable(relevance.score_corpus(
        rel, qe, ql, emb_d, loc_d, dist_max=corpus.dist_max), 20), reps=3)
    tok, msk = corpus.query_tokens(qids)
    qloc = corpus.q_loc[qids].astype(np.float32)
    s = api.Searcher(snap, backend="auto", device=dev)
    full = s.query(tok, msk, qloc, k=20, cr=c, batch=BF_BATCH,
                   backend="cuda-cm")
    err = topk_match(full[0], full[1], bf_ids, bf_sc)
    rec = dict(n_objects=N_CORPUS, embed_s=t_embed, tokens=tokens,
               tokens_per_s=tokens / t_embed, corpus_s=t_corpus,
               capacity=buf["capacity"], n_spilled=buf["n_spilled"],
               brute_force_s=t_bf, brute_force_score_ms=score_ms,
               cr_c_max_abs_err=err, recall_at_10={})
    for cr in (2, 20):
        ids, _ = s.query(tok, msk, qloc, k=20, cr=cr, batch=BF_BATCH)
        rec["recall_at_10"][f"cr{cr}"] = recall_at(ids, bf_ids, 10)
        rec.setdefault("auto_picks", {})[f"cr{cr}"] = s.engine.pick_backend(
            tok, msk, qloc, cr=cr, batch=BF_BATCH)
    log(f"phase 5 (d) corpus: {N_CORPUS} objects (scale_corpus, "
        f"{corpus.cfg.max_len} tokens, made in {t_corpus:.1f} s) embedded by "
        f"the object tower on the card in {t_embed:.1f} s ({tokens} tokens, "
        f"{tokens / t_embed:.0f} tokens/s); c = {c}, cap {buf['capacity']}, "
        f"{buf['n_spilled']} spilled; brute_force {t_bf:.1f} s in all "
        f"(re-embedding included), its scoring {score_ms:.3f} ms per "
        f"{N_BF_QUERIES} queries; cuda-cm at cr = c == brute_force up to ties"
        f" (max|Δ| {err:.3g}); recall@10 of auto (random weights): cr 2 "
        f"{rec['recall_at_10']['cr2']:.3f} ({rec['auto_picks']['cr2']}), "
        f"cr 20 {rec['recall_at_10']['cr20']:.3f} "
        f"({rec['auto_picks']['cr20']})")
    del snap, s, emb_d, loc_d, buf
    torch.cuda.empty_cache()
    return rec


def phase5(dev, wctx, base_walls):
    """The write path at full width on phase 3's index, the kernels'
    launch counters zeroed just before (a) and read just after (d); then
    the delta scan held against its plain version."""
    import torch
    from repro_torch.kernels import fused_topk_score as fts
    torch.cuda.reset_peak_memory_stats()
    fts.reset_launch_counts()
    rec = {}
    rec["compaction"], snap_d = write_parity(dev, wctx)
    rec["delta_query"] = write_walls(dev, wctx, snap_d, base_walls)
    torch.cuda.empty_cache()
    rec["save_load"] = save_load(dev, wctx)
    rec["brute_force"] = brute_force_recall(dev)
    rec["launches"] = dict(fts.launches)
    for name in ("routed", "cluster_major"):
        if not rec["launches"][name]:
            raise AssertionError(f"phase 5: kernel {name} not launched")
    # after the counts are read: its launches are a comparison's
    rec["delta_scan"] = delta_scan_check(dev, wctx, snap_d)
    del snap_d
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


# ---------------------------------------------------------------------------
# Phase 6: training and build at full width
# ---------------------------------------------------------------------------

N_HELD = 256                     # held-out queries: the test split, then val
N_CPU_CHECK = 32                 # of them served on the CPU copy in (b)
SPLIT_STEPS = 5                  # relevance steps timed part by part
BUILD_LOG_EVERY = 20             # api.build's history records
GRAD_TOL = (1e-5, 1e-4, 1e-7)    # loss rtol; leaf rtol of max|g|, atol
RECALL_RATIO = 0.7               # tests/test_pipeline_e2e.py:33


class StageTimes:
    """Host timers around module functions for the build's records: each
    wrapped call runs between two device syncs; ``tokens`` (optional)
    counts a call's tokens before its timer starts. ``restore`` puts the
    functions back."""

    def __init__(self):
        import collections
        self.s = collections.defaultdict(list)
        self._undo = []

    def wrap(self, owner, name, key, tokens=None):
        import torch
        fn = getattr(owner, name)

        def timed(*a, **k):
            if tokens is not None:
                self.s[key + "_tokens"].append(tokens(*a, **k))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.s[key].append(time.perf_counter() - t0)
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []


def step_tokens(rel, params, opt_state, opt_update, batch, lr, **kw):
    return int(batch["q_mask"].sum() + batch["pos_mask"].sum()
               + batch["neg_mask"].sum())


def grads_close(got, want, zero_suffix="wk.b"):
    """``got``, ``want``: ``{name: gradient}``. → max over leaves of |Δ| /
    (rtol·max|g_want| + atol); raises above 1. A key projection's bias
    (a name ending in ``zero_suffix``; None for a model with RoPE) has a
    zero gradient in exact arithmetic (the softmax cancels it): both sides
    must stay below rtol of the largest gradient."""
    import numpy as np
    _, rtol, atol = GRAD_TOL
    if got.keys() != want.keys():
        raise AssertionError("gradient leaves differ")
    g_max = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if zero_suffix and name.endswith(zero_suffix):
            if max(float(g.abs().max()), float(w.abs().max())) > rtol * g_max:
                raise AssertionError(f"gradient {name}: not zero")
            continue
        tol = rtol * float(w.abs().max()) + atol
        ratio = float((g.cpu() - w).abs().max()) / tol
        if not np.isfinite(ratio) or ratio > 1:
            raise AssertionError(f"gradient {name}: |Δ| {ratio * tol:.3g} "
                                 f"> {tol:.3g}")
        worst = max(worst, ratio)
    return worst


def grad_check(dev):
    """(a) The contrastive (Eq. 8) and MCL (Eq. 14) losses and every
    gradient leaf on the card against the same port code on a CPU copy, at
    fixed params of a small config (2 layers, d 128, f32 compute), TF32
    off; the CPU tests' tolerances (``GRAD_TOL``)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import index as index_lib
    from repro_torch.core import pipeline as pipeline_lib
    from repro_torch.core import relevance
    from repro_torch.data import geotextual as geo
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"), n_layers=2, d_model=128, n_heads=4,
        d_ff=256, vocab_size=4096, max_len=16, spatial_t=100, n_clusters=12,
        index_mlp_hidden=(64,), compute_dtype="float32")
    corpus = geo.GeoCorpus(geo.GeoCorpusConfig(
        n_objects=2000, n_queries=200, n_topics=8, vocab_size=4096,
        seed=SEED))
    pool = np.random.default_rng(SEED + 20).integers(0, 2000, (200, 16))
    batch = corpus.train_batch(0, 16, corpus.split()[0], hard_negs=pool)
    g = torch.Generator().manual_seed(SEED + 21)
    rel = relevance.relevance_init(cfg, g)
    index = index_lib.index_init(cfg.d_model, cfg.n_clusters, g,
                                 hidden=cfg.index_mlp_hidden)
    fb = {k: torch.randn(*shape, generator=g) for k, shape in (
        ("q_feat", (16, 130)), ("pos_feat", (16, 130)),
        ("neg_feat", (16, 8, 130)))}
    out = {}
    for where in ("cpu", dev):
        r, ix = copy.deepcopy(rel).to(where), copy.deepcopy(index).to(where)
        loss, m = relevance.contrastive_loss(
            r, pipeline_lib.batch_to(batch, where))
        loss.backward()
        mloss, _ = index_lib.mcl_loss(ix, {k: v.to(where)
                                          for k, v in fb.items()})
        mloss.backward()
        out[str(where)] = (float(loss), float(mloss),
                           {n: p.grad for n, p in r.named_parameters()
                            if p.grad is not None},
                           {n: p.grad for n, p in ix.named_parameters()})
    (cl, cm, cg, cig), (gl, gm, gg, gig) = out["cpu"], out[str(dev)]
    rtol = GRAD_TOL[0]
    for name, a, b in (("contrastive", gl, cl), ("mcl", gm, cm)):
        if not abs(a - b) <= rtol * max(1.0, abs(b)):
            raise AssertionError(f"phase 6 (a): {name} loss {a} on the card, "
                                 f"{b} on the CPU")
    rec = dict(contrastive_loss=gl, contrastive_loss_cpu=cl, mcl_loss=gm,
               mcl_loss_cpu=cm, leaves=len(gg) + len(gig),
               worst_leaf_over_tol=max(grads_close(gg, cg),
                                       grads_close(gig, cig)))
    record(f"phase 6 (a) gradients on the card == CPU copy: contrastive "
           f"{gl:.6f} / {cl:.6f}, MCL {gm:.6f} / {cm:.6f}, {rec['leaves']} "
           f"leaves, worst |Δ| at {rec['worst_leaf_over_tol']:.3f} of its "
           f"tolerance")
    return rec


def f32_compute_twin(snap):
    """``snap`` with copies of its towers computing in float32: the same
    weights, buffers and router, for holding the card's serve path against
    the CPU's without bf16's device-dependent rounding in the encoder."""
    import copy
    import torch
    rel = copy.deepcopy(snap.rel)
    for enc in (rel.q_enc, rel.o_enc):
        enc.compute_dtype = torch.float32
    return dataclasses.replace(snap, rel=rel)


def serve_parity(dev, snap, q):
    """(b) The trained snapshot's f32-compute twin at every tier on cuda /
    cuda-cm / auto against the dense backend on a CPU copy, cr 2 and 20,
    on the rows whose routes agree on both devices."""
    import torch
    from repro_torch import api
    twin = f32_compute_twin(snap)
    rec = {}
    for p in TIERS:
        s = twin.with_precision(p)
        cpu = api.Searcher(s, backend="dense", device="cpu")
        gpu = {b: api.Searcher(s, backend=b, device=dev)
               for b in ("cuda", "cuda-cm", "auto")}
        for cr in (2, 20):
            same = (cpu.engine.route(*q, cr=cr).numpy()
                    == gpu["cuda"].engine.route(*q, cr=cr).cpu().numpy()
                    ).all(axis=1)
            if same.mean() < 0.9:
                raise AssertionError(f"phase 6 (b) {p}: routes at cr {cr} "
                                     f"agree on {same.mean():.3f} of rows")
            want = cpu.query(*q, k=20, cr=cr, batch=len(q[0]))
            for b, s_gpu in gpu.items():
                got = s_gpu.query(*q, k=20, cr=cr, batch=len(q[0]))
                rec[f"{p}/{b}/cr{cr}"] = dict(
                    rows=int(same.sum()),
                    max_abs_err=topk_match(got[0][same], got[1][same],
                                           want[0][same], want[1][same]))
        del cpu, gpu, s
    torch.cuda.empty_cache()
    record(f"phase 6 (b) the trained snapshot (f32-compute twin) on cuda / "
           f"cuda-cm / auto == dense on a CPU copy, every tier, cr 2 and 20, "
           f"{len(q[0])} queries: max|Δ| "
           f"{max(r['max_abs_err'] for r in rec.values()):.3g}, rows "
           f"{min(r['rows'] for r in rec.values())}+")
    return rec


def round_trip(dev, snap, q):
    """(d) ``api.save`` → ``api.load`` of the trained snapshot: 256
    queries bit-equal on ``cuda``."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import api
    tmp = tempfile.mkdtemp(prefix="chip_smoke_build_")
    try:
        t0 = time.perf_counter()
        path = api.save(snap, tmp)
        t_save = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        loaded = api.load(tmp, device=dev)
        t_load = time.perf_counter() - t0
        want = api.Searcher(snap, backend="cuda", device=dev).query(
            *q, k=20, cr=2, batch=256)
        got = api.Searcher(loaded, backend="cuda", device=dev).query(
            *q, k=20, cr=2, batch=256)
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError("phase 6 (d): the loaded trained snapshot "
                                 "answers differently")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record(f"phase 6 (d) save -> load of the trained snapshot: "
           f"{nbytes / 1e9:.3f} GB, save {t_save:.2f} s, load {t_load:.2f} "
           f"s; {len(q[0])} queries bit-equal")
    return dict(bytes=nbytes, save_s=t_save, load_s=t_load)


def step_split(dev, snap, corpus):
    """Forward / backward / optimizer of one relevance step by CUDA events,
    ``SPLIT_STEPS`` steps (after one warm-up) of a trainable copy of the
    trained model with a fresh AdamW state, on the trainer's batches
    (random negatives in place of the TkQ pool: the same shapes)."""
    import copy
    import torch
    from repro_torch.convert import grad_or_zeros
    from repro_torch.core import pipeline as pipeline_lib
    from repro_torch.core import relevance
    from repro_torch.optim import clip_by_global_norm, make_optimizer
    rel = copy.deepcopy(snap.rel).requires_grad_(True)
    params = list(rel.parameters())
    init, update = make_optimizer("adamw")
    state = init(params)
    train_q = corpus.split()[0]
    parts = {"forward": [], "backward": [], "optimizer": []}
    for i in range(SPLIT_STEPS + 1):
        b = pipeline_lib.batch_to(corpus.train_batch(i, 64, train_q), dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = relevance.contrastive_loss(rel, b)
        ev[1].record()
        loss.backward()
        ev[2].record()
        grads, _ = clip_by_global_norm([grad_or_zeros(p) for p in params],
                                       1.0)
        update(grads, state, params, 1e-4)
        ev[3].record()
        for p in params:
            p.grad = None
        torch.cuda.synchronize()
        if i:
            for j, name in enumerate(parts):
                parts[name].append(ev[j].elapsed_time(ev[j + 1]))
    del rel, params, state
    torch.cuda.empty_cache()
    return {name: median(v) for name, v in parts.items()}


def gt_recall(ids, positives, k=10):
    """Mean over queries of |top-k ∩ positives| / |positives| (the
    reference's ``cluster_metrics.recall_at_k``)."""
    import numpy as np
    vals = [len(set(int(x) for x in p) & set(int(x) for x in r[:k])) / len(p)
            for r, p in zip(ids, positives) if len(p)]
    return float(np.mean(vals)) if vals else 0.0


def finite_history(hist):
    import numpy as np
    return all(np.isfinite(v) for rec in hist for v in rec.values())


def phase6(dev, skew_ctx):
    """Training and build at full width: ``api.build`` of
    ``list-dual-encoder`` (n_clusters 300) on ``N_CORPUS`` generated
    objects with the reference's defaults, then the trained snapshot
    served through ``Searcher`` on every tier × cuda / cuda-cm / auto ×
    cr 2, 20 (the launch counters zeroed before the build and read after
    the serving); checks (a)–(e); the trained router's routes on phase 3's
    full-width buffers (the skew ``trained``) and on its own."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs import SERVE_QUERIES, get_config
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import pipeline as pipeline_lib
    from repro_torch.core import pseudo_labels
    from repro_torch.data import geotextual as geo
    from repro_torch.kernels import fused_topk_score as fts
    rec = {"gradients": grad_check(dev)}
    c = SERVE_QUERIES["n_clusters"]
    cfg = dataclasses.replace(get_config("list-dual-encoder"), n_clusters=c)
    corpus = geo.GeoCorpus(geo.scale_corpus(geo.GeoCorpusConfig(seed=SEED),
                                            N_CORPUS))
    _, va, te = corpus.split()
    held = np.concatenate([te, va])[:N_HELD]
    tok, msk = corpus.query_tokens(held)
    qloc = corpus.q_loc[held].astype(np.float32)
    q = (tok, msk, qloc)
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: api.build, then the trained snapshot served -------
    st = StageTimes()
    st.wrap(pipeline_lib, "mine_tkq_negatives", "tkq_mining")
    st.wrap(pipeline_lib, "relevance_step", "relevance_step", step_tokens)
    st.wrap(pipeline_lib, "embed_objects", "object_pass")
    st.wrap(pipeline_lib, "embed_queries", "query_pass")
    st.wrap(pseudo_labels, "mine_negatives", "eq13_mining")
    st.wrap(pipeline_lib, "index_step", "index_step")
    st.wrap(pipeline_lib.ListRetriever, "build", "build")
    fts.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        snap, r = api.build(cfg, corpus, seed=SEED, log_every=BUILD_LOG_EVERY,
                            return_retriever=True, device=dev)
    finally:
        st.restore()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    tiers = {p: snap.with_precision(p) for p in TIERS}
    served, picks = {}, {}
    for p, s in tiers.items():
        for b in ("cuda", "cuda-cm", "auto"):
            searcher = api.Searcher(s, backend=b, device=dev)
            for cr in (2, 20):
                ids, sc = searcher.query(*q, k=20, cr=cr, batch=256)
                if ids.shape != (N_HELD, 20) or not np.isfinite(sc).all() \
                        or not (ids >= 0).all():
                    raise AssertionError(f"phase 6 {p} {b} cr {cr}: bad "
                                         f"output")
                served[(p, b, cr)] = ids
                if b == "auto":
                    picks[f"{p}/cr{cr}"] = searcher.engine.pick_backend(
                        *q, cr=cr, batch=256)
    torch.cuda.synchronize()
    launches = dict(fts.launches)
    for name in ("routed", "cluster_major"):
        if not launches[name]:
            raise AssertionError(f"phase 6: kernel {name} not launched")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    tm = st.s
    rh, ih = r.history["relevance"], r.history["index"]
    steps_s = tm["relevance_step"]
    rec.update(
        build_s=t_build, launches=launches, auto_picks=picks,
        peak_gb=peak_gb, resident_before_gb=resident_gb,
        tkq_mining_s=sum(tm["tkq_mining"]),
        relevance_step_ms=median(steps_s) * 1e3,
        relevance_steps=len(steps_s),
        relevance_tokens_per_s=sum(tm["relevance_step_tokens"])
        / sum(steps_s),
        relevance_first=rh[0], relevance_last=rh[-1],
        object_pass_s=sum(tm["object_pass"]),
        object_tokens=int(corpus.object_tokens()[1].sum()),
        query_pass_s=sum(tm["query_pass"]),
        eq13_mining_s=sum(tm["eq13_mining"]),
        index_step_ms=median(tm["index_step"]) * 1e3,
        index_steps=len(tm["index_step"]),
        index_first=ih[0], index_last=ih[-1],
        pack_s=sum(tm["build"]))
    counts = snap.buffers["counts"].cpu().numpy()
    assign = np.bincount(r.obj_assign, minlength=c)
    rec["balance"] = dict(
        capacity=snap.buffers["capacity"],
        n_spilled=snap.buffers["n_spilled"],
        largest_over_mean=float(counts.max() / counts.mean()),
        empty=int((counts == 0).sum()),
        top1_largest_over_mean=float(assign.max() / assign.mean()),
        top1_empty=int((assign == 0).sum()))
    record(f"phase 6 build: {N_CORPUS} objects, list-dual-encoder full width "
           f"(c = {c}), api.build defaults; {t_build:.1f} s in all (peak "
           f"{peak_gb:.1f} GB, {resident_gb:.1f} GB of phase 3 resident)")
    record(f"phase 6 relevance: TkQ mining {rec['tkq_mining_s']:.2f} s; "
           f"{len(steps_s)} steps, median {rec['relevance_step_ms']:.1f} ms "
           f"({rec['relevance_tokens_per_s']:.0f} tokens/s); loss "
           f"{rh[0]['loss']:.4f} -> {rh[-1]['loss']:.4f}, acc "
           f"{rh[0]['acc']:.3f} -> {rh[-1]['acc']:.3f} (steps "
           f"{rh[0]['step']}, {rh[-1]['step']})")
    record(f"phase 6 index: object tower's pass {rec['object_pass_s']:.2f} s "
           f"({rec['object_tokens']} tokens, "
           f"{rec['object_tokens'] / rec['object_pass_s']:.0f} tokens/s); "
           f"Eq. 13 mining {rec['eq13_mining_s']:.2f} s; {rec['index_steps']} "
           f"steps, median {rec['index_step_ms']:.2f} ms; loss "
           f"{ih[0]['loss']:.4f} -> {ih[-1]['loss']:.4f}, s_pos "
           f"{ih[0]['s_pos']:.3f} -> {ih[-1]['s_pos']:.3f}, s_neg "
           f"{ih[0]['s_neg']:.4f} -> {ih[-1]['s_neg']:.4f}")
    record(f"phase 6 pack: {rec['pack_s']:.2f} s; balance {rec['balance']}; "
           f"served every tier x cuda/cuda-cm/auto x cr 2, 20 on {N_HELD} "
           f"held-out queries; launches {launches}; auto picks {picks}")

    # ---- (e) nothing is not finite ----------------------------------------
    if not (finite_history(rh) and finite_history(ih)):
        raise AssertionError("phase 6 (e): a loss or gradient norm is not "
                             "finite")
    for m in (snap.rel, snap.index):
        for name, p in m.named_parameters():
            if not torch.isfinite(p).all():
                raise AssertionError(f"phase 6 (e): parameter {name} is not "
                                     f"finite")

    # ---- checks (b)-(d) ---------------------------------------------------
    rec["serve_parity"] = serve_parity(dev, snap,
                                       tuple(a[:N_CPU_CHECK] for a in q))
    t0 = time.perf_counter()
    bf_ids, bf_sc = api.brute_force(snap, corpus, held, k=20, batch=512)
    rec["brute_force_s"] = time.perf_counter() - t0
    full = api.Searcher(snap, device=dev).query(*q, k=20, cr=c, batch=512,
                                                backend="cuda-cm")
    rec["cr_c_max_abs_err"] = topk_match(full[0], full[1], bf_ids, bf_sc)
    record(f"phase 6 (c) brute_force on the trained snapshot "
           f"({rec['brute_force_s']:.1f} s) == cuda-cm at cr = c up to ties "
           f"(max|Δ| {rec['cr_c_max_abs_err']:.3g})")
    rec["round_trip"] = round_trip(dev, snap, q)

    # ---- recall, recorded -------------------------------------------------
    n_te = len(te)
    pos = [corpus.positives[i] for i in held[:n_te]]
    rec["recall_vs_brute_force"] = {
        f"cr{cr}": recall_at(served[("f32", "auto", cr)], bf_ids, 10)
        for cr in (2, 20)}
    rec["gt_recall_at_10"] = dict(
        brute_force=gt_recall(bf_ids[:n_te], pos),
        **{f"auto_cr{cr}": gt_recall(served[("f32", "auto", cr)][:n_te], pos)
           for cr in (2, 20)})
    gt = rec["gt_recall_at_10"]
    rec["reference_criterion_holds"] = bool(
        gt["auto_cr2"] >= RECALL_RATIO * gt["brute_force"])
    record(f"phase 6 recall@10 of auto against brute_force (trained): cr 2 "
           f"{rec['recall_vs_brute_force']['cr2']:.3f}, cr 20 "
           f"{rec['recall_vs_brute_force']['cr20']:.3f}; ground truth "
           f"({n_te} test queries): brute_force {gt['brute_force']:.4f}, "
           f"auto cr 2 {gt['auto_cr2']:.4f}, cr 20 {gt['auto_cr20']:.4f}; "
           f"LIST >= {RECALL_RATIO} x brute force: "
           f"{rec['reference_criterion_holds']}")

    # ---- the trained router's routes: phase 3's buffers, then its own -----
    top_tr = api.Searcher(snap, device=dev).engine.route(*q, cr=2)
    rec["trained_row"] = skew_row("trained", top_tr, skew_ctx)
    chunk = [torch.from_numpy(a).to(dev) for a in q]
    q_emb, w, top_own = engine_lib.make_prefix_fn(cr=2)(
        snap.rel, snap.index, snap.norm, *chunk)
    own_ctx = dict(bufs={p: s.buffers for p, s in tiers.items()},
                   q_emb=q_emb, ql=chunk[2], w=w, w_hat=snap.w_hat, c=c,
                   d=cfg.d_model, k=20, cr=2, batch=N_HELD,
                   dist_max=snap.dist_max)
    rec["trained_own_row"] = skew_row("trained (own buffers)", top_own,
                                      own_ctx)
    rec["step_split_ms"] = step_split(dev, snap, corpus)
    record(f"phase 6 relevance step split (CUDA events, median of "
           f"{SPLIT_STEPS}): {rec['step_split_ms']}")
    # the trained snapshot and its held-out queries: phase 7 (e); the
    # retriever, its corpus and the queries' ids: phase 8 (c)
    rec["trained_snap"], rec["trained_q"] = snap, q
    rec["trained_retriever"], rec["trained_corpus"] = r, (corpus, held)
    del tiers, own_ctx, q_emb, w
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Phase 7: the serving stack at full width
# ---------------------------------------------------------------------------

# ServerConfig at the reference CLI's defaults (src/repro/launch/
# serve.py:115-163): batch 64, 2 ms, k 10, cr 1, cache 8,192, no near
# tier, delta_threshold 1,024, spill 3; Zipf 1.05 traffic, concurrency 64
SERVE_CFG = dict(batch_size=64, max_delay_ms=2.0, k=10, cr=1,
                 cache_size=8192, near_cells=0, delta_threshold=1024,
                 spill=3)
SERVE_BACKENDS = ("cuda", "cuda-cm", "auto")
N_PARITY = 4096                  # serve_all against Searcher.query
N_ZIPF = 16_384                  # requests of the closed and open loops
ZIPF_A = 1.05
CONCURRENCY = 64
OPEN_RATES = (0.5, 0.9)          # of (b)'s cuda rate: nothing may be shed
OVERLOAD = dict(rate=2.0, max_queue=256, request_timeout_ms=50.0)
CHURN_ROUNDS = 32                # each: insert 64 rows, delete 16, 128 queries
CHURN_INSERT, CHURN_DELETE, CHURN_QUERIES = 64, 16, 128
CHURN_ID0 = 10_000_000           # ids of the inserted rows
CRASH_POINTS = ("write.pre_publish", "write.post_publish", "wal.torn_tail",
                "ckpt.mid_save")
N_SUBS = 256                     # standing queries on the int8 server
                                 # (1,024 registered in 22 s: cut for time)
SUB_BATCHES = 8                  # insert batches of 64 dispatched to them
SUB_ID0 = 20_000_000
SUB_TOL = 1e-4                   # card against the CPU oracle


class FlushProbe:
    """Wraps a server's ``engine.query`` (its flushes) for the phase's
    records and launch rule: per flush, the wall time (the call ends in
    the host copy of its results), whether it is the first flush on a new
    snapshot version (right after a write), and the scan launches it
    made — one base scan of the backend's kernel, plus one routed delta
    scan while the delta holds rows. A flush breaking the rule is kept in
    ``bad`` (raising inside the engine call would reach the server's
    retry path instead)."""

    def __init__(self, server, backend):
        from repro_torch.kernels import fused_topk_score as fts
        self.counts = fts.launches
        self.eng, self.backend = server.engine, backend
        self.orig = self.eng.query
        self.steady_ms, self.after_write_ms, self.bad = [], [], []
        self.launches = {"routed": 0, "cluster_major": 0}
        self.flushes = self.delta_flushes = self.cm_picks = 0
        self.dedup = []
        self._version = None
        self.eng.query = self._query

    def _query(self, *a, snapshot=None, **kw):
        snap = self.eng.snapshot if snapshot is None else snapshot
        live = int(snap.delta is not None and snap.delta.n_rows > 0)
        before = dict(self.counts)
        t0 = time.perf_counter()
        out = self.orig(*a, snapshot=snapshot, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: self.counts[k] - before[k] for k in self.launches}
        want_cm = {"cuda": (0,), "cuda-cm": (1,)}.get(self.backend, (0, 1))
        if d["cluster_major"] not in want_cm or \
                d["routed"] + d["cluster_major"] != 1 + live:
            self.bad.append(dict(launches=d, delta_live=live))
        for k in d:
            self.launches[k] += d[k]
        self.flushes += 1
        self.delta_flushes += live
        self.cm_picks += d["cluster_major"]
        if self.eng.last_dedup_factor is not None:
            self.dedup.append(self.eng.last_dedup_factor)
        fresh = self._version is not None and \
            snap.meta.version != self._version
        (self.after_write_ms if fresh else self.steady_ms).append(ms)
        self._version = snap.meta.version
        return out

    def restore(self):
        self.eng.query = self.orig

    def report(self):
        if self.bad:
            raise AssertionError(f"phase 7 {self.backend}: flushes that went "
                                 f"around a scan kernel: {self.bad[:4]}")
        return dict(engine_calls=self.flushes,
                    delta_flushes=self.delta_flushes,
                    launches=dict(self.launches), cm_picks=self.cm_picks,
                    flush_ms_median=median(self.steady_ms or [0.0]),
                    flush_ms_p99=pct(self.steady_ms, 99),
                    after_write_flush_ms_median=(
                        median(self.after_write_ms)
                        if self.after_write_ms else None),
                    dedup_mean=(sum(self.dedup) / len(self.dedup)
                                if self.dedup else None))


def pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def p7_server(snap, backend, dev, **over):
    """A streaming server at ``SERVE_CFG`` on ``backend`` over ``snap``,
    through ``Searcher.serve``."""
    from repro_torch import api
    from repro_torch.core.server import ServerConfig
    cfg = ServerConfig(**dict(SERVE_CFG, backend=backend, **over))
    return api.Searcher(snap, backend=backend, device=dev).serve(cfg)


def p7_check_server(srv, where):
    """The breaker never opens on the card: no fallback exists, no trip,
    no fallback flush, no poisoned request."""
    s = srv.stats
    if srv._fallback_backend() is not None or s.breaker_trips or \
            s.breaker_fallback_flushes or s.poisoned_requests:
        raise AssertionError(
            f"phase 7 {where}: fallback {srv._fallback_backend()}, breaker "
            f"trips {s.breaker_trips}, fallback flushes "
            f"{s.breaker_fallback_flushes}, poisoned {s.poisoned_requests}")


def p7_flush_split(dev, snap, q):
    """Where a 64-row flush goes, on the first 64 requests: the prefix
    (encode, weights, route) and each backend's scan path (plan and fold
    included) by CUDA events, the extra encoder pass of ``auto``'s pick
    (``QueryEngine.route`` from host arrays), and the whole
    ``engine.query`` wall (host copies in and out included), median of
    5 after a warm-up."""
    import torch
    from repro_torch.core import engine as engine_lib
    bs, k, cr = SERVE_CFG["batch_size"], SERVE_CFG["k"], SERVE_CFG["cr"]
    host = [a[:bs] for a in q]
    chunk = [torch.from_numpy(a).to(dev) for a in host]
    prefix = engine_lib.make_prefix_fn(cr=cr,
                                       weight_mode=snap.meta.weight_mode)
    rec = dict(prefix_ms=time_ms(lambda: prefix(snap.rel, snap.index,
                                                snap.norm, *chunk)))
    q_emb, w, top_c = prefix(snap.rel, snap.index, snap.norm, *chunk)
    for b in ("cuda", "cuda-cm"):
        rec[f"scan_{b}_ms"] = time_ms(lambda b=b: engine_lib._routed_topk(
            q_emb, chunk[2], w, top_c, snap.buffers, snap.w_hat, k=k,
            backend=b, dist_max=snap.dist_max,
            precision=snap.meta.precision))
    eng = engine_lib.QueryEngine(snap, backend="auto", device=dev)
    rec["auto_route_ms"] = time_ms(lambda: eng.route(*host, cr=cr))
    for b in SERVE_BACKENDS:
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            eng.query(*host, k=k, cr=cr, batch=bs, backend=b)
            walls.append((time.perf_counter() - t0) * 1e3)
        rec[f"query_{b}_ms"] = median(walls[1:])
    return rec


def device_busy(fn):
    """``fn`` run twice: alone for its wall, then under
    ``torch.profiler`` for the time the card spends in its kernels and
    copies (the union of the device events' intervals: no event is
    counted twice). → busy share = device time / unprofiled wall, and
    the device events taking the most time. A profiler that records no
    device event gives ``None`` (not measured)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    device_ms = busy_us / 1e3 if spans else None
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if device_ms else None,
                device_events=len(spans),
                top_device_ms=dict(by_name.most_common(6)))


def p7_parity(dev, snap, q, servers):
    """(a) Warm-up on each backend, then ``serve_all`` of ``N_PARITY``
    queries bit-equal to ``Searcher.query`` at batch 64 (on ``auto``, one
    call per 64-row chunk: ``auto`` picks per call as the server picks per
    flush). Returns the records and the offline answers."""
    import numpy as np
    from repro_torch import api
    tok, msk, loc = (a[:N_PARITY] for a in q)
    bs, k, cr = SERVE_CFG["batch_size"], SERVE_CFG["k"], SERVE_CFG["cr"]
    rec, offline = {}, {}
    for b in SERVE_BACKENDS:
        srv = p7_server(snap, b, dev)
        servers.append(srv)
        compile_s = srv.warmup()
        probe = FlushProbe(srv, b)
        t0 = time.perf_counter()
        got = srv.serve_all(tok, msk, loc)
        t_serve = time.perf_counter() - t0
        probe.restore()
        searcher = api.Searcher(snap, backend=b, device=dev)
        t0 = time.perf_counter()
        if b == "auto":
            parts = [searcher.query(tok[s:s + bs], msk[s:s + bs],
                                    loc[s:s + bs], k=k, cr=cr, batch=bs)
                     for s in range(0, len(tok), bs)]
            want = tuple(np.concatenate([p[i] for p in parts])
                         for i in (0, 1))
        else:
            want = searcher.query(tok, msk, loc, k=k, cr=cr, batch=bs)
        t_off = time.perf_counter() - t0
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"phase 7 (a) {b}: serve_all differs from "
                                 f"Searcher.query at batch {bs}")
        if got[0].shape != (len(tok), k) or not np.isfinite(got[1]).all():
            raise AssertionError(f"phase 7 (a) {b}: bad output")
        offline[b] = want
        rec[b] = dict(compile_seconds=compile_s, serve_all_s=t_serve,
                      serve_all_qps=len(tok) / t_serve, offline_s=t_off,
                      offline_qps=len(tok) / t_off,
                      flushes=dict(srv.stats.flushes), **probe.report())
        p7_check_server(srv, f"(a) {b}")
        record(f"phase 7 (a) {b}: warm-up {compile_s}; serve_all of {len(tok)} "
            f"queries in {t_serve:.2f} s ({len(tok) / t_serve:.0f} q/s) == "
            f"Searcher.query at batch {bs} bit for bit ({t_off:.2f} s); "
            f"flush median {rec[b]['flush_ms_median']:.2f} ms, launches "
            f"{rec[b]['launches']}")
    return rec, offline


def p7_closed(dev, snap, q, zipf, offline, servers):
    """(b) ``closed_loop`` of the Zipf stream at concurrency 64 on each
    backend, a fresh server each; every answer against the offline answer
    of its row (ids up to ties, scores within ATOL + RTOL·|s|)."""
    import asyncio
    import numpy as np
    from repro_torch.core import server as server_lib
    reqs = [(q[0][i], q[1][i], q[2][i]) for i in zipf]
    rec = {}
    for b in SERVE_BACKENDS:
        srv = p7_server(snap, b, dev)
        servers.append(srv)
        srv.warmup()
        probe = FlushProbe(srv, b)
        t0 = time.perf_counter()
        res = asyncio.run(server_lib.closed_loop(srv, reqs,
                                                 concurrency=CONCURRENCY))
        wall = time.perf_counter() - t0
        probe.restore()
        ids = np.stack([r[0] for r in res])
        sc = np.stack([r[1] for r in res])
        err = topk_match(ids, sc, offline[b][0][zipf], offline[b][1][zipf])
        m = srv.metrics(wall)
        rec[b] = dict(qps=m["qps"], latency_ms=m["latency_ms"],
                      exact_hit_rate=m["exact_hit_rate"],
                      coalesced=m["coalesced"], batch_fill=m["batch_fill"],
                      flushes=m["flushes"],
                      engine_batches=m["engine_batches"],
                      engine_queries=m["engine_queries"],
                      dedup_factor=m["dedup_factor"], max_abs_err=err,
                      wall_s=wall, **probe.report())
        p7_check_server(srv, f"(b) {b}")
        record(f"phase 7 (b) {b}: {len(reqs)} Zipf requests at concurrency "
            f"{CONCURRENCY} in {wall:.2f} s ({m['qps']:.0f} q/s); latency "
            f"{m['latency_ms']}; exact hits {m['exact_hit_rate']:.3f}, "
            f"coalesced {m['coalesced']}, fill {m['batch_fill']:.3f}, "
            f"flushes {m['flushes']}, dedup mean {rec[b]['dedup_mean']}; "
            f"answers == offline up to ties (max|Δ| {err:.3g})")
    return rec


def p7_open(dev, snap, q, zipf, rate, servers):
    """(c) ``open_loop`` of the Zipf stream on ``cuda`` at ``OPEN_RATES``
    of (b)'s rate (nothing shed), then of the ``N_PARITY`` distinct
    requests at twice it with a bounded queue and a deadline
    (``shed_ok``): answered + shed == arrivals. The overload stream has
    no repeats: a request coalesced onto one that is then shed fails with
    it but is not counted in ``stats.shed`` (the reference's accounting),
    so only distinct requests make the server's counters add up."""
    import asyncio
    from repro_torch.core import server as server_lib
    zipf_reqs = [(q[0][i], q[1][i], q[2][i]) for i in zipf]
    uniq_reqs = [(q[0][i], q[1][i], q[2][i]) for i in range(N_PARITY)]
    rec = {}
    runs = [(f, zipf_reqs, {}) for f in OPEN_RATES] + [
        (OVERLOAD["rate"], uniq_reqs,
         dict(max_queue=OVERLOAD["max_queue"],
              request_timeout_ms=OVERLOAD["request_timeout_ms"]))]
    for frac, reqs, over in runs:
        srv = p7_server(snap, "cuda", dev, **over)
        servers.append(srv)
        srv.warmup()
        probe = FlushProbe(srv, "cuda")
        t0 = time.perf_counter()
        res = asyncio.run(server_lib.open_loop(srv, reqs, qps=frac * rate,
                                               shed_ok=bool(over)))
        wall = time.perf_counter() - t0
        probe.restore()
        answered = sum(r is not None for r in res)
        shed = dict(srv.stats.shed)
        if not over and (sum(shed.values()) or answered != len(reqs)):
            raise AssertionError(f"phase 7 (c) at {frac} x: shed {shed}")
        if answered + sum(shed.values()) != len(reqs):
            raise AssertionError(f"phase 7 (c) at {frac} x: answered "
                                 f"{answered} + shed {shed} != {len(reqs)}")
        m = srv.metrics(wall)
        key = f"{frac:g}x"
        rec[key] = dict(offered_qps=frac * rate, arrivals=len(reqs),
                        stream="distinct" if over else "zipf",
                        achieved_qps=answered / wall, answered=answered,
                        shed=shed, latency_ms=m["latency_ms"],
                        batch_fill=m["batch_fill"], flushes=m["flushes"],
                        exact_hit_rate=m["exact_hit_rate"],
                        coalesced=m["coalesced"], **over, **probe.report())
        p7_check_server(srv, f"(c) {key}")
        record(f"phase 7 (c) open loop at {key} of (b)'s cuda rate "
               f"({frac * rate:.0f} q/s offered, {len(reqs)} "
               f"{rec[key]['stream']} requests"
               f"{', ' + str(over) if over else ''}): answered {answered}, "
               f"shed {shed}, latency {m['latency_ms']}, fill "
               f"{m['batch_fill']:.3f}, flushes {m['flushes']}")
    return rec


def q_embeddings(snap, q, n, dev):
    """The prefix's ``q_emb`` of the first ``n`` requests (chunks of 256)
    as host f32, normalised: phase 5's rows."""
    import torch
    from repro_torch.core import engine as engine_lib
    prefix = engine_lib.make_prefix_fn(cr=1, weight_mode=snap.meta.weight_mode)
    out = []
    for s in range(0, n, 256):
        chunk = [torch.from_numpy(a[s:min(s + 256, n)]).to(dev) for a in q]
        out.append(prefix(snap.rel, snap.index, snap.norm, *chunk)[0])
    return torch.nn.functional.normalize(torch.cat(out).float(),
                                         dim=-1).cpu().numpy()


def own_rows_found(snap, q, rows, ids, dev):
    """Each query of ``rows`` finds its inserted row ``ids`` at cr = c on
    ``cuda-cm``. Returns the answers."""
    import numpy as np
    got = api_query(snap, q, rows, dev)
    found = (got[0] == np.asarray(ids)[:, None]).any(axis=1)
    if not found.all():
        raise AssertionError(f"{int((~found).sum())} acknowledged inserts "
                             f"not found at cr = c")
    return got


def p7_churn(dev, snap, q, offline, servers):
    """(d) Churn with the WAL on (fsync, a temporary directory): rounds
    of an insert of 64 rows (queries' own normalised embeddings at their
    locations), a delete of 16 ids (12 base ids from offline answers, 4
    rows inserted the round before) and 128 queries, in one event loop,
    so compaction runs on a loop tick."""
    import asyncio
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import delta as delta_lib
    n_rows = CHURN_ROUNDS * CHURN_INSERT
    emb = q_embeddings(snap, q, n_rows, dev)
    ids = np.arange(CHURN_ID0, CHURN_ID0 + n_rows)
    # base victims: answers of queries past the inserted rows' ones
    pool = offline["cuda"][0][n_rows:].reshape(-1)
    pool = pool[pool >= 0]
    _, first = np.unique(pool, return_index=True)
    base_victims = pool[np.sort(first)][:CHURN_ROUNDS * 12]
    rng = np.random.default_rng(SEED + 21)
    wal_dir = tempfile.mkdtemp(prefix="chip_smoke_wal_")
    try:
        srv = p7_server(snap, "auto", dev, wal_dir=wal_dir, wal_fsync=True)
        servers.append(srv)
        srv.warmup()
        compact_ms = []
        orig_compact = srv._compact

        def timed_compact(trigger):
            t0 = time.perf_counter()
            orig_compact(trigger)
            compact_ms.append((time.perf_counter() - t0) * 1e3)

        srv._compact = timed_compact
        probe = FlushProbe(srv, "auto")
        ack = {"insert": [], "delete": []}
        deleted = []

        async def churn():
            for r in range(CHURN_ROUNDS):
                sl = slice(r * CHURN_INSERT, (r + 1) * CHURN_INSERT)
                t0 = time.perf_counter()
                srv.insert_objects(emb[sl], q[2][sl], ids[sl])
                ack["insert"].append((time.perf_counter() - t0) * 1e3)
                dels = list(base_victims[r * 12:(r + 1) * 12])
                if r:
                    dels += list(ids[sl.start - CHURN_INSERT:
                                     sl.start - CHURN_INSERT + 4])
                t0 = time.perf_counter()
                srv.delete_objects(np.asarray(dels))
                ack["delete"].append((time.perf_counter() - t0) * 1e3)
                deleted.extend(int(x) for x in dels)
                rows = rng.integers(0, N_PARITY, CHURN_QUERIES)
                await asyncio.gather(*[srv.submit(q[0][i], q[1][i], q[2][i])
                                       for i in rows])
            await asyncio.sleep(0)            # a compaction queued last

        t0 = time.perf_counter()
        asyncio.run(churn())
        wall = time.perf_counter() - t0
        probe.restore()
        srv._compact = orig_compact
        m = srv.metrics(wall)
        if m["compaction_triggers"]["size"] < 2:
            raise AssertionError(f"phase 7 (d): {m['compactions']} "
                                 f"compactions, want >= 2 on a loop tick")
        if srv.wal.n_records != 2 * CHURN_ROUNDS:
            raise AssertionError(f"phase 7 (d): {srv.wal.n_records} WAL "
                                 f"records")
        final = srv.engine.snapshot
        dead = set(deleted)
        alive = np.array([j for j in range(n_rows)
                          if int(ids[j]) not in dead])
        got = own_rows_found(final, q, alive, ids[alive], dev)
        # the victims' own source queries too: no deleted id comes back
        src = np.arange(n_rows, N_PARITY)
        got2 = api_query(final, q, src, dev)
        for a in (got[0], got2[0]):
            if np.isin(a, np.asarray(deleted)).any():
                raise AssertionError("phase 7 (d): a deleted id came back")
        # what a live delta costs a flush: the final snapshot's base with
        # a delta of churn's mid size (512 rows, 64 tombstones) and
        # without one, one 64-row chunk, engine walls in turns
        eng = srv.engine
        bare = dataclasses.replace(final, delta=None)
        seg = delta_lib.DeltaSegment.empty(
            int(final.buffers["emb"].shape[-1]), final.meta.precision)
        m_d = min(512, n_rows)
        seg = seg.insert(emb[:m_d], q[2][:m_d],
                         np.arange(CHURN_ID0 + n_rows,
                                   CHURN_ID0 + n_rows + m_d))
        final = bare.with_delta(seg.delete(base_victims[:64]))
        chunk = [a[:SERVE_CFG["batch_size"]] for a in q]
        walls = {"delta": [], "bare": []}
        for _ in range(6):
            for key, s_ in (("delta", final), ("bare", bare)):
                t0 = time.perf_counter()
                eng.query(*chunk, k=SERVE_CFG["k"], cr=SERVE_CFG["cr"],
                          batch=SERVE_CFG["batch_size"], snapshot=s_)
                walls[key].append((time.perf_counter() - t0) * 1e3)
        delta_cost = {f"{key}_flush_ms": median(v[1:])
                      for key, v in walls.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        delta_lib.mask_tombstones(final.buffers["ids"],
                                  final.delta.tombstone_array())
        torch.cuda.synchronize()
        delta_cost["mask_build_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        delta_lib.padded_rows(final.delta.arrays(), dev)
        torch.cuda.synchronize()
        delta_cost["delta_rows_build_ms"] = (time.perf_counter() - t0) * 1e3
        rec = dict(rounds=CHURN_ROUNDS, wall_s=wall, qps=m["qps"],
                   delta_cost=delta_cost,
                   latency_ms=m["latency_ms"],
                   insert_ack_ms={"p50": pct(ack["insert"], 50),
                                  "p99": pct(ack["insert"], 99)},
                   delete_ack_ms={"p50": pct(ack["delete"], 50),
                                  "p99": pct(ack["delete"], 99)},
                   compactions=m["compactions"],
                   compaction_triggers=m["compaction_triggers"],
                   compaction_ms=compact_ms, wal=m["wal"],
                   invalidations=m["invalidations"],
                   checked_inserts=len(alive), deleted=len(deleted),
                   delta_rows_end=m["delta_rows"],
                   tombstones_end=m["tombstones"], **probe.report())
        p7_check_server(srv, "(d)")
        srv.close()
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)
    record(f"phase 7 (d) churn: {CHURN_ROUNDS} rounds (insert {CHURN_INSERT}, "
        f"delete {CHURN_DELETE}, {CHURN_QUERIES} queries) with the WAL on "
        f"(fsync) in {wall:.2f} s; insert ack {rec['insert_ack_ms']} ms, "
        f"delete ack {rec['delete_ack_ms']} ms; compactions "
        f"{rec['compactions']} on a loop tick ({compact_ms} ms); query "
        f"latency {m['latency_ms']}; flush after a write "
        f"{rec['after_write_flush_ms_median']} ms vs steady "
        f"{rec['flush_ms_median']:.2f}; a live delta's cost "
        f"{rec['delta_cost']}; {len(alive)} acknowledged inserts "
        f"found at cr = c on cuda-cm, no deleted id back")
    return rec


def api_query(snap, q, rows, dev):
    """The answers of ``q``'s ``rows`` at cr = c on ``cuda-cm``."""
    from repro_torch import api
    c = snap.buffers["emb"].shape[0]
    return api.Searcher(snap, backend="cuda-cm", device=dev).query(
        *(a[rows] for a in q), k=SERVE_CFG["k"], cr=c, batch=256)


def p7_crash(dev, trained, tq, servers):
    """(e) Crash and recovery on phase 6's trained snapshot, saved once:
    two inserts and a delete acknowledged, then a crash at each of
    ``CRASH_POINTS``; ``api.recover(..., device=dev)`` must answer as a
    server that never crashed and applied the surviving records: at cr =
    c on ``cuda-cm``, ids equal and scores bit-equal."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import faults
    from repro_torch.core import snapshot as snapshot_lib
    from repro_torch.core.server import ServerConfig
    n = len(tq[0])
    emb = q_embeddings(trained, tq, 3 * 64, dev)
    ids = np.arange(CHURN_ID0, CHURN_ID0 + 3 * 64)
    base = trained.buffers["ids"][trained.buffers["ids"] >= 0][:8]
    base = base.cpu().numpy()
    snap_dir = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    rec = {}
    try:
        t0 = time.perf_counter()
        api.save(trained, snap_dir)
        rec["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        snapshot_lib.load_latest_good(snap_dir, device=dev)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0     # recovery's first part
        for point in CRASH_POINTS:
            wal_dir = tempfile.mkdtemp(prefix="chip_smoke_wal_")
            try:
                cfg = ServerConfig(**dict(SERVE_CFG, backend="auto",
                                          wal_dir=wal_dir))
                victim = api.Searcher(trained, device=dev).serve(cfg)
                for j in (0, 1):
                    sl = slice(j * 64, (j + 1) * 64)
                    victim.insert_objects(emb[sl], tq[2][sl], ids[sl])
                victim.delete_objects(np.concatenate([base, ids[:8]]))
                faults.clear()
                if point == "wal.torn_tail":
                    faults.inject(point, callback=lambda nbytes, path:
                                  nbytes // 3)
                else:
                    faults.inject(point, error=faults.Crash("died"))
                try:
                    if point == "ckpt.mid_save":
                        victim.checkpoint(snap_dir)
                    else:
                        victim.insert_objects(emb[128:], tq[2][128:192],
                                              ids[128:])
                    raise AssertionError(f"phase 7 (e): {point} did not fire")
                except faults.Crash:
                    pass
                finally:
                    faults.clear()
                victim.close()
                t0 = time.perf_counter()
                got = api.recover(snap_dir, wal_dir, config=cfg,
                                  backend="auto", device=dev)
                t_rec = time.perf_counter() - t0
                servers.append(got)
                want_n = 4 if point.startswith("write.") else 3
                if got.stats.recovered_writes != want_n:
                    raise AssertionError(
                        f"phase 7 (e) {point}: replayed "
                        f"{got.stats.recovered_writes}, want {want_n}")
                oracle = api.Searcher(trained, device=dev).serve(
                    ServerConfig(**dict(SERVE_CFG, backend="auto")))
                for r in got.wal.records():
                    if r["kind"] == "insert":
                        oracle.insert_objects(r["emb"], r["loc"], r["ids"])
                    else:
                        oracle.delete_objects(r["ids"])
                rows = np.arange(n)
                a = api_query(got.engine.snapshot, tq, rows, dev)
                b = api_query(oracle.engine.snapshot, tq, rows, dev)
                if not (np.array_equal(a[0], b[0])
                        and np.array_equal(a[1], b[1])):
                    raise AssertionError(f"phase 7 (e) {point}: recovered "
                                         f"answers differ from the oracle's")
                acked = np.arange(8, 128)        # inserted, not deleted
                own_rows_found(got.engine.snapshot, tq, acked, ids[acked],
                               dev)
                rec[point] = dict(recover_s=t_rec,
                                  recovered_writes=want_n,
                                  dropped_tail=got.wal.dropped_tail)
                got.close()
                del oracle, victim
            finally:
                shutil.rmtree(wal_dir, ignore_errors=True)
            record(f"phase 7 (e) crash at {point}: api.recover (load + replay "
                   f"of {rec[point]['recovered_writes']} records) "
                   f"{t_rec:.2f} s; answers at cr = c on cuda-cm bit-equal "
                   f"to the never-crashed server's")
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    return rec


def p7_subs(dev, snap, q, servers):
    """(f) ``N_SUBS`` standing queries on the int8 server, then
    ``SUB_BATCHES`` insert batches of 64 rows (the subscribers' own
    normalised embeddings at their locations): each batch notifies the
    pairs a plain oracle on a CPU copy finds (argmax assignment ∈ routes,
    ST ≥ threshold on the int8 row), scores within ``SUB_TOL``; a pair
    may differ only as a tie (its score or the assignment's logit gap
    within ``SUB_TOL``)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import index as index_lib
    srv = p7_server(snap, "auto", dev)
    servers.append(srv)
    thr = np.where(np.arange(N_SUBS) % 2 == 0, -1e9, 0.0).astype(np.float32)
    t0 = time.perf_counter()
    subs = [srv.subscribe(q[0][i], q[1][i], q[2][i], threshold=float(thr[i]))
            for i in range(N_SUBS)]
    t_reg = time.perf_counter() - t0
    reg = srv.subscriptions
    disp_ms = []
    orig_dispatch = reg.dispatch

    def timed_dispatch(*a, **kw):
        t0 = time.perf_counter()
        out = orig_dispatch(*a, **kw)
        disp_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    reg.dispatch = timed_dispatch
    # the CPU copy of what the oracle needs
    index_cpu = copy.deepcopy(snap.index).cpu()
    norm_cpu = {k: v.cpu() for k, v in snap.norm.items()}
    w_hat = snap.w_hat.cpu()
    qe = torch.from_numpy(np.stack([s.q_emb for s in subs]))
    ws = torch.from_numpy(np.stack([s.w_st for s in subs]))
    ql = torch.from_numpy(np.stack([s.loc for s in subs]))
    routes = np.stack([s.routes for s in subs])            # (S, cr)
    emb = q_embeddings(snap, q, N_SUBS, dev)
    rec = dict(pairs=0, ties=0, max_abs_err=0.0)
    for bi in range(SUB_BATCHES):
        rows = np.arange(bi * 64, (bi + 1) * 64) % N_SUBS
        ids = np.arange(SUB_ID0 + bi * 64, SUB_ID0 + (bi + 1) * 64)
        srv.insert_objects(emb[rows], q[2][rows], ids)
        got = {(n.sub_id, n.object_id): n.score
               for s in subs for n in s.drain()}
        e, l_ = torch.from_numpy(emb[rows]), torch.from_numpy(q[2][rows])
        with torch.no_grad():
            logits = index_lib.cluster_logits(
                index_cpu, index_lib.build_features(e, l_, norm_cpu))
        top2 = torch.topk(logits, 2).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        assign = torch.argmax(logits, dim=-1).numpy()
        stored, scale = index_lib.quantize_rows(e, "int8")
        st = engine_lib.score_candidates(
            qe, ql, ws, stored, l_, torch.from_numpy(ids)[None], w_hat,
            dist_max=snap.dist_max, cand_scale=scale).numpy()   # (S, 64)
        hit = (routes[:, None, :] == assign[None, :, None]).any(-1) & \
            (st >= thr[:, None])
        want = {(int(s), int(ids[j])): float(st[s, j])
                for s, j in zip(*np.nonzero(hit))}
        for key in set(got) ^ set(want):
            s, j = key[0], int(key[1] - ids[0])
            if not (abs(st[s, j] - thr[s]) <= SUB_TOL or gap[j] <= SUB_TOL):
                raise AssertionError(f"phase 7 (f) batch {bi}: pair {key} "
                                     f"(score {st[s, j]}) differs from the "
                                     f"CPU oracle")
            rec["ties"] += 1
        for key in set(got) & set(want):
            err = abs(got[key] - want[key])
            if err > SUB_TOL:
                raise AssertionError(f"phase 7 (f): pair {key} score "
                                     f"{got[key]} vs {want[key]}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["pairs"] += len(want)
    reg.dispatch = orig_dispatch
    m = reg.metrics()
    rec.update(subscriptions=N_SUBS, register_s=t_reg,
               dispatch_ms={"median": median(disp_ms), "max": max(disp_ms)},
               notifications_per_dispatch=m["notifications"] / SUB_BATCHES,
               us_per_notification=sum(disp_ms) * 1e3 / max(
                   m["notifications"], 1),
               distinct_clusters_per_dispatch=m[
                   "distinct_clusters_per_dispatch"],
               notifications=m["notifications"], dispatches=m["dispatches"])
    p7_check_server(srv, "(f)")
    record(f"phase 7 (f) {N_SUBS} standing queries (registered in {t_reg:.2f} "
        f"s): {SUB_BATCHES} insert batches of 64, {m['notifications']} "
        f"notifications == the CPU oracle's {rec['pairs']} pairs "
        f"({rec['ties']} ties at the threshold), max|Δ| "
        f"{rec['max_abs_err']:.3g}; dispatch {rec['dispatch_ms']} ms, "
        f"{m['distinct_clusters_per_dispatch']:.1f} distinct clusters a "
        f"dispatch")
    return rec


def phase7(dev, wctx, trained, tq):
    """The serving stack at full width: phase 3's int8 index (2,849,754
    objects, c = 300) behind ``Searcher.serve`` at the reference CLI's
    defaults, (a)–(f); the launch counters zeroed just before (a) and read
    just after (f)."""
    import numpy as np
    import torch
    from repro_torch.core import server as server_lib
    from repro_torch.kernels import fused_topk_score as fts
    snap = wctx["snaps"]["int8"]
    q = (wctx["tok"], wctx["msk"], wctx["q_loc"])
    zipf = server_lib.zipf_sample(np.random.default_rng(SEED + 20), N_PARITY,
                                  N_ZIPF, a=ZIPF_A)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    servers = []
    fts.reset_launch_counts()
    rec = {}
    rec["parity"], offline = p7_parity(dev, snap, q, servers)
    rec["closed_loop"] = p7_closed(dev, snap, q, zipf, offline, servers)
    rec["open_loop"] = p7_open(dev, snap, q, zipf,
                               rec["closed_loop"]["cuda"]["qps"], servers)
    rec["churn"] = p7_churn(dev, snap, q, offline, servers)
    rec["crash"] = p7_crash(dev, trained, tq, servers)
    rec["subscriptions"] = p7_subs(dev, snap, q, servers)
    rec["launches"] = dict(fts.launches)
    for name in ("routed", "cluster_major"):
        if not rec["launches"][name]:
            raise AssertionError(f"phase 7: kernel {name} not launched")
    # timings after the counts are read: where a flush goes, and how busy
    # the card is while a server flushes back to back
    rec["flush_split"] = p7_flush_split(dev, snap, q)
    record(f"phase 7 a 64-row flush, split (ms): {rec['flush_split']}")
    rec["device_busy"] = {}
    for b in ("cuda", "auto"):
        srv = p7_server(snap, b, dev, cache_size=0)
        servers.append(srv)
        srv.warmup()
        rec["device_busy"][b] = device_busy(lambda srv=srv: srv.serve_all(
            *(a[:1024] for a in q)))
        record(f"phase 7 device busy over serve_all of 1,024 distinct "
               f"requests on {b}: {rec['device_busy'][b]}")
    probes = [r for part in ("parity", "closed_loop", "open_loop")
              for r in rec[part].values()] + [rec["churn"]]
    rec["flush_launches"] = {k: sum(p["launches"][k] for p in probes)
                             for k in ("routed", "cluster_major")}
    rec["breaker_trips"] = sum(s.stats.breaker_trips for s in servers)
    rec["servers"] = len(servers)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


# ---------------------------------------------------------------------------
# Phase 8: the command line, the dispatch path, the baselines, the
# round-trip selftest and the examples
# ---------------------------------------------------------------------------

# (a) the reference CLI's flags (src/repro/launch/serve.py) at a real
# object count; c by the paper's n / 10k rule (131,072 objects → 16). The
# CLI's model is fixed in its code: 4L / d 64, bf16 compute.
CLI_ARGS = ["--objects", "131072", "--queries", "4096", "--clusters", "16",
            "--cr", "2", "--precision", "int8", "--skew", "1.05",
            "--concurrency", "64"]
# phase 8 (a) cuts the CLI's training from its defaults (300 + 600 steps)
# for the script's time
CLI_TRAIN_ARGS = ["--train-steps", "50", "--index-steps", "100"]
CLI_REQUESTS = 16_384            # the closed-loop run, with churn
CLI_CHURN = 32
CLI_OPEN_RATE = 0.5              # of the first run's QPS
CLI_OPEN_REQUESTS = 16_384
# (b) one 256-query chunk of phase 3's requests on its full-width index
N_DISPATCH = 256
DISPATCH_K, DISPATCH_CR = 20, 2
# (c) the paper's baselines on phase 6's trained retriever
BASELINE_K, BASELINE_CR = 10, 2
IVF_C = 300
IVF_S_ALPHA = 0.5
LSH_BITS, LSH_TABLES = 16, 4
KMEANS_ITERS = 25
KMEANS_CHECK_STEPS = (0, 1, 2, 3, 4, KMEANS_ITERS - 1)
KMEANS_TOL = 1e-4                # centroids, card against the CPU
KMEANS_TIE = 1e-5                # near-tie: distance gap over |x|² + |c|²
# (d) the selftest and (e) the examples, as subprocesses (arguments after
# the interpreter); the training example runs the paper's towers, then
# resumes from its checkpoint
SELFTEST = ["-m", "repro_torch.api"]
EXAMPLES = {"quickstart": ["examples/torch_quickstart.py"],
            "serve_queries": ["examples/torch_serve_queries.py"],
            "incremental_index": ["examples/torch_incremental_index.py"]}
TRAIN_EXAMPLE = ["examples/torch_train_dual_encoder.py", "--full"]
TRAIN_STEPS = (10, 15)
SUBPROCESS_TIMEOUT = 600


class Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        import io
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_main(main, argv, what, phase="phase 8"):
    """``main(argv)`` in process, its output shown and kept: → (text,
    wall seconds). A non-zero return fails the phase."""
    import contextlib
    import torch
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{phase} {what}: exit code {rc}")
    return tee.buf.getvalue(), wall


def grab(pattern, text, what, cast=float):
    import re
    m = re.search(pattern, text)
    if not m:
        raise AssertionError(f"phase 8 {what}: no line matching {pattern!r}")
    return [cast(g) for g in m.groups()]


def cli_report(text, what):
    """The CLI's printed numbers: recall@10 / ndcg@5 of brute force and of
    LIST, served QPS, p50 / p95 / p99 latency, recall under serving."""
    bf = grab(r"brute force : recall@10=([\d.]+) ndcg@5=([\d.]+)", text, what)
    lst = grab(r"LIST cr=\d+\s*: recall@10=([\d.]+) ndcg@5=([\d.]+)", text,
               what)
    qps = grab(r"served QPS  : ([\d.]+)", text, what)[0]
    lat = grab(r"latency ms  : p50=([\d.]+) p95=([\d.]+) p99=([\d.]+)", text,
               what)
    served = grab(r"recall@10 under serving: ([\d.]+)", text, what)[0]
    return dict(brute_force_recall_at_10=bf[0], brute_force_ndcg_at_5=bf[1],
                list_recall_at_10=lst[0], list_ndcg_at_5=lst[1], qps=qps,
                p50_ms=lat[0], p95_ms=lat[1], p99_ms=lat[2],
                served_recall_at_10=served)


def p8_cli(dev, tmp):
    """(a) ``repro_torch.launch.serve.main`` on the card: build, save,
    churn with the WAL and a closed loop; then a restart that loads the
    snapshot, replays the WAL and runs an open loop at half the first
    run's QPS. The launch counters are zeroed before and read after."""
    import os
    import torch
    from repro_torch import api
    from repro_torch.kernels import fused_topk_score as fts
    from repro_torch.launch import serve as cli
    base = CLI_ARGS + CLI_TRAIN_ARGS + [
        "--snapshot-dir", os.path.join(tmp, "snap"),
                       "--wal-dir", os.path.join(tmp, "wal")]
    build_s = []
    build = api.build

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        try:
            return build(*a, **kw)
        finally:
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t0)

    fts.reset_launch_counts()
    api.build = timed_build
    try:
        first, wall1 = run_main(cli.main, base + [
            "--mode", "closed", "--requests", str(CLI_REQUESTS),
            "--churn", str(CLI_CHURN)], "(a) first run")
    finally:
        api.build = build
    rep1 = cli_report(first, "(a) first run")
    if len(build_s) != 1 or "== saved snapshot" not in first:
        raise AssertionError("phase 8 (a): the first run did not build and "
                             "save")
    rate = CLI_OPEN_RATE * rep1["qps"]
    second, wall2 = run_main(cli.main, base + [
        "--mode", "open", "--qps", f"{rate:.3f}",
        "--requests", str(CLI_OPEN_REQUESTS)], "(a) restart")
    launches = dict(fts.launches)
    rep2 = cli_report(second, "(a) restart")
    replayed = grab(r"== recovery: replayed (\d+) WAL record", second,
                    "(a) restart", int)[0]
    if "== loaded snapshot" not in second or replayed < 1:
        raise AssertionError(f"phase 8 (a): the restart loaded no snapshot "
                             f"or replayed {replayed} WAL records")
    if not launches["routed"] and not launches["cluster_major"]:
        raise AssertionError("phase 8 (a): the CLI launched no scan kernel")
    rec = dict(args=CLI_ARGS + CLI_TRAIN_ARGS, requests=CLI_REQUESTS,
               churn=CLI_CHURN, build_s=build_s[0], first=dict(rep1, wall_s=wall1),
               restart=dict(rep2, wall_s=wall2, open_qps=rate,
                            requests=CLI_OPEN_REQUESTS,
                            wal_records_replayed=replayed),
               launches=launches)
    record(f"phase 8 (a) CLI: build {build_s[0]:.1f} s; closed loop "
           f"{rep1['qps']:.1f} QPS p50/p95/p99 {rep1['p50_ms']:.2f}/"
           f"{rep1['p95_ms']:.2f}/{rep1['p99_ms']:.2f} ms; restart replayed "
           f"{replayed} WAL records, open loop at {rate:.1f} QPS: "
           f"{rep2['qps']:.1f} QPS p50/p95/p99 {rep2['p50_ms']:.2f}/"
           f"{rep2['p95_ms']:.2f}/{rep2['p99_ms']:.2f} ms; recall@10 brute "
           f"force {rep1['brute_force_recall_at_10']:.4f}, LIST "
           f"{rep1['list_recall_at_10']:.4f}; launches {launches}")
    return rec


def p8_dispatch(dev, wctx):
    """(b) ``serving.cluster_dispatch_query`` on phase 3's full-width index,
    one 256-query chunk at k 20, cr 2, every tier, at the default capacity
    and at the chunk's largest cluster load (the launch counters zeroed
    before and read after: one cluster-major launch per call, nothing
    routed); then ids against ``cuda-cm``, the kernel's pair lists against
    the plain dispatch scan on the card, and the times."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import serving
    from repro_torch.kernels import fused_topk_score as fts
    snaps = wctx["snaps"]
    q = [a[:N_DISPATCH] for a in (wctx["tok"], wctx["msk"], wctx["q_loc"])]
    k, cr = DISPATCH_K, DISPATCH_CR
    c, _, d = snaps["f32"].buffers["emb"].shape
    top_c = api.Searcher(snaps["f32"], device=dev).engine.route(*q, cr=cr)
    loads = torch.bincount(top_c.reshape(-1).long(), minlength=c)
    max_load = int(loads.max())
    caps = {"default": None, "max_load": max_load}
    torch.cuda.synchronize()
    fts.reset_launch_counts()
    out = {(p, name): serving.cluster_dispatch_query(
        snaps[p], *q, k=k, cr=cr, capacity=cap, return_dropped=True)
        for p in TIERS for name, cap in caps.items()}
    torch.cuda.synchronize()
    launches = dict(fts.launches)
    if launches["cluster_major"] != len(out) or launches["routed"]:
        raise AssertionError(f"phase 8 (b): {len(out)} dispatch calls made "
                             f"launches {launches}")
    default_cap = serving.query_capacity(N_DISPATCH, c, cr)
    rec = dict(queries=N_DISPATCH, k=k, cr=cr, capacity=default_cap,
               max_load=max_load, distinct_clusters=int((loads > 0).sum()),
               launches=launches)
    prefix = engine_lib.make_prefix_fn(cr=cr)
    chunk = [torch.from_numpy(a).to(dev) for a in q]
    for p in TIERS:
        snap = snaps[p]
        buf = snap.buffers
        scale = buf["scale"] if p == "int8" else None
        ids_m, sc_m, nd_m = out[(p, "max_load")]
        if int(nd_m):
            raise AssertionError(f"phase 8 (b) {p}: {int(nd_m)} pairs dropped "
                                 f"at capacity {max_load}")
        searcher = api.Searcher(snap, device=dev)
        want = searcher.query(*q, k=k, cr=cr, batch=N_DISPATCH,
                              backend="cuda-cm")
        err_cm = topk_match(ids_m.cpu(), sc_m.cpu(), want[0], want[1])
        # the kernel's pair lists against the plain dispatch scan
        q_emb, w, tc = prefix(snap.rel, snap.index, snap.norm, *chunk)
        errs = {}
        for name, cap in caps.items():
            origin, nd = serving.dispatch_slots(
                tc, n_clusters=c, capacity=cap or default_cap)
            args = (q_emb, chunk[2], w, origin, buf["emb"], buf["loc"],
                    buf["ids"], snap.w_hat)
            kw = dict(k=k, cr=cr, dist_max=snap.dist_max, buf_scale=scale)
            got = serving.dispatch_scan(*args, **kw)
            plain = serving.dispatch_scan_plain(*args, **kw)
            n = N_DISPATCH * cr
            placed = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            placed[origin.reshape(-1).long()] = True
            placed = placed[:n]
            for s_, i_ in (got, plain):
                if not ((s_[~placed] == -math.inf).all()
                        and (i_[~placed] == -1).all()):
                    raise AssertionError(f"phase 8 (b) {p} {name}: a dropped "
                                         f"pair's row is not (-inf, -1)")
            errs[name] = topk_match(got[1][placed].cpu(), got[0][placed].cpu(),
                                    plain[1][placed].cpu(),
                                    plain[0][placed].cpu())
            if name == "default":
                if int(nd) != int(out[(p, "default")][2]):
                    raise AssertionError("phase 8 (b): n_dropped differs")
                fold_k = engine_lib.merge_cluster_major(*got, b=N_DISPATCH,
                                                        cr=cr, k=k)
                fold_p = engine_lib.merge_cluster_major(*plain, b=N_DISPATCH,
                                                        cr=cr, k=k)
                lost = torch.isinf(fold_p[0]).all(dim=1)
                if not (torch.equal(torch.isinf(fold_k[0]).all(dim=1), lost)
                        and (fold_k[1][lost] == -1).all()):
                    raise AssertionError(f"phase 8 (b) {p}: the all-dropped "
                                         f"queries differ")
                ids_d, sc_d, _ = out[(p, "default")]
                if not torch.equal(ids_d, fold_k[1]):
                    raise AssertionError(f"phase 8 (b) {p}: the dispatch "
                                         f"path's ids are not its scan's fold")
                keep = ~lost
                errs["fold"] = topk_match(
                    fold_k[1][keep].cpu(), fold_k[0][keep].cpu(),
                    fold_p[1][keep].cpu(), fold_p[0][keep].cpu())
                n_lost = int(lost.sum())
        # times: the whole path beside cuda-cm, then the scan alone
        origin, _ = serving.dispatch_slots(tc, n_clusters=c,
                                           capacity=max_load)
        args = (q_emb, chunk[2], w, origin, buf["emb"], buf["loc"],
                buf["ids"], snap.w_hat)
        kw = dict(k=k, cr=cr, dist_max=snap.dist_max, buf_scale=scale)
        bd = bound(buf["ids"], tc, torch.unique(tc), d=d,
                   elem_bytes=buf["emb"].element_size(), k=k, b=N_DISPATCH,
                   dequant=p == "int8")
        t = dict(
            dispatch_path_ms=time_ms(lambda: serving.cluster_dispatch_query(
                snap, *q, k=k, cr=cr, capacity=max_load), reps=3),
            cuda_cm_path_ms=time_ms(lambda: searcher.query(
                *q, k=k, cr=cr, batch=N_DISPATCH, backend="cuda-cm"), reps=3),
            ms=time_ms(lambda: serving.dispatch_scan(*args, **kw)),
            plain_ms=time_ms(lambda: serving.dispatch_scan_plain(*args, **kw),
                             reps=1),
            bound_ms=bd["bound_ms"], bound_by=bd["bound_by"])
        t["x_bound"] = t["ms"] / bd["bound_ms"]
        rec[p] = dict(n_dropped_default=int(out[(p, "default")][2]),
                      queries_all_dropped=n_lost, err_vs_cuda_cm=err_cm,
                      err_vs_plain=max(errs.values()), **t)
        record(f"phase 8 (b) dispatch {p}: default capacity {default_cap} "
               f"drops {rec[p]['n_dropped_default']} of {N_DISPATCH * cr} "
               f"pairs ({n_lost} queries lose every route); capacity "
               f"{max_load} drops none, ids == cuda-cm up to ties (max|Δ| "
               f"{err_cm:.3g}); kernel == plain (max|Δ| "
               f"{rec[p]['err_vs_plain']:.3g}); path {t['dispatch_path_ms']:.2f}"
               f" ms vs cuda-cm {t['cuda_cm_path_ms']:.2f} ms; scan "
               f"{t['ms']:.3f} ms ({t['x_bound']:.2f}x bound "
               f"{bd['bound_ms']:.3f} ms, {bd['bound_by']}), plain "
               f"{t['plain_ms']:.1f} ms")
    return rec


def p8_kmeans_check(dev, emb):
    """``kmeans`` on the card, timed, then its trajectory step by step
    (``kmeans_step`` from the same init) against the same step on a CPU
    copy from the card's centroids: assignments (``kmeans_assign``) equal
    except at near-ties, and the update from the card's assignment
    (``kmeans_update``) within ``KMEANS_TOL`` of the card's centroids."""
    import numpy as np
    import torch
    from repro_torch.core import baselines
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cent, assign = baselines.kmeans(emb, IVF_C, iters=KMEANS_ITERS, seed=0,
                                    device=dev)
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    x = torch.from_numpy(emb).to(dev)
    init = np.random.default_rng(0).choice(len(emb), IVF_C, replace=False)
    cents, assigns = [x[torch.from_numpy(init).to(dev)]], []
    with torch.no_grad():
        for _ in range(KMEANS_ITERS):
            c_, a_ = baselines.kmeans_step(x, cents[-1])
            cents.append(c_)
            assigns.append(a_)
    own = bool(torch.equal(assigns[-1], assign)
               and (cents[-1] - cent).abs().max() <= KMEANS_TOL)
    xc = x.cpu()
    xx = (xc * xc).sum(1)
    n_ties, err = 0, 0.0
    for s in KMEANS_CHECK_STEPS:
        prev, ag = cents[s].cpu(), assigns[s].cpu()
        ac = baselines.kmeans_assign(xc, prev)
        bad = (ac != ag).nonzero().reshape(-1)
        if bad.numel():
            xb = xc[bad]
            dist = (xx[bad, None] - 2 * xb @ prev.T
                    + (prev * prev).sum(1)[None])
            gap = (dist.gather(1, ag[bad, None]) - dist.gather(
                1, ac[bad, None]))[:, 0].abs()
            scale = xx[bad] + (prev * prev).sum(1)[ag[bad]]
            if (gap > KMEANS_TIE * scale).any():
                raise AssertionError(f"phase 8 (c) kmeans step {s}: an "
                                     f"assignment differs beyond a near-tie")
        # the update from the card's assignment, so a near-tie cannot move
        # a centroid of the comparison
        cc = baselines.kmeans_update(xc, ag, prev)
        e = float((cc - cents[s + 1].cpu()).abs().max())
        if e > KMEANS_TOL:
            raise AssertionError(f"phase 8 (c) kmeans step {s}: centroids "
                                 f"differ by {e}")
        n_ties += int(bad.numel())
        err = max(err, e)
    return dict(kmeans_s=kmeans_s, steps_checked=list(KMEANS_CHECK_STEPS),
                near_tie_assignments=n_ties, centroid_max_abs_err=err,
                equals_its_steps_on_card=own)


def p8_baselines(dev, r, corpus, held):
    """(c) the paper's comparison on phase 6's trained retriever: IVF (c
    300), IVF_S (α 0.5) and LSH (16 bits × 4 tables) over its object
    embeddings, their candidates reranked with ``score_fn``; recall@10
    against ``ListRetriever.brute_force`` and the mean candidate count,
    beside LIST's own at cr 2; k-means held against the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import baselines
    from repro_torch.core import pipeline as pipeline_lib
    k, cr = BASELINE_K, BASELINE_CR
    t0 = time.perf_counter()
    emb = np.asarray(r.ensure_embeddings(), np.float32)
    rec = dict(ensure_embeddings_s=time.perf_counter() - t0,
               n_objects=len(emb), queries=len(held))
    q_emb = pipeline_lib.embed_queries(r.rel, corpus, held)
    q_loc = corpus.q_loc[held].astype(np.float32)
    t0 = time.perf_counter()
    bf_ids, _ = r.brute_force(held, k=k)
    rec["brute_force_s"] = time.perf_counter() - t0
    ids, _ = r.query(held, k=k, cr=cr)
    tok, msk = corpus.query_tokens(held)
    top_c = r.engine().route(tok, msk, q_loc, cr=cr)
    counts = r.snapshot().buffers["counts"]
    rec["list"] = dict(recall_at_10=recall_at(ids, bf_ids, k),
                       mean_candidates=float(counts[top_c.long()].sum(1)
                                             .float().mean()), cr=cr)
    # the trained embeddings (near-ties abound where the towers
    # collapsed), then seeded blobs of the same shape, where they are rare
    rec["kmeans"] = p8_kmeans_check(dev, emb)
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    centres = torch.randn(IVF_C, emb.shape[1], generator=g, device=dev)
    pick = torch.randint(0, IVF_C, (len(emb),), generator=g, device=dev)
    blobs = centres[pick] + torch.randn(emb.shape, generator=g, device=dev)
    rec["kmeans_blobs"] = p8_kmeans_check(dev, blobs.cpu().numpy())
    del centres, pick, blobs
    fn = r.score_fn()

    def timed(make):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = make()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    obj_loc = corpus.obj_loc.astype(np.float32)
    ivf, t_ivf = timed(lambda: baselines.IVFIndex(emb, n_clusters=IVF_C,
                                                  device=dev))
    ivf_s, t_ivf_s = timed(lambda: baselines.IVFIndex(
        emb, obj_loc, n_clusters=IVF_C, alpha=IVF_S_ALPHA, device=dev))
    lsh, t_lsh = timed(lambda: baselines.LSHIndex(
        emb, nbits=LSH_BITS, n_tables=LSH_TABLES, device=dev))
    for name, index, t_build, cands in (
            ("ivf", ivf, t_ivf, lambda: ivf.candidates(q_emb, cr=cr)),
            ("ivf_s", ivf_s, t_ivf_s,
             lambda: ivf_s.candidates(q_emb, q_loc, cr=cr)),
            ("lsh", lsh, t_lsh, lambda: lsh.candidates(q_emb))):
        t0 = time.perf_counter()
        lists = cands()
        t_probe = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, mean_c = baselines.rerank_candidates(
            lambda i, cand: fn(q_emb[i], q_loc[i], cand), lists, k)
        rec[name] = dict(recall_at_10=recall_at(out, bf_ids, k),
                         mean_candidates=mean_c, build_s=t_build,
                         probe_s=t_probe,
                         rerank_s=time.perf_counter() - t0)
    rec["ivf"]["cr"] = rec["ivf_s"]["cr"] = cr
    rec["ivf_s"]["alpha"] = IVF_S_ALPHA
    rec["lsh"].update(nbits=LSH_BITS, tables=LSH_TABLES)
    record(f"phase 8 (c) baselines ({len(held)} held-out queries, "
           f"{len(emb)} objects, recall@{k} against brute_force / mean "
           f"candidates): LIST cr {cr} {rec['list']['recall_at_10']:.3f} / "
           f"{rec['list']['mean_candidates']:.0f}; " + "; ".join(
               f"{n} {rec[n]['recall_at_10']:.3f} / "
               f"{rec[n]['mean_candidates']:.0f} (build "
               f"{rec[n]['build_s']:.2f} s)" for n in ("ivf", "ivf_s", "lsh"))
           + f"; kmeans {rec['kmeans']}; on blobs {rec['kmeans_blobs']}")
    return rec


def p8_subprocesses(tmp):
    """(d) ``python -m repro_torch.api`` and (e) the four examples, as
    subprocesses on the card, side by side (the training example's two
    runs in turn): each must exit 0."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    # five processes share the host's cores: two threads each
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    ck = os.path.join(tmp, "ckpt")

    def run(argv):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                           capture_output=True, text=True,
                           timeout=SUBPROCESS_TIMEOUT)
        return dict(rc=p.returncode, out=p.stdout, err=p.stderr,
                    s=time.perf_counter() - t0)

    def train_chain():
        return [run(TRAIN_EXAMPLE + ["--steps", str(s), "--ckpt-dir", ck])
                for s in TRAIN_STEPS]

    jobs = {"selftest": lambda: run(SELFTEST),
            **{name: (lambda argv=argv: run(argv))
               for name, argv in EXAMPLES.items()},
            "train_dual_encoder": train_chain}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(fn) for name, fn in jobs.items()}
        res = {name: f.result() for name, f in futs.items()}
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall}
    for name, out in res.items():
        runs = out if isinstance(out, list) else [out]
        for i, o in enumerate(runs):
            tail = "\n".join(o["out"].strip().splitlines()[-6:])
            log(f"phase 8 {name}[{i}] exit {o['rc']} in {o['s']:.1f} s:\n"
                f"{tail}")
            if o["rc"]:
                log(o["err"][-4000:])
                raise AssertionError(f"phase 8 {name}[{i}]: exit code "
                                     f"{o['rc']}")
        rec[name] = [round(o["s"], 3) for o in runs]
    selftest = res["selftest"]["out"]
    rec["selftest_legs"] = selftest.count("bit-identical")
    if "0 leg(s) disagree" not in selftest:
        raise AssertionError("phase 8 (d): the selftest reports a mismatch")
    if "streaming server and engine path agree" not in \
            res["serve_queries"]["out"]:
        raise AssertionError("phase 8 (e): server and engine disagree")
    agree = grab(r"paths agree on ([\d.]+)%", res["serve_queries"]["out"],
                 "(e) serve_queries")[0]
    rec["serve_queries_dispatch_agree_pct"] = agree
    first, second = res["train_dual_encoder"]
    if f"resume from step {TRAIN_STEPS[0]}" not in second["out"]:
        raise AssertionError("phase 8 (e): the training example did not "
                             "resume")
    rec["train_resumed_from"] = TRAIN_STEPS[0]
    record(f"phase 8 (d) selftest: {rec['selftest_legs']} legs bit-identical;"
           f" (e) examples exit 0 (server == engine; dispatch agrees on "
           f"{agree}% of ids; training resumed at step {TRAIN_STEPS[0]}) in "
           f"{wall:.1f} s side by side")
    return rec


def phase8(dev, wctx, retriever, trained_corpus):
    """(a) the CLI, (b) the dispatch path, (c) the baselines, (d) the
    selftest and (e) the examples; the launch counters zeroed around (a)
    and around (b)."""
    import tempfile
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec["cli"] = p8_cli(dev, tmp)
        rec["cli"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["dispatch"] = p8_dispatch(dev, wctx)
        rec["dispatch"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["baselines"] = p8_baselines(dev, retriever, *trained_corpus)
        rec["baselines"]["phase_s"] = time.perf_counter() - t0
        rec["subprocesses"] = p8_subprocesses(tmp)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


# ---------------------------------------------------------------------------
# Phase 9: the sharded query phase (logical shards on one card)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)
SHARD_BACKENDS = ("cuda", "cuda-cm", "auto")
SHARD_QUERIES = 1024             # per run, at every shard count (cut
                                 # from 4,096 for the script's time)
SHARD_K, SHARD_CR, SHARD_BATCH = 20, 2, 256
P9_PLAIN_SUB = 32                # queries per slice of a shard's plain scan
FAULT_S = 4                      # the lost-shard, recovery and hedging runs
LOST_SHARD, SLOW_SHARD = 1, 2
SLOW_SLEEP_S = 0.25              # the straggler's delay per device scan
N_MINE_Q = 256                   # phase 6's training queries mined
MINE_SHARDS = 8                  # mine_negatives_sharded's corpus blocks
CLI_MESH_ARGS = CLI_ARGS + ["--train-steps", "10", "--index-steps", "10",
                            "--requests", "1024", "--mode", "closed",
                            "--mesh", "1"]


def logical_mesh(dev, n):
    """``n`` logical shards on ``dev``: an explicit device list."""
    from repro_torch.distributed import sharding
    return sharding.ClusterMesh((dev,) * n)


def p9_shard(dev, snap, n, what):
    """``snap`` sharded ``n`` ways on ``dev``, timed, with its memory:
    the parts' bytes, and the device memory it added (its global buffers
    must have gone to the host)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = snap.with_mesh(logical_mesh(dev, n))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    if any(v.device.type != "cpu" for v in s.buffers.values()
           if isinstance(v, torch.Tensor)):
        raise AssertionError(f"phase 9 {what}: global buffers not on the host")
    per = s.shards.nbytes_per_device()
    glob = sum(snap.buffers[k_].numel() * snap.buffers[k_].element_size()
               for k_ in ("emb", "loc", "ids", "scale", "attrs", "counts"))
    return s, dict(shard_s=shard_s, bytes_per_part=per, parts_gb=sum(per) / 1e9,
                   global_gb=glob / 1e9, before=before, peak=0)


def p9_memory(rec, what):
    """Device memory added since ``p9_shard`` against the parts: what
    stays resident after the queries must be the parts (the global
    buffers stay on the host), and the peak over all the runs the parts
    plus at most one part in flight (a hedged scan's replica copy) and
    1 GB of work space. The runs with
    hedging off are held tighter in ``p9_run``."""
    import torch
    peak = (max(rec.pop("peak"), torch.cuda.max_memory_allocated())
            - rec["before"]) / 1e9
    resident = (torch.cuda.memory_allocated() - rec.pop("before")) / 1e9
    rec.update(peak_added_gb=peak, resident_added_gb=resident,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    part = max(rec["bytes_per_part"]) / 1e9
    if resident > rec["parts_gb"] + 0.25 or peak > rec["parts_gb"] + part + 1:
        raise AssertionError(
            f"phase 9 {what}: the card gained {resident:.2f} GB resident, "
            f"{peak:.2f} GB at peak, for {rec['parts_gb']:.2f} GB of parts "
            f"(one part {part:.2f} GB); the global buffers "
            f"({rec['global_gb']:.2f} GB) came back")


class NeverSlow:
    """A straggler monitor that flags nothing: the sharded walls without
    hedging (``p9_run``)."""

    def record(self, host, seconds):
        pass

    def slow(self, host):
        return False


def p9_run(dev, snap, backend, q, n, want=None, mem=None):
    """``Searcher.query`` of the first ``n`` queries (one chunk first, to
    warm), checked against ``want`` up to ties when given → a record:
    the wall as served (``wall_ms``; on a sharded snapshot no scan may be
    hedged or run on a host replica: with no fault injected a device scan
    never costs more than a replica scan, the engine's hedge floor, whose
    values ``hedge_floor_ms`` holds for the shards host jitter flagged)
    and, on a sharded snapshot, the wall of a second run with
    hedging off (``steady_wall_ms``, answers checked the same), with the
    shard counters of each. The hedging-off run's own peak must stay within
    the parts (``mem``, from ``p9_shard``) and 1 GB of work space: no
    global buffer comes back, even for a moment."""
    import numpy as np
    import torch
    from repro_torch import api
    s = api.Searcher(snap, backend=backend, device=dev)
    if snap.shards is not None and s.snapshot.buffers["emb"].device.type \
            != "cpu":
        raise AssertionError("phase 9: the engine moved the global buffers")
    tok, msk, loc = (a[:n] for a in q)
    kw = dict(k=SHARD_K, cr=SHARD_CR, batch=SHARD_BATCH)
    s.query(tok[:SHARD_BATCH], msk[:SHARD_BATCH], loc[:SHARD_BATCH], **kw)
    eng = s.engine

    def timed():
        torch.cuda.synchronize()
        before = dict(eng.shard_stats)
        t0 = time.perf_counter()
        ids, sc = s.query(tok, msk, loc, **kw)
        wall = time.perf_counter() - t0
        if ids.shape != (n, SHARD_K) or not np.isfinite(sc).all():
            raise AssertionError(f"phase 9 {backend}: bad output "
                                 f"{ids.shape}")
        if eng.last_coverage != 1.0:
            raise AssertionError(f"phase 9 {backend}: coverage "
                                 f"{eng.last_coverage}")
        err = (None if want is None else
               topk_match(ids, sc, want[0][:n], want[1][:n]))
        return ids, sc, wall * 1e3, err, {
            k_: eng.shard_stats[k_] - before[k_] for k_ in before}

    ids, sc, wall, err, stats = timed()
    rec = dict(wall_ms=wall, max_abs_err=err, shard_stats=stats,
               dedup_factor=eng.last_dedup_factor)
    if snap.shards is not None:
        rec["hedge_floor_ms"] = {s_: t * 1e3 for s_, t in
                                 eng.replica_scan_s.items()}
        if stats["hedged_scans"] or stats["host_scans"]:
            raise AssertionError(
                f"phase 9 {backend}: {stats['hedged_scans']} hedged scans "
                f"with no fault injected (hedge floors "
                f"{rec['hedge_floor_ms']} ms)")
        eng._shard_monitor, eng._hedged = NeverSlow(), {}
        mem["peak"] = max(mem["peak"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        _, _, rec["steady_wall_ms"], e2, rec["steady_shard_stats"] = timed()
        rec["max_abs_err"] = max(err, e2)
        top = torch.cuda.max_memory_allocated()
        mem["peak"] = max(mem["peak"], top)
        rec["steady_peak_added_gb"] = (top - mem["before"]) / 1e9
        if rec["steady_peak_added_gb"] > mem["parts_gb"] + 1:
            raise AssertionError(
                f"phase 9 {backend}: with hedging off the card gained "
                f"{rec['steady_peak_added_gb']:.2f} GB at peak for "
                f"{mem['parts_gb']:.2f} GB of parts; a global buffer came "
                f"back")
    return ids, sc, rec


def p9_plain(backend, part, ctx, local, *, precision, dist_max):
    """The plain version of one shard's scan on the card: the same part
    and local routes through ``fts.routed_topk_plain`` (``cuda``) or
    ``fts.cluster_major_partials_plain`` and the fold (``cuda-cm``), in
    slices of ``P9_PLAIN_SUB`` queries → ``(ids, scores)`` on the host."""
    import torch
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import serving
    from repro_torch.kernels import fused_topk_score as fts
    kw = dict(k=SHARD_K, dist_max=dist_max,
              buf_scale=part["scale"] if precision == "int8" else None)
    bufs = (part["emb"], part["loc"], part["ids"])
    ids, scores = [], []
    for a in range(0, local.shape[0], P9_PLAIN_SUB):
        sl = slice(a, a + P9_PLAIN_SUB)
        q = (ctx["q_emb"][sl], ctx["ql"][sl], ctx["w"][sl])
        if backend == "cuda":
            sc, ix = fts.routed_topk_plain(*q, local[sl], *bufs,
                                           ctx["w_hat"], **kw)
        else:
            u, roster, _ = serving.cluster_major_plan(
                local[sl], n_clusters=part["emb"].shape[0])
            ps, pi = fts.cluster_major_partials_plain(
                *q, u, roster, *bufs, ctx["w_hat"], cr=SHARD_CR, **kw)
            sc, ix = engine_lib.merge_cluster_major(
                ps, pi, b=q[0].shape[0], cr=SHARD_CR, k=SHARD_K)
        ids.append(ix.cpu())
        scores.append(sc.cpu())
    return torch.cat(ids), torch.cat(scores)


def p9_scan_split(dev, snap_s, ctx, backend):
    """One 256-query chunk on each shard: the shard's scan (its kernel)
    held against its plain version (``p9_plain``) on the same part and
    the same local routes, up to ties within ATOL + RTOL (raises on a
    mismatch), and timed with CUDA events, to be summed over the shards
    beside the unsharded scan → ``(per-shard ms, max |score error|)``.
    Launched after the main path's counts are read."""
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import serving
    sh = snap_s.shards
    precision = snap_s.meta.precision
    eng = engine_lib.QueryEngine(snap_s, backend=backend, device=dev)
    sfn = eng.shard_topk_fn(k=SHARD_K, backend=backend, precision=precision)
    so, lo = eng._placement_maps(sh)
    args = (ctx["q_emb"], ctx["ql"], ctx["w"])
    per, err = [], 0.0
    for s, part in enumerate(sh.parts):
        local = serving.localize_routes(ctx["top_c"], so, lo, s,
                                        sentinel=sh.sentinel)
        ids, sc = sfn(ctx["w_hat"], part, *args, local)
        w_ids, w_sc = p9_plain(backend, part, ctx, local,
                               precision=precision, dist_max=snap_s.dist_max)
        try:
            err = max(err, topk_match(ids.cpu(), sc.cpu(), w_ids, w_sc))
        except AssertionError as e:
            raise AssertionError(
                f"phase 9 {backend} S={sh.n_shards} shard {s}: the kernel "
                f"differs from its plain version: {e}") from None
        per.append(time_ms(lambda part=part, local=local: sfn(
            ctx["w_hat"], part, *args, local)))
    return per, err


def p9_faults(dev, snap_s, base_snap, q):
    """On ``FAULT_S`` logical shards, int8, ``cuda``: a lost shard
    (coverage = the share of routes the others own, ids = a masked
    unsharded oracle), ``recover_shard`` (bit-equal to before the loss,
    timed), a straggler hedged onto its host replica (bit-equal; the
    replica scan timed)."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import faults
    tok, msk, loc = q
    kw = dict(k=SHARD_K, cr=SHARD_CR, batch=SHARD_BATCH)
    searcher = api.Searcher(snap_s, backend="cuda", device=dev)
    eng = searcher.engine
    healthy = searcher.query(tok, msk, loc, **kw)
    sh = snap_s.shards
    # the routes, chunk by chunk as the engine's prefix computes them
    router = api.Searcher(base_snap, backend="cuda", device=dev).engine
    top_c = np.concatenate([
        router.route(tok[i:i + SHARD_BATCH], msk[i:i + SHARD_BATCH],
                     loc[i:i + SHARD_BATCH], cr=SHARD_CR).cpu().numpy()
        for i in range(0, len(tok), SHARD_BATCH)])
    owned = int((sh.shard_of[top_c] == LOST_SHARD).sum())
    want_cov = (top_c.size - owned) / top_c.size

    def lost(shard):
        if shard == LOST_SHARD:
            raise RuntimeError(f"device of shard {shard} lost")
    faults.inject("shard.device_lost", callback=lost, times=None)
    try:
        ids, sc = searcher.query(tok, msk, loc, **kw)
    finally:
        faults.clear()
    cov = searcher.last_coverage
    if cov != want_cov or eng.down_signature() != (LOST_SHARD,):
        raise AssertionError(f"phase 9 lost shard: coverage {cov} != "
                             f"{want_cov} or down {eng.down_signature()}")
    masked = base_snap.buffers["ids"].clone()
    masked[torch.from_numpy(sh.group(LOST_SHARD)).to(dev)] = -1
    oracle = dataclasses.replace(base_snap,
                                 buffers={**base_snap.buffers, "ids": masked})
    o_ids, o_sc = api.Searcher(oracle, backend="cuda", device=dev).query(
        tok, msk, loc, **kw)
    err_lost = topk_match(ids, sc, o_ids, o_sc)
    t0 = time.perf_counter()
    eng.recover_shard(LOST_SHARD)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    after = searcher.query(tok, msk, loc, **kw)
    if not (np.array_equal(after[0], healthy[0])
            and np.array_equal(after[1], healthy[1])
            and searcher.last_coverage == 1.0):
        raise AssertionError("phase 9 recovery: answers differ from before "
                             "the loss")

    def crawl(shard):
        if shard == SLOW_SHARD:
            time.sleep(SLOW_SLEEP_S)
    # the straggler test reads a window of the shard's own scan times
    mon = eng._shard_monitor
    while len(mon.latencies[f"shard{SLOW_SHARD}"]) < mon.window:
        searcher.query(tok[:SHARD_BATCH], msk[:SHARD_BATCH],
                       loc[:SHARD_BATCH], **kw)
    stats0 = dict(eng.shard_stats)
    faults.inject("shard.scan_slow", callback=crawl, times=None)
    try:
        hedged = searcher.query(tok, msk, loc, **kw)
    finally:
        faults.clear()
    st = {k_: eng.shard_stats[k_] - stats0[k_] for k_ in stats0}
    if SLOW_SHARD not in eng._hedged or st["hedged_scans"] < 1:
        raise AssertionError(f"phase 9 hedging: shard {SLOW_SHARD} not "
                             f"hedged ({st})")
    if not (np.array_equal(hedged[0], healthy[0])
            and np.array_equal(hedged[1], healthy[1])):
        raise AssertionError("phase 9 hedging: answers differ")
    # the replica scan alone: its host part to the card, the same scan
    snap_now = eng.snapshot
    host = eng._host_shard_part(snap_now, snap_now.shards, SLOW_SHARD)
    chunk = [torch.from_numpy(a[:SHARD_BATCH]).to(dev) for a in q]
    q_emb, w, top = eng.prefix_fn(cr=SHARD_CR)(
        snap_now.rel, snap_now.index, snap_now.norm, *chunk)
    from repro_torch.core import serving
    so, lo = eng._placement_maps(snap_now.shards)
    local = serving.localize_routes(top, so, lo, SLOW_SHARD,
                                    sentinel=snap_now.shards.sentinel)
    sfn = eng.shard_topk_fn(k=SHARD_K, backend="cuda", precision="int8")
    w_hat = snap_now.w_hat

    def replica_scan():
        p = {k_: v.to(dev, non_blocking=True) for k_, v in host.items()}
        return sfn(w_hat, p, q_emb, chunk[2], w, local)

    def device_scan():
        return sfn(w_hat, snap_now.shards.parts[SLOW_SHARD], q_emb, chunk[2],
                   w, local)
    r_out, d_out = replica_scan(), device_scan()
    if not (torch.equal(r_out[0], d_out[0]) and torch.equal(r_out[1],
                                                             d_out[1])):
        raise AssertionError("phase 9: the replica scan differs from the "
                             "device scan")
    part_gb = sum(v.numel() * v.element_size() for v in host.values()) / 1e9
    rec = dict(shards=FAULT_S, lost_shard=LOST_SHARD,
               lost_coverage=cov, lost_routes_owned=owned,
               lost_routes=int(top_c.size),
               even_share=(FAULT_S - 1) / FAULT_S, lost_max_abs_err=err_lost,
               recover_s=recover_s, slow_shard=SLOW_SHARD,
               slow_sleep_s=SLOW_SLEEP_S, hedge_stats=st,
               hedge_floor_ms=eng.replica_scan_s[SLOW_SHARD] * 1e3,
               host_copy_gb_s=eng.host_copy_rate() / 1e9,
               replica_scan_ms=time_ms(replica_scan, reps=3),
               device_scan_ms=time_ms(device_scan, reps=3),
               replica_part_gb=part_gb)
    record(f"phase 9 faults (S={FAULT_S}, int8, cuda): shard {LOST_SHARD} "
           f"lost -> coverage {cov:.6f} = 1 - {owned}/{top_c.size} routes "
           f"(an even split would say {(FAULT_S - 1) / FAULT_S:.4f}), ids == "
           f"masked oracle up to ties (max|Δ| {err_lost:.3g}); recover_shard "
           f"{recover_s:.3f} s, then bit-equal to before the loss; shard "
           f"{SLOW_SHARD} slowed {SLOW_SLEEP_S} s per device scan -> hedged "
           f"(above its hedge floor {rec['hedge_floor_ms']:.2f} ms: the part "
           f"at {rec['host_copy_gb_s']:.1f} GB/s plus a median scan), "
           f"bit-equal ({st}); replica scan {rec['replica_scan_ms']:.2f} ms "
           f"(its {part_gb:.2f} GB part copied each time) vs device scan "
           f"{rec['device_scan_ms']:.3f} ms")
    return rec


def p9_mining(dev, retriever, trained_corpus):
    """The corpus-sharded minings on phase 6's 131,072 objects and trained
    relevance model, ``N_MINE_Q`` training queries, phase 6's window:
    ``mine_negatives_sharded`` and ``_dense`` against ``mine_negatives``
    (up to ties: equal scores at every rank), each timed."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline as pl
    from repro_torch.core import pseudo_labels as plab
    from repro_torch.core import relevance
    corpus, _ = trained_corpus
    rel = retriever.rel
    qids = corpus.split()[0][:N_MINE_Q]
    q_emb = torch.from_numpy(pl.embed_queries(rel, corpus, qids)).to(dev)
    q_loc = torch.from_numpy(corpus.q_loc[qids].astype(np.float32)).to(dev)
    obj = torch.from_numpy(np.asarray(retriever.obj_emb, np.float32)).to(dev)
    oloc = torch.from_numpy(corpus.obj_loc.astype(np.float32)).to(dev)
    window = dict(neg_start=retriever.cfg.neg_start,
                  neg_end=retriever.cfg.neg_end, dist_max=corpus.dist_max)
    args = (rel, q_emb, q_loc, obj, oloc)
    runs = {"exact": lambda: plab.mine_negatives(*args, **window),
            "sharded": lambda: plab.mine_negatives_sharded(
                *args, shards=MINE_SHARDS, **window),
            "dense": lambda: plab.mine_negatives_dense(*args, **window)}
    out, ms = {}, {}
    for name, fn in runs.items():
        out[name] = fn().cpu().numpy()
        ms[name] = time_ms(fn, reps=2, warmup=0)
    scores = relevance.score_corpus(rel, q_emb, q_loc, obj, oloc,
                                    dist_max=corpus.dist_max).cpu().numpy()
    want = np.take_along_axis(scores, out["exact"], 1)
    errs = {}
    for name in ("sharded", "dense"):
        if out[name].shape != out["exact"].shape:
            raise AssertionError(f"phase 9 mining {name}: shape "
                                 f"{out[name].shape}")
        got = np.take_along_axis(scores, out[name], 1)
        err = np.abs(got - want)
        if (err > ATOL + RTOL * np.abs(want)).any():
            raise AssertionError(f"phase 9 mining {name}: the window differs "
                                 f"from mine_negatives' beyond ties "
                                 f"(max |Δscore| {err.max():.3g})")
        errs[name] = float(err.max())
    rec = dict(queries=N_MINE_Q, n_objects=int(obj.shape[0]),
               window=[window["neg_start"], window["neg_end"]],
               sharded_shards=MINE_SHARDS, ms=ms, max_abs_score_err=errs,
               same_ids={n: float((out[n] == out["exact"]).mean())
                         for n in ("sharded", "dense")})
    record(f"phase 9 mining ({N_MINE_Q} queries × {obj.shape[0]} objects, "
           f"window {window['neg_start']}:{window['neg_end']}): "
           f"mine_negatives {ms['exact']:.1f} ms, _sharded ({MINE_SHARDS} "
           f"blocks) {ms['sharded']:.1f} ms, _dense (256 blocks) "
           f"{ms['dense']:.1f} ms; windows equal up to ties (max |Δscore| "
           f"{errs}, ids equal {rec['same_ids']})")
    return rec


def p9_cli(dev, tmp):
    """``--mesh 1`` through the command line at phase 8's flags (training
    cut to 10 + 10 steps, 1,024 requests): the mesh line printed, the quality queries'
    ids equal to an unsharded searcher's over the same snapshot; and on
    this host a mesh wider than its cards raises."""
    import os
    import torch
    from repro_torch import api
    from repro_torch.launch import serve as cli
    seen = []
    real = api.Searcher.query_corpus

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append((self.snapshot, a, kw, out))
        return out

    api.Searcher.query_corpus = spy
    try:
        text, wall = run_main(cli.main, CLI_MESH_ARGS + [
            "--snapshot-dir", os.path.join(tmp, "mesh_snap")], "phase 9 CLI")
    finally:
        api.Searcher.query_corpus = real
    if "== mesh: cluster buffers sharded across 1 devices" not in text:
        raise AssertionError("phase 9 CLI: no mesh line")
    if len(seen) != 1 or seen[0][0].shards is None:
        raise AssertionError("phase 9 CLI: the quality queries were not "
                             "served by the sharded snapshot")
    snap, a, kw, (ids, sc) = seen[0]
    w_ids, w_sc = api.Searcher(snap.unshard(), device=dev).query_corpus(*a,
                                                                        **kw)
    err = topk_match(ids, sc, w_ids, w_sc)
    rep = cli_report(text, "phase 9 CLI")
    try:
        api.load(os.path.join(tmp, "mesh_snap"), device=dev,
                 mesh=torch.cuda.device_count() + 1)
    except ValueError as e:
        refused = str(e).splitlines()[0]
    else:
        raise AssertionError("phase 9: a mesh wider than the host's cards "
                             "was accepted")
    rec = dict(args=CLI_MESH_ARGS, wall_s=wall, max_abs_err=err,
               refused=refused, **rep)
    record(f"phase 9 CLI --mesh 1: exit 0 in {wall:.1f} s, ids == unsharded "
           f"(max|Δ| {err:.3g}), {rep['qps']:.1f} QPS p99 "
           f"{rep['p99_ms']:.2f} ms; load(mesh={torch.cuda.device_count() + 1})"
           f" refused: {refused}")
    return rec


def phase9(dev, wctx, retriever, trained_corpus):
    """The sharded query phase on phase 3's full-width index: S logical
    shards on this card (``SHARD_COUNTS``), int8 on ``cuda`` / ``cuda-cm``
    / ``auto`` and f32 at S 4 on ``cuda``, against the unsharded
    searchers; then the per-shard scans of one chunk, the faults, the
    minings and the CLI. The launch counters are zeroed before the
    sharded runs and read after them."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import engine as engine_lib
    from repro_torch.kernels import fused_topk_score as fts
    snaps = wctx["snaps"]
    q = (wctx["tok"], wctx["msk"], wctx["q_loc"])
    n_all = q[0].shape[0]
    rec = dict(queries=SHARD_QUERIES, k=SHARD_K, cr=SHARD_CR,
               batch=SHARD_BATCH, card=CARD)

    # ---- the unsharded searchers: the answers and walls to beat ----------
    base = {}
    for p, b in [("int8", b) for b in SHARD_BACKENDS] + [("f32", "cuda")]:
        ids, sc, r = p9_run(dev, snaps[p], b, q, n_all)
        base[(p, b)] = (ids, sc, r["wall_ms"])
    rec["unsharded_walls_ms"] = {f"{p}/{b}": v[2]
                                 for (p, b), v in base.items()}
    log(f"phase 9 unsharded walls ({n_all} queries): "
        f"{rec['unsharded_walls_ms']}")

    # ---- the main path: sharded searchers, counters read around it -------
    runs = {}
    # f32 first: its 18 GB of parts are freed before the int8 placements
    # are kept for the chunk split
    plan = [(FAULT_S, "f32", ("cuda",))] + [
        (S, "int8", SHARD_BACKENDS) for S in SHARD_COUNTS]
    kept = {}                         # the int8 placements, for the split
    torch.cuda.synchronize()
    fts.reset_launch_counts()
    for S, p, backends in plan:
        what = f"S={S} {p}"
        snap_s, mem = p9_shard(dev, snaps[p], S, what)
        n = SHARD_QUERIES
        for b in backends:
            _, _, r = p9_run(dev, snap_s, b, q, n, want=base[(p, b)][:2],
                             mem=mem)
            r.update(queries=n, unsharded_wall_ms=base[(p, b)][2] * n / n_all)
            runs[f"{p}/{b}/S{S}"] = r
            log(f"phase 9 {what} {b}: {n} queries in {r['wall_ms']:.1f} ms "
                f"as served (hedges {r['shard_stats']['hedged_scans']}; "
                f"hedge floors of the shards jitter flagged "
                f"{r['hedge_floor_ms']} ms), "
                f"{r['steady_wall_ms']:.1f} ms with hedging off (peak "
                f"+{r['steady_peak_added_gb']:.3f} GB), vs "
                f"unsharded {r['unsharded_wall_ms']:.1f} ms (overhead, not "
                f"scale-out: {S} logical shards on one card); ids == "
                f"unsharded up to ties (max|Δ| {r['max_abs_err']:.3g})")
        p9_memory(mem, what)
        rec.setdefault("memory", {})[what] = mem
        record(f"phase 9 {what}: sharded in {mem['shard_s']:.2f} s; parts "
               f"{[round(x / 1e9, 3) for x in mem['bytes_per_part']]} GB "
               f"(sum {mem['parts_gb']:.3f} GB vs global "
               f"{mem['global_gb']:.3f} GB, now on the host); the card "
               f"gained {mem['peak_added_gb']:.3f} GB at peak, "
               f"{mem['resident_added_gb']:.3f} GB resident; peak "
               f"{mem['peak_device_gb']:.1f} GB")
        if p == "int8":
            kept[S] = snap_s
        del snap_s, r
    launches = dict(fts.launches)
    rec["runs"], rec["launches"] = runs, launches
    log(f"phase 9 main path launches {launches}")
    for name in ("routed", "cluster_major"):
        if launches[name] == 0:
            raise AssertionError(f"phase 9: kernel {name} not launched on "
                                 f"the sharded path")

    # ---- one chunk's scans: summed over the shards vs unsharded ----------
    rel, index, norm = (getattr(snaps["int8"], x) for x in ("rel", "index",
                                                            "norm"))
    chunk = [torch.from_numpy(a[:SHARD_BATCH]).to(dev) for a in q]
    q_emb, w, top_c = engine_lib.make_prefix_fn(cr=SHARD_CR)(rel, index,
                                                             norm, *chunk)
    ctx = dict(q_emb=q_emb, ql=chunk[2], w=w, top_c=top_c,
               w_hat=snaps["int8"].w_hat)
    split = {}
    buf8 = snaps["int8"].buffers
    for b in ("cuda", "cuda-cm"):
        unsh = time_ms(lambda b=b: engine_lib._routed_topk(
            q_emb, chunk[2], w, top_c, buf8, ctx["w_hat"], k=SHARD_K,
            backend=b, dist_max=1.4142, precision="int8"))
        split[b] = {"unsharded_ms": unsh}
    for S in SHARD_COUNTS:
        snap_s = kept[S]
        for b in ("cuda", "cuda-cm"):
            per, err = p9_scan_split(dev, snap_s, ctx, b)
            split[b][f"S{S}"] = dict(per_shard_ms=per, sum_ms=sum(per),
                                     max_abs_err_vs_plain=err)
            log(f"phase 9 chunk scan int8 {b} S={S}: per shard "
                f"{[round(x, 3) for x in per]} ms, sum {sum(per):.3f} ms vs "
                f"unsharded {split[b]['unsharded_ms']:.3f} ms (overhead: "
                f"each shard streams its sentinel for off-shard routes); "
                f"every shard == its plain version up to ties (max|Δ| "
                f"{err:.3g})")
        del snap_s
    rec["chunk_scan_ms"] = split
    rec["max_abs_err_vs_plain"] = {
        name: max(split[b][f"S{S}"]["max_abs_err_vs_plain"]
                  for S in SHARD_COUNTS)
        for name, b in (("routed", "cuda"), ("cluster_major", "cuda-cm"))}
    # what the scans do not explain: the S syncs and copies a chunk, the
    # host merge and the lost overlap, per chunk
    chunks = -(-SHARD_QUERIES // SHARD_BATCH)
    rec["host_ms_per_chunk"] = {
        b: {f"S{S}": (runs[f"int8/{b}/S{S}"]["steady_wall_ms"]
                      - runs[f"int8/{b}/S{S}"]["unsharded_wall_ms"])
            / chunks - (split[b][f"S{S}"]["sum_ms"]
                           - split[b]["unsharded_ms"])
            for S in SHARD_COUNTS}
        for b in ("cuda", "cuda-cm")}
    log(f"phase 9 per-chunk time beyond the scans (syncs, copies, merge, "
        f"lost overlap), ms: {rec['host_ms_per_chunk']}")

    # ---- faults, mining, the command line --------------------------------
    fault_snap = kept.pop(FAULT_S)
    kept.clear()
    torch.cuda.empty_cache()
    rec["faults"] = p9_faults(dev, fault_snap, snaps["int8"], q)
    del fault_snap
    rec["mining"] = p9_mining(dev, retriever, trained_corpus)
    with tempfile.TemporaryDirectory() as tmp:
        rec["cli"] = p9_cli(dev, tmp)
    torch.cuda.empty_cache()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


# ---------------------------------------------------------------------------
# Phase 10: the substrate's serving paths at full width
# ---------------------------------------------------------------------------


# qwen2-7b at its full config; gemma3-27b at its full widths, one
# LLLLLG period (6 of 62 layers: its 27B f32 params are ~108 GB)
LM_PLANS = {
    "qwen2-7b": dict(layers=None, long=(1, 32_768), batch=8, prompt=4096,
                     max_len=32_768),
    "gemma3-27b": dict(layers=6, long=None, batch=2, prompt=8192,
                       max_len=8192 + 32),
}
DECODE_STEPS = 32
DECODE_TOL = (2e-2, 2e-2)        # rtol, atol: tests/test_decode_parity.py
# decode against lm_prefill, held to a gate: its largest |Δ| and its share
# of logits beyond DECODE_TOL at most these. The served bf16 run: the sound
# runs read at most 0.094 and 7.7% at full width (the reference 0.102 and
# 8.6% at qwen2-7b's), a lost cache write 0.149 and 19% (PERF.md §6, on an
# H100). The f32 twin: no logit beyond DECODE_TOL (sound 2.6e-5).
DECODE_BF16_GATE = dict(max_abs_err=0.125, beyond_frac=0.10)
DECODE_F32_GATE = dict(max_abs_err=math.inf, beyond_frac=0.0)
HELD_S = 4096                    # leading query rows of every held sequence
HELD_TAIL = 1024                 # and its last rows, where S is longer
HELD_SCORES = 1 << 28            # f32 scores per plain-version block
DLRM_MAX_ROWS = 10_000_000       # per table (MLPerf's --max-ind-range)
DLRM_SERVE = {"serve_p99": 512, "serve_bulk": 262_144}
BAG_BATCH, BAG_MAX = 262_144, 16  # bags of 1..16 ids on table 0
BAG_TOL = 1e-5                   # relative, and absolute on near-zero sums
MIND_CANDIDATES = 1_000_000      # the retrieval_cand cell


def causal_pairs(s, window):
    """Unmasked (query, key) pairs of one head: causal, window-limited."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


class FlashTap:
    """Wraps ``kernels.flash_attention.flash_attention`` (the function the
    LM layers call): passes every call through and keeps the inputs and
    output of the launches whose index (counted from 0 since ``reset``) is
    in ``keep``."""

    def __init__(self, keep):
        from repro_torch.kernels import flash_attention as fa
        self.fa, self.real, self.keep = fa, fa.flash_attention, set(keep)
        self.calls, self.kept = 0, {}

    def __call__(self, q, k, v, **kw):
        out = self.real(q, k, v, **kw)
        if self.calls in self.keep:
            self.kept[self.calls] = (q, k, v, kw, out)
        self.calls += 1
        return out

    def __enter__(self):
        self.fa.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.real


def rows_excess(out, q, k, v, b, r0, r1, *, causal, window):
    """``one_rounding_excess`` of query rows ``[r0, r1)`` of sequence
    ``b``: the plain f32 attention of those rows over every key they may
    see (positions ``r0..`` against ``0..``, so rows deep in a long
    sequence are held too), a block of KV heads at a time with at most
    ``HELD_SCORES`` scores."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    _, s, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    k0 = max(0, r0 - window + 1) if (causal and window) else 0
    k1 = r1 if causal else s
    pos_q = torch.arange(r0, r1, device=q.device)[:, None]
    pos_k = torch.arange(k0, k1, device=q.device)[None, :]
    mask = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q >= pos_k
    if window > 0:
        mask &= (pos_q - pos_k) < window
    rel = FLASH_ONE_ROUNDING[str(q.dtype).split(".")[1]]
    per = max(1, HELD_SCORES // (g * (r1 - r0) * (k1 - k0)))
    worst = 0.0
    for j0 in range(0, n_kv, per):
        j1 = min(n_kv, j0 + per)
        qs = q[b, r0:r1, j0 * g:j1 * g].float().reshape(
            r1 - r0, j1 - j0, g, d) * (1.0 / math.sqrt(d))
        sc = torch.einsum("qkgd,jkd->kgqj", qs, k[b, k0:k1, j0:j1].float())
        sc = torch.where(mask, sc, torch.full((), fa.NEG_INF,
                                              device=q.device))
        want = torch.einsum("kgqj,jkd->qkgd", torch.softmax(sc, dim=-1),
                            v[b, k0:k1, j0:j1].float())
        del sc
        want = want.reshape(r1 - r0, (j1 - j0) * g, d)
        got = out[b, r0:r1, j0 * g:j1 * g].float()
        worst = max(worst, ((got - want).abs()
                            / (rel * want.abs() + 1e-4)).max().item())
    return worst


def held_flash(q, k, v, kw, out, what):
    """Every sequence of the launch against the plain f32 version within
    one rounding (``FLASH_ONE_ROUNDING``; raises): its first ``HELD_S``
    query rows and, where S is longer, its last ``HELD_TAIL`` rows (the
    heaviest causal tiles, where 32-bit index products would overflow
    first), each row against every key it may see → the largest
    excess."""
    b, s = q.shape[:2]
    spans = [(0, min(HELD_S, s))] + ([(s - HELD_TAIL, s)] if s > HELD_S
                                     else [])
    worst = 0.0
    for i in range(b):
        for r0, r1 in spans:
            x = rows_excess(out, q, k, v, i, r0, r1, causal=kw["causal"],
                            window=kw["window"])
            if not x <= 1.0:
                raise AssertionError(
                    f"{what}: sequence {i} rows {r0}..{r1}: |kernel - "
                    f"plain_f32| is {x:.3g}× the one-rounding bound")
            worst = max(worst, x)
    return worst


def flash_shape_times(dev, q, k, v, kw):
    """Kernel, plain (per sequence, first ``HELD_S`` rows, the most one
    score tensor of the plain version holds here) and SDPA times on one
    prefill layer's inputs, with the bound of the full launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, s, h, d = q.shape
    w = kw["window"]
    rec = dict(shape=[b, s, h, k.shape[2], d], window=w)
    rec["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=3)
    sl = slice(0, min(HELD_S, s))
    rec["plain_rows"] = sl.stop
    rec["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
        q[:1, sl], k[:1, sl], v[:1, sl], **kw), reps=2)
    # SDPA on K/V expanded to the query heads (outside the timing): with
    # enable_gqa or a mask at these lengths it may leave its fused
    # backends for the math one, whose score tensor would not fit
    g = h // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    if w:
        mask = fa.attention_mask(s, s, causal=True, window=w, device=dev)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
    rec["library_ms"] = time_ms(lib, reps=3)
    del kt, vt
    pairs = causal_pairs(s, w) * h * b
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rec.update(roof(nbytes, 4 * d * pairs, BF16_FLOPS_PER_S))
    rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    return rec


def decode_divergence(model, toks, gen, last_logits):
    """``lm_prefill`` over the prompt and the decoded tokens (S + steps)
    against the last decode step's logits: ``(record, prefill logits)``
    with the largest and mean |Δ| and the logits beyond ``DECODE_TOL``."""
    import torch
    from repro_torch.models import transformer as tf
    full = torch.cat([toks, gen], dim=1)
    want, cache = tf.lm_prefill(model, full)
    del cache
    return dict(positions=int(full.shape[1]),
                **logit_divergence(last_logits, want)), want


def decode_faults(model, toks, gen, want, max_len):
    """What the bf16 gate must tell apart from a sound decode: the last
    step run alone after ``lm_prefill`` over the prompt and the other
    decoded tokens into a ``max_len`` cache, sound (``one_step``) and with
    a planted fault, each against ``want`` (``lm_prefill`` over all of
    them): ``slot_off_by_one`` decodes at the position before (its K/V
    overwrite the previous token's slot, its rotation one off);
    ``lost_write`` zeroes the previous token's slot in every layer's
    cache; ``control`` is the sound prefill's logits one position early.
    → ``{name: divergence record}``."""
    import torch
    from repro_torch.models import transformer as tf
    b = toks.shape[0]
    full = torch.cat([toks, gen[:, :-1]], dim=1)
    pos = full.shape[1]
    out = {}
    for name in ("one_step", "slot_off_by_one", "lost_write"):
        prev, cache = tf.lm_prefill(model, full, max_len=max_len)
        if name == "lost_write":
            for c in cache:
                slot = (pos - 1) % c["k"].shape[1]
                c["k"][:, slot] = 0
                c["v"][:, slot] = 0
        at = pos - 1 if name == "slot_off_by_one" else pos
        logits, cache = tf.lm_decode_step(model, cache, gen[:, -1:],
                                          torch.full((b,), at,
                                                     device=toks.device))
        del cache
        out[name] = logit_divergence(logits, want)
    out["control"] = logit_divergence(prev, want)
    return out


def logit_divergence(got, want):
    """|got - want| over the logits: its largest and mean, and how many
    lie beyond ``DECODE_TOL``."""
    rtol, atol = DECODE_TOL
    diff = (got - want).abs()
    return dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                beyond_tol=int((diff > atol + rtol * want.abs()).sum()),
                of=int(diff.numel()))


def decode_gate(served, faults, what, lim):
    """Raises unless the served run and the sound single step pass the
    gate ``lim`` and every planted fault and the control fail it (so the
    gate is shown, in each run, to catch what it is for)."""
    def passes(r):
        return (r["max_abs_err"] <= lim["max_abs_err"]
                and r["beyond_tol"] <= lim["beyond_frac"] * r["of"])
    for name, r in [("served", served), ("one_step", faults["one_step"])]:
        if not passes(r):
            raise AssertionError(
                f"{what}: the {name} decode differs from "
                f"lm_prefill by max |Δ| {r['max_abs_err']:.4g} with "
                f"{r['beyond_tol']}/{r['of']} logits beyond {DECODE_TOL} "
                f"(gate {lim})")
    missed = [n for n, r in faults.items() if n != "one_step" and passes(r)]
    if missed:
        raise AssertionError(f"{what}: the gate {lim} passes "
                             f"the planted faults {missed}: {faults}")


def decode_check(model, toks, gen, what):
    """The KV-cache check on ``model``'s float32-compute twin (the same
    weights; f32 activations, flash's f32 body): prefill the prompt into a
    cache of S + steps, decode the served run's tokens teacher-forced, and
    hold the last step against ``lm_prefill`` over all of them within
    ``DECODE_TOL`` (``DECODE_F32_GATE``, which the planted faults of
    ``decode_faults`` must fail; raises). In bf16 the two paths round in other places
    (M = B rows against B·S in each product, flash against the plain
    decode attention) and those roundings grow over the layers, so the
    served run is held to ``DECODE_BF16_GATE`` instead (``decode_gate``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
    twin = tf.LM(cfg, model.embed.data, list(model.blocks), model.final_norm,
                 None if model.unembed is None else model.unembed.data)
    b, p = toks.shape
    steps = gen.shape[1]
    fa.launches["flash_attention_f32"] = 0
    logits, cache = tf.lm_prefill(twin, toks, max_len=p + steps)
    f32_launches = fa.launches["flash_attention_f32"]
    for i in range(steps):
        logits, cache = tf.lm_decode_step(
            twin, cache, gen[:, i:i + 1],
            torch.full((b,), p + i, device=toks.device))
    del cache
    rec, want = decode_divergence(twin, toks, gen, logits)
    if not torch.isfinite(want).all():
        raise AssertionError(f"{what}: the f32 twin's prefill "
                             f"logits are not finite")
    rec["faults"] = decode_faults(twin, toks, gen, want, p + steps)
    decode_gate(rec, rec["faults"], f"{what} f32 twin", DECODE_F32_GATE)
    rec["f32_flash_launches"] = f32_launches
    return rec


def lm_prefill_held(model, toks, max_len, first, what):
    """One ``lm_prefill`` of ``toks`` into a ``max_len`` cache with the
    flash counter zeroed before and read after: raises unless it launched
    flash once per layer and the logits are finite, holds the first
    launch of each layer kind (``first``: kind → layer index) within one
    rounding (``held_flash``) → ``(logits, cache, tap, record)``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    b, s = toks.shape
    fa.launches["flash_attention"] = fa.launches["flash_attention_f32"] = 0
    with FlashTap(first.values()) as tap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tf.lm_prefill(model, toks, max_len=max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_launch = fa.launches["flash_attention"]
    if n_launch != cfg.n_layers:
        raise AssertionError(f"{what}: {n_launch} flash launches for "
                             f"{cfg.n_layers} layers")
    if logits.shape != (b, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: bad logits")
    held = {kind: held_flash(*tap.kept[i], what=f"{what} layer {i}")
            for kind, i in first.items()}
    rec = dict(batch=b, seq=s, cache_len=max_len, wall_ms=wall * 1e3,
               tokens_per_s=b * s / wall, flash_launches=n_launch,
               f32_flash_launches=fa.launches["flash_attention_f32"],
               held_one_rounding=held,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{what} (B {b} × S {s}, cache {max_len}): {wall * 1e3:.1f} ms, "
        f"{b * s / wall:.0f} tokens/s, {n_launch} flash launches = layers; "
        f"held launches within {held} of one rounding; peak "
        f"{rec['peak_gb']:.1f} GB")
    return logits, cache, tap, rec


def lm_greedy_decode(model, cache, logits, start, what, on_step=None):
    """``DECODE_STEPS`` greedy steps from ``logits`` (the prompt's last)
    at positions ``start``.., flash's counter zeroed: raises if decode
    launched flash or a step's logits are not finite. ``on_step(i)`` is
    called after step i. → ``(generated tokens (B, steps) fed to the
    steps, last logits, record)``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    b = logits.shape[0]
    dev = logits.device
    fa.launches["flash_attention"] = 0
    tok = logits.argmax(-1, keepdim=True)
    gen, steps_ms = [tok], []
    for i in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tf.lm_decode_step(model, cache, tok,
                                          torch.full((b,), start + i,
                                                     device=dev))
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        if on_step is not None:
            on_step(i)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{what}: decode step {i} logits not "
                                 f"finite")
        tok = logits.argmax(-1, keepdim=True)
        if i < DECODE_STEPS - 1:
            gen.append(tok)
    if fa.launches["flash_attention"]:
        raise AssertionError(f"{what}: decode launched flash")
    mean_ms = sum(steps_ms[1:]) / (len(steps_ms) - 1)
    rec = dict(batch=b, start=start, steps=DECODE_STEPS, step_ms=steps_ms,
               mean_step_ms=mean_ms, tokens_per_s=b / (mean_ms / 1e3))
    return torch.cat(gen, 1), logits, rec


def p10_lm(dev, arch, plan):
    """One LM: init at full width, the long prefill (when planned), the
    decode prompt's prefill into a ``max_len`` cache, ``DECODE_STEPS``
    greedy steps, the decode-against-prefill check, the held launches and
    the flash times on the prompt prefill's first layer of each kind."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMStream
    from repro_torch.models import transformer as tf
    cfg = get_config(arch)
    if plan["layers"]:
        n = plan["layers"]
        cfg = dataclasses.replace(cfg, n_layers=n,
                                  layer_pattern=cfg.pattern()[:n])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.lm_init(cfg, seed=SEED, device=dev).requires_grad_(False)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    rec = dict(arch=arch, n_layers=cfg.n_layers, pattern="".join(
        cfg.pattern()), params=params, params_gb=params * 4 / 1e9,
        init_s=time.perf_counter() - t0, prefill={}, launches={})
    stream = LMStream(cfg.vocab_size, seed=SEED)
    first = {kind: cfg.pattern().index(kind) for kind in set(cfg.pattern())}

    def prefill(name, b, s, max_len):
        toks = torch.from_numpy(stream.batch(len(rec["prefill"]), b, s)[
            "tokens"][:, :s]).to(dev)
        logits, cache, tap, r = lm_prefill_held(
            model, toks, max_len, first, f"phase 10 {arch} {name}")
        rec["launches"][name] = r["flash_launches"]
        rec["prefill"][name] = r
        return toks, logits, cache, tap

    if plan["long"]:
        b, s = plan["long"]
        _, _, cache, tap = prefill(f"prefill_{s // 1024}k", b, s, s)
        del cache
        q, k, v, kw, _ = tap.kept[first["G"]]
        rec["flash_long"] = flash_shape_times(dev, q, k, v, kw)
        del tap, q, k, v
        torch.cuda.empty_cache()
    b, p = plan["batch"], plan["prompt"]
    toks, logits, cache, tap = prefill("decode_prompt", b, p, plan["max_len"])
    rec["flash"] = {kind: flash_shape_times(dev, *tap.kept[i][:4])
                    for kind, i in first.items()}
    del tap
    torch.cuda.empty_cache()
    toks = toks.long()
    gen, logits, rec["decode"] = lm_greedy_decode(model, cache, logits, p,
                                                  f"phase 10 {arch}")
    rec["decode"]["cache_len"] = plan["max_len"]
    del cache
    torch.cuda.empty_cache()
    rec["decode_vs_prefill_bf16"], want = decode_divergence(model, toks, gen,
                                                            logits)
    torch.cuda.empty_cache()
    rec["decode_faults_bf16"] = decode_faults(model, toks, gen, want,
                                              plan["max_len"])
    del want
    torch.cuda.empty_cache()
    decode_gate(rec["decode_vs_prefill_bf16"], rec["decode_faults_bf16"],
                f"phase 10 {arch}", DECODE_BF16_GATE)
    rec["decode_vs_prefill"] = decode_check(model, toks, gen,
                                            f"phase 10 {arch}")
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    bf, f32 = rec["decode_vs_prefill_bf16"], rec["decode_vs_prefill"]
    log(f"phase 10 {arch} decode: {DECODE_STEPS} greedy steps of B {b} from "
        f"position {p} on a {plan['max_len']}-slot cache, "
        f"{rec['decode']['mean_step_ms']:.2f} ms a step, "
        f"{rec['decode']['tokens_per_s']:.0f} tokens/s; the last step's "
        f"logits against lm_prefill over {f32['positions']} tokens: f32 twin "
        f"max |Δ| {f32['max_abs_err']:.3g} (within {DECODE_TOL}), served "
        f"bf16 max |Δ| {bf['max_abs_err']:.4g}, mean {bf['mean_abs_err']:.4g}"
        f", {bf['beyond_tol']}/{bf['of']} beyond {DECODE_TOL} (within the "
        f"gate {DECODE_BF16_GATE}; planted faults "
        f"{ {n: (round(r['max_abs_err'], 4), r['beyond_tol']) for n, r in rec['decode_faults_bf16'].items()} }); "
        f"flash per kind "
        f"{ {kind: round(r['ms'], 3) for kind, r in rec['flash'].items()} } "
        f"ms vs SDPA "
        f"{ {kind: round(r['library_ms'], 3) for kind, r in rec['flash'].items()} }"
        f" ms; peak {rec['peak_gb']:.1f} GB")
    del model
    torch.cuda.empty_cache()
    return rec


def p10_dlrm(dev):
    """DLRM at its full widths (tables capped at ``DLRM_MAX_ROWS``):
    ``dlrm_forward`` on ``CTRStream`` batches at ``serve_p99`` and
    ``serve_bulk``, one dot launch each (its features held against the
    plain version and timed beside bmm + triangle), then
    ``recsys.embedding_bag`` on table 0 at ``BAG_BATCH`` bags in ``sum``
    and ``mean``, one bag launch each, held against the plain version and
    ``F.embedding_bag``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data.recsys_data import CTRStream
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.models import recsys as rs
    cfg = get_config("dlrm-mlperf")
    sizes = [min(v, DLRM_MAX_ROWS) for v in cfg.table_sizes]
    cfg = dataclasses.replace(cfg, table_sizes=tuple(sizes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rs.dlrm_init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    rows = sum(t.shape[0] for t in params["tables"])
    rec = dict(table_rows=rows, tables_gb=rows * cfg.embed_dim * 4 / 1e9,
               init_s=time.perf_counter() - t0, serve={}, launches={})
    stream = CTRStream(cfg.n_dense, sizes, seed=SEED)
    real = di.dot_interaction
    for step, (name, b) in enumerate(DLRM_SERVE.items()):
        batch = stream.batch(step, b)
        dense = torch.from_numpy(batch["dense"]).to(dev)
        sparse = torch.from_numpy(batch["sparse"]).to(dev)
        kept = []

        def tap(feats):
            out = real(feats)
            kept.append((feats, out))
            return out
        di.launches["dot_interaction"] = 0
        di.dot_interaction = tap
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logit = rs.dlrm_forward(params, dense, sparse, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            di.dot_interaction = real
        n_launch = di.launches["dot_interaction"]
        rec["launches"][name] = n_launch
        if n_launch != 1 or logit.shape != (b,) or \
                not torch.isfinite(logit).all():
            raise AssertionError(f"phase 10 dlrm {name}: {n_launch} dot "
                                 f"launches, logits {tuple(logit.shape)}")
        feats, out = kept[0]
        want = di.dot_interaction_plain(feats)
        err = (out - want).abs()
        if (err > DOT_TOL + DOT_TOL * want.abs()).any():
            raise AssertionError(f"phase 10 dlrm {name}: dot interaction "
                                 f"differs from plain by {err.max().item()}")
        iu, ju = di.triu_pairs(feats.shape[1], dev)
        r = dict(batch=b, wall_ms=wall * 1e3, rows_per_s=b / wall,
                 dot=dict(err=err.max().item(), shape=list(feats.shape),
                          ms=time_ms(lambda: real(feats), reps=DOT_REPS),
                          plain_ms=time_ms(lambda: di.dot_interaction_plain(
                              feats), reps=3),
                          library_ms=time_ms(lambda: torch.bmm(
                              feats, feats.mT)[:, iu, ju], reps=DOT_REPS)))
        r["forward_ms"] = time_ms(lambda: rs.dlrm_forward(
            params, dense, sparse, cfg), reps=3)
        n_pairs = iu.numel()
        r["dot"].update(roof(feats.numel() * 4 + b * n_pairs * 4,
                             b * n_pairs * 2 * feats.shape[2],
                             F32_FLOPS_PER_S))
        rec["serve"][name] = r
        log(f"phase 10 dlrm {name} (B {b}): forward {r['forward_ms']:.3f} ms "
            f"({b / r['forward_ms'] * 1e3:.0f} rows/s), 1 dot launch, dot "
            f"{r['dot']['ms']:.3f} ms vs plain {r['dot']['plain_ms']:.3f} ms, "
            f"bmm+triu {r['dot']['library_ms']:.3f} ms, bound "
            f"{r['dot']['bound_ms']:.4f} ms; max|err| {r['dot']['err']:.3g}")
        del feats, out, want, kept, dense, sparse, logit
    # ---- embedding bags on table 0 ------------------------------------------
    table = params["tables"][0]
    rng = np.random.default_rng(SEED + 10)
    counts = rng.integers(1, BAG_MAX + 1, BAG_BATCH)
    idx = torch.from_numpy(rng.integers(0, sizes[0], int(counts.sum()))
                           ).to(dev)
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)[:-1]])).to(dev)
    rec["bags"] = {}
    for mode in ("sum", "mean"):
        eb.launches["embedding_bag"] = 0
        got = rs.embedding_bag(table, idx, offsets=offsets, n_bags=BAG_BATCH,
                               mode=mode)
        torch.cuda.synchronize()
        n_launch = eb.launches["embedding_bag"]
        rec["launches"][f"bag_{mode}"] = n_launch
        if n_launch != 1:
            raise AssertionError(f"phase 10 bag {mode}: {n_launch} launches")
        seg = torch.searchsorted(offsets, torch.arange(
            idx.numel(), device=dev), right=True) - 1
        ids = rs.bag_matrix(seg, BAG_BATCH, idx)
        want = eb.embedding_bag_plain(table, ids)
        if mode == "mean":
            want = want / torch.from_numpy(counts).to(dev, torch.float32)[:,
                                                                         None]
        err = (got - want).abs()
        if (err > BAG_TOL * want.abs() + BAG_TOL).any():
            raise AssertionError(f"phase 10 bag {mode}: differs from plain "
                                 f"by {err.max().item()}")
        lib = lambda: F.embedding_bag(  # noqa: E731
            idx, table, offsets, mode=mode)
        touched = int(torch.unique(idx).numel())
        r = dict(err=err.max().item(), library_err=(lib() - got).abs().max(
            ).item(), bags=BAG_BATCH, ids=int(idx.numel()), width=ids.shape[1],
            rows_touched=touched,
            ms=time_ms(lambda: eb.embedding_bag(table, ids)),
            path_ms=time_ms(lambda: rs.embedding_bag(
                table, idx, offsets=offsets, n_bags=BAG_BATCH, mode=mode),
                reps=3),
            plain_ms=time_ms(lambda: eb.embedding_bag_plain(table, ids),
                             reps=3),
            library_ms=time_ms(lib, reps=3))
        r.update(roof(touched * cfg.embed_dim * 4 + ids.numel() * 4
                      + BAG_BATCH * cfg.embed_dim * 4,
                      int(idx.numel()) * cfg.embed_dim, F32_FLOPS_PER_S))
        rec["bags"][mode] = r
        log(f"phase 10 embedding_bag {mode} on table 0 ({sizes[0]} rows; "
            f"{BAG_BATCH} bags of 1..{BAG_MAX}, padded to {ids.shape[1]}): "
            f"kernel {r['ms']:.3f} ms (with the offsets' conversion "
            f"{r['path_ms']:.3f} ms) vs plain {r['plain_ms']:.3f} ms, "
            f"F.embedding_bag {r['library_ms']:.3f} ms (|Δ| "
            f"{r['library_err']:.3g}); bound {r['bound_ms']:.4f} ms "
            f"({touched} rows); max|err| {r['err']:.3g}")
        del got, want, ids, seg
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, table
    torch.cuda.empty_cache()
    return rec


def p10_plain_models(dev):
    """xDeepFM at ``serve_p99``, BERT4Rec's ``score_all`` over its 1M items
    at B 512, MIND's ``score_candidates`` at the ``retrieval_cand`` cell:
    full configs, plain torch (the reference computes them in jnp); walls,
    rows/s and peaks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data.recsys_data import CTRStream, SeqRecStream
    from repro_torch.models import recsys as rs
    out = {}
    b = get_shape("xdeepfm", "serve_p99").dims["batch"]

    def run(name, init, fn, rows, check_shape):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        res = fn(params)
        torch.cuda.synchronize()
        if tuple(res.shape) != check_shape or not torch.isfinite(res).all():
            raise AssertionError(f"phase 10 {name}: output "
                                 f"{tuple(res.shape)} != {check_shape}")
        ms = time_ms(lambda: fn(params), reps=3)
        out[name] = dict(init_s=init_s, ms=ms, rows=rows,
                         rows_per_s=rows / ms * 1e3, shape=list(check_shape),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"phase 10 {name}: {ms:.3f} ms for {rows} rows "
            f"({rows / ms * 1e3:.0f} rows/s), output {check_shape}, peak "
            f"{out[name]['peak_gb']:.2f} GB")
        del params, res
        torch.cuda.empty_cache()

    xcfg = get_config("xdeepfm")
    xb = CTRStream(1, [xcfg.vocab_per_field] * xcfg.n_sparse,
                   seed=SEED).batch(0, b)
    xs = torch.from_numpy(xb["sparse"]).to(dev)
    run("xdeepfm/serve_p99", lambda: rs.xdeepfm_init(xcfg, device=dev),
        lambda p: rs.xdeepfm_forward(p, xs, xcfg), b, (b,))
    bcfg = get_config("bert4rec")
    bb = SeqRecStream(bcfg.n_items, seed=SEED).bert4rec_batch(
        0, b, bcfg.seq_len, bcfg.mask_prob, mask_token=bcfg.n_items + 1)
    seq = torch.from_numpy(bb["seq"]).to(dev)
    msk = torch.from_numpy(bb["mask"]).to(dev)
    run("bert4rec/score_all", lambda: rs.bert4rec_init(bcfg, device=dev),
        lambda p: rs.bert4rec_score_all(p, seq, msk, bcfg), b,
        (b, rs.pad_rows(bcfg.n_items + 2)))
    mcfg = get_config("mind")
    dims = get_shape("mind", "retrieval_cand").dims
    mb = SeqRecStream(mcfg.n_items, seed=SEED).mind_batch(
        0, dims["batch"], mcfg.hist_len)
    hist = torch.from_numpy(mb["hist"]).to(dev)
    hmask = torch.from_numpy(mb["hist_mask"]).to(dev)
    cand = torch.arange(1, dims["n_candidates"] + 1, device=dev)
    run("mind/retrieval_cand", lambda: rs.mind_init(mcfg, device=dev),
        lambda p: rs.mind_score_candidates(p, hist, hmask, cand, mcfg),
        dims["n_candidates"], (dims["batch"], dims["n_candidates"]))
    return out


def substrate_row(name, p10, p11):
    """The kernels line's substrate fields of flash attention, dot
    interaction or embedding bag: ``launches`` on phase 10's and 11's
    paths (the kernel's main path), the times at their shapes beside their
    bound, plain version and library call, and the largest error there."""
    keys = ("ms", "plain_ms", "plain_rows", "library_ms", "bound_ms",
            "bound_by", "x_bound", "shape", "window", "batch", "err",
            "library_err", "rows_touched", "path_ms")
    pick = lambda r: {f: r[f] for f in keys if f in r}  # noqa: E731
    shapes, err, launches = {}, 0.0, 0
    if name == "flash_attention":
        for arch, r in p10["lm"].items():
            launches += sum(r["launches"].values())
            if "flash_long" in r:
                shapes[f"{arch}/prefill_32k/G"] = pick(r["flash_long"])
            for kind, f in r["flash"].items():
                shapes[f"{arch}/decode_prompt/{kind}"] = pick(f)
        for arch, r in p11["lm"].items():
            launches += r["launches"]
            shapes[f"{arch}/prefill/G"] = pick(r["flash"]["G"])
    elif name == "dot_interaction":
        for shape, r in p10["dlrm"]["serve"].items():
            launches += p10["dlrm"]["launches"][shape]
            shapes[f"dlrm-mlperf/{shape}"] = pick(dict(r["dot"], batch=r[
                "batch"]))
            err = max(err, r["dot"]["err"])
    else:
        for mode, r in p10["dlrm"]["bags"].items():
            launches += p10["dlrm"]["launches"][f"bag_{mode}"]
            shapes[f"dlrm-mlperf/table0_{mode}"] = pick(r)
            err = max(err, r["err"])
    return dict(launches=launches, substrate_shapes=shapes,
                substrate_err=err)


def phase10(dev):
    """The substrate's serving paths at full width, one model at a time
    (each freed before the next): qwen2-7b and gemma3-27b (6 layers)
    prefill and decode through the flash twin, DLRM through the dot and
    bag twins, then xDeepFM, BERT4Rec and MIND (plain torch). The launch
    counters are zeroed before and read after each path."""
    import torch
    rec = dict(card=CARD, lm={}, launches={})
    with torch.no_grad():
        for arch, plan in LM_PLANS.items():
            rec["lm"][arch] = p10_lm(dev, arch, plan)
            rec["launches"][arch] = rec["lm"][arch]["launches"]
        rec["dlrm"] = p10_dlrm(dev)
        rec["launches"]["dlrm-mlperf"] = rec["dlrm"]["launches"]
        rec["plain_models"] = p10_plain_models(dev)
    rec["peak_gb"] = max([r["peak_gb"] for r in rec["lm"].values()]
                         + [rec["dlrm"]["peak_gb"]]
                         + [r["peak_gb"] for r in
                            rec["plain_models"].values()])
    return rec


# ---------------------------------------------------------------------------
# Phase 11: the MoE LMs and GatedGCN at full width, Adafactor on the card
# ---------------------------------------------------------------------------


# moonshot-v1-16b-a3b at its full widths (f32 params, ≈ 2.28 GB a layer):
# as many of its 48 layers as fit MOE_MEMORY_SHARE of the card with the
# B 8 × 4,096 prompt's prefill, from two trial depths' max_memory_allocated;
# kimi-k2-1t-a32b at its full widths, one of 61 layers (bf16 params 38.8 GB
# with both 163,840 × 7,168 tables: two layers do not fit one card). The
# decode gate runs on a no-drop twin (capacity_factor = E) at a prompt whose
# dispatch buffer (G·E·T·k·d elements) stays small; the oracle check's
# 1,024 tokens at cf = E would need a 45 GB buffer at kimi's widths, so
# kimi's runs at cf = E / 8 (C = 1,024 slots an expert; its drop fraction
# is checked to be 0).
MOE_PLANS = {
    "moonshot-v1-16b-a3b": dict(layers=None, batch=8, prompt=4096,
                                max_len=4096 + DECODE_STEPS, twin=(2, 512),
                                oracle_cf=None),
    "kimi-k2-1t-a32b": dict(layers=1, batch=2, prompt=4096,
                            max_len=4096 + DECODE_STEPS, twin=(1, 128),
                            oracle_cf=48.0),
}
# the no-drop twin's decode against lm_prefill (routes pinned). Moonshot's
# sound runs read at most 0.057 and 1.54% beyond DECODE_TOL, its lost cache
# write at least 0.063 and 2.77% (kimi: sound 0.034 / 0.012%, lost write
# 0.74 / 80%; PERF.md §6, on an H100); the share's limit is the geometric
# mean of 1.54% and 2.77% (2.06%), rounded up. DECODE_BF16_GATE's 10%
# passes moonshot's lost write.
MOE_TWIN_GATE = dict(max_abs_err=0.125, beyond_frac=0.021)
MOE_MEMORY_SHARE = 0.85
MOE_TRIAL_LAYERS = (1, 2)
MOE_ORACLE_TOKENS = 1024
# the bf16 dispatch against the f32 oracle, |Δ| ≤ atol + rtol·|oracle|:
# a few bf16 roundings of outputs of order 1 (the check records its own
# largest |Δ| beside this bound); a token sent to a wrong expert moves its
# output by O(1)
MOE_ORACLE_TOL = dict(rtol=2 ** -6, atol=2 ** -6)
# GatedGCN on the card against the CPU on the same inputs: one layer (and
# the input and readout denses) at GNN_TOL, sixteen layers end to end at
# GNN_FORWARD_TOL (the card's scatter-add and products sum in other orders,
# and each LayerNorm rescales what that leaves)
GNN_TOL = dict(rtol=1e-4, atol=1e-4)
GNN_FORWARD_TOL = dict(rtol=1e-3, atol=1e-3)
GNN_LOSS_RTOL = 1e-4
GNN_MEMORY_SHARE = 0.85          # ogb_products' edge cut
OGB_TRIAL_EDGES = (4_000_000, 8_000_000)
OGB_EDGE_STEP = 1_000_000        # the cut's edge count is a multiple of it
OGB_SLICE = 25_000               # nodes held against the CPU, layer by
                                 # layer (its host time bounds the slice:
                                 # 50,000 took 59.5 s on a slow host)
ADAFACTOR_SHAPE = (64, 2048, 1408)   # a moonshot expert stack
ADAFACTOR_LR = 1e-2


class MoETap:
    """Wraps ``models.moe.moe_apply`` (the function the LM blocks call):
    keeps each call's ``drop_fraction`` (a tensor, no sync). With
    ``routes`` it also wraps ``models.moe.route`` and keeps each call's
    top-k ids and probabilities (``routes``, cleared by the caller)."""

    def __init__(self, routes=False):
        from repro_torch.models import moe as moe_lib
        self.mod = moe_lib
        self.real_apply, self.real_route = moe_lib.moe_apply, moe_lib.route
        self.drops, self.routes = [], [] if routes else None

    def apply(self, moe, x, spec):
        out, aux = self.real_apply(moe, x, spec)
        self.drops.append(aux["drop_fraction"].detach())
        return out, aux

    def route(self, router, x, spec):
        import torch
        out = self.real_route(router, x, spec)
        self.routes.append((out[0], torch.softmax(
            x.float() @ router.float(), dim=-1)))
        return out

    def take_drops(self):
        """The drop fractions recorded since the last take, summed (over
        the layers of one call: ``lm_forward``'s aux)."""
        import torch
        total = float(torch.stack(self.drops).sum()) if self.drops else 0.0
        self.drops = []
        return total

    def __enter__(self):
        self.mod.moe_apply = self.apply
        if self.routes is not None:
            self.mod.route = self.route
        return self

    def __exit__(self, *exc):
        self.mod.moe_apply, self.mod.route = self.real_apply, self.real_route


def moe_depth(dev, cfg, plan):
    """The layers of ``cfg`` that fit ``MOE_MEMORY_SHARE`` of the card in
    the planned prefill: two trial depths' peaks (params, cache and the
    dispatch's working set) → the growth per layer → the depth."""
    import torch
    from repro_torch.data.lm_data import LMStream
    from repro_torch.models import transformer as tf
    b, p = plan["batch"], plan["prompt"]
    toks = torch.from_numpy(LMStream(cfg.vocab_size, seed=SEED).batch(
        0, b, p)["tokens"][:, :p]).to(dev)
    peaks = {}
    for n in MOE_TRIAL_LAYERS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = tf.lm_init(dataclasses.replace(cfg, n_layers=n), seed=SEED,
                           device=dev).requires_grad_(False)
        logits, cache = tf.lm_prefill(model, toks, max_len=plan["max_len"])
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated() - base
        del model, logits, cache
    torch.cuda.empty_cache()
    n0, n1 = MOE_TRIAL_LAYERS
    per_layer = (peaks[n1] - peaks[n0]) / (n1 - n0)
    total = torch.cuda.get_device_properties(dev).total_memory
    depth = n0 + int((MOE_MEMORY_SHARE * total - peaks[n0]) // per_layer)
    depth = max(1, min(cfg.n_layers, depth))
    rec = dict(trial_peak_gb={n: v / 1e9 for n, v in peaks.items()},
               per_layer_gb=per_layer / 1e9, card_gb=total / 1e9,
               share=MOE_MEMORY_SHARE, layers=depth)
    log(f"phase 11 {cfg.arch_id} depth: trial peaks "
        f"{ {n: round(v / 1e9, 2) for n, v in peaks.items()} } GB at "
        f"{MOE_TRIAL_LAYERS} layers, {per_layer / 1e9:.3f} GB a layer → "
        f"{depth} of {cfg.n_layers} layers in {MOE_MEMORY_SHARE:.0%} of "
        f"{total / 1e9:.1f} GB")
    return depth, rec


def moe_oracle(dev, model, plan, what):
    """The first layer's dispatch on ``MOE_ORACLE_TOKENS`` seeded hidden
    states in the compute dtype at a capacity factor where nothing drops,
    against ``moe_dense_plain`` in f32 on the same inputs
    (``MOE_ORACLE_TOL``; raises), and both timed."""
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    cfg, m = model.cfg, model.blocks[0].moe
    cf = plan["oracle_cf"] or float(cfg.moe.n_experts)
    spec = dataclasses.replace(cfg.moe, capacity_factor=cf)
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    x = torch.randn(1, MOE_ORACLE_TOKENS, cfg.d_model, generator=g,
                    device=dev).to(tf.torch_dtype(cfg.compute_dtype))
    out, aux = moe_lib.moe_apply(m, x, spec)
    drop = float(aux["drop_fraction"])
    if drop != 0.0:
        raise AssertionError(f"{what}: the oracle check's dispatch dropped "
                             f"{drop} of its assignments at cf {cf}")
    want = moe_lib.moe_dense_plain(m, x.float(), spec)
    diff = (out.float() - want).abs()
    excess = (diff / (MOE_ORACLE_TOL["atol"]
                      + MOE_ORACLE_TOL["rtol"] * want.abs())).max().item()
    rec = dict(tokens=MOE_ORACLE_TOKENS, capacity_factor=cf,
               capacity=moe_lib.capacity(MOE_ORACLE_TOKENS, spec),
               drop_fraction=drop, max_abs_err=diff.max().item(),
               mean_abs_err=diff.mean().item(), tol=MOE_ORACLE_TOL,
               excess=excess)
    del out, want, diff
    if not excess <= 1.0:
        raise AssertionError(f"{what}: the dispatch differs from "
                             f"moe_dense_plain by {rec['max_abs_err']:.4g} "
                             f"({excess:.3g}× {MOE_ORACLE_TOL})")
    rec["ms"] = time_ms(lambda: moe_lib.moe_apply(m, x, spec), reps=3)
    rec["plain_ms"] = time_ms(lambda: moe_lib.moe_dense_plain(
        m, x.float(), spec), reps=1)
    log(f"{what} dispatch: {MOE_ORACLE_TOKENS} tokens at cf {cf} (C "
        f"{rec['capacity']}), drop 0, against moe_dense_plain (f32) max |Δ| "
        f"{rec['max_abs_err']:.4g}, {excess:.3f}× {MOE_ORACLE_TOL}; "
        f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms")
    return rec


def moe_decode_split(dev, model, b, step_ms, what):
    """A decode step's MoE split on the first layer at decode's shape (one
    group of B tokens): the whole ``moe_apply``, the f32 → compute-dtype
    casts of the three expert stacks (a no-op for bf16 params) and the
    three expert products on weights cast beforehand, each × the layers
    against the measured step."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    cfg, m = model.cfg, model.blocks[0].moe
    cdt = tf.torch_dtype(cfg.compute_dtype)
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    x = torch.randn(b, 1, cfg.d_model, generator=g, device=dev).to(cdt)
    c = moe_lib.capacity(b, cfg.moe)
    xin = torch.randn(cfg.moe.n_experts, c, cfg.d_model, generator=g,
                      device=dev).to(cdt)
    stacks = (m.w1, m.w3, m.w2)
    w1, w3, w2 = (w.to(cdt) for w in stacks)
    cast_ms = time_ms(lambda: [w.to(cdt) for w in stacks])
    prod_ms = time_ms(lambda: torch.bmm(
        layers.silu(torch.bmm(xin, w1)) * torch.bmm(xin, w3), w2))
    moe_ms = time_ms(lambda: moe_lib.moe_apply(m, x, cfg.moe))
    del w1, w3, w2, xin
    n = cfg.n_layers
    w_bytes = sum(w.numel() * w.element_size() for w in stacks)
    cast_bytes = (w_bytes + sum(w.numel() for w in stacks) * 2
                  if stacks[0].dtype != cdt else 0)
    rec = dict(layer_moe_ms=moe_ms, layer_cast_ms=cast_ms,
               layer_products_ms=prod_ms, layer_cast_gb=cast_bytes / 1e9,
               layer_expert_gb=w_bytes / 1e9, capacity=c, layers=n,
               step_ms=step_ms, moe_share=moe_ms * n / step_ms,
               cast_share=cast_ms * n / step_ms,
               products_share=prod_ms * n / step_ms)
    log(f"{what} decode split (B {b}, C {c}): a layer's moe_apply "
        f"{moe_ms:.3f} ms = casts {cast_ms:.3f} ms ({cast_bytes / 1e9:.2f} "
        f"GB moved) + expert products {prod_ms:.3f} ms + routing, gather "
        f"and scatter; × {n} layers: {moe_ms * n:.1f} of the step's "
        f"{step_ms:.1f} ms (casts {rec['cast_share']:.0%}, products "
        f"{rec['products_share']:.0%})")
    return rec


class RouteReplay:
    """Pins ``models.moe.route``'s expert choices to recorded ones, so
    that a bf16 comparison of two paths (decode against ``lm_prefill``)
    tests their arithmetic and not the router's discontinuity: a prefill
    (one group a sequence, T > 1) takes the recorded routes of its first
    T positions (``seq``: per layer ``(B, S, k)``), a decode step (one
    group ``(1, B)``) the recorded last step's (``step``: per layer
    ``(1, B, k)``); the weights are the call's own probabilities at the
    pinned experts, renormalised, as ``route`` computes them. Every
    decision the pin changes must be one that the two paths' difference
    could flip: the call's own probabilities at its k-th expert and at
    the weakest pinned one differ by at most twice the largest |Δ|
    between its and the recorded probabilities of that token (raises
    otherwise); the changes are counted."""

    def __init__(self, seq, step, b):
        from repro_torch.models import moe as moe_lib
        self.mod, self.real = moe_lib, moe_lib.route
        self.seq, self.step, self.b = seq, step, b
        self.calls = self.changed = self.decisions = 0

    def route(self, router, x, spec):
        import torch
        _, _, aux = self.real(router, x, spec)
        layer = self.calls % len(self.seq)
        self.calls += 1
        g, t = x.shape[:2]
        decode = g == 1 and t == self.b
        ids, rec_p = (self.step[layer] if decode else
                      [r[:, :t] for r in self.seq[layer]])
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        own = torch.topk(probs, spec.top_k, dim=-1)
        changed = (torch.sort(own.indices, dim=-1).values
                   != torch.sort(ids, dim=-1).values).any(-1)
        pinned = torch.gather(probs, -1, ids)
        drift = (probs - rec_p).abs().amax(-1)
        gap = own.values[..., -1] - pinned.amin(-1)
        if bool((changed & (gap > 2 * drift)).any()):
            raise AssertionError(
                f"route replay: a pinned choice differs from the call's own "
                f"by more than the two paths' probabilities do (layer "
                f"{layer}, largest gap {gap[changed].max().item():.4g})")
        self.changed += int(changed.sum())
        self.decisions += changed.numel()
        w = pinned / torch.clamp(pinned.sum(-1, keepdim=True), min=1e-9)
        return ids, w, aux

    def __enter__(self):
        self.mod.route = self.route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real


def moe_twin_gate(dev, model, plan, what):
    """Decode against ``lm_prefill`` on the no-drop twin (the same
    weights at capacity_factor = E: prefill groups tokens by sequence,
    decode by batch, so capacity drops would differ between them):
    prefill the twin prompt, ``DECODE_STEPS`` greedy steps recording
    every layer's routes, then ``lm_prefill`` over all the tokens and
    the planted faults with those routes pinned (``RouteReplay``); the
    last step against that prefill within ``MOE_TWIN_GATE``, which the
    planted faults must fail (``decode_gate``; raises). Records the drops
    (must be 0) and the routing decisions the pin changed."""
    import torch
    from repro_torch.data.lm_data import LMStream
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    e = cfg.moe.n_experts
    tcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(e)))
    twin = tf.LM(tcfg, model.embed.data, list(model.blocks),
                 model.final_norm,
                 None if model.unembed is None else model.unembed.data)
    b, s = plan["twin"]
    toks = torch.from_numpy(LMStream(cfg.vocab_size, seed=SEED + 1).batch(
        0, b, s)["tokens"][:, :s]).to(dev).long()
    with MoETap(routes=True) as mt:
        logits, cache = tf.lm_prefill(twin, toks, max_len=s + DECODE_STEPS)
        prompt, steps = list(mt.routes), []
        drops = [mt.take_drops()]

        def on_step(i):
            drops.append(mt.take_drops())
            steps.append(list(mt.routes))
            mt.routes.clear()
        mt.routes.clear()
        gen, logits, dec = lm_greedy_decode(twin, cache, logits, s,
                                            f"{what} twin", on_step)
        del cache
    if any(drops):
        raise AssertionError(f"{what} twin: drops {drops} at cf = E")
    n = cfg.n_layers
    seq = [[torch.cat([prompt[l][j]] + [st[l][j].reshape(b, 1, -1)
                                        for st in steps], dim=1)
            for j in range(2)] for l in range(n)]
    del prompt
    torch.cuda.empty_cache()
    with RouteReplay(seq, steps[-1], b) as replay:
        served, want = decode_divergence(twin, toks, gen, logits)
        faults = decode_faults(twin, toks, gen, want, s + DECODE_STEPS)
    del want, seq, steps
    rec = dict(batch=b, prompt=s, capacity_factor=float(e),
               drop_fraction=max(drops), decode=dec, served=served,
               faults=faults, pinned_changed=replay.changed,
               pinned_decisions=replay.decisions)
    brief = {k: (round(r["max_abs_err"], 4), r["beyond_tol"])
             for k, r in faults.items()}
    log(f"{what} no-drop twin (cf {e}, B {b} × {s} + {DECODE_STEPS}): "
        f"decode against lm_prefill with decode's routes pinned max |Δ| "
        f"{served['max_abs_err']:.4g}, {served['beyond_tol']}/"
        f"{served['of']} beyond {DECODE_TOL}; the pin changed "
        f"{replay.changed} of {replay.decisions} routing decisions (each "
        f"within the paths' drift); faults {brief}")
    decode_gate(served, faults, f"{what} no-drop twin", MOE_TWIN_GATE)
    return rec


def p11_moe(dev, arch, plan):
    """One MoE LM at full width: its depth (planned, or from memory), the
    B × prompt prefill into a prompt + ``DECODE_STEPS`` cache through the
    flash twin (launches = layers, the first held within one rounding,
    timed beside SDPA), ``DECODE_STEPS`` greedy steps with the summed drop
    fractions, the served decode against ``lm_prefill`` (recorded), the
    decode step's split, the dispatch against its oracle and the no-drop
    twin's decode gate."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMStream
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    what = f"phase 11 {arch}"
    cfg = get_config(arch)
    rec = dict(arch=arch, full_layers=cfg.n_layers)
    n = plan["layers"]
    if n is None:
        n, rec["depth"] = moe_depth(dev, cfg, plan)
    cfg = dataclasses.replace(cfg, n_layers=n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.lm_init(cfg, seed=SEED, device=dev).requires_grad_(False)
    torch.cuda.synchronize()
    params = list(model.parameters())
    b, p = plan["batch"], plan["prompt"]
    rec.update(n_layers=n, params=sum(x.numel() for x in params),
               params_gb=sum(x.numel() * x.element_size()
                             for x in params) / 1e9,
               init_s=time.perf_counter() - t0,
               capacity_prefill=moe_lib.capacity(p, cfg.moe),
               capacity_decode=moe_lib.capacity(b, cfg.moe))
    del params
    toks = torch.from_numpy(LMStream(cfg.vocab_size, seed=SEED).batch(
        0, b, p)["tokens"][:, :p]).to(dev).long()
    # the timed prefill is not the first at its shapes (the products' and
    # the allocator's first calls)
    tf.lm_prefill(model, toks, max_len=plan["max_len"])
    torch.cuda.empty_cache()
    with MoETap() as mt:
        logits, cache, tap, rec["prefill"] = lm_prefill_held(
            model, toks, plan["max_len"], {"G": 0}, f"{what} prefill")
        rec["prefill"]["drop_fraction"] = mt.take_drops()
    rec["launches"] = rec["prefill"]["flash_launches"]
    rec["flash"] = {"G": flash_shape_times(dev, *tap.kept[0][:4])}
    del tap
    torch.cuda.empty_cache()
    step_drops = []
    with MoETap() as mt:
        gen, logits, rec["decode"] = lm_greedy_decode(
            model, cache, logits, p, what,
            lambda i: step_drops.append(mt.take_drops()))
    rec["decode"].update(cache_len=plan["max_len"], drop_fraction=dict(
        mean=sum(step_drops) / len(step_drops), max=max(step_drops),
        per_step=step_drops))
    del cache
    torch.cuda.empty_cache()
    with MoETap() as mt:
        rec["served_decode_vs_prefill"], want = decode_divergence(
            model, toks, gen, logits)
        rec["served_decode_vs_prefill"]["prefill_drop_fraction"] = \
            mt.take_drops()
    del want
    torch.cuda.empty_cache()
    rec["decode_split"] = moe_decode_split(dev, model, b,
                                           rec["decode"]["mean_step_ms"],
                                           what)
    rec["oracle"] = moe_oracle(dev, model, plan, what)
    torch.cuda.empty_cache()
    rec["twin"] = moe_twin_gate(dev, model, plan, what)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    pre, dec = rec["prefill"], rec["decode"]
    sv = rec["served_decode_vs_prefill"]
    log(f"{what}: {n} of {rec['full_layers']} layers, "
        f"{rec['params_gb']:.1f} GB of params; prefill B {b} × {p} "
        f"{pre['tokens_per_s']:.0f} tokens/s (C {rec['capacity_prefill']}, "
        f"drop fraction summed over the layers {pre['drop_fraction']:.4f}); "
        f"decode {dec['mean_step_ms']:.2f} ms a step "
        f"({dec['tokens_per_s']:.0f} tokens/s, C {rec['capacity_decode']}, "
        f"drop mean {dec['drop_fraction']['mean']:.4f}); served decode vs "
        f"lm_prefill max |Δ| {sv['max_abs_err']:.4g} "
        f"({sv['beyond_tol']}/{sv['of']} beyond, recorded); flash "
        f"{rec['flash']['G']['ms']:.3f} ms vs SDPA "
        f"{rec['flash']['G']['library_ms']:.3f}; peak {rec['peak_gb']:.1f} GB")
    del model
    torch.cuda.empty_cache()
    return rec


def gnn_excess(got, want, tol):
    """max |got − want| / (atol + rtol·|want|) and max |got − want|."""
    diff = (got.float() - want.float()).abs()
    return ((diff / (tol["atol"] + tol["rtol"] * want.float().abs()))
            .max().item(), diff.max().item())


def gnn_cpu_twin(model):
    """The model's CPU copy through the reference's layout."""
    from repro_torch import convert
    return convert.gnn_from_numpy(convert.gnn_to_numpy(model), model.cfg)


def gnn_run(dev, model, graph, host_graph, what):
    """Forward and loss on the card (timed) against the same on the CPU's
    copy of the model over ``host_graph`` (``GNN_FORWARD_TOL``,
    ``GNN_LOSS_RTOL``; raises)."""
    import torch
    from repro_torch.models import gnn as gnn_lib
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = gnn_lib.gnn_forward(model, graph)
    loss = gnn_lib.gnn_loss(model, graph)[0].item()
    ms = time_ms(lambda: gnn_lib.gnn_forward(model, graph), reps=3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    cpu = gnn_cpu_twin(model)
    want = gnn_lib.gnn_forward(cpu, host_graph)
    w_loss = gnn_lib.gnn_loss(cpu, host_graph)[0].item()
    cpu_s = time.perf_counter() - t0
    excess, err = gnn_excess(logits.cpu(), want, GNN_FORWARD_TOL)
    rec = dict(logits=list(logits.shape), forward_ms=ms, loss=loss,
               cpu_loss=w_loss, max_abs_err=err, excess=excess,
               cpu_forward_s=cpu_s, peak_gb=peak)
    if not (excess <= 1.0 and math.isfinite(loss)
            and abs(loss - w_loss) <= GNN_LOSS_RTOL * abs(w_loss)):
        raise AssertionError(f"{what}: card against CPU: logits max |Δ| "
                             f"{err:.3g} ({excess:.3g}× {GNN_FORWARD_TOL}),"
                             f" loss {loss} vs {w_loss}")
    return rec


def p11_minibatch(dev, cfg):
    """minibatch_lg: a reddit-size ``community_graph``, its CSR
    (``NeighborSampler``), one 1,024-seed (15, 10) sample padded to its
    bounds, forward and loss on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.data.graph_data import NeighborSampler, community_graph
    from repro_torch.models import gnn as gnn_lib
    dims = get_shape("gatedgcn", "minibatch_lg").dims
    n, e = dims["n_nodes"], dims["n_edges"]
    t0 = time.perf_counter()
    g = community_graph(n, e, dims["d_feat"], dims["n_classes"], seed=SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ns = NeighborSampler(g["edge_src"], g["edge_dst"], n)
    csr_s = time.perf_counter() - t0
    bn, (f1, f2) = dims["batch_nodes"], dims["fanout"]
    pad_nodes, pad_edges = bn * (1 + f1 + f1 * f2), bn * (f1 + f1 * f2)
    seeds = np.random.default_rng(SEED).choice(n, bn, replace=False)
    t0 = time.perf_counter()
    sub = ns.padded_batch(seeds, (f1, f2), g["x"], g["labels"],
                          pad_nodes=pad_nodes, pad_edges=pad_edges, seed=SEED)
    sample_s = time.perf_counter() - t0
    del g, ns
    model = gnn_lib.gnn_init(cfg, dims["d_feat"], dims["n_classes"],
                             seed=SEED, device=dev).requires_grad_(False)
    graph = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                 else v) for k, v in sub.items()}
    rec = dict(nodes=n, edges=e, gen_s=gen_s, csr_s=csr_s,
               sample_s=sample_s, seeds=bn, fanout=[f1, f2],
               pad_nodes=pad_nodes, pad_edges=pad_edges,
               sampled_nodes=int(sub["node_mask"].sum()),
               sampled_edges=int(sub["edge_mask"].sum()),
               **gnn_run(dev, model, graph, sub, "phase 11 minibatch_lg"))
    log(f"phase 11 gatedgcn minibatch_lg: graph {n} nodes / {e} edges "
        f"generated in {gen_s:.1f} s, CSR "
        f"{csr_s:.1f} s, sample {sample_s:.2f} s ({rec['sampled_nodes']} "
        f"nodes, {rec['sampled_edges']} edges in {pad_nodes} / {pad_edges});"
        f" forward {rec['forward_ms']:.2f} ms, loss {rec['loss']:.5f}, "
        f"against the CPU max |Δ| {rec['max_abs_err']:.3g} "
        f"({rec['excess']:.3f}× {GNN_FORWARD_TOL})")
    del model, graph
    torch.cuda.empty_cache()
    return rec


def p11_ogb(dev, cfg):
    """ogb_products full batch: every node, the edges cut to the largest
    count (a multiple of ``OGB_EDGE_STEP``, a prefix of the generated
    edges) whose
    forward fits ``GNN_MEMORY_SHARE`` of the card by two trial forwards'
    peaks; the forward timed, then run again with every layer (and the
    input and readout denses) held against the CPU on the first
    ``OGB_SLICE`` nodes: the CPU recomputes the layer from the card's
    inputs over the edges into those nodes (``GNN_TOL``; raises)."""
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.data.graph_data import community_graph
    from repro_torch.models import gnn as gnn_lib
    dims = get_shape("gatedgcn", "ogb_products").dims
    n, e_full = dims["n_nodes"], dims["n_edges"]
    t0 = time.perf_counter()
    full = community_graph(n, e_full, dims["d_feat"], dims["n_classes"],
                           seed=SEED)
    gen_s = time.perf_counter() - t0
    model = gnn_lib.gnn_init(cfg, dims["d_feat"], dims["n_classes"],
                             seed=SEED, device=dev).requires_grad_(False)
    nodes = {k: torch.from_numpy(full[k]).to(dev)
             for k in ("x", "node_mask", "labels", "label_mask")}
    src_all = torch.from_numpy(full["edge_src"])
    dst_all = torch.from_numpy(full["edge_dst"])
    del full

    def graph_of(ne):
        return dict(nodes, edge_src=src_all[:ne].to(dev).long(),
                    edge_dst=dst_all[:ne].to(dev).long(),
                    edge_mask=torch.ones(ne, dtype=torch.bool, device=dev),
                    edge_attr=None)
    peaks = {}
    for ne in OGB_TRIAL_EDGES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gnn_lib.gnn_forward(model, graph_of(ne))
        torch.cuda.synchronize()
        peaks[ne] = torch.cuda.max_memory_allocated() - base
    e0, e1 = OGB_TRIAL_EDGES
    per_edge = (peaks[e1] - peaks[e0]) / (e1 - e0)
    total = torch.cuda.get_device_properties(dev).total_memory
    room = GNN_MEMORY_SHARE * total - torch.cuda.memory_allocated()
    ne = int(e0 + (room - peaks[e0]) / per_edge) // OGB_EDGE_STEP * \
        OGB_EDGE_STEP
    ne = min(e_full, ne)
    graph = graph_of(ne)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = gnn_lib.gnn_loss(model, graph)[0].item()     # warms up, too
    ms = time_ms(lambda: gnn_lib.gnn_forward(model, graph), reps=1,
                 warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    split = gnn_layer_split(model, graph)
    log(f"phase 11 gatedgcn ogb_products: {n} nodes, {e_full} edges "
        f"generated in {gen_s:.1f} s; {per_edge:.0f} B an edge at the peak "
        f"→ {ne} edges ({ne / e_full:.1%}) fit {GNN_MEMORY_SHARE:.0%} of the "
        f"card; forward {ms:.1f} ms, loss {loss:.5f}, peak {peak:.1f} GB; "
        f"a layer's ops: { {k: round(v, 2) for k, v in split.items()} } ms")

    # the slice check: hooks on every layer and the two denses. The CPU
    # runs each layer on the slice's subgraph: its nodes first (ids
    # 0..sl-1, so they keep their ids), then the sources of the edges
    # into them; a slice node has all its in-edges there, so its output
    # is the full graph's
    cpu = gnn_cpu_twin(model)
    sl = OGB_SLICE
    sel = torch.nonzero(graph["edge_dst"] < sl).squeeze(1)
    src_sel = graph["edge_src"][sel]
    needed = torch.unique(torch.cat([torch.arange(sl, device=dev), src_sel]))
    sub = [torch.searchsorted(needed, src_sel).cpu(),
           graph["edge_dst"][sel].cpu()]
    del src_sel
    worst = dict(node_in=0.0, readout=0.0, layers=[0.0] * cfg.n_layers)
    errs = dict(node_in=0.0, readout=0.0, layers=[0.0] * cfg.n_layers)

    def dense_hook(name):
        def hook(mod, inputs, out):
            want = getattr(cpu, name)(inputs[0][:sl].cpu())
            worst[name], errs[name] = gnn_excess(out[:sl].cpu(), want,
                                                 GNN_TOL)
        return hook

    def layer_hook(i):
        def hook(mod, inputs, outputs):
            h, e, _, _, emask = inputs
            want_h, want_e = cpu.layers[i](h[needed].cpu(), e[sel].cpu(),
                                           *sub, emask[sel].cpu())
            xh, eh = gnn_excess(outputs[0][:sl].cpu(), want_h[:sl], GNN_TOL)
            xe, ee = gnn_excess(outputs[1][sel].cpu(), want_e, GNN_TOL)
            worst["layers"][i], errs["layers"][i] = max(xh, xe), max(eh, ee)
        return hook
    handles = ([model.node_in.register_forward_hook(dense_hook("node_in")),
                model.readout.register_forward_hook(dense_hook("readout"))]
               + [m.register_forward_hook(layer_hook(i))
                  for i, m in enumerate(model.layers)])
    t0 = time.perf_counter()
    try:
        logits = gnn_lib.gnn_forward(model, graph)
    finally:
        for h in handles:
            h.remove()
    check_s = time.perf_counter() - t0
    top = max([worst["node_in"], worst["readout"]] + worst["layers"])
    rec = dict(nodes=n, edges=e_full, edges_run=ne, gen_s=gen_s,
               trial_edges=list(OGB_TRIAL_EDGES),
               trial_peak_gb=[peaks[x] / 1e9 for x in OGB_TRIAL_EDGES],
               bytes_per_edge=per_edge, share=GNN_MEMORY_SHARE,
               forward_ms=ms, loss=loss, peak_gb=peak,
               layer_split_ms=split, logits=list(logits.shape),
               slice_nodes=sl, slice_subgraph_nodes=int(needed.numel()),
               slice_edges=int(sel.numel()), slice_excess=worst,
               slice_max_abs_err=errs, check_s=check_s)
    if not (top <= 1.0 and math.isfinite(loss)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"phase 11 ogb_products: the first {sl} nodes "
                             f"against the CPU, layer by layer: {worst} of "
                             f"{GNN_TOL}; loss {loss}")
    log(f"phase 11 gatedgcn ogb_products: nodes 0..{sl - 1} over "
        f"{sel.numel()} edges held against the CPU layer by layer: worst "
        f"{top:.3f}× {GNN_TOL} (max |Δ| {max(errs['layers']):.3g}) in "
        f"{check_s:.1f} s")
    del model, graph, nodes, logits, cpu
    torch.cuda.empty_cache()
    return rec


def gnn_layer_split(model, graph):
    """The first layer's ops at the graph's size, each timed alone on the
    graph's own node states: the two edge gathers, the four edge denses
    (A, B, C, V), the two scatter-adds into the nodes, and the whole
    layer."""
    import torch
    layer = model.layers[0]
    src, dst = graph["edge_src"], graph["edge_dst"]
    emask = graph["edge_mask"].float()[:, None]
    h = model.node_in(graph["x"])
    e = h.new_zeros((src.shape[0], h.shape[1]))
    n = h.shape[0]
    h_src = h.index_select(0, src)

    def run(ops):           # each result dropped at once: (E, d) each
        for op in ops:
            op()
    rec = dict(
        gathers=time_ms(lambda: run([lambda: h.index_select(0, src),
                                     lambda: h.index_select(0, dst)]),
                        reps=1),
        edge_denses=time_ms(lambda: run([lambda m=m: m(h_src) for m in (
            layer.A, layer.B, layer.C, layer.V)]), reps=1),
        scatters=time_ms(lambda: run([lambda: h.new_zeros(
            h.shape).index_add(0, dst, h_src)] * 2), reps=1))
    del h_src
    rec["layer"] = time_ms(lambda: layer(h, e, src, dst, emask), reps=1)
    return rec


def p11_molecule(dev, cfg):
    """molecule: 128 graphs of 30 nodes / 64 edges with 4 edge features,
    the ``graph_ids`` mean readout; forward and loss against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.data.graph_data import molecule_batch
    from repro_torch.models import gnn as gnn_lib
    dims = get_shape("gatedgcn", "molecule").dims
    mb = molecule_batch(dims["batch"], dims["n_nodes"], dims["n_edges"],
                        dims["d_feat"], seed=SEED)
    model = gnn_lib.gnn_init(cfg, dims["d_feat"], dims["n_classes"],
                             d_edge_in=mb["edge_attr"].shape[1], seed=SEED,
                             device=dev).requires_grad_(False)
    graph = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                 else v) for k, v in mb.items()}
    rec = dict(graphs=dims["batch"], nodes=int(mb["x"].shape[0]),
               edges=int(mb["edge_src"].shape[0]),
               **gnn_run(dev, model, graph, mb, "phase 11 molecule"))
    log(f"phase 11 gatedgcn molecule: {rec['graphs']} graphs "
        f"({rec['nodes']} nodes, {rec['edges']} edges) → logits "
        f"{rec['logits']}, forward {rec['forward_ms']:.3f} ms, loss "
        f"{rec['loss']:.5f}, against the CPU max |Δ| "
        f"{rec['max_abs_err']:.3g}")
    return rec


def p11_adafactor(dev):
    """One ``adafactor_update`` of an ``ADAFACTOR_SHAPE`` leaf, f32 and a
    bf16 copy, on the card against the same update on the CPU: f32
    params at rtol 1e-6 / atol 1e-7, bf16 params within one bf16 rounding
    (2^-7 of the value) and atol 1e-7, the factored state at rtol 1e-5
    (its means sum in another order); the card's update timed."""
    import torch
    from repro_torch.optim import make_optimizer
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    p0 = torch.randn(ADAFACTOR_SHAPE, generator=g, device=dev) * 0.03
    grad = torch.randn(ADAFACTOR_SHAPE, generator=g, device=dev)
    init, update = make_optimizer("adafactor")
    out = {}
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        p, gr = p0.to(dt, copy=True), grad.to(dt)
        p_cpu, g_cpu = p.cpu(), gr.cpu()
        st = init([p])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update([gr], st, [p], ADAFACTOR_LR)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        st_c = init([p_cpu])
        t0 = time.perf_counter()
        update([g_cpu], st_c, [p_cpu], ADAFACTOR_LR)
        cpu_s = time.perf_counter() - t0
        got, want = p.cpu().float(), p_cpu.float()
        diff = (got - want).abs()
        # bf16: one rounding apart, plus the f32 update's own difference
        # before the cast (≤ 1.5e-8 in the f32 run): where p ≈ lr·u
        # cancels, the two tiny results are far apart relative to
        # themselves
        ok = bool((diff <= 1e-7 + (1e-6 if dt == torch.float32
                                   else 2 ** -7) * want.abs()).all())
        state_err = max(
            ((st["v"][0][k].cpu() - st_c["v"][0][k]).abs()
             / st_c["v"][0][k].abs()).max().item() for k in ("vr", "vc"))
        rec = dict(first_ms=first_ms, cpu_s=cpu_s,
                   max_abs_err=diff.max().item(),
                   differing=int((diff > 0).sum()), of=int(diff.numel()),
                   state_max_rel_err=state_err)
        if not (ok and state_err <= 1e-5):
            raise AssertionError(f"phase 11 adafactor {name}: card against "
                                 f"CPU {rec}")
        rec["ms"] = time_ms(lambda: update([gr], st, [p], ADAFACTOR_LR),
                            reps=3)
        nbytes = 3 * p.numel() * p.element_size()
        rec["gb_per_s"] = nbytes / (rec["ms"] / 1e3) / 1e9
        out[name] = rec
        log(f"phase 11 adafactor {name} {list(ADAFACTOR_SHAPE)}: "
            f"{rec['ms']:.3f} ms an update ({rec['gb_per_s']:.0f} GB/s of "
            f"param + grad reads and param writes); against the CPU max "
            f"|Δ| {rec['max_abs_err']:.3g} ({rec['differing']} of "
            f"{rec['of']} differ), state {state_err:.3g}")
        del p, gr, p_cpu, g_cpu, st, st_c, got, want, diff
    return out


def phase11(dev):
    """The MoE LMs (moonshot at the depth that fits, kimi one layer), the
    GatedGCN on its three graphs and Adafactor, one model at a time (each
    freed before the next). The flash counter is zeroed before and read
    after each MoE prefill."""
    import torch
    from repro_torch.configs import get_config
    rec = dict(card=CARD, lm={}, launches={})
    with torch.no_grad():
        for arch, plan in MOE_PLANS.items():
            rec["lm"][arch] = p11_moe(dev, arch, plan)
            rec["launches"][arch] = rec["lm"][arch]["launches"]
        cfg = get_config("gatedgcn")
        rec["gnn"] = dict(minibatch_lg=p11_minibatch(dev, cfg),
                          ogb_products=p11_ogb(dev, cfg),
                          molecule=p11_molecule(dev, cfg))
    rec["adafactor"] = p11_adafactor(dev)
    rec["f32_flash_launches"] = sum(r["prefill"]["f32_flash_launches"]
                                    for r in rec["lm"].values())
    rec["peak_gb"] = max([r["peak_gb"] for r in rec["lm"].values()]
                         + [r["peak_gb"] for r in rec["gnn"].values()])
    return rec


# ---------------------------------------------------------------------------
# Phase 12: the substrate's trainer on the card, through the backward kernels
# ---------------------------------------------------------------------------


# flash backward against its plain version on the same inputs (the
# kernel's own o and lse) widened to f32: |kernel - plain_f32| ≤
# rel·|plain_f32| + FLASH_BWD_ATOL·max|plain_f32|, rel half a unit in the
# last place of the 16-bit types (one rounding of f32 sums, as
# FLASH_ONE_ROUNDING holds the forward) and FLASH_TOL's 2e-5 in f32; ≤ 1
# passes. The planted fault (the kernel given lse + FLASH_BWD_FAULT, every
# P off by 1%) must fail it.
FLASH_BWD_REL = {"float32": 2e-5, "bfloat16": 2 ** -8, "float16": 2 ** -11}
FLASH_BWD_ATOL = 1e-4
FLASH_BWD_FAULT = 1e-2
# (B, S, H, KV, D, causal, window): MHA and GQA, S not a multiple of the
# tiles, windows, D 16 to 128, causal and not; the second row crosses
# several of the kernels' 128-row blocks and 64-row tiles: ragged S (300,
# 333), a window straddling tile boundaries (S 520, window 130), 8 query
# heads a KV head, D 16 and 32
FLASH_BWD_SMALL = [(2, 100, 4, 4, 64, True, 0), (1, 77, 4, 2, 64, True, 0),
                   (2, 130, 8, 2, 64, True, 24), (1, 200, 2, 2, 128, True, 0),
                   (1, 129, 4, 1, 128, True, 40),
                   (1, 64, 2, 2, 128, False, 0),
                   (1, 90, 4, 2, 64, False, 17),
                   (1, 300, 4, 4, 64, True, 0), (1, 333, 2, 2, 128, True, 0),
                   (1, 520, 4, 2, 64, True, 130),
                   (1, 333, 16, 2, 64, True, 0), (1, 300, 4, 2, 16, True, 0),
                   (1, 333, 4, 2, 32, True, 0), (1, 300, 4, 4, 16, False, 0),
                   (1, 257, 4, 2, 32, False, 40)]
# stablelm-1.6b's layer at the trainer's 8 × 4,096 and gemma3-27b's local
# layer at 2 × 8,192 (window 1,024), bf16; both again in f32 (the f32
# kernels, three bf16 terms on wgmma: D 64 in the split shape, D 128 in the
# alternate one), read at the bf16 peak with the 67 TFLOP/s bound and the
# split's floor beside it
FLASH_BWD_MAIN = {"stablelm-1.6b": dict(b=8, s=4096, h=32, kv=32, d=64,
                                        window=0),
                  "gemma3-27b-local": dict(b=2, s=8192, h=32, kv=16, d=128,
                                           window=1024),
                  "stablelm-1.6b/f32": dict(b=8, s=4096, h=32, kv=32, d=64,
                                            window=0, dtype="float32"),
                  "gemma3-27b-local/f32": dict(b=2, s=8192, h=32, kv=16,
                                               d=128, window=1024,
                                               dtype="float32")}
# the f32 backward's products: six bf16 products for each of S, dP, dV, dK
# and dQ, S and dP in both kernels, each 2·d flops a pair
F32_BWD_PRODUCTS = 42
BWD_PLAIN_SCORES = 1 << 27       # f32 scores per block of the plain backward
DOT_BWD = dict(b=65_536, f=27, d=128)   # dlrm-mlperf's train_batch, f32
# (c): every family's reduced config, its gradients on the card against the
# same port code on the CPU (f32 compute, TF32 off, GRAD_TOL); gatedgcn on
# the molecule batch, whose edge features reach edge_in (the community
# graph has none, so edge_in and the first layer's C get no gradient there)
P12_FAMILIES = ("stablelm-1.6b", "gemma3-27b", "moonshot-v1-16b-a3b",
                "dlrm-mlperf", "xdeepfm", "bert4rec", "mind", "gatedgcn")
P12_GRAD_BATCH = dict(batch=4, seq_len=64, gnn_shape="molecule")
# (d): the trainer's entry point at stablelm-1.6b's full config, remat on
TRAIN_ARGS = ["--arch", "stablelm-1.6b", "--full", "--steps", "6",
              "--batch", "8", "--seq-len", "4096", "--microbatch", "2",
              "--log-every", "1"]
# (e): a 2-layer full-width stablelm stopped after RESUME_STOP steps and
# resumed, against a run straight through; the losses agree within
# RESUME_LOSS_RTOL (the embedding's gradient is a scatter with float
# atomics, so two runs on the card differ in the last bits)
RESUME_LAYERS = 2
RESUME_STOP, RESUME_STEPS = 3, 6
RESUME_ARGS = ["--arch", "stablelm-1.6b", "--full", "--batch", "8",
               "--seq-len", "1024", "--log-every", "1", "--ckpt-every",
               "100"]                # only each run's final state is saved
RESUME_LOSS_RTOL = 1e-3
# (f): dlrm-mlperf at its full widths and train_batch; each table capped
# at DLRM_TRAIN_MAX_ROWS so f32 params, gradients and AdamW's moments and
# temporaries (≈ 28 B an element at the update's peak) fit the card
DLRM_TRAIN_MAX_ROWS = 2_000_000
DLRM_TRAIN_ARGS = ["--arch", "dlrm-mlperf", "--full", "--batch", "65536",
                   "--steps", "4", "--log-every", "1"]
# (g): the others at full widths, each with its flags for launch.train.
# The recsys models at their train_batch (65,536 rows), in as many
# microbatches as the card needs: xdeepfm's CIN outer products take 20 GB
# a layer at 65,536 rows; bert4rec's softmax over 1,000,002 items takes
# 80 MB a row, so microbatches of 128 rows, one step, and 16,384 rows of
# the 65,536 (128 microbatches): at 65,536 its step took 33.9–34.7 s on an
# NVIDIA H100 80GB HBM3 at 700 W, its first step as long as its second,
# and the script sits near its time limit;
# mind's in-batch softmax is (B, B), 17 GB, and would change with
# microbatches, so one. moonshot with MOE_TRAIN_LAYERS of its 48 layers at
# the 4,096-token training sequence, as (d), in 4 microbatches. gatedgcn
# on the trainer's full_graph_sm graph (it has no batch).
MOE_TRAIN_LAYERS = 2
OTHER_STEPS = 4
OTHER_TRAIN = {
    "gatedgcn": [],
    "xdeepfm": ["--batch", "65536", "--microbatch", "4"],
    "bert4rec": ["--batch", "16384", "--microbatch", "128", "--steps", "1"],
    "mind": ["--batch", "65536"],
    "moonshot-v1-16b-a3b": ["--batch", "8", "--seq-len", "4096",
                            "--microbatch", "4"]}


def bwd_excess(got, want, dtype):
    """max |got − want| / (rel·|want| + FLASH_BWD_ATOL·max|want|)."""
    a = FLASH_BWD_ATOL * float(want.abs().max())
    return float(((got.float() - want).abs()
                  / (FLASH_BWD_REL[dtype] * want.abs() + a)).max())


def flash_bwd_plain(q, k, v, o, lse, do, kw):
    """``flash_attention_backward_plain`` on the inputs widened to f32, a
    sequence and a block of KV heads (at most ``BWD_PLAIN_SCORES`` scores)
    at a time → f32 ``(dq, dk, dv)``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    per = max(1, BWD_PLAIN_SCORES // (g * s * s))
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty(x.shape, **f32) for x in (q, k, v))
    for i in range(b):
        for j0 in range(0, n_kv, per):
            j1 = min(n_kv, j0 + per)
            hs, ks = slice(j0 * g, j1 * g), slice(j0, j1)
            r = fa.flash_attention_backward_plain(
                q[i:i + 1, :, hs].float(), k[i:i + 1, :, ks].float(),
                v[i:i + 1, :, ks].float(), o[i:i + 1, :, hs].float(),
                lse[i:i + 1, hs].contiguous(), do[i:i + 1, :, hs].float(),
                **kw)
            dq[i:i + 1, :, hs], dk[i:i + 1, :, ks], dv[i:i + 1, :, ks] = r
    return dq, dk, dv


def flash_bwd_gate(q, k, v, do, kw, what):
    """The forward with and without lse (outputs bit-equal), the backward
    kernel against the plain version (the gate), the planted fault (must
    fail it) → ``(record, kernel inputs)``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    causal, window = kw["causal"], kw["window"]
    dt = str(q.dtype).split(".")[1]
    o, lse = fa._launch(q, k, v, causal, window, True)
    if not torch.equal(o, fa._launch(q, k, v, causal, window, False)[0]):
        raise AssertionError(f"phase 12 (a) {what}: the forward's output "
                             f"changes when it writes lse")
    got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    bad = fa.flash_attention_backward(q, k, v, o, lse + FLASH_BWD_FAULT, do,
                                      **kw)
    torch.cuda.synchronize()
    want = flash_bwd_plain(q, k, v, o, lse, do, kw)
    rec = dict(excess={}, fault_excess={}, err=0.0)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, bad):
        rec["excess"][name] = bwd_excess(g, w, dt)
        rec["fault_excess"][name] = bwd_excess(x, w, dt)
        rec["err"] = max(rec["err"], float((g.float() - w).abs().max()))
    if not max(rec["excess"].values()) <= 1.0:
        raise AssertionError(f"phase 12 (a) {what}: |kernel − plain| is "
                             f"{rec['excess']}× the gate")
    if not min(rec["fault_excess"].values()) > 1.0:
        raise AssertionError(f"phase 12 (a) {what}: the planted lse fault "
                             f"passes the gate ({rec['fault_excess']})")
    del want, bad
    return rec, (o, lse)


def sdpa_backward_ms(q, k, v, do, kw):
    """SDPA's forward + backward minus its forward, under autograd, K/V
    expanded to the query heads (outside the timing)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    s, h = q.shape[1], q.shape[2]
    g = h // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    dot = do.transpose(1, 2)
    if kw["window"]:
        mask = fa.attention_mask(s, s, causal=True, window=kw["window"],
                                 device=q.device)
        fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask)
    else:
        fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
    t_fwd = time_ms(fwd, reps=3)
    t_both = time_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot),
                     reps=3)
    return dict(library_ms=t_both - t_fwd, library_fwd_ms=t_fwd,
                library_fwd_bwd_ms=t_both)


def p12_flash(dev):
    """(a) The flash backward kernels against their plain version: the
    small shapes in f32 / bf16 / fp16 (and once through
    ``FlashAttentionFn`` under autograd), then stablelm's and gemma3's
    local layer in bf16 and in f32, timed beside the bound, the plain
    version and SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(SEED)
    rec = dict(small={}, main={})
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for case in FLASH_BWD_SMALL:
            b, s, h, kv, d, causal, window = case
            q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
            do = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
            kw = dict(causal=causal, window=window)
            key = f"{str(dtype).split('.')[1]}/{b}x{s}/{h}-{kv}/d{d}/" \
                  f"{'causal' if causal else 'full'}/w{window}"
            rec["small"][key], _ = flash_bwd_gate(q, k, v, do, kw, key)
    # once under autograd, on the last small case: FlashAttentionFn
    # launches the forward with lse and the backward kernel, and gives the
    # kernel's gradients
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(fa.launches)
    out = fa.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    o, lse = fa._launch(q, k, v, kw["causal"], kw["window"], True)
    direct = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    n = {key: fa.launches[key] - before[key] for key in before}
    if n["flash_attention_backward"] != 2 or not all(
            torch.equal(a, b_) for a, b_ in zip(grads, direct)):
        raise AssertionError(f"phase 12 (a): FlashAttentionFn launches {n} "
                             f"or its gradients differ from the kernel's")
    worst = max(max(r["excess"].values()) for r in rec["small"].values())
    fault = min(min(r["fault_excess"].values())
                for r in rec["small"].values())
    log(f"phase 12 (a) flash backward, {len(rec['small'])} small cases: "
        f"largest excess {worst:.3f} of the gate, the planted lse fault at "
        f"least {fault:.2f}×")
    for name, c in FLASH_BWD_MAIN.items():
        b, s, h, kv, d, w = (c[x] for x in ("b", "s", "h", "kv", "d",
                                            "window"))
        q, k, v, do, kw = flash_bwd_main_inputs(g, dev, c)
        r, (o, lse) = flash_bwd_gate(q, k, v, do, kw, name)
        r["shape"] = [b, s, h, kv, d]
        r["window"] = w
        r["dtype"] = dt = c.get("dtype", "bfloat16")
        r["ms"] = flash_bwd_ms(q, k, v, o, lse, do, kw)
        r["forward_lse_ms"] = time_ms(lambda: fa._launch(
            q, k, v, True, w, True), reps=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flash_bwd_plain(q, k, v, o, lse, do, kw)
        torch.cuda.synchronize()
        r["plain_ms"] = (time.perf_counter() - t0) * 1e3
        r.update(sdpa_backward_ms(q, k, v, do, kw))
        pairs = causal_pairs(s, w) * h * b
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        # 5 products of 2·d flops per unmasked pair: S again, dP, dV, dK,
        # dQ; all on wgmma, the f32 ones in three bf16 terms: the bound at
        # the bf16 peak
        r.update(roof(nbytes, 10 * d * pairs, BF16_FLOPS_PER_S))
        f32_bounds = ""
        if dt == "float32":
            # beside it the CUDA cores' bound the earlier f32 kernels were
            # read against, and the split's floor at the wgmma rate
            r["bound_cuda_core_ms"] = roof(
                nbytes, 10 * d * pairs, F32_FLOPS_PER_S)["bound_ms"]
            r["split_floor_ms"] = (F32_BWD_PRODUCTS * 2 * d * pairs
                                   / BF16_FLOPS_PER_S * 1e3)
            f32_bounds = (f"; at 67 TFLOP/s {r['bound_cuda_core_ms']:.3f}, "
                          f"the split's floor {r['split_floor_ms']:.3f}")
        r["x_bound"] = r["ms"] / r["bound_ms"]
        rec["main"][name] = r
        record(f"phase 12 (a) flash backward {name} {dt} {b}×{s} H {h}/{kv} "
               f"D {d}"
               f" w {w}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f}, "
               f"×{r['x_bound']:.1f}{f32_bounds}; plain {r['plain_ms']:.1f}, SDPA "
               f"backward {r['library_ms']:.3f}); excess "
               f"{max(r['excess'].values()):.3f}, planted fault "
               f"{min(r['fault_excess'].values()):.2f}")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    rec["err"] = max(r["err"] for part in ("small", "main")
                     for r in rec[part].values())
    return rec


def flash_bwd_main_inputs(g, dev, c):
    """q, k, v, dO in the shape's dtype (bf16 unless it names one) from
    ``g`` and the mask's keywords of one ``FLASH_BWD_MAIN`` shape."""
    import torch
    b, s, h, kv, d = (c[x] for x in ("b", "s", "h", "kv", "d"))
    dtype = getattr(torch, c.get("dtype", "bfloat16"))
    q, k, v, do = (torch.randn(b, s, n, d, generator=g, device=dev,
                               dtype=dtype) for n in (h, kv, kv, h))
    return q, k, v, do, dict(causal=True, window=c["window"])


def flash_bwd_ms(q, k, v, o, lse, do, kw):
    """One flash backward launch's time (phase 12 (a) and ``--compare``)."""
    from repro_torch.kernels import flash_attention as fa
    return time_ms(lambda: fa.flash_attention_backward(
        q, k, v, o, lse, do, **kw), reps=3)


def dot_bwd_inputs(g, dev):
    """X and the pair gradient at ``DOT_BWD`` from ``g``, and the
    symmetric (B, F, F) matrix that one bmm multiplies X by."""
    import torch
    from repro_torch.kernels import dot_interaction as di
    b, f, d = DOT_BWD["b"], DOT_BWD["f"], DOT_BWD["d"]
    x = torch.randn(b, f, d, generator=g, device=dev)
    gr = torch.randn(b, f * (f - 1) // 2, generator=g, device=dev)
    iu, ju = di.triu_pairs(f, dev)
    gsym = torch.zeros((b, f, f), device=dev)
    gsym[:, iu, ju] = gr
    return x, gr, gsym + gsym.transpose(1, 2)


def dot_bwd_ms(x, gr, gsym):
    """The dot backward's time and the bmm's, ``(ms, library_ms)``
    (phase 12 (b) and ``--compare``)."""
    import torch
    from repro_torch.kernels import dot_interaction as di
    return (time_ms(lambda: di.dot_interaction_backward(x, gr), reps=10),
            time_ms(lambda: torch.bmm(gsym, x), reps=10))


def p12_dot(dev):
    """(b) The dot-interaction backward at dlrm-mlperf's train_batch (B
    65,536, F 27, d 128, f32) against its plain version, timed beside its
    bound, the plain version and one bmm with the symmetric matrix."""
    import torch
    from repro_torch.kernels import dot_interaction as di
    b, f, d = DOT_BWD["b"], DOT_BWD["f"], DOT_BWD["d"]
    x, gr, gsym = dot_bwd_inputs(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    got = di.dot_interaction_backward(x, gr)
    want = di.dot_interaction_backward_plain(x, gr)
    err = (got - want).abs()
    if (err > DOT_TOL + DOT_TOL * want.abs()).any():
        raise AssertionError(f"phase 12 (b): dot backward differs from plain"
                             f" by {err.max().item()}")
    ms, library_ms = dot_bwd_ms(x, gr, gsym)
    rec = dict(shape=[b, f, d], err=float(err.max()), ms=ms,
               plain_ms=time_ms(lambda: di.dot_interaction_backward_plain(
                   x, gr), reps=3),
               library_ms=library_ms)
    nbytes = (2 * x.numel() + gr.numel()) * 4
    rec.update(roof(nbytes, 2 * f * f * d * b, F32_FLOPS_PER_S))
    rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    record(f"phase 12 (b) dot backward B {b} F {f} d {d}: {rec['ms']:.3f} "
           f"ms (bound {rec['bound_ms']:.3f} by {rec['bound_by']}, "
           f"×{rec['x_bound']:.2f}; plain {rec['plain_ms']:.3f}, bmm "
           f"{rec['library_ms']:.3f}); max |Δ| {rec['err']:.3g}")
    return rec


def _named_leaves(params, prefix=""):
    """``{name: tensor}`` of a module's parameters or a nested dict's
    leaves (dotted paths)."""
    import torch
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, dict):
        return {n: t for k in sorted(params)
                for n, t in _named_leaves(params[k], f"{prefix}{k}.").items()}
    if isinstance(params, (list, tuple)):
        return {n: t for i, x in enumerate(params)
                for n, t in _named_leaves(x, f"{prefix}{i}.").items()}
    return {prefix[:-1]: params}


def _tree_to(tree, dev):
    """A nested dict / list of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    return tree.to(dev)


def _train_args(**kw):
    import argparse
    base = dict(batch=8, seq_len=128, seed=SEED, gnn_shape="full_graph_sm")
    base.update(kw)
    return argparse.Namespace(**base)


def p12_grads(dev):
    """(c) Every family's reduced config (LMs in f32, stablelm with remat):
    loss and every gradient leaf on the card against the same port code on
    the CPU, TF32 off; every leaf's card gradient nonzero; the flash and
    dot twins' forward and backward launched (the LMs' flash backward
    through its f32 kernels, one launch a layer)."""
    import copy
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import steps, train
    rec = {}
    for arch in P12_FAMILIES:
        cfg = reduced(get_config(arch))
        if cfg.family == "lm":
            cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                      remat=arch == "stablelm-1.6b")
        args = _train_args(**P12_GRAD_BATCH)
        init_fn, loss_fn, batch_fn = train._train_fns(cfg, args, "cpu")
        host = init_fn(SEED)
        batch = batch_fn(0)
        out = {}
        for side in ("cpu", dev):
            params = (copy.deepcopy(host).to(side)
                      if isinstance(host, torch.nn.Module)
                      else _tree_to(host, side))
            kops.reset_launch_counts()
            loss, _, grads = steps.loss_and_grads(
                loss_fn, params, train._on_device(batch, side))
            names = list(_named_leaves(params))
            out[str(side)] = (float(loss), dict(zip(names, grads)),
                              kops.launch_counts())
        (cl, cg, _), (gl, gg, launches) = out["cpu"], out[str(dev)]
        if abs(gl - cl) > GRAD_TOL[0] * max(1.0, abs(cl)):
            raise AssertionError(f"phase 12 (c) {arch}: loss {gl} on the "
                                 f"card, {cl} on the CPU")
        zero = [n for n, t in gg.items() if not bool(t.ne(0).any())]
        if zero:
            raise AssertionError(f"phase 12 (c) {arch}: no gradient on the "
                                 f"card for {zero}")
        worst = grads_close(gg, cg, zero_suffix=None if cfg.family == "lm"
                            else "wk.b")
        want = {}
        if cfg.family == "lm":
            # in f32: the f32 forward and backward kernels
            want = {"flash_attention": cfg.n_layers * (2 if cfg.remat else 1),
                    "flash_attention_backward": cfg.n_layers,
                    "flash_attention_backward_f32": cfg.n_layers}
        elif arch == "dlrm-mlperf":
            want = {"dot_interaction": 1, "dot_interaction_backward": 1}
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"phase 12 (c) {arch}: launches {launches},"
                                 f" want {want}")
        rec[arch] = dict(loss=gl, leaves=len(gg), worst_over_tol=worst,
                         launches={k: launches[k] for k in want},
                         f32_flash_launches=launches["flash_attention_f32"],
                         f32_flash_backward_launches=launches[
                             "flash_attention_backward_f32"])
    record(f"phase 12 (c) gradients on the card = the CPU's for "
           f"{len(rec)} families, every leaf nonzero: " + ", ".join(
               f"{a} {r['leaves']} leaves ×{r['worst_over_tol']:.2f}"
               for a, r in rec.items()))
    return rec


def flag(argv, name):
    """The int value of ``name`` in ``argv``."""
    return int(argv[argv.index(name) + 1])


def train_summary(text, what):
    import json
    line = next((x for x in text.splitlines() if x.startswith("summary ")),
                None)
    if line is None:
        raise AssertionError(f"phase 12 {what}: no summary line")
    return json.loads(line[len("summary "):])


def _medians(summary, skip=1):
    """Median step and split ms over the steps after the first ``skip``."""
    steps_ = summary["step_ms"][skip:] or summary["step_ms"]
    out = dict(step_ms=median(steps_))
    for k, xs in summary["split_ms"].items():
        xs = xs[skip:] or xs
        out[f"{k}_ms"] = median(xs)
    return out


def p12_stablelm(dev):
    """(d) ``python -m repro_torch.launch.train`` at stablelm-1.6b's full
    config (24 layers, remat) at 8 × 4,096 in 2 microbatches, as a
    subprocess: its loss falls, flash launches 2 forwards (remat) and one
    backward per layer and microbatch; step ms and its split, tokens/s,
    model FLOPs over the step and 989 TFLOP/s, peak GB."""
    import os
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-1.6b")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *TRAIN_ARGS], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=SUBPROCESS_TIMEOUT)
    wall = time.perf_counter() - t0
    tail = "\n".join(p.stdout.strip().splitlines()[-10:-1])
    log(f"phase 12 (d) launch.train {' '.join(TRAIN_ARGS)}: exit "
        f"{p.returncode} in {wall:.1f} s\n{tail}")
    if p.returncode:
        log(p.stderr[-4000:])
        raise AssertionError(f"phase 12 (d): exit code {p.returncode}")
    s = train_summary(p.stdout, "(d)")
    n_steps, b, seq, mb = (flag(TRAIN_ARGS, k) for k in (
        "--steps", "--batch", "--seq-len", "--microbatch"))
    want = {"flash_attention": cfg.n_layers * mb * 2 * n_steps,
            "flash_attention_backward": cfg.n_layers * mb * n_steps}
    if any(s["launches"][k] != n for k, n in want.items()):
        raise AssertionError(f"phase 12 (d): launches {s['launches']}, want "
                             f"{want}")
    losses = s["losses"]
    if not (losses[-1] < losses[0] and "(improved)" in p.stdout):
        raise AssertionError(f"phase 12 (d): the loss did not fall {losses}")
    rec = dict(wall_s=wall, losses=losses, launches=s["launches"],
               peak_gb=s["peak_gb"], n_params=s["n_params"],
               device_name=s["device_name"], step_ms_all=s["step_ms"],
               split_ms_all=s["split_ms"], **_medians(s))
    tokens = b * seq
    pairs = causal_pairs(seq, 0) * b * cfg.n_heads
    # 6·N·tokens for the dense products (forward + backward), N without the
    # input embedding (a gather; an untied unembedding stays, a product),
    # and the attention's 4·d per unmasked pair three times over
    rec["n_matmul_params"] = s["n_params"] - (
        0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    rec["model_flops"] = 6 * rec["n_matmul_params"] * tokens \
        + 3 * 4 * cfg.head_dim * pairs * cfg.n_layers
    rec["tokens_per_s"] = tokens / (rec["step_ms"] / 1e3)
    rec["flops_share"] = rec["model_flops"] / (rec["step_ms"] / 1e3) \
        / BF16_FLOPS_PER_S
    record(f"phase 12 (d) stablelm-1.6b full, {b} × {seq:,} ({mb} "
           f"microbatches, remat): step {rec['step_ms']:.0f} ms median (forward "
           f"{rec['forward_ms']:.0f}, backward {rec['backward_ms']:.0f}, "
           f"optimizer {rec['optimizer_ms']:.0f}), {rec['tokens_per_s']:.0f}"
           f" tokens/s, model FLOPs {rec['model_flops'] / 1e12:.1f} T = "
           f"{rec['flops_share']:.3f} of 989 TFLOP/s, peak "
           f"{rec['peak_gb']:.1f} GB; loss {losses[0]:.4f} -> "
           f"{losses[-1]:.4f}; launches {s['launches']}")
    return rec


class PatchedConfig:
    """``launch.train.get_config`` patched for the run: ``edit(cfg)``
    applied to the config it returns."""

    def __init__(self, edit):
        from repro_torch.launch import train
        self.train, self.real, self.edit = train, train.get_config, edit

    def __enter__(self):
        self.train.get_config = lambda arch: self.edit(self.real(arch))
        return self

    def __exit__(self, *exc):
        self.train.get_config = self.real


def p12_resume(dev, tmp):
    """(e) A 2-layer full-width stablelm: 6 steps straight through, and 3
    steps with ``--ckpt-dir``, a stop, and a resume to 6; the losses of
    both runs agree within ``RESUME_LOSS_RTOL``."""
    import os
    import shutil
    from repro_torch.launch import train
    ck = os.path.join(tmp, "resume_ckpt")
    edit = lambda c: dataclasses.replace(c, n_layers=RESUME_LAYERS)  # noqa
    with PatchedConfig(edit):
        whole = train_summary(run_main(train.main, RESUME_ARGS + [
            "--steps", str(RESUME_STEPS)], "(e) straight", "phase 12")[0],
            "(e)")
        first = train_summary(run_main(train.main, RESUME_ARGS + [
            "--steps", str(RESUME_STOP), "--ckpt-dir", ck], "(e) stop",
            "phase 12")[0], "(e)")
        text, _ = run_main(train.main, RESUME_ARGS + [
            "--steps", str(RESUME_STEPS), "--ckpt-dir", ck], "(e) resume",
            "phase 12")
        second = train_summary(text, "(e)")
    shutil.rmtree(ck, ignore_errors=True)
    if f"resumed from step {RESUME_STOP}" not in text:
        raise AssertionError("phase 12 (e): the run did not resume")
    got = first["losses"] + second["losses"]
    want = whole["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if len(got) != len(want) or max(rel) > RESUME_LOSS_RTOL:
        raise AssertionError(f"phase 12 (e): resumed losses {got} against "
                             f"{want}")
    rec = dict(losses_straight=want, losses_resumed=got, max_rel=max(rel),
               launches=second["launches"], first_launches=first["launches"],
               straight_launches=whole["launches"], **_medians(whole))
    record(f"phase 12 (e) resume at step {RESUME_STOP} of a {RESUME_LAYERS}"
           f"-layer full-width stablelm: losses within {max(rel):.2e} "
           f"(limit {RESUME_LOSS_RTOL}) of the straight run")
    return rec


def p12_dlrm(dev):
    """(f) dlrm-mlperf at full widths and its train_batch (tables capped at
    ``DLRM_TRAIN_MAX_ROWS``): one dot forward and one backward launch per
    step, rows/s."""
    from repro_torch.launch import train
    edit = lambda c: dataclasses.replace(c, table_sizes=tuple(  # noqa: E731
        min(v, DLRM_TRAIN_MAX_ROWS) for v in c.table_sizes))
    with PatchedConfig(edit):
        text, wall = run_main(train.main, DLRM_TRAIN_ARGS, "(f)",
                              "phase 12")
    s = train_summary(text, "(f)")
    n, b = flag(DLRM_TRAIN_ARGS, "--steps"), flag(DLRM_TRAIN_ARGS, "--batch")
    if (s["launches"]["dot_interaction"], s["launches"][
            "dot_interaction_backward"]) != (n, n):
        raise AssertionError(f"phase 12 (f): launches {s['launches']}, want "
                             f"{n} dot forward and backward")
    rec = dict(losses=s["losses"], launches=s["launches"],
               peak_gb=s["peak_gb"], n_params=s["n_params"],
               table_cap=DLRM_TRAIN_MAX_ROWS, **_medians(s))
    rec["rows_per_s"] = b / (rec["step_ms"] / 1e3)
    record(f"phase 12 (f) dlrm-mlperf B {b}, tables ≤ {DLRM_TRAIN_MAX_ROWS:,}"
           f" rows ({s['n_params'] / 1e9:.2f} B params): step "
           f"{rec['step_ms']:.1f} ms (forward {rec['forward_ms']:.1f}, "
           f"backward {rec['backward_ms']:.1f}, optimizer "
           f"{rec['optimizer_ms']:.1f}), {rec['rows_per_s']:.0f} rows/s, "
           f"peak {rec['peak_gb']:.1f} GB")
    return rec


def p12_others(dev):
    """(g) gatedgcn, xdeepfm, bert4rec and mind at full widths, the recsys
    models at their train_batch, moonshot at full widths with
    ``MOE_TRAIN_LAYERS`` layers at 8 × 4,096: a few steps each, ms a step
    and rows or tokens a second."""
    from repro_torch.launch import train
    rec = {}
    for arch, extra in OTHER_TRAIN.items():
        edit = (lambda c: dataclasses.replace(c, n_layers=MOE_TRAIN_LAYERS)
                ) if arch.startswith("moonshot") else (lambda c: c)
        argv = ["--arch", arch, "--full", "--steps", str(OTHER_STEPS),
                "--log-every", "1", *extra]
        with PatchedConfig(edit):
            text, wall = run_main(train.main, argv, f"(g) {arch}",
                                  "phase 12")
        s = train_summary(text, f"(g) {arch}")
        if not all(math.isfinite(x) for x in s["losses"]):
            raise AssertionError(f"phase 12 (g) {arch}: losses {s['losses']}")
        r = rec[arch] = dict(argv=argv, losses=s["losses"],
                             launches=s["launches"], peak_gb=s["peak_gb"],
                             n_params=s["n_params"], wall_s=wall,
                             **_medians(s))
        if extra:
            rows = flag(argv, "--batch") * (flag(argv, "--seq-len")
                                            if "--seq-len" in argv else 1)
            r["rows_per_s" if arch != "moonshot-v1-16b-a3b"
              else "tokens_per_s"] = rows / (r["step_ms"] / 1e3)
    record("phase 12 (g) " + "; ".join(
        f"{a} {r['n_params'] / 1e6:.1f}M params {r['step_ms']:.1f} ms a step"
        + "".join(f", {r[k]:.0f} {k[:-6]}/s" for k in (
            "rows_per_s", "tokens_per_s") if k in r)
        + f" (peak {r['peak_gb']:.1f} GB)" for a, r in rec.items()))
    return rec


def phase12(dev):
    """The substrate's trainer on the card: (a) the flash and (b) the dot
    backward kernels against their plain versions, (c) every family's
    gradients on the card against the CPU's, (d) launch.train at
    stablelm-1.6b's full config as a subprocess, (e) a resume, (f) DLRM at
    its train_batch, (g) the other families. The launches of (d)–(g), the
    trainer's runs, are the backward kernels' main-path counts."""
    import tempfile
    import torch
    rec = dict(card=CARD)
    t0 = time.perf_counter()
    rec["flash"] = p12_flash(dev)
    rec["dot"] = p12_dot(dev)
    rec["grads"] = p12_grads(dev)
    rec["checks_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rec["stablelm"] = p12_stablelm(dev)
    with tempfile.TemporaryDirectory() as tmp:
        rec["resume"] = p12_resume(dev, tmp)
    torch.cuda.empty_cache()
    rec["dlrm"] = p12_dlrm(dev)
    torch.cuda.empty_cache()
    rec["others"] = p12_others(dev)
    runs = [rec["stablelm"]["launches"], rec["resume"]["launches"],
            rec["resume"]["first_launches"],
            rec["resume"]["straight_launches"], rec["dlrm"]["launches"]] + [
        r["launches"] for r in rec["others"].values()]
    rec["launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    rec["peak_gb"] = max([rec["stablelm"]["peak_gb"], rec["dlrm"]["peak_gb"]]
                         + [r["peak_gb"] for r in rec["others"].values()])
    return rec


# ---------------------------------------------------------------------------
# Phase 13: the cell plans on a torch mesh
# ---------------------------------------------------------------------------

DE_ARCH = "list-dual-encoder"
DE_TRAIN_STEPS = 3               # contrastive steps at the batch that fits
ENCODE_REPS = 3
SERVE_REPS = 3
MINE_BLOCK = 1024                # queries per mining call, halved on OOM
REMAT_BATCH = 256                # (c): a batch both forms fit
REMAT_GRAD_TOL = 1e-5            # (c): of max|g|, if the bits differ
MOE_EP_TOKENS = (2, 512)         # (d): moonshot's expert shapes
PSUM_ELEMENTS = 4 << 20
PG_BACKEND = "nccl"              # the host mesh's process group


def meta_leaves(tree):
    """Every tensor of a plan's argument tree (modules' parameters,
    dicts, lists)."""
    import torch
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in meta_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in meta_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def p13_plans():
    """(a) ``plan_cell`` for every registered cell on the abstract
    production meshes: every argument on the meta device, the device's
    allocation unchanged."""
    import torch
    import warnings
    from repro_torch.configs import arch_ids, get_shapes
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    before = torch.cuda.memory_allocated()
    out = {}
    for multi_pod in (False, True):
        mesh = mesh_lib.abstract_production_mesh(multi_pod=multi_pod)
        t0 = time.perf_counter()
        ok, skip, n_meta = 0, 0, 0
        for arch in arch_ids():
            for s in get_shapes(arch):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    plan = steps.plan_cell(arch, s.name, mesh)
                if plan.skip:
                    skip += 1
                    continue
                leaves = meta_leaves(plan.args)
                if not callable(plan.fn) or not leaves or not all(
                        t.is_meta for t in leaves):
                    raise AssertionError(f"phase 13 (a): {arch}/{s.name} "
                                         f"plan has a non-meta argument")
                ok += 1
                n_meta += len(leaves)
        name = "x".join(map(str, mesh.sizes))
        out[name] = dict(ok=ok, skip=skip, meta_tensors=n_meta,
                         s=time.perf_counter() - t0)
        log(f"phase 13 (a): {name} mesh {mesh.axis_names}: {ok} plans OK, "
            f"{skip} SKIP, {n_meta} meta tensors, "
            f"{out[name]['s']:.2f} s")
        if ok + skip != 44 or skip != 4:
            raise AssertionError(f"phase 13 (a): {ok} OK + {skip} SKIP, "
                                 f"want 40 + 4")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("phase 13 (a): planning allocated device memory")
    return out


def de_model(cfg, dev, seed):
    """Seeded relevance model (drawn on the CPU, moved)."""
    import torch
    from repro_torch.core import relevance
    return relevance.relevance_init(
        cfg, torch.Generator().manual_seed(seed)).to(dev)


def de_tokens(rng, shape, cfg, dev):
    """Seeded tokens and masks of ``shape`` (rows of 8..max_len live)."""
    import numpy as np
    import torch
    L = cfg.max_len
    tok = rng.integers(1, cfg.vocab_size, shape + (L,)).astype(np.int32)
    lens = rng.integers(8, L + 1, shape)
    msk = np.arange(L) < lens[..., None]
    tok[~msk] = 0
    return torch.from_numpy(tok).to(dev), torch.from_numpy(msk).to(dev)


def de_batch(cfg, b, nneg, dev, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in (("q", (b,)), ("pos", (b,)), ("neg", (b, nneg))):
        out[f"{name}_tokens"], out[f"{name}_mask"] = de_tokens(rng, shape,
                                                               cfg, dev)
        out[f"{name}_loc"] = torch.from_numpy(
            rng.uniform(size=shape + (2,)).astype(np.float32)).to(dev)
    return out


def like_plan(args, real):
    """Raise unless the materialised ``real`` has the meta ``args``'
    shapes and dtypes, leaf for leaf."""
    got, want = meta_leaves(real), meta_leaves(args)
    if [(tuple(t.shape), t.dtype) for t in got] != [
            (tuple(t.shape), t.dtype) for t in want]:
        raise AssertionError("phase 13: materialised arguments differ from "
                             "the plan's")


def place_params(mesh, params, pspecs):
    """Each parameter through its spec's DTensor placements on ``mesh``
    (``sharding.leaf_specs``); on a world of one the local block is the
    whole parameter, bit for bit. → parameters placed."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as sh
    n = 0
    for p, spec in sh.leaf_specs(params, pspecs):
        dt = distribute_tensor(p.detach(), mesh,
                               sh.placements(mesh, spec, tuple(p.shape)))
        if not torch.equal(dt.to_local(), p.detach()):
            raise AssertionError("phase 13: a placed parameter's local "
                                 "block differs on a world of one")
        n += 1
    return n


def p13_train(dev, mesh, cfg):
    """contrastive_train with remat at the plan's batch, halved until one
    step fits (no microbatches: the loss's in-batch negatives would
    change), then DE_TRAIN_STEPS steps."""
    import gc
    import torch
    from repro_torch.launch import steps
    plan = steps.plan_cell(DE_ARCH, "contrastive_train", mesh)
    params_m, opt_m, batch_m = plan.args
    b_plan, nneg, L = batch_m["neg_tokens"].shape
    rel = de_model(cfg, dev, SEED + 13)
    like_plan(params_m, rel)
    placed = place_params(mesh, rel, plan.in_shardings[0])
    opt_state = plan_opt_init(plan, rel)
    like_plan(opt_m, opt_state)
    before = [p.detach().clone() for p in rel.parameters()]
    b, tried = b_plan, []
    losses, step_ms = [], []
    while True:
        batch = de_batch(cfg, b, nneg, dev, SEED + 14)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            _, opt_state, metrics = plan.fn(rel, opt_state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            break
        except torch.OutOfMemoryError:  # a trial batch's step
            pass
        tried.append(dict(batch=b, peak_gb=torch.cuda.max_memory_allocated()
                          / 1e9, error=f"OutOfMemoryError at batch {b}"))
        log(f"phase 13 (b): contrastive_train does not fit at batch {b} "
            f"({tried[-1]['peak_gb']:.1f} GB when it failed); halving")
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        b //= 2
        if b < 1:
            raise AssertionError("phase 13 (b): no batch fits")
    for _ in range(DE_TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        _, opt_state, metrics = plan.fn(rel, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(before, rel.parameters()))
    if not all(math.isfinite(x) for x in losses) or moved == 0:
        raise AssertionError(f"phase 13 (b): losses {losses}, "
                             f"{moved} parameters moved")
    tokens = b * L * (2 + nneg)
    ms = median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    rec = dict(plan_batch=b_plan, batch=b, cut=b != b_plan, tried=tried,
               hard_negs=nneg, max_len=L, step_ms=step_ms, ms=ms,
               tokens_per_step=tokens, tokens_per_s=tokens / ms * 1e3,
               peak_gb=peak, losses=losses, params_moved=moved,
               params_placed=placed, remat=cfg.remat)
    record(f"phase 13 (b): contrastive_train at batch {b} (plan {b_plan}) "
           f"× {L} tokens, {nneg} hard negatives, remat {cfg.remat}: steps "
           f"{', '.join(f'{x:.1f}' for x in step_ms)} ms, "
           f"{rec['tokens_per_s']:.0f} tokens/s, peak {peak:.1f} GB, "
           f"losses {losses}, {moved} parameters moved")
    del opt_state, batch
    return rec, rel


def plan_opt_init(plan, params):
    """The optimizer state of ``params`` as the plan's step initialises it
    (``steps._train_step``'s ``opt_init``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    return steps._train_step(None, get_config(plan.arch_id))[1](params)


def p13_encode(dev, mesh, cfg, rel):
    import numpy as np
    import torch
    from repro_torch.configs import SERVE_QUERIES
    from repro_torch.core import relevance
    from repro_torch.launch import steps
    plan = steps.plan_cell(DE_ARCH, "encode_corpus", mesh)
    params_m, tok_m, msk_m = plan.args
    b, L = tok_m.shape
    tok, msk = de_tokens(np.random.default_rng(SEED + 15), (b,), cfg, dev)
    like_plan((params_m, tok_m, msk_m), (rel, tok, msk))
    place_params(mesh, rel, plan.in_shardings[0])
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = time_ms(lambda: plan.fn(rel, tok, msk), reps=ENCODE_REPS)
        got = plan.fn(rel, tok, msk)
        want = relevance.encode_objects(rel, tok, msk)
    if got.shape != (b, cfg.d_model) or not torch.isfinite(got).all() \
            or not torch.equal(got, want):
        raise AssertionError("phase 13 (b): encode_corpus differs from "
                             "encode_objects on the same batch")
    n = SERVE_QUERIES["n_objects"]
    rec = dict(batch=b, max_len=L, ms=ms, tokens_per_s=b * L / ms * 1e3,
               objects_per_s=b / ms * 1e3,
               corpus_s=n / (b / ms * 1e3), corpus_objects=n,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    record(f"phase 13 (b): encode_corpus {b} × {L}: {ms:.1f} ms a batch, "
           f"{rec['tokens_per_s']:.0f} tokens/s; {n} objects would take "
           f"{rec['corpus_s']:.1f} s; bit-equal to encode_objects; peak "
           f"{rec['peak_gb']:.1f} GB")
    return rec


def serve_buffers(dev, c, cap, d, n_obj, seed):
    """``(emb (c, cap, d) f32 unit rows, loc, ids)``: ``n_obj`` objects
    in a seeded random order, spread evenly over the ``c`` clusters' first
    rows; the rest padding (ids −1, loc PAD_LOC, zero rows)."""
    import numpy as np
    import torch
    from repro_torch.core import index as index_lib
    gd = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(n_obj, generator=gd, device=dev).to(torch.int32)
    sizes = np.full(c, n_obj // c)
    sizes[:n_obj % c] += 1
    emb = torch.zeros((c, cap, d), device=dev)
    loc = torch.full((c, cap, 2), index_lib.PAD_LOC, device=dev)
    ids = torch.full((c, cap), -1, dtype=torch.int32, device=dev)
    start = 0
    for ci, n in enumerate(sizes.tolist()):
        emb[ci, :n] = torch.nn.functional.normalize(
            torch.randn(n, d, generator=gd, device=dev), dim=-1)
        loc[ci, :n] = torch.rand(n, 2, generator=gd, device=dev)
        ids[ci, :n] = perm[start:start + n]
        start += n
    return emb, loc, ids


def p13_serve(dev, mesh, cfg, rel):
    """serve_queries: the plan's ``dispatch_query_kernel`` over seeded
    buffers at the plan's (c, cap), against the dispatch path with the
    plain scan (``dispatch_scan_plain``) on the same inputs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.core import index as index_lib
    from repro_torch.core import relevance
    from repro_torch.kernels import fused_topk_score as fts
    from repro_torch.launch import steps
    plan = steps.plan_cell(DE_ARCH, "serve_queries", mesh)
    dims = get_shape(DE_ARCH, "serve_queries").dims
    (params_m, index_m, w_hat_m, norm_m, emb_m, loc_m, ids_m, tok_m, msk_m,
     qloc_m) = plan.args
    c, cap, d = emb_m.shape
    b = tok_m.shape[0]
    index = index_lib.index_init(d, c, torch.Generator().manual_seed(
        SEED + 16), hidden=cfg.index_mlp_hidden).to(dev)
    torch.cuda.reset_peak_memory_stats()
    emb, loc, ids = serve_buffers(dev, c, cap, d, dims["n_objects"],
                                  SEED + 17)
    norm = {"lo": torch.zeros(2, device=dev), "span": torch.ones(2,
                                                                 device=dev)}
    w_hat = rel.spatial["w_s"].detach()
    rng = np.random.default_rng(SEED + 18)
    tok, msk = de_tokens(rng, (b,), cfg, dev)
    qloc = torch.from_numpy(rng.uniform(size=(b, 2)).astype(
        np.float32)).to(dev)
    args = (rel, index, w_hat, norm, emb, loc, ids, tok, msk, qloc)
    like_plan(plan.args, args)
    with torch.no_grad():
        feats = index_lib.build_features(
            relevance.encode_queries(rel, tok, msk), qloc, norm)
        top_c, _ = index_lib.route_queries(index, feats,
                                           cr=cfg.cluster_route)
    loads = torch.bincount(top_c.reshape(-1).long(), minlength=c)
    fts.reset_launch_counts()
    ms = time_ms(lambda: plan.fn(*args), reps=SERVE_REPS)
    got_ids, got_sc = plan.fn(*args)
    torch.cuda.synchronize()
    launches = dict(fts.launches)
    calls = SERVE_REPS + 2              # time_ms's warm-up and reps, then one
    if dev.type == "cuda" and (launches["cluster_major"] != calls
                               or launches["routed"]):
        raise AssertionError(f"phase 13 (b): {calls} serve calls made "
                             f"launches {launches}")
    want_ids, want_sc, dropped = plain_dispatch(args, dims, cfg)
    got_ids, got_sc = got_ids.cpu().numpy(), got_sc.cpu().numpy()
    want_ids, want_sc = want_ids.cpu().numpy(), want_sc.cpu().numpy()
    # a query whose pair was dropped at the capacity is (−1, −inf) whole
    live = np.isfinite(want_sc).all(axis=1)
    if not (np.array_equal(np.isfinite(got_sc), np.isfinite(want_sc))
            and (got_ids[~live] == -1).all()
            and (want_ids[~live] == -1).all()):
        raise AssertionError("phase 13 (b): serve_queries' dropped pairs "
                             "differ from the plain scan's")
    err = topk_match(got_ids[live], got_sc[live], want_ids[live],
                     want_sc[live])
    rec = dict(queries=b, c=c, cap=cap, k=dims["topk"],
               cr=cfg.cluster_route, notes=plan.notes, ms=ms,
               queries_dropped=int((~live).sum()),
               distinct_clusters=int((loads > 0).sum()),
               max_load=int(loads.max()),
               qps=b / ms * 1e3, dropped_pairs=int(dropped),
               max_abs_err_vs_plain=err, launches=launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               buffer_gb=emb.numel() * 4 / 1e9)
    record(f"phase 13 (b): serve_queries {b} queries over ({c}, {cap}, "
           f"{d}) f32 buffers ({plan.notes}): {ms:.2f} ms, "
           f"{rec['qps']:.0f} q/s, {dropped} pairs dropped (the random "
           f"router: {rec['distinct_clusters']} clusters routed, the "
           f"largest {rec['max_load']} pairs), ids equal to "
           f"the plain scan's up to ties (max |Δs| {err:.2e}), launches "
           f"{launches}, peak {rec['peak_gb']:.1f} GB")
    return rec


def plain_dispatch(args, dims, cfg):
    """The serve cell's dispatch path with ``dispatch_scan_plain`` in the
    scan's place → ``(ids, scores, dropped pairs)``."""
    from repro_torch.core import serving
    real = serving.dispatch_scan
    serving.dispatch_scan = serving.dispatch_scan_plain
    try:
        ids, sc, dropped = serving.dispatch_query_kernel(
            *args, k=dims["topk"], cr=cfg.cluster_route, dist_max=1.4142,
            capacity=serving.query_capacity(dims["query_batch"],
                                            dims["n_clusters"],
                                            cfg.cluster_route),
            return_dropped=True)
    finally:
        serving.dispatch_scan = real
    return ids, sc, dropped


def window_match(rel, got, want, q_emb, q_loc, obj_emb, obj_loc):
    """Raise unless each row's window ids equal, or differ only where the
    scores tie (the same multiset of scores). → rows that differ."""
    import torch
    from repro_torch.core import relevance
    rows = (got != want).any(dim=1).nonzero().reshape(-1).tolist()
    for r in rows:
        def sc(i):
            return relevance.score_corpus(
                rel, q_emb[r:r + 1], q_loc[r:r + 1], obj_emb[i],
                obj_loc[i], dist_max=1.4142)[0]
        a, b = torch.sort(sc(got[r])).values, torch.sort(sc(want[r])).values
        if not torch.equal(a, b):
            raise AssertionError(f"phase 13 (b): mining row {r} differs "
                                 f"beyond ties")
    return len(rows)


def p13_mine(dev, mesh, cfg, rel):
    """mine_negatives: the plan's ``mine_negatives_dense`` (shards = the
    mesh's size) over the corpus in blocks of MINE_BLOCK queries (halved
    on OOM), against ``mine_negatives`` on the same rows."""
    import gc
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.core import pseudo_labels
    from repro_torch.launch import steps
    plan = steps.plan_cell(DE_ARCH, "mine_negatives", mesh)
    dims = get_shape(DE_ARCH, "mine_negatives").dims
    params_m, qe_m, ql_m, oe_m, ol_m = plan.args
    b, d = qe_m.shape
    n = oe_m.shape[0]
    gd = torch.Generator(device=dev).manual_seed(SEED + 19)
    unit = lambda m: torch.nn.functional.normalize(  # noqa: E731
        torch.randn(m, d, generator=gd, device=dev), dim=-1)
    q_emb, q_loc = unit(b), torch.rand(b, 2, generator=gd, device=dev)
    obj_emb = torch.empty((n, d), device=dev)
    for s in range(0, n, 1 << 18):
        obj_emb[s:s + (1 << 18)] = unit(min(1 << 18, n - s))
    obj_loc = torch.rand(n, 2, generator=gd, device=dev)
    like_plan(plan.args, (rel, q_emb, q_loc, obj_emb, obj_loc))
    block, tried = min(MINE_BLOCK, b), []
    while True:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            outs = []
            with torch.no_grad():
                for s in range(0, b, block):
                    outs.append(plan.fn(rel, q_emb[s:s + block],
                                        q_loc[s:s + block], obj_emb,
                                        obj_loc))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            break
        except torch.OutOfMemoryError:  # a trial block's call
            pass
        tried.append(dict(block=block, peak_gb=torch.cuda.max_memory_allocated()
                          / 1e9))
        outs = None
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 13 (b): mining does not fit {block} queries a call; "
            f"halving")
        block //= 2
        if block < 1:
            raise AssertionError("phase 13 (b): no mining block fits")
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = torch.cat(outs)
    del outs
    t0 = time.perf_counter()
    with torch.no_grad():
        want = pseudo_labels.mine_negatives(
            rel, q_emb, q_loc, obj_emb, obj_loc, neg_start=dims["neg_start"],
            neg_end=dims["neg_end"], dist_max=1.4142, batch_queries=block)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        if got.shape != want.shape:
            raise AssertionError(f"phase 13 (b): mined {tuple(got.shape)} "
                                 f"against {tuple(want.shape)}")
        tie_rows = window_match(rel, got, want, q_emb, q_loc, obj_emb,
                                obj_loc)
    rec = dict(queries=b, objects=n, window=(dims["neg_start"],
                                             dims["neg_end"]),
               block=block, cut=block != min(MINE_BLOCK, b), tried=tried,
               shards=steps.all_size(mesh),
               wall_s=wall, oracle_s=oracle_s, rows_differing_by_ties=tie_rows,
               peak_gb=peak)
    record(f"phase 13 (b): mine_negatives {b} queries × {n} objects, window "
           f"{dims['neg_start']}:{dims['neg_end']}, {block} queries a call: "
           f"{wall:.2f} s (mine_negatives {oracle_s:.2f} s), ids equal "
           f"({tie_rows} rows differ by ties), peak {peak:.1f} GB")
    return rec


def p13_remat(dev, cfg):
    """(c) One contrastive step's loss and gradients with remat off and on
    at REMAT_BATCH, and each one's peak memory."""
    import gc
    import torch
    from repro_torch.core import relevance
    from repro_torch.launch import steps
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        rel = de_model(c, dev, SEED + 20)
        batch = de_batch(c, REMAT_BATCH, 4, dev, SEED + 21)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _, grads = steps.loss_and_grads(
            lambda p, bt: relevance.contrastive_loss(p, bt), rel, batch)
        torch.cuda.synchronize()
        out[remat] = (loss, grads,
                      (torch.cuda.max_memory_allocated() - base) / 1e9)
        del rel, batch
    (l0, g0, p0), (l1, g1, p1) = out[False], out[True]
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(g0, g1)]
    scale = [float(a.float().abs().max()) for a in g0]
    equal = sum(torch.equal(a, b) for a, b in zip(g0, g1))
    rec = dict(batch=REMAT_BATCH, loss_equal=bool(torch.equal(l0, l1)),
               grads_equal=equal, grads=len(g0), max_grad_diff=max(diffs),
               peak_gb_no_remat=p0, peak_gb_remat=p1)
    record(f"phase 13 (c): remat at batch {REMAT_BATCH}: loss equal "
           f"{rec['loss_equal']}, {equal}/{len(g0)} gradients bit-equal "
           f"(largest difference {max(diffs):.3e}); peak above the "
           f"resident {p0:.2f} GB without remat, {p1:.2f} GB with")
    if not rec["loss_equal"] or any(
            dd > REMAT_GRAD_TOL * max(s, 1e-30) for dd, s in
            zip(diffs, scale)):
        raise AssertionError("phase 13 (c): remat changed the loss or a "
                             "gradient")
    if not p1 < p0:
        raise AssertionError("phase 13 (c): remat's peak is not lower")
    return rec


def p13_moe_psum(dev, mesh):
    """(d) On the world of one: the expert-parallel MoE against the local
    path at moonshot's expert shapes, and ``compressed_psum`` against its
    arithmetic on PSUM_ELEMENTS values."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import torch_dtype
    cfg = get_config("moonshot-v1-16b-a3b")
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    moe = moe_lib.moe_init(g, cfg.d_model, cfg.moe,
                           dtype=torch_dtype(cfg.param_dtype))
    b, s = MOE_EP_TOKENS
    x = torch.randn(b, s, cfg.d_model, generator=g, device=dev).to(
        torch_dtype(cfg.compute_dtype)).requires_grad_(True)
    res = {}
    # index_add and the gathers' backward add with atomics on the card:
    # their deterministic forms, so that two runs can be held bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for path in ("local", "expert_parallel"):
            if path == "local":
                out, aux = moe_lib._moe_apply_local(moe, x, cfg.moe)
            else:
                with sh.axis_rules(sh.rules_for_mesh(mesh)):
                    out, aux = moe_lib.moe_apply(moe, x, cfg.moe)
            loss = out.float().square().mean() + 0.01 * aux["lb_loss"]
            grads = torch.autograd.grad(loss, [moe.router, moe.w1, moe.w3,
                                               moe.w2, x])
            res[path] = (out.detach(),
                         {k: v.detach() for k, v in aux.items()}, grads)
    finally:
        torch.use_deterministic_algorithms(False)
    (o0, a0, g0), (o1, a1, g1) = res["local"], res["expert_parallel"]
    moe_rec = dict(tokens=b * s, experts=cfg.moe.n_experts,
                   top_k=cfg.moe.top_k, out_equal=bool(torch.equal(o0, o1)),
                   aux_equal=all(torch.equal(a0[k], a1[k]) for k in a0),
                   grads_equal=sum(torch.equal(a, c) for a, c in zip(g0, g1)),
                   drop_fraction=float(a1["drop_fraction"]))
    if not (moe_rec["out_equal"] and moe_rec["aux_equal"]
            and moe_rec["grads_equal"] == 5):
        raise AssertionError(f"phase 13 (d): expert-parallel MoE {moe_rec}")
    gr = torch.randn(PSUM_ELEMENTS, generator=g, device=dev)
    group = mesh.get_group("data")
    got = comp.compressed_psum(gr, group)
    q, sc, n = comp.quantize_int8(gr)
    want = comp.dequantize_int8(q.to(torch.int32).float() / 1.0, sc / 1.0,
                                n, gr.shape)
    ms = time_ms(lambda: comp.compressed_psum(gr, group))
    err = float((got - gr).abs().max())
    psum_rec = dict(elements=PSUM_ELEMENTS, bit_equal=bool(torch.equal(
        got, want)), max_err_vs_g=err, bound=float(gr.abs().max()) / 100,
        ms=ms)
    if not psum_rec["bit_equal"] or not err < psum_rec["bound"]:
        raise AssertionError(f"phase 13 (d): compressed_psum {psum_rec}")
    record(f"phase 13 (d): moonshot experts ({cfg.moe.n_experts}, top "
           f"{cfg.moe.top_k}) at {b} × {s} tokens: expert-parallel path "
           f"bit-equal to the local one (output, aux, 5 gradients); "
           f"compressed_psum of {PSUM_ELEMENTS} values bit-equal to its "
           f"arithmetic, max |Δ| {err:.3e} < {psum_rec['bound']:.3e}, "
           f"{ms:.3f} ms")
    return dict(moe=moe_rec, psum=psum_rec)


def phase13(dev):
    """The cell plans: (a) every cell planned on the abstract production
    meshes; (b) LIST's four cells executed through ``plan_cell`` on the
    host mesh (a world of one over PG_BACKEND, a ``file://`` store,
    destroyed at the end); (c) the encoder's remat off and on; (d) the
    expert-parallel MoE and ``compressed_psum`` on that world."""
    import gc
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    rec = dict(card=CARD)
    t0 = time.perf_counter()
    rec["plans"] = p13_plans()
    cfg = get_config(DE_ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(PG_BACKEND, init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = mesh_lib.make_host_mesh(device_type=dev.type)
            rec["mesh"] = dict(axis_names=list(mesh_lib.axis_names(mesh)),
                               sizes=mesh_lib.axis_sizes(mesh),
                               backend=PG_BACKEND)
            t1 = time.perf_counter()
            rec["contrastive_train"], rel = p13_train(dev, mesh, cfg)
            gc.collect()
            torch.cuda.empty_cache()
            rec["encode_corpus"] = p13_encode(dev, mesh, cfg, rel)
            rec["serve_queries"] = p13_serve(dev, mesh, cfg, rel)
            gc.collect()
            torch.cuda.empty_cache()
            rec["mine_negatives"] = p13_mine(dev, mesh, cfg, rel)
            rec["cells_s"] = time.perf_counter() - t1
            del rel
            gc.collect()
            torch.cuda.empty_cache()
            rec["remat"] = p13_remat(dev, cfg)
            rec["moe_psum"] = p13_moe_psum(dev, mesh)
        finally:
            dist.destroy_process_group()
    rec["launches"] = rec["serve_queries"]["launches"]
    rec["peak_gb"] = max(rec[k]["peak_gb"] for k in (
        "contrastive_train", "encode_corpus", "serve_queries",
        "mine_negatives"))
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# Phase 14: the dry-run and its analysis (launch/dryrun.py, analysis/)
# ---------------------------------------------------------------------------

DRYRUN_JOBS = 7                  # (a)'s worker processes (8 host cores)
DRYRUN_WANT = {"16x16": dict(OK=40, SKIP=4, FAIL=0),
               "2x16x16": dict(OK=40, SKIP=4, FAIL=0)}
PROFILE_BATCH = 256              # (d): the LIST cells profiled
PROFILE_CELLS = ("serve_queries", "contrastive_train")
PROFILE_TOP = 12
TIER_DTYPES = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}


def p14_dryrun():
    """(a) Every cell counted on both abstract production meshes."""
    import torch
    from repro_torch.launch import dryrun
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    results = dryrun.run(dryrun.all_cells(), [False, True], jobs=DRYRUN_JOBS,
                         verbose=False)
    secs = time.perf_counter() - t0
    counts = dryrun.summary(results)
    for name, c in counts.items():
        log(f"phase 14 (a): {name}: {c['OK']} OK, {c['SKIP']} SKIP, "
            f"{c['FAIL']} FAIL")
    for r in results:
        if r["status"] == "FAIL":
            log(f"phase 14 (a): FAIL [{r['mesh']}] {r['arch']} × "
                f"{r['shape']}: {r['error']}")
    if counts != DRYRUN_WANT:
        raise AssertionError(f"phase 14 (a): {counts}, want {DRYRUN_WANT}")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("phase 14 (a): the dry-run allocated device "
                             "memory")
    log(f"phase 14 (a): {len(results)} records in {secs:.1f} s with "
        f"{DRYRUN_JOBS} workers, no device memory allocated")
    cells = [[r["arch"], r["shape"], r["mesh"], r["flops_per_chip"],
              r["bytes_per_chip"], r["collectives"].get("total", 0.0),
              r["roofline"]["bottleneck"]]
             for r in results if r["status"] == "OK"]
    return dict(meshes=counts, s=secs, jobs=DRYRUN_JOBS, cells=cells)


def p14_flop_share(p13):
    """(b) LIST's four cells counted at phase 13's executed sizes on a
    (1, 1) mesh; each one's FLOPs over phase 13's seconds × the peak of
    its dtype."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((1, 1), ("data", "model"))
    tr, en, sv, mn = (p13[k] for k in ("contrastive_train", "encode_corpus",
                                       "serve_queries", "mine_negatives"))
    calls = -(-mn["queries"] // mn["block"])
    runs = {"contrastive_train": (dict(global_batch=tr["batch"]),
                                  tr["ms"] / 1e3, "bf16"),
            "encode_corpus": (dict(global_batch=en["batch"]),
                              en["ms"] / 1e3, "bf16"),
            "serve_queries": (dict(query_batch=sv["queries"]),
                              sv["ms"] / 1e3, "bf16"),
            "mine_negatives": (dict(query_batch=mn["block"]),
                               mn["wall_s"] / calls, "f32")}
    peaks = {"bf16": BF16_FLOPS_PER_S, "f32": F32_FLOPS_PER_S}
    out = {}
    for cell, (dims, secs, dt) in runs.items():
        rec = dryrun.run_cell(DE_ARCH, cell, mesh=mesh, dims=dims,
                              verbose=False)
        if rec["status"] != "OK":
            raise AssertionError(f"phase 14 (b): {cell}: {rec.get('error')}")
        share = rec["flops"] / (secs * peaks[dt])
        out[cell] = dict(dims=dims, flops=rec["flops"], bytes=rec["bytes"],
                         s=secs, peak=dt, flop_share=share,
                         kernels=rec["kernels"])
        record(f"phase 14 (b): {cell} at {dims}: {rec['flops']:.4e} FLOPs "
               f"(dry-run) in {secs * 1e3:.1f} ms (phase 13) = "
               f"{rec['flops'] / secs / 1e12:.1f} TFLOP/s, FLOP share "
               f"{share:.4f} of the {dt} peak")
    return out


def p14_work(p3, p4, p12, shapes):
    """(c) Each kernel row's ``work()`` at the shapes of phases 3, 4 and 12
    against the bytes and FLOPs their bounds counted, as integers."""
    import torch
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_topk_score as fts
    _, cap, d = shapes["scan"]
    rows = []
    router = p3["report"]["router"]
    for tier in TIERS:
        bd = router[tier]["bound"]
        rows.append((f"routed / cluster_major (phase 3, router, {tier})",
                     fts.scan_work(p3["batch"], d, p3["k"], cap=cap,
                                   distinct=router["U"],
                                   live_rows=bd["live_rows"],
                                   pairs=bd["pairs_scored"],
                                   dtype=getattr(torch, TIER_DTYPES[tier])),
                     bd))
    rep = p4["report"]
    for tier, rec in rep["gather"]["shapes"].items():
        rows.append((f"gather (phase 4, {tier})",
                     fts.gather_work(N_GATHER, shapes["n_cand"], d, 20,
                                     t=shapes["t"],
                                     dtype=getattr(torch, TIER_DTYPES[tier]),
                                     live=rec["live_rows"]), rec))
    for key, rec in rep["flash_attention"]["shapes"].items():
        name, dt = key.split("/")
        c = FLASH_CFGS[name]
        rows.append((f"flash_attention (phase 4, {key})",
                     fa.work(1, FLASH_S, c["h"], c["kv"], c["d"],
                             causal=True, window=c["window"],
                             dtype=getattr(torch, dt)), rec))
    for key, rec in rep["dot_interaction"]["shapes"].items():
        rows.append((f"dot_interaction (phase 4, {key})",
                     di.work(rec["batch"], DLRM["f"], DLRM["d"]), rec))
    for key, rec in rep["embedding_bag"]["shapes"].items():
        rows.append((f"embedding_bag (phase 4, {key})",
                     eb.work(DLRM["vocab"], DLRM["d"], rec["batch"],
                             DLRM["bag"], rows_touched=rec["rows_touched"],
                             valid=rec["valid_indices"]), rec))
    for key, rec in p12["flash"]["main"].items():
        b, s, h, kv, dh = rec["shape"]
        rows.append((f"flash_attention_backward (phase 12, {key})",
                     fa.backward_work(b, s, h, kv, dh, causal=True,
                                      window=rec["window"],
                                      dtype=getattr(torch, rec["dtype"])),
                     rec))
    b, f, dd = p12["dot"]["shape"]
    rows.append(("dot_interaction_backward (phase 12)",
                 di.backward_work(b, f, dd), p12["dot"]))
    out, bad = {}, []
    for what, (flops, nbytes), rec in rows:
        same = (int(flops) == rec["flops"] and int(nbytes) == rec["bytes"])
        out[what] = dict(flops=int(flops), bytes=int(nbytes), equal=same)
        if not same:
            bad.append(f"{what}: work() ({flops}, {nbytes}) against the "
                       f"bound's ({rec['flops']}, {rec['bytes']})")
    log(f"phase 14 (c): {len(rows) - len(bad)} of {len(rows)} kernel rows' "
        f"work() equal the bytes and FLOPs their phase's bound counted")
    if bad:
        raise AssertionError("phase 14 (c): " + "; ".join(bad))
    return out


def p14_profiles(dev):
    """(d) ``op_top`` on the card: one call of each ``PROFILE_CELLS`` cell
    at ``PROFILE_BATCH`` under ``torch.profiler``; each twin launched in
    the profiled call appears under its name, launch for launch."""
    import gc
    import torch
    from repro_torch.analysis import op_top
    out = {}
    for cell in PROFILE_CELLS:
        r = op_top.profile(DE_ARCH, cell, device=dev.type,
                           batch=PROFILE_BATCH, top=PROFILE_TOP)
        for line in op_top.report(r).splitlines():
            log(f"phase 14 (d) {line}")
        traced = {k: v["launches"] for k, v in r["twins"].items()}
        if traced != r["launches"]:
            raise AssertionError(f"phase 14 (d): {cell}: the profile shows "
                                 f"twins {traced}, the launch counters "
                                 f"gained {r['launches']}")
        out[cell] = {k: r[k] for k in ("batch", "device_ms", "top",
                                        "writers", "twins", "launches")}
        record(f"phase 14 (d): {cell} at batch {r['batch']}: "
               f"{r['device_ms']:.3f} ms of device time; twins {traced}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase14(dev, p3, p4, p12, p13, shapes):
    """The dry-run and its analysis: (a)–(d) of the module docstring."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rec = dict(card=CARD)
    rec["dryrun"] = p14_dryrun()
    rec["flop_share"] = p14_flop_share(p13)
    rec["work_check"] = p14_work(p3, p4, p12, shapes)
    rec["profiles"] = p14_profiles(dev)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# --compare's forward shapes (PERF.md §6 row 4), bf16, causal:
# (b, s, h, kv, d, window, with_lse) of phase 10's qwen2-7b and gemma3-27b
# layers, phase 11's moonshot and kimi layers and phase 12's stablelm-1.6b
# forward (the trainer's, writing lse)
FWD_COMPARE = {"qwen2-7b/1x32768": (1, 32_768, 28, 4, 128, 0, False),
               "qwen2-7b/8x4096": (8, 4096, 28, 4, 128, 0, False),
               "gemma3-27b-global/2x8192": (2, 8192, 32, 16, 128, 0, False),
               "gemma3-27b-local/2x8192": (2, 8192, 32, 16, 128, 1024, False),
               "moonshot-v1-16b-a3b/8x4096": (8, 4096, 16, 16, 128, 0, False),
               "kimi-k2-1t-a32b/2x4096": (2, 4096, 64, 8, 128, 0, False),
               "stablelm-1.6b/8x4096/lse": (8, 4096, 32, 32, 64, 0, True)}
# and the f32 body's: phase 4's qwen2-7b layer and three of the above, f32
FWD_COMPARE_F32 = {"qwen2-7b/1x2048": (1, 2048, 28, 4, 128, 0, False),
                   "qwen2-7b/8x4096": FWD_COMPARE["qwen2-7b/8x4096"],
                   "gemma3-27b-local/2x8192":
                       FWD_COMPARE["gemma3-27b-local/2x8192"],
                   "stablelm-1.6b/8x4096/lse":
                       FWD_COMPARE["stablelm-1.6b/8x4096/lse"]}


# --compare's route skews of the engine scans (``two``: the stand-in for
# phase 6's trained routes, U = 2)
COMPARE_SKEWS = ("router", "uniform", "zipf1.05", "two")


def compare(dev):
    """``--compare``: timings only, for two trees compared in turns on one
    card (parent / change / change / parent). The flash forward at
    ``FWD_COMPARE``'s and ``FWD_COMPARE_F32``'s shapes beside SDPA
    (``forward_turns``), the backward
    kernels at phase 12's shapes (``backward_turns``), then the scans
    (``scan_turns``): the gather scan on its full-width copies, the routed
    and cluster-major kernels on one 256-query chunk at ``COMPARE_SKEWS``,
    every tier, both at the int8 full fan-out, and the query walls with
    and without a delta (``delta_walls``). It calls only wrappers whose
    signatures the older tree shares, so a checkout of the parent with
    this script copied in runs it too."""
    return {"forward": forward_turns(dev), "backward": backward_turns(dev),
            **scan_turns(dev)}


def forward_turns(dev, turns=2, reps=10):
    """For ``--compare``: the flash forward at ``FWD_COMPARE``'s shapes on
    seeded bf16 inputs and at ``FWD_COMPARE_F32``'s on f32 ones, timed
    ``turns`` times each (CUDA events over ``reps`` launches), each turn
    beside SDPA on the same inputs (K/V expanded to the query heads outside
    the timing, the window's mask where there is one), with the bound of
    ``flash_attention.work`` at the bf16 peak (both bodies run on
    ``wgmma``). It calls only ``ops.flash_attention`` and
    ``flash_attention._launch`` with lse, which older trees share."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    out = {}
    shapes = [(name, torch.bfloat16, c) for name, c in FWD_COMPARE.items()]
    shapes += [(f"f32/{name}", torch.float32, c)
               for name, c in FWD_COMPARE_F32.items()]
    for name, dtype, (b, s, h, kv, d, w, with_lse) in shapes:
        q, k, v = (torch.randn(b, s, n, d, generator=g, device=dev,
                               dtype=dtype) for n in (h, kv, kv))
        if with_lse:
            run = lambda: fa._launch(q, k, v, True, w, True)  # noqa: E731
        else:
            run = lambda: kops.flash_attention(  # noqa: E731
                q, k, v, causal=True, window=w)
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(h // kv, dim=2).transpose(1, 2)
                  for x in (k, v))
        mask = (fa.attention_mask(s, s, causal=True, window=w, device=dev)
                if w else None)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, is_causal=mask is None)
        rec = dict(shape=[b, s, h, kv, d], window=w, with_lse=with_lse,
                   ms=[], library_ms=[])
        for _ in range(turns):
            rec["ms"].append(time_ms(run, reps=reps))
            rec["library_ms"].append(time_ms(lib, reps=reps))
        flops, nbytes = fa.work(b, s, h, kv, d, causal=True, window=w,
                                dtype=dtype, with_lse=with_lse)
        rec.update(roof(nbytes, flops, BF16_FLOPS_PER_S))
        if dtype == torch.float32:   # as phase 4 prints them
            rec["bound_cuda_core_ms"] = roof(nbytes, flops,
                                             F32_FLOPS_PER_S)["bound_ms"]
            rec["split_floor_ms"] = 6 * flops / BF16_FLOPS_PER_S * 1e3
        rec["x_bound"] = min(rec["ms"]) / rec["bound_ms"]
        rec["x_library"] = min(rec["ms"]) / min(rec["library_ms"])
        out[name] = rec
        log(f"compare flash forward {name}: {rec['ms']} ms (bound "
            f"{rec['bound_ms']:.3f}, ×{rec['x_bound']:.2f}), SDPA "
            f"{rec['library_ms']} ms")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return out


def scan_turns(dev):
    """For ``--compare``: the scans (see ``compare``)."""
    import torch
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import serving as serving_lib
    from repro_torch.core.snapshot import IndexSnapshot
    from repro_torch.kernels import fused_topk_score as fts
    fi = full_width_index(dev)
    bufs, c = fi["bufs"], fi["cfg"].n_clusters
    w_hat = IndexSnapshot.from_parts(fi["cfg"], fi["rel"], fi["index"],
                                     fi["norm"], bufs["f32"],
                                     dist_max=1.4142).w_hat
    chunk = [torch.from_numpy(a[:256]).to(dev)
             for a in (fi["tok"], fi["msk"], fi["q_loc"])]
    q_emb, w, top_router = engine_lib.make_prefix_fn(cr=2)(
        fi["rel"], fi["index"], fi["norm"], *chunk)
    ql = chunk[2]
    ctx = dict(buf32=bufs["f32"], buf8=bufs["int8"], w_hat=w_hat,
               q_emb=q_emb, ql=ql, w=w, top_c=top_router)
    qa, cand, cl, ci, _, _ = gather_inputs(ctx)
    out = {"gather": {}}
    for p, (ce, sc) in cand.items():
        rec = gather_times(qa, ce, sc, cl, ci, w_hat)
        out["gather"][p] = rec
        log(f"compare gather {p}: {rec['ms']:.3f} ms ({rec['x_bound']:.2f}x "
            f"bound {rec['bound_ms']:.3f} ms), plain {rec['plain_ms']:.3f} ms")
    del cand, cl, ci
    torch.cuda.empty_cache()
    for skew in COMPARE_SKEWS:
        top_c = skew_routes(skew, top_router, c=c, seed=SEED + 10)
        u, roster, _ = serving_lib.cluster_major_plan(top_c, n_clusters=c)
        for p, buf in bufs.items():
            kw = dict(k=20, dist_max=1.4142,
                      buf_scale=buf["scale"] if p == "int8" else None)
            bargs = (buf["emb"], buf["loc"], buf["ids"], w_hat)
            rec = dict(
                routed_ms=time_ms(lambda: fts.fused_topk_score_routed(
                    q_emb, ql, w, top_c, *bargs, **kw), reps=10),
                cluster_major_ms=time_ms(
                    lambda: fts.fused_topk_score_cluster_major(
                        q_emb, ql, w, u, roster, *bargs, cr=2, **kw),
                    reps=10))
            out[f"{skew}/{p}"] = rec
            log(f"compare {skew} {p}: routed {rec['routed_ms']:.3f} ms, "
                f"cluster_major {rec['cluster_major_ms']:.3f} ms")
    # the int8 full fan-out (cr = c): both kernels, and both query paths
    # (plan and fold included), as phase 3 times them
    fq = [x[:N_FAN] for x in chunk]
    qe_f, w_f, top_all = engine_lib.make_prefix_fn(cr=c)(
        fi["rel"], fi["index"], fi["norm"], *fq)
    u, roster, _ = serving_lib.cluster_major_plan(top_all, n_clusters=c)
    buf8 = bufs["int8"]
    kw = dict(k=20, dist_max=1.4142, buf_scale=buf8["scale"])
    bargs = (buf8["emb"], buf8["loc"], buf8["ids"], w_hat)
    fan = dict(
        routed_ms=time_ms(lambda: fts.fused_topk_score_routed(
            qe_f, fq[2], w_f, top_all, *bargs, **kw), reps=3),
        cluster_major_ms=time_ms(lambda: fts.fused_topk_score_cluster_major(
            qe_f, fq[2], w_f, u, roster, *bargs, cr=c, **kw), reps=3),
        **{f"path_{b}_ms": time_ms(lambda b=b: engine_lib._routed_topk(
            qe_f, fq[2], w_f, top_all, buf8, w_hat, k=20, backend=b,
            dist_max=1.4142, precision="int8"), reps=3)
           for b in ("cuda", "cuda-cm")})
    out["full_fan_out/int8"] = fan
    log(f"compare full fan-out int8 ({N_FAN} queries, cr = c = {c}): "
        f"{fan}")
    out["delta_walls_ms"] = delta_walls(dev, fi)
    return out


def backward_turns(dev, turns=3):
    """For ``--compare``: the flash backward at ``FLASH_BWD_MAIN``'s shapes
    and the dot backward at ``DOT_BWD`` beside bmm, each timed ``turns``
    times by phase 12's helpers on seeded inputs."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, c in FLASH_BWD_MAIN.items():
        q, k, v, do, kw = flash_bwd_main_inputs(g, dev, c)
        o, lse = fa._launch(q, k, v, True, kw["window"], True)
        out[name] = [flash_bwd_ms(q, k, v, o, lse, do, kw)
                     for _ in range(turns)]
        log(f"compare flash backward {name}: {out[name]} ms")
        del q, k, v, do, o, lse
    x, gr, gsym = dot_bwd_inputs(g, dev)
    out["dot"], out["bmm"] = map(list, zip(*(dot_bwd_ms(x, gr, gsym)
                                             for _ in range(turns))))
    log(f"compare dot backward: {out['dot']} ms, bmm {out['bmm']} ms")
    del x, gr, gsym
    torch.cuda.empty_cache()
    return out


def delta_walls(dev, fi, reps=2):
    """The query wall of the write path, for ``--compare``: 4,096 queries
    (batch 256, k 20, cr 2) on ``cuda`` and ``auto`` against the int8
    snapshot with a delta of ``N_INSERT`` seeded rows and ``N_VICTIM``
    seeded tombstones, and against the same snapshot without it. Built
    through ``DeltaSegment.from_leaves``, which older trees share."""
    import torch
    from repro_torch import api
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import index as index_lib
    from repro_torch.core.snapshot import IndexSnapshot
    buf8, cfg = fi["bufs"]["int8"], fi["cfg"]
    d, n = cfg.d_model, int(buf8["counts"].sum())
    g = torch.Generator().manual_seed(SEED + 12)
    raw = torch.nn.functional.normalize(torch.randn(N_INSERT, d, generator=g),
                                        dim=-1)
    stored, scale = index_lib.quantize_rows(raw, "int8")
    held = buf8["ids"][buf8["ids"] >= 0]
    gt = torch.Generator(device=dev).manual_seed(SEED + 11)
    tomb = held[torch.randperm(held.numel(), generator=gt, device=dev)[
        :N_VICTIM]].cpu().long()
    delta = delta_lib.DeltaSegment.from_leaves(d, "int8", {
        "emb": stored, "scale": scale,
        "loc": torch.rand(N_INSERT, 2, generator=g),
        "ids": torch.arange(n, n + N_INSERT, dtype=torch.int32), "raw": raw,
        "attrs": torch.zeros(N_INSERT, 3, dtype=torch.int32),
        "tombstones": tomb})
    parts = (cfg, fi["rel"], fi["index"], fi["norm"], buf8)
    snaps = {"delta": IndexSnapshot.from_parts(*parts, dist_max=1.4142,
                                               delta=delta),
             "delta_free": IndexSnapshot.from_parts(*parts, dist_max=1.4142)}
    tok, msk, q_loc = fi["tok"], fi["msk"], fi["q_loc"]
    out = {}
    for b in ("cuda", "auto"):
        for name, snap in snaps.items():
            s = api.Searcher(snap, backend=b, device=dev)
            s.query(tok[:256], msk[:256], q_loc[:256], k=20, cr=2, batch=256)
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.query(tok, msk, q_loc, k=20, cr=2, batch=256)
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}/{b}"] = walls
            log(f"compare wall int8 {name} {b}: {len(tok)} queries in "
                f"{', '.join(f'{w:.1f}' for w in walls)} ms")
    return out


def backward_rows(p12):
    """The kernels line's rows of the two backward kernels, from phase 12:
    ``launches`` on the trainer's runs (d)–(g), times at their main
    shapes."""
    csrc = "src/repro_torch/kernels/csrc/"
    note = ("backward; no Pallas counterpart: the reference differentiates "
            "its jnp path")
    flash = p12["flash"]["main"]
    main_f = flash["stablelm-1.6b"]
    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "x_bound", "shape", "window", "excess", "fault_excess",
              "library_fwd_ms", "library_fwd_bwd_ms", "forward_lse_ms",
              "dtype", "bound_cuda_core_ms", "split_floor_ms")
    dot = p12["dot"]
    return [
        {"name": "flash_attention_backward", "route": "cuda",
         "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:82",
         "replaces_note": note,
         "launches": p12["launches"]["flash_attention_backward"],
         "max_abs_err": p12["flash"]["err"], "ms": main_f["ms"],
         "plain_ms": main_f["plain_ms"], "bound_ms": main_f["bound_ms"],
         "bound_by": main_f["bound_by"], "library_ms": main_f["library_ms"],
         "library_note": "SDPA forward + backward minus SDPA forward",
         "shape": "stablelm-1.6b",
         "shapes": {k: {f: r[f] for f in fields if f in r}
                    for k, r in flash.items()},
         # the f32 kernels' launches (counted under
         # flash_attention_backward_f32 too) on the paths that run them
         "f32_launches": {
             "phase 12 (c)": sum(g["f32_flash_backward_launches"]
                                 for g in p12["grads"].values()),
             "phase 12 (d)-(g)": p12["launches"][
                 "flash_attention_backward_f32"]}},
        {"name": "dot_interaction_backward", "route": "cuda",
         "source": csrc + "dot_interaction.cu",
         "replaces": "src/repro/kernels/dot_interaction.py:26",
         "replaces_note": note,
         "launches": p12["launches"]["dot_interaction_backward"],
         "max_abs_err": dot["err"], "ms": dot["ms"],
         "plain_ms": dot["plain_ms"], "bound_ms": dot["bound_ms"],
         "bound_by": dot["bound_by"], "library_ms": dot["library_ms"],
         "library_note": "torch.bmm with the symmetric gradient matrix",
         "shape": dot["shape"]}]


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    bind_bounds()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    card = CARD = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import ops as kops
    global PROBES
    compare_only = "--compare" in sys.argv[1:]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # --compare runs on older trees too, and needs no probe
        if not compare_only:
            PROBES = probe_library()
            probe_build = pool.submit(PROBES.info)
        infos = kops.build_all()
        if not compare_only:
            infos[PROBES.name] = probe_build.result()
    log(f"phase 0: {len(infos)} libraries (kernels and memory probes) built "
        f"side by side in {time.perf_counter() - t0:.1f} s with loading")
    for name, info in infos.items():
        log(f"phase 0: {name} nvcc {info['seconds']:.1f} s -> {info['path']}")
        entry = "?"
        for line in info["log"].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif ("registers" in line or "spill" in line
                  or "C7518" in line):
                # C7518: ptxas serialised a kernel's wgmma (a branch that
                # differs between warpgroups sits between one and its wait)
                log(f"  ptxas {entry}:", line.strip())
    if compare_only:
        log(json.dumps({"card": card, "compare": compare(dev)}))
        return 0
    sass = flash_sass_check(infos["flash_attention"]["path"])
    log(f"phase 0: flash_attention SASS, HGMMA per 16-bit instantiation "
        f"and (HGMMA, UTMALDG) per f32 forward and backward kernel (D "
        f"16..128): {sass}")
    sass = scan_sass_check(infos["fused_topk_score"]["path"])
    log(f"phase 0: fused_topk_score SASS, (HGMMA, UTMALDG) per "
        f"engine_scan_kernel instantiation: {sass}")
    log(f"phase 0: the engine scans' shared-memory layout equals "
        f"launch_shape's mirror at {scan_layout_check()} launch shapes")

    t0 = time.perf_counter()
    err1 = phase1(dev)
    log(f"phase 1 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase2(dev)
    log(f"phase 2 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    p3 = phase3(dev)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{p3['peak_gb']:.1f} GB")
    t0 = time.perf_counter()
    ctx = p3.pop("ctx")
    # what phase 14 (c) declares the kernels' work at
    scan = tuple(ctx["buf32"]["emb"].shape)
    work_shapes = dict(scan=scan, t=ctx["w_hat"].numel(),
                       n_cand=ctx["top_c"].shape[1] * scan[1])
    p4 = phase4(dev, ctx)
    del ctx
    log(f"phase 4 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{p4['peak_gb']:.1f} GB")
    t0 = time.perf_counter()
    wctx = p3.pop("write_ctx")
    p5 = phase5(dev, wctx, p3["walls_ms"])
    log(f"phase 5 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{p5['peak_gb']:.1f} GB; launches {p5['launches']}")
    t0 = time.perf_counter()
    p6 = phase6(dev, p3.pop("skew_ctx"))
    log(f"phase 6 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{p6['peak_gb']:.1f} GB; launches {p6['launches']}")
    p3["report"]["trained"] = p6.pop("trained_row")
    t0 = time.perf_counter()
    p7 = phase7(dev, wctx, p6.pop("trained_snap"), p6.pop("trained_q"))
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{p7['peak_gb']:.1f} GB; launches {p7['launches']}")
    t0 = time.perf_counter()
    retriever, trained_corpus = (p6.pop("trained_retriever"),
                                 p6.pop("trained_corpus"))
    p8 = phase8(dev, wctx, retriever, trained_corpus)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{p8['peak_gb']:.1f} GB; launches (a) {p8['cli']['launches']}, (b) "
        f"{p8['dispatch']['launches']}")
    t0 = time.perf_counter()
    p9 = phase9(dev, wctx, retriever, trained_corpus)
    p9["phase_s"] = time.perf_counter() - t0
    del retriever, trained_corpus
    log(f"phase 9 took {p9['phase_s']:.1f} s; peak device memory "
        f"{p9['peak_gb']:.1f} GB; launches {p9['launches']}")
    # phase 10 needs the card to itself: the LIST phases' indexes go
    del wctx
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated before the substrate")
    t0 = time.perf_counter()
    p10 = phase10(dev)
    p10["phase_s"] = time.perf_counter() - t0
    log(f"phase 10 took {p10['phase_s']:.1f} s; peak device memory "
        f"{p10['peak_gb']:.1f} GB; launches {p10['launches']}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p11 = phase11(dev)
    p11["phase_s"] = time.perf_counter() - t0
    log(f"phase 11 took {p11['phase_s']:.1f} s; peak device memory "
        f"{p11['peak_gb']:.1f} GB; launches {p11['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p12 = phase12(dev)
    p12["phase_s"] = time.perf_counter() - t0
    log(f"phase 12 took {p12['phase_s']:.1f} s; peak device memory "
        f"{p12['peak_gb']:.1f} GB; launches {p12['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 13: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated before the cell plans")
    p13 = phase13(dev)
    log(f"phase 13 took {p13['phase_s']:.1f} s; peak device memory "
        f"{p13['peak_gb']:.1f} GB; launches {p13['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    p14 = phase14(dev, p3, p4, p12, p13, work_shapes)
    log(f"phase 14 took {p14['phase_s']:.1f} s; peak device memory "
        f"{p14['peak_gb']:.1f} GB")

    src = "src/repro_torch/kernels/csrc/fused_topk_score.cu"
    replaces = {"routed": "src/repro/kernels/fused_topk_score.py:314",
                "cluster_major": "src/repro/kernels/fused_topk_score.py:509"}
    kernels = []
    skews = p3["report"]
    for name in ("routed", "cluster_major"):
        main_rec = skews["router"]["f32"]
        row = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": p3["launches"][name],
            "max_abs_err": max([err1[name]] + [
                skews[sk][p][name]["err"] for sk in skews for p in TIERS] + (
                [p5["delta_scan"]["max_abs_err"]] if name == "routed" else [])
                + [p6["trained_own_row"][p][name]["err"] for p in TIERS]
                + ([p8["dispatch"][p]["err_vs_plain"] for p in TIERS]
                   if name == "cluster_major" else [])
                + [p9["max_abs_err_vs_plain"][name]]),
            "ms": main_rec[name]["ms"], "plain_ms": main_rec[name]["plain_ms"],
            "bound_ms": main_rec["bound"]["bound_ms"],
            "bound_by": main_rec["bound"]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a fused "
                            "score + top-k",
            "write_path_launches": p5["launches"][name],
            "build_launches": p6["launches"][name],
            "serving_launches": p7["launches"][name],
            "cli_launches": p8["cli"]["launches"][name],
            "dispatch_launches": p8["dispatch"]["launches"][name],
            "sharded_launches": p9["launches"][name],
            "cell_plan_launches": p13["launches"][name],
            "shape": {"queries": p3["batch"], "cr": p3["cr"], "k": p3["k"],
                      "precision": "f32", "skew": "router",
                      "distinct_clusters": p3["distinct_clusters"]},
            "skews": {sk: {p: {"ms": rec[p][name]["ms"],
                               "x_bound": rec[p][name]["x_bound"],
                               "plain_ms": rec[p][name].get("plain_ms"),
                               "bound_ms": rec[p]["bound"]["bound_ms"],
                               "bound_by": rec[p]["bound"]["bound_by"]}
                           for p in TIERS}
                      for sk, rec in skews.items()},
        }
        if name == "cluster_major":
            row["dispatch"] = {p: {f: p8["dispatch"][p][f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "x_bound",
                "err_vs_plain")} for p in TIERS}
        kernels.append(row)
    csrc = "src/repro_torch/kernels/csrc/"
    new = {"gather": ("fused_topk_score.cu",
                      "src/repro/kernels/fused_topk_score.py:173"),
           "flash_attention": ("flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:82"),
           "dot_interaction": ("dot_interaction.cu",
                               "src/repro/kernels/dot_interaction.py:26"),
           "embedding_bag": ("embedding_bag.cu",
                             "src/repro/kernels/embedding_bag.py:47")}
    for name, (cu, where) in new.items():
        r = p4["report"][name]
        main_rec = r["shapes"][r["main"]]
        entry = {
            "name": name, "route": "cuda", "source": csrc + cu,
            "replaces": where, "launches": p4["launches"][name],
            "max_abs_err": p4["err"][name], "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": r.get("library_ms", main_rec.get("library_ms")),
            "shape": r["main"],
            "shapes": {key: {f: v for f, v in rec.items()
                             if f in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "copy_ms",
                                      "routed_bit_equal", "err", "x_bound",
                                      "one_rounding", "library_one_rounding",
                                      "library_over_kernel", "l2_bound_ms",
                                      "bound_cuda_core_ms", "split_floor_ms",
                                      "l2_rates", "l2_rate_by",
                                      "share_of_bound")}
                       for key, rec in r["shapes"].items()}}
        if "library_note" in r:
            entry["library_note"] = r["library_note"]
        if name == "flash_attention":
            # the f32 body's own launches on each phase's path, and its
            # full-width launches against the plain version
            entry["f32_launches"] = {
                "phase 4": r["f32_launches"],
                "phase 10 decode checks": sum(
                    rec["decode_vs_prefill"]["f32_flash_launches"]
                    for rec in p10["lm"].values()),
                "phase 11": p11["f32_flash_launches"],
                "phase 12 (c)": sum(g["f32_flash_launches"]
                                    for g in p12["grads"].values())}
            entry["f32_full_width"] = r["f32_full_width"]
        if name != "gather":
            entry.update(substrate_row(name, p10, p11))
            entry["bench_launches"] = p4["launches"][name]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       entry.pop("substrate_err"))
            if name != "embedding_bag":
                entry["train_launches"] = p12["launches"][name]
        kernels.append(entry)
    kernels += backward_rows(p12)
    log(json.dumps({
        "card": card, "route_loads": p3["route_loads"], "qps": p3["qps"],
        "walls_ms": p3["walls_ms"], "picks": p3["picks"],
        "prefix_ms": p3["prefix_ms"],
        "skews": {sk: {"U": rec["U"], "max_load": rec["max_load"],
                       **{p: {"path_ms": rec[p]["path_ms"],
                              "bound": rec[p]["bound"]} for p in TIERS}}
                  for sk, rec in skews.items()},
        "full_fan_out": p3["fan_out"], "tombstone_mask_ms": p3["mask_ms"],
        "candidate_copy_check": p3["candidate_copy_check"],
        "memory_rates": p4["rates"],
        "peak_device_gb": p3["peak_gb"]}))
    bf = p5["brute_force"]
    log(json.dumps({"write_path": {
        "card": card,
        "compaction_ms": {p: r["compact_ms"] for p, r in
                          p5["compaction"].items()},
        "compaction": p5["compaction"],
        "delta_walls_ms": p5["delta_query"]["walls_ms"],
        "delta_free_walls_ms": p5["delta_query"]["delta_free_walls_ms"],
        "delta_launches": p5["delta_query"]["launches"],
        "delta_scan": p5["delta_scan"],
        "save_s": p5["save_load"]["save_s"],
        "save_gb_s": p5["save_load"]["save_gb_s"],
        "load_s": p5["save_load"]["load_s"],
        "load_gb_s": p5["save_load"]["load_gb_s"],
        "crc_gb_s": p5["save_load"]["crc_gb_s"],
        "artifact_bytes": p5["save_load"]["bytes"],
        "brute_force_s": bf["brute_force_s"],
        "brute_force_score_ms": bf["brute_force_score_ms"],
        "recall_at_10": bf["recall_at_10"], "corpus": {
            k: bf[k] for k in ("n_objects", "embed_s", "tokens",
                               "tokens_per_s", "capacity", "n_spilled",
                               "auto_picks", "cr_c_max_abs_err")},
        "launches": p5["launches"], "peak_device_gb": p5["peak_gb"]}}))
    own = p6.pop("trained_own_row")
    log(json.dumps({"build": dict(
        card=card, **p6,
        trained_own_buffers={
            "U": own["U"], "max_load": own["max_load"],
            **{p: {name: {f: own[p][name][f] for f in ("ms", "x_bound")}
                   for name in ("routed", "cluster_major")}
               | {"path_ms": own[p]["path_ms"],
                  "bound_ms": own[p]["bound"]["bound_ms"]}
               for p in TIERS}})}))
    log(json.dumps({"serving": dict(card=card, config=SERVE_CFG,
                                    zipf_a=ZIPF_A, concurrency=CONCURRENCY,
                                    **p7)}))
    log(json.dumps({"tools": dict(card=card, **{
        part: p8[part] for part in ("cli", "dispatch", "baselines",
                                    "subprocesses")},
        peak_device_gb=p8["peak_gb"])}))
    log(json.dumps({"sharded": p9}))
    log(json.dumps({"substrate": p10}))
    log(json.dumps({"moe_gnn": p11}))
    log(json.dumps({"train": p12}))
    log(json.dumps({"cell_plans": p13}))
    log(json.dumps({"dryrun": p14}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
