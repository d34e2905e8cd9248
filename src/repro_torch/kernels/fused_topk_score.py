"""Fused spatio-textual score + running top-k: the query phase's hot loop.

Three hand-written CUDA kernels for Hopper (``csrc/fused_topk_score.cu``),
each with its plain PyTorch version beside it:

* :func:`fused_topk_score_routed` replaces the Pallas kernel
  ``repro/kernels/fused_topk_score.py::fused_topk_score_routed`` (the
  reference engine's ``pallas`` backend). Plan-free: inside the launch,
  a counting sort on the device orders the batch's (query, route) pairs
  by cluster (:func:`routed_rows`), and work items are (cluster, row
  chunk, group of up to 16 of its pairs) (:func:`routed_items`), so a
  cluster chunk is read once per slot group, not once per query group.
  Each pair keeps its scan positions ``route·cap + row``; the chunk
  partials are merged by key into ``(B, k)``. Plain version:
  :func:`routed_topk_plain` (gather + one stable top-k).
* :func:`fused_topk_score_cluster_major` replaces
  ``fused_topk_score_cluster_major`` (the ``pallas-cm`` backend). The
  same kernel, its items (distinct routed cluster, row chunk, slot group)
  built on the device from the host plan's roster
  (:func:`cluster_major_items` is the same arithmetic). It writes one
  partial top-k list per (query, route) pair, which
  ``engine.merge_cluster_major`` folds per query. Plain version:
  :func:`cluster_major_partials_plain`.
* :func:`fused_topk_score` replaces the gather-path Pallas kernel
  ``fused_topk_score`` (``repro.kernels.ops.fused_topk_score``; no engine
  backend calls it). The caller materializes a per-query candidate copy
  ``(B, N, d)``: B "clusters" of capacity N, query b routed to cluster b
  alone. A tiled scan: work items of (query, row chunk) with one slot,
  rows through a cp.async ring onto the CUDA cores; the chunk partials
  are merged by key into local positions in ``[0, N)``. Plain
  version: :func:`gather_topk_plain` (:func:`gather_partials_plain` is
  the chunk arithmetic).

What bounds all three on an H100 is the bytes of the scanned embedding
rows. The engine scans stream a cluster chunk's live 64-row tiles by TMA
(tiles that are all padding are never fetched) and compute the (row,
slot) products with ``wgmma`` on the tensor cores: the queries split
once into three bf16 terms (:func:`query_terms`, :func:`split_terms`),
f32 rows into three as well, int8 rows widened exactly
(:func:`scan_dots_plain` is that arithmetic on the CPU). Each chunk's top k is kept behind a
threshold, and the chunk partials merged by key
(:func:`merge_partials_plain` is the plain version of that merge). See
the CUDA source for the design and its numerics; :func:`launch_shape`
sizes the engine scans' launches (slots per item shrinking as ``k``
grows, ``K_MAX`` the largest ``k``), :func:`gather_launch_shape` the
gather's.

Each wrapper sends a CPU tensor to the plain version and launches the
kernel for a CUDA tensor (or raises); ``launches`` counts kernel launches.
:func:`scan_work` (the routed and cluster-major scans) and
:func:`gather_work` declare the kernels' FLOPs and bytes; for ``meta``
tensors the wrappers launch nothing, return outputs of the kernel's
shapes on ``meta`` and record that work (``kernels.meta``), counting
every routed cluster distinct and full (a meta tensor holds no routes
or ids).
Scores follow the reference's contract: ``NEG_INF`` (-1e30) with id -1
past the last valid candidate, and equal scores rank in scan order (route,
then row), the tie rule of ``jax.lax.top_k``. The gather path returns
position -1 there instead of id -1.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import filters as filters_lib
from repro_torch.core import serving as serving_lib
from repro_torch.core import spatial as sp
from repro_torch.core.index import topk_stable
from repro_torch.kernels import build
from repro_torch.kernels import meta

NEG_INF = -1e30

# the widest embedding the kernels are held against their plain versions at
D_MAX = 1024

SMEM_MAX = 232_448               # shared memory one block may have (227 KB)
SMEM_TWO_PER_SM = 115_712        # the most two blocks of an SM may each have
MERGE_WARPS = 4                  # kMergeWarps: output rows per merge block
# partial lists per output row the merge takes: its list heads (one int
# each, per warp) fill at most SMEM_MAX
MERGE_LISTS_MAX = SMEM_MAX // (MERGE_WARPS * 4)

# the gather scan (its tiled CUDA-core body): kTile ... in csrc/fused_topk_score.cu
TILE_ROWS = 256                  # rows per tile: one row per thread
CHUNK_BYTES = 128                # bytes of each row one ring stage holds
STAGES = 2                       # the cp.async ring
GATHER_FIELDS = 16               # kGroup: per-slot fields of its layout
CAND_CAP = TILE_ROWS // 2        # candidates the slot takes per half tile
CHUNK_ROWS = 1024                # rows per work item

# the engine scans (routed, cluster-major): kScanTile ... in the CUDA source
SCAN_TILE = 64                   # object rows per wgmma tile (M)
STAGE_BYTES = 128                # bytes of a row per TMA stage (one box row)
SCAN_CHUNK = 1024                # rows per work item
SLOT_COUNTS = (32, 16, 8, 4, 2, 1)   # query slots per item, widest first
RING_MAX = 8                     # a warpgroup's TMA ring: at most,
RING_MIN = 6                     # at least while a slot count fits,
RING_FLOOR = 2                   # and where none fits RING_MIN
WARPGROUPS = (2, 1)              # consumer warpgroups of a block, most first
SLOT_MAX = 32                    # kSlotMax
FIELD_BYTES = 2560               # kFieldBytes: the per-slot fields
ITEM_RECORD = 16 + 4 * SLOT_MAX   # an item record: descriptor, slot pairs
Q_TERMS = 3                      # bf16 terms of a query or an f32 row (hi + mid + lo)

# kernel launches since the last reset, by kernel
launches = {"routed": 0, "cluster_major": 0, "gather": 0}

_EMB_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _bind(lib) -> None:
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.fts_routed.argtypes = ([ptr] * 5 + [i32] + [ptr] * 6 + [i32] * 8
                               + [f32] + [i32] * 4 + [i64, ptr, i32]
                               + [ptr] * 6)
    lib.fts_routed.restype = i32
    lib.fts_cluster_major.argtypes = ([ptr] * 6 + [i32] + [ptr] * 6
                                      + [i32] * 10 + [f32] + [i32] * 4
                                      + [i64, ptr, i32] + [ptr] * 6)
    lib.fts_cluster_major.restype = i32
    lib.fts_scan_smem.argtypes = [i32] * 6
    lib.fts_scan_smem.restype = i64
    lib.fts_gather.argtypes = ([ptr] * 4 + [i32] + [ptr] * 4 + [i32] * 5
                               + [f32, i32, i64] + [ptr] * 5)
    lib.fts_gather.restype = i32


# the compiled kernels; built by nvcc at first use (kernels/build.py)
_lib = build.KernelLibrary("fused_topk_score", ["fused_topk_score.cu"], _bind)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' oracles; the engine's dense backends)
# ---------------------------------------------------------------------------


def score_candidates(q_emb, q_loc, w_st, cand_emb, cand_loc, cand_ids, w_hat,
                     *, dist_max: float, cand_scale=None):
    """ST(q, o) (Eq. 5 serve form) of every query against every candidate.

    ``q_emb (..., Q, d)``, ``q_loc``/``w_st (..., Q, 2)`` against
    ``cand_emb (..., N, d)``, ``cand_loc (..., N, 2)``; ``cand_ids``
    broadcastable to ``(..., Q, N)``. Returns ``(..., Q, N)`` f32 with
    candidates of id < 0 at ``NEG_INF``. ``cand_scale (..., N)``
    dequantizes int8 rows as ``float(o) * scale`` before the product."""
    ce = cand_emb.float()
    if cand_scale is not None:
        ce = ce * cand_scale[..., None]
    trel = q_emb.float() @ ce.transpose(-1, -2)
    s_in = sp.s_in_from_locs(q_loc[..., :, None, :], cand_loc[..., None, :, :],
                             dist_max)
    srel = sp.spatial_relevance_serve(w_hat, s_in)
    st = w_st[..., :, 0:1] * trel + w_st[..., :, 1:2] * srel
    return torch.where(cand_ids >= 0, st, torch.full_like(st, NEG_INF))


def routed_topk_plain(q_emb, q_loc, w_st, top_c, buf_emb, buf_loc, buf_ids,
                      w_hat, *, k: int, dist_max: float, buf_scale=None,
                      buf_attrs=None, q_filt=None):
    """Gather the routed clusters' rows and take one stable top-k.

    Returns ``(scores (B, k) f32, ids (B, k) int32)`` global object ids;
    a row failing the filter takes the padding semantics (id -1 before
    scoring, so NEG_INF)."""
    b = q_emb.shape[0]
    tc = top_c.long()
    cand_emb = buf_emb[tc].reshape(b, -1, buf_emb.shape[-1])
    cand_loc = buf_loc[tc].reshape(b, -1, 2)
    cand_ids = buf_ids[tc].reshape(b, -1)
    cand_scale = None if buf_scale is None else buf_scale[tc].reshape(b, -1)
    if buf_attrs is not None:
        cand_attrs = buf_attrs[tc].reshape(b, -1, buf_attrs.shape[-1])
        ok = filters_lib.predicate_mask(cand_attrs, q_filt[:, None, :])
        cand_ids = torch.where(ok, cand_ids, torch.full_like(cand_ids, -1))
    st = score_candidates(q_emb[:, None], q_loc[:, None], w_st[:, None],
                          cand_emb, cand_loc, cand_ids[:, None], w_hat,
                          dist_max=dist_max,
                          cand_scale=cand_scale)[:, 0]          # (B, N)
    scores, pos = topk_stable(st, k)
    return scores, torch.gather(cand_ids, 1, pos).to(torch.int32)


def gather_topk_plain(q_emb, q_loc, w_st, cand_emb, cand_loc, cand_ids,
                      w_hat, *, k: int, dist_max: float, cand_scale=None):
    """Score a materialized candidate copy and take one stable top-k.

    Returns ``(scores (B, k) f32, positions (B, k) int32)``: local
    positions in ``[0, N)``; a masked row (id < 0) never enters the list,
    so slots past the last valid candidate are ``(NEG_INF, -1)``."""
    st = score_candidates(q_emb[:, None], q_loc[:, None], w_st[:, None],
                          cand_emb, cand_loc, cand_ids[:, None], w_hat,
                          dist_max=dist_max, cand_scale=cand_scale)[:, 0]
    scores, pos = topk_stable(st, k)
    pos = torch.where(torch.gather(cand_ids, 1, pos) >= 0, pos,
                      torch.full_like(pos, -1)).to(torch.int32)
    if pos.shape[1] < k:                        # fewer candidates than k
        pad = k - pos.shape[1]
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    return scores, pos


def _scatter_to_pairs(part_s, part_i, roster, n_total: int):
    """Roster-slot partials ``(u, Q, k)`` → one row per (query, route)
    pair ``(n_total, k)``; empty slots are dropped. The plan puts every
    pair in exactly one slot, so every row is written."""
    k = part_s.shape[-1]
    flat = roster.reshape(-1).long()
    back_s = torch.empty((n_total, k), dtype=torch.float32,
                         device=part_s.device)
    back_i = torch.empty((n_total, k), dtype=torch.int32,
                         device=part_s.device)
    live = flat < n_total
    back_s[flat[live]] = part_s.reshape(-1, k)[live]
    back_i[flat[live]] = part_i.reshape(-1, k).to(torch.int32)[live]
    return back_s, back_i


def cluster_major_partials_plain(q_emb, q_loc, w_st, u, roster, buf_emb,
                                 buf_loc, buf_ids, w_hat, *, k: int,
                                 dist_max: float, cr: int, buf_scale=None,
                                 buf_attrs=None, q_filt=None):
    """Per-(query, route) partial top-k lists of the cluster-major plan.

    ``u (u_max,)`` / ``roster (u_max, qcap)`` come from
    ``serving.cluster_major_plan``; query rows are ``roster // cr``.
    Each distinct cluster is gathered once and scored against its whole
    roster. Returns ``(scores (B·cr, k), ids (B·cr, k) int32)``, the
    row of pair ``o`` holding the partial list of its roster slot.

    Only roster rows with a live slot, and slots up to the last live one,
    are scored: the rest are empty by construction, and skipping them
    keeps the full-size plain version within device memory."""
    n_total = q_emb.shape[0] * cr
    c, cap, d = buf_emb.shape
    live = (roster >= 0) & (roster < n_total)
    rows = live.any(dim=1).nonzero().reshape(-1)
    cols = live.any(dim=0).nonzero().reshape(-1)
    q_len = int(cols.max()) + 1 if cols.numel() else 0
    u, roster, live = u[rows].long(), roster[rows, :q_len], live[rows, :q_len]
    qidx = serving_lib.roster_query_rows(roster, cr=cr, n_total=n_total).long()
    cand_ids = buf_ids[u][:, None]                          # (U, 1, cap)
    if buf_attrs is not None:
        ok = filters_lib.predicate_mask(buf_attrs[u][:, None],
                                        q_filt[qidx][:, :, None, :])
        cand_ids = torch.where(ok, cand_ids, torch.full_like(cand_ids, -1))
    cand_scale = None if buf_scale is None else buf_scale[u]
    st = score_candidates(q_emb[qidx], q_loc[qidx], w_st[qidx], buf_emb[u],
                          buf_loc[u], cand_ids, w_hat, dist_max=dist_max,
                          cand_scale=cand_scale)            # (U, Q, cap)
    st = torch.where(live[..., None], st, torch.full_like(st, NEG_INF))
    kk = min(k, cap)
    vals, pos = topk_stable(st, kk)
    ids = torch.gather(cand_ids.expand(st.shape), -1, pos)
    ids = torch.where(live[..., None], ids, torch.full_like(ids, -1))
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return _scatter_to_pairs(vals, ids, roster, n_total)


# ---------------------------------------------------------------------------
# The tiled scans' launch shape, work items and chunk partials (host side)
# ---------------------------------------------------------------------------


def _tile_smem(chunk_rows: int, k: int, elem_size: int, slots: int = 1) -> int:
    """Shared bytes of one block of the gather's tiled scan: ``tile_smem``
    in the CUDA source, field by field."""
    a16 = lambda x: -(-x // 16) * 16  # noqa: E731
    kce = CHUNK_BYTES // elem_size
    stage = a16(TILE_ROWS * CHUNK_BYTES + slots * kce * 4)
    return (stage * STAGES + a16(chunk_rows * 4)
            + a16((chunk_rows // TILE_ROWS + 1) * 4)
            + slots * CAND_CAP * 8             # candidate buffers
            + 2 * slots * k * 8                # double-buffered lists
            + GATHER_FIELDS * (8 + 8 + 16 + 16 + 5 * 4))  # per-slot fields


# the largest k of the scans: one slot's lists at a full chunk of int8 rows
# (the widest stage of query floats) fill a gather block's SMEM_MAX; the
# engine scans serve it too (launch_shape)
K_MAX = (SMEM_MAX - _tile_smem(CHUNK_ROWS, 0, 1)) // (2 * 8)


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} outside the scans' range [1, {K_MAX}]: "
                         f"one slot's sorted lists must fit shared memory")


def gather_launch_shape(*, cap: int, k: int, elem_size: int) -> dict:
    """The gather scan's launch over copies of ``cap`` candidates: rows
    per chunk (a multiple of the 256-row tile, at most the copy's),
    chunks, shared bytes per block, the blocks an SM holds and the most
    partial lists per output row the merge takes. d does not enter: rows
    stream through the ring 128 bytes at a time. Raises for k outside
    [1, K_MAX]."""
    _check_k(k)
    chunk = min(CHUNK_ROWS, -(-cap // TILE_ROWS) * TILE_ROWS)
    smem = _tile_smem(chunk, k, elem_size)
    return dict(chunk_rows=chunk, n_chunks=-(-cap // chunk), slots=1,
                smem_bytes=smem,
                blocks_per_sm=2 if smem <= SMEM_TWO_PER_SM else 1,
                merge_lists_max=MERGE_LISTS_MAX)


def stage_elems(elem_size: int) -> int:
    """Row elements one TMA stage (128 bytes) holds."""
    return STAGE_BYTES // elem_size


def b_blocks(d: int, elem_size: int) -> int:
    """64-wide blocks of the wgmma B operand's depth: the row's stages
    (``ceil(d·elem / 128)`` of ``stage_elems``), zero past d."""
    nk = -(-d * elem_size // STAGE_BYTES)
    return -(-nk * stage_elems(elem_size) // 64)


def scan_smem(d: int, k: int, elem_size: int, slots: int, stages: int,
              wgs: int = 2) -> int:
    """Shared bytes of one engine-scan block with ``wgs`` consumer
    warpgroups: ``scan_smem`` in the CUDA source, field by field. A ring
    of ``stages`` TMA boxes (64 rows × 128 bytes) per warpgroup, B
    (``b_blocks`` × 3N rows × 128 bytes: the three query terms of N
    slots, N = ``slots`` rounded up to 8), per warpgroup the
    double-buffered lists (``slots`` × k keys), the candidate buffers
    (``slots`` × 64 keys) and the per-slot fields, the item queue (two
    item records), the mbarriers, and 1024 bytes to align the rings."""
    n = max(8, slots)
    return (1024 + wgs * stages * SCAN_TILE * STAGE_BYTES
            + Q_TERMS * b_blocks(d, elem_size) * n * 128
            + wgs * (2 * slots * k * 8 + slots * SCAN_TILE * 8 + FIELD_BYTES)
            + 2 * ITEM_RECORD + (2 * wgs * stages + 4) * 8)


def launch_shape(*, cap: int, d: int, k: int, elem_size: int) -> dict:
    """The engine scans' launch over buffers of capacity ``cap`` and width
    ``d``: rows per chunk (a multiple of the 64-row tile, at most the
    buffer's), chunks per cluster, 64-row tiles per chunk, query slots per
    item and the wgmma's N (slots rounded up to 8; the product takes 3N
    columns), consumer warpgroups, each warpgroup's ring of TMA stages,
    shared bytes per block, the query terms' width and the merge's list
    cap (each item writes one partial list per slot and warpgroup).

    Two warpgroups with the most slots that fit a ring of RING_MIN stages
    each (16 slots, 7 stages at the main path's d 768 and k 20; 32 slots
    at narrow rows); else one warpgroup; where nothing fits RING_MIN (k
    in the thousands), one warpgroup, the most slots, the fewest stages
    down to RING_FLOOR. Stages: as many as fit, up to RING_MAX. Raises
    for k outside [1, K_MAX]."""
    _check_k(k)

    def fits(wgs, slots, stages):
        return scan_smem(d, k, elem_size, slots, stages, wgs) <= SMEM_MAX

    order = ([(w, g, RING_MIN) for w in WARPGROUPS for g in SLOT_COUNTS]
             + [(1, g, st) for st in range(RING_MIN - 1, RING_FLOOR - 1, -1)
                for g in SLOT_COUNTS])
    pick = next(((w, g) for w, g, st in order if fits(w, g, st)), None)
    if pick is None:
        raise ValueError(f"k={k} at d={d}: no engine-scan layout fits "
                         f"{SMEM_MAX} bytes")
    wgs, slots = pick
    stages = max(st for st in range(RING_FLOOR, RING_MAX + 1)
                 if fits(wgs, slots, st))
    chunk = min(SCAN_CHUNK, -(-cap // SCAN_TILE) * SCAN_TILE)
    return dict(chunk_rows=chunk, n_chunks=-(-cap // chunk),
                tiles=chunk // SCAN_TILE, slots=slots, n=max(8, slots),
                wgs=wgs, stages=stages,
                smem_bytes=scan_smem(d, k, elem_size, slots, stages, wgs),
                kb=b_blocks(d, elem_size), merge_lists_max=MERGE_LISTS_MAX)


def stage_perm(elem_size: int) -> torch.Tensor:
    """``stage_perm`` of the CUDA source for a stage of ``stage_elems``
    elements: the element each logical k index of the products reads. The
    identity for bf16 rows (wgmma reads them from shared memory); for A in
    registers (f32, int8) logical index ``16s + k`` reads element
    ``E/4·((k % 8) // 2) + 4s + 2·(k // 8) + k % 2``, so a thread's A
    values of a stage are E/4 contiguous elements of each of its rows."""
    e = stage_elems(elem_size)
    li = torch.arange(e)
    if elem_size == 2:
        return li
    s, kq = li // 16, li % 16
    return (e // 4) * ((kq % 8) // 2) + 4 * s + 2 * (kq // 8) + kq % 2


def split_terms(x: torch.Tensor, n: int) -> list:
    """``x`` (f32) as ``n`` bf16 terms, each the rounded residue of the
    ones before (``x_hi = RN(x)``, ``x_mid = RN(x − x_hi)``, ...): the
    kernel's split of a query and of an f32 row (3 terms each). Each
    difference is exact in f32 and bf16 keeps 8 significant bits, so what
    is left after n terms is at most ``2^(-8n)·|x|``."""
    terms, r = [], x.float()
    for _ in range(n):
        t = r.to(torch.bfloat16)
        terms.append(t)
        r = r - t.float()
    return terms


def query_terms(q: torch.Tensor, elem_size: int) -> torch.Tensor:
    """``split_q_kernel``'s output: ``q (B, d)`` f32 → ``(B, 3, 64·kb)``
    bf16 terms, each row's logical k index ``stage·E + i`` holding element
    ``stage·E + stage_perm[i]`` (zero past d)."""
    b, d = q.shape
    width = 64 * b_blocks(d, elem_size)
    e = stage_elems(elem_size)
    li = torch.arange(width)
    src = (li // e) * e + stage_perm(elem_size).to(li.device)[li % e]
    x = torch.where(src < d, q.float()[:, src.clamp(max=d - 1)],
                    torch.zeros((), device=q.device))
    return torch.stack(split_terms(x, Q_TERMS), dim=1)


def scan_dots_plain(q: torch.Tensor, emb: torch.Tensor, scale=None):
    """The engine scans' products by the kernel's arithmetic: ``q (..., B,
    d)`` f32 against rows ``emb (..., n, d)`` → ``(..., B, n)`` f32. The
    query as three bf16 terms, each its own column of the product; f32
    rows as three bf16 terms too (int8 and bf16 rows are exact in bf16),
    each against every query term; each product exact in f32, summed in f32
    per query term, the terms then added as (hi + mid) + lo; int8 rows
    times their ``scale (..., n)`` after the sum. Only the order of the
    sums within a term differs from the tensor cores'."""
    rt = (split_terms(emb, Q_TERMS) if emb.dtype == torch.float32
          else [emb.float().to(torch.bfloat16)])
    cols = [sum(t.float() @ r.float().transpose(-1, -2) for r in rt)
            for t in split_terms(q, Q_TERMS)]
    acc = (cols[0] + cols[1]) + cols[2]
    return acc if scale is None else acc * scale[..., None, :]


def routed_rows(top_c, *, c: int):
    """The routed scan's counting sort, as its device kernels build it:
    row ``r < c`` holds the (query, route) pairs ``p = q·cr + route``
    routed to cluster r, row c the routes to no cluster. Returns
    ``(count (c+1,), start (c+2,), order (B·cr,))`` int64, the pairs of
    row r at ``order[start[r]:start[r] + count[r]]`` (ascending here; the
    kernel's scatter may place them in any order: a pair's partial lists
    depend on its own scores alone)."""
    flat = top_c.reshape(-1).long()
    rows = torch.where((flat >= 0) & (flat < c), flat,
                       torch.full_like(flat, c))
    count = torch.bincount(rows, minlength=c + 1)
    start = torch.zeros(c + 2, dtype=torch.int64)
    start[1:] = torch.cumsum(count, 0)
    return count, start, torch.argsort(rows, stable=True)


def scan_items(groups, *, n_chunks: int):
    """Item offsets of a roster of ``groups[i]`` slot groups per row:
    row i takes ``groups[i]·n_chunks`` items from ``offsets[i]``,
    chunk-major (item ``offsets[i] + ch·groups[i] + g``). ``offsets``
    (rows + 1,) int64; ``offsets[-1]`` is the item count."""
    groups = torch.as_tensor(groups, dtype=torch.int64)
    offsets = torch.zeros(groups.numel() + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(groups * n_chunks, 0)
    return offsets


def scan_item(item: int, groups, offsets):
    """Item number → ``(row i, slot group g, chunk ch)``, by the kernel's
    binary search over ``offsets``."""
    i = int(torch.searchsorted(offsets, torch.tensor(item), right=True)) - 1
    local = item - int(offsets[i])
    return i, local % int(groups[i]), local // int(groups[i])


def routed_items(top_c, *, c: int, n_chunks: int, slots: int = SLOT_MAX):
    """The routed scan's work items, by its device arithmetic: per row of
    :func:`routed_rows`, ``ceil(count / slots)`` slot groups of its pairs
    in order. Returns a list of ``(cluster or -1, chunk, [pairs])`` in
    item order (-1: the routes to no cluster, whose partials are
    empty)."""
    count, start, order = routed_rows(top_c, c=c)
    groups = (count + slots - 1) // slots
    offsets = scan_items(groups, n_chunks=n_chunks)
    items = []
    for item in range(int(offsets[-1])):
        i, g, ch = scan_item(item, groups, offsets)
        lo = int(start[i]) + g * slots
        hi = min(int(start[i] + count[i]), lo + slots)
        items.append((i if i < c else -1, ch, order[lo:hi].tolist()))
    return items


def cluster_major_items(roster, *, n_total: int, n_chunks: int,
                        slots: int = SLOT_MAX):
    """The cluster-major scan's work items, as its two plan kernels
    build them on the device: roster row ``i`` has ``groups[i] =
    ceil((last live slot + 1) / slots)`` slot groups and ``n_chunks`` row
    chunks (:func:`scan_items`). Returns ``(groups (u_max,), offsets
    (u_max + 1,))`` int64; ``offsets[-1]`` is the item count."""
    live = (roster >= 0) & (roster < n_total)
    slot = torch.arange(roster.shape[1], device=roster.device)
    last = torch.where(live, slot, torch.full_like(slot, -1)).amax(dim=1) \
        if roster.shape[1] else torch.full((roster.shape[0],), -1)
    groups = (last.long() + slots) // slots
    return groups, scan_items(groups.cpu(), n_chunks=n_chunks)


def chunk_partials_plain(st, ids, *, k: int, chunk_rows: int, pos0=None):
    """Scores ``st (..., L, n)`` of ``L`` scanned rows lists with ids
    ``(..., L, n)`` → the kernels' chunk partials: per list and chunk of
    ``chunk_rows`` rows, the top k by (score desc, row asc), as ``(scores,
    pos, ids)`` of shape ``(..., L·n_chunks, k)``; ``pos`` is the scan
    position ``pos0[l] + row`` (``pos0`` defaults to 0). Masked rows (id <
    0) never enter: their slots are ``(NEG_INF, -1, -1)``."""
    *lead, n_lists, n = st.shape
    n_chunks = -(-n // chunk_rows)
    pad = n_chunks * chunk_rows - n
    st = torch.where(ids >= 0, st, torch.full_like(st, NEG_INF))
    st = torch.nn.functional.pad(st, (0, pad), value=NEG_INF)
    ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    st = st.reshape(*lead, n_lists, n_chunks, chunk_rows)
    ids = ids.reshape(*lead, n_lists, n_chunks, chunk_rows)
    kk = min(k, chunk_rows)
    vals, local = topk_stable(st, kk)
    row = local + torch.arange(n_chunks, device=st.device)[:, None] * chunk_rows
    pos = row if pos0 is None else row + pos0.reshape(n_lists, 1, 1)
    got_ids = torch.gather(ids, -1, local)
    real = got_ids >= 0
    vals = torch.where(real, vals, torch.full_like(vals, NEG_INF))
    pos = torch.where(real, pos, torch.full_like(pos, -1))
    got_ids = torch.where(real, got_ids, torch.full_like(got_ids, -1))
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        pos = torch.nn.functional.pad(pos, (0, k - kk), value=-1)
        got_ids = torch.nn.functional.pad(got_ids, (0, k - kk), value=-1)
    shape = (*lead, n_lists * n_chunks, k)
    return vals.reshape(shape), pos.reshape(shape), got_ids.reshape(shape)


def merge_partials_plain(scores, pos, ids, *, k: int):
    """The kernels' merge of chunk partials ``(..., L, k)`` into ``(...,
    k)``: the top k of all real entries (id ≥ 0) by (score desc, scan
    position asc); ``(NEG_INF, -1)`` past the last real one. Returns
    ``(scores f32, ids int32)``."""
    lead = scores.shape[:-2]
    s = scores.reshape(*lead, -1)
    p = pos.reshape(*lead, -1)
    i = ids.reshape(*lead, -1)
    real = i >= 0
    big = torch.iinfo(torch.int64).max
    order = torch.argsort(torch.where(real, p.long(), big), dim=-1,
                          stable=True)
    s, i = torch.gather(s, -1, order), torch.gather(i, -1, order)
    s = torch.where(i >= 0, s, torch.full_like(s, -float("inf")))
    vals, top = topk_stable(s, min(k, s.shape[-1]))
    out_i = torch.gather(i, -1, top)
    vals = torch.where(out_i >= 0, vals, torch.full_like(vals, NEG_INF))
    if vals.shape[-1] < k:
        vals = torch.nn.functional.pad(vals, (0, k - vals.shape[-1]),
                                       value=NEG_INF)
        out_i = torch.nn.functional.pad(out_i, (0, k - out_i.shape[-1]),
                                        value=-1)
    return vals.float(), out_i.to(torch.int32)


def routed_partials_plain(q_emb, q_loc, w_st, top_c, buf_emb, buf_loc,
                          buf_ids, w_hat, *, k: int, dist_max: float,
                          chunk_rows: int, buf_scale=None, buf_attrs=None,
                          q_filt=None):
    """The routed kernel's chunk partials ``(B, cr·n_chunks, k)`` (scores,
    scan positions ``route·cap + row``, ids): fold them with
    :func:`merge_partials_plain` to get :func:`routed_topk_plain`."""
    b, cr = top_c.shape
    cap = buf_emb.shape[1]
    tc = top_c.long()
    cand_ids = buf_ids[tc]                                  # (B, cr, cap)
    if buf_attrs is not None:
        ok = filters_lib.predicate_mask(buf_attrs[tc], q_filt[:, None, None, :])
        cand_ids = torch.where(ok, cand_ids, torch.full_like(cand_ids, -1))
    cand_scale = None if buf_scale is None else buf_scale[tc]
    st = torch.stack([
        score_candidates(q_emb[:, None], q_loc[:, None], w_st[:, None],
                         buf_emb[tc[:, r]], buf_loc[tc[:, r]],
                         cand_ids[:, r][:, None], w_hat, dist_max=dist_max,
                         cand_scale=None if cand_scale is None
                         else cand_scale[:, r])[:, 0]
        for r in range(cr)], dim=1)                         # (B, cr, cap)
    pos0 = torch.arange(cr, device=st.device) * cap
    return chunk_partials_plain(st, cand_ids, k=k, chunk_rows=chunk_rows,
                                pos0=pos0)


def gather_partials_plain(q_emb, q_loc, w_st, cand_emb, cand_loc, cand_ids,
                          w_hat, *, k: int, dist_max: float, chunk_rows: int,
                          cand_scale=None):
    """The gather kernel's chunk partials ``(B, n_chunks, k)``: (scores,
    local positions, local positions), the positions standing in for ids
    (-1 where no real entry). Fold them with :func:`merge_partials_plain`
    to get :func:`gather_topk_plain`."""
    st = score_candidates(q_emb[:, None], q_loc[:, None], w_st[:, None],
                          cand_emb, cand_loc, cand_ids[:, None], w_hat,
                          dist_max=dist_max, cand_scale=cand_scale)  # (B,1,N)
    vals, pos, _ = chunk_partials_plain(st, cand_ids[:, None], k=k,
                                        chunk_rows=chunk_rows)
    return vals, pos, pos


# ---------------------------------------------------------------------------
# Declared work
# ---------------------------------------------------------------------------


def scan_work(b: int, d: int, k: int, *, cap: int, distinct: int,
              live_rows: int, pairs: int, dtype=torch.float32,
              filtered: bool = False):
    """``(flops, bytes)`` of one routed or cluster-major scan of ``b``
    queries over buffers of capacity ``cap`` and width ``d`` in ``dtype``
    (int8 rows are dequantized, once per row): every input byte read once
    (the queries; the ids of the ``distinct`` routed clusters; the
    embedding, location and scale of their ``live_rows`` rows; their
    attributes and the queries' filters when ``filtered``) and the ``(b,
    k)`` lists written once; 2·d FLOPs per scored (query, live row)
    ``pairs`` plus d per live row for the dequant."""
    dequant = dtype == torch.int8
    row_bytes = d * meta.itemsize(dtype) + 8 + (4 if dequant else 0)
    nbytes = (b * (d * 4 + 16) + distinct * cap * 4 + live_rows * row_bytes
              + b * k * 8)
    if filtered:
        nbytes += live_rows * 12 + b * 16
    return pairs * d * 2 + (live_rows * d if dequant else 0), nbytes


def gather_work(b: int, n: int, d: int, k: int, *, t: int,
                dtype=torch.float32, live=None):
    """``(flops, bytes)`` of one gather-path launch over ``(b, n, d)``
    candidates in ``dtype`` with a ``t``-step ``w_hat``: the ``live``
    candidates' rows read once (all ``b·n`` when not given), every
    candidate's location, id (and int8 scale) once, the queries and
    ``w_hat`` once, the ``(b, k)`` lists written once; 2·d FLOPs per live
    candidate plus d for an int8 row's dequant."""
    live = b * n if live is None else live
    dequant = dtype == torch.int8
    per_cand = 12 + (4 if dequant else 0)       # loc, id (and scale)
    nbytes = (live * d * meta.itemsize(dtype) + b * n * per_cand
              + b * (d * 4 + 16) + t * 4 + b * k * 8)
    return live * 2 * d + (live * d if dequant else 0), nbytes


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, x, *, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_buffers(buf_emb, buf_loc, buf_ids, buf_scale, buf_attrs, w_hat,
                   *, k: int, device):
    if buf_emb.dtype not in _EMB_KIND:
        raise TypeError(f"buf_emb dtype {buf_emb.dtype} not in "
                        f"{list(_EMB_KIND)}")
    c, cap, d = buf_emb.shape
    if d % 16 or d > D_MAX:
        raise ValueError(f"embedding width {d} must be a multiple of 16 "
                         f"and at most {D_MAX}")
    if (buf_emb.dtype == torch.int8) != (buf_scale is not None):
        raise ValueError("int8 buffers need buf_scale (the dequant body); "
                         "f32/bf16 buffers take none")
    _check("buf_emb", buf_emb, dtype=buf_emb.dtype, shape=(c, cap, d),
           device=device)
    _check("buf_loc", buf_loc, dtype=torch.float32, shape=(c, cap, 2),
           device=device)
    _check("buf_ids", buf_ids, dtype=torch.int32, shape=(c, cap),
           device=device)
    _check("w_hat", w_hat, dtype=torch.float32, shape=w_hat.shape,
           device=device)
    if buf_scale is not None:
        _check("buf_scale", buf_scale, dtype=torch.float32, shape=(c, cap),
               device=device)
    if buf_attrs is not None:
        _check("buf_attrs", buf_attrs, dtype=torch.int32, shape=(c, cap, 3),
               device=device)
    return c, cap, d


def _check_grid(items: int, n_lists: int, positions: int, rows: int = 0):
    """Limits of the scans: work items, scan positions and the buffers'
    rows (the TMA row coordinate) fit 31 bits, and the merge's list heads
    its shared memory."""
    if max(items, positions, rows) >= 2 ** 31:
        raise ValueError(f"{items} work items / {positions} scan positions "
                         f"/ {rows} rows exceed the kernels' 31-bit indices")
    if n_lists > MERGE_LISTS_MAX:
        raise ValueError(f"{n_lists} partial lists per output row exceed "
                         f"the merge's {MERGE_LISTS_MAX}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def fused_topk_score_routed(q_emb, q_loc, w_st, top_c, buf_emb, buf_loc,
                            buf_ids, w_hat, *, k: int, dist_max: float,
                            buf_scale=None, buf_attrs=None, q_filt=None):
    """Routed fused score + top-k: ``(scores (B, k) f32, ids (B, k)
    int32)`` over each query's ``top_c (B, cr)`` clusters.

    Replaces ``repro/kernels/fused_topk_score.py::fused_topk_score_routed``.
    Bound by the bytes of the routed clusters' rows: the launch sorts the
    batch's pairs by cluster on the device (no host plan, no sync), and a
    work item (cluster, row chunk, up to 16 of its pairs;
    :func:`routed_items`) streams the chunk's live tiles once by TMA for
    all its pairs, the products on the tensor cores; a merge kernel folds
    the chunk partials by key (:func:`launch_shape`,
    :func:`routed_partials_plain`). Any ``cr``, routes to no cluster
    included (their lists are empty).

    ``q_emb (B, d)`` f32; ``q_loc``/``w_st (B, 2)`` f32; ``buf_emb (c,
    cap, d)`` f32, bf16, or int8 with ``buf_scale (c, cap)``; ``buf_loc
    (c, cap, 2)``; ``buf_ids (c, cap)`` int32; ``w_hat (t,)``. Filtered
    search: ``buf_attrs (c, cap, 3)`` and ``q_filt (B, 4)`` together."""
    if (buf_attrs is None) != (q_filt is None):
        raise ValueError("pass buf_attrs and q_filt together or not at all")
    if q_emb.device.type == "cpu":
        return routed_topk_plain(q_emb, q_loc, w_st, top_c, buf_emb, buf_loc,
                                 buf_ids, w_hat, k=k, dist_max=dist_max,
                                 buf_scale=buf_scale, buf_attrs=buf_attrs,
                                 q_filt=q_filt)
    if q_emb.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q_emb.device}")
    dev = q_emb.device
    c, cap, d = _check_buffers(buf_emb, buf_loc, buf_ids, buf_scale,
                               buf_attrs, w_hat, k=k, device=dev)
    b, cr = top_c.shape
    _check("q_emb", q_emb, dtype=torch.float32, shape=(b, d), device=dev)
    _check("q_loc", q_loc, dtype=torch.float32, shape=(b, 2), device=dev)
    _check("w_st", w_st, dtype=torch.float32, shape=(b, 2), device=dev)
    _check("top_c", top_c, dtype=torch.int32, shape=(b, cr), device=dev)
    if q_filt is not None:
        _check("q_filt", q_filt, dtype=torch.int32, shape=(b, 4), device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    shape = launch_shape(cap=cap, d=d, k=k, elem_size=buf_emb.element_size())
    slots, n_chunks, wgs = shape["slots"], shape["n_chunks"], shape["wgs"]
    n_lists = cr * n_chunks * wgs
    _check_grid((-(-b * cr // slots) + c + 1) * n_chunks, n_lists, cr * cap,
                c * cap)
    if dev.type == "meta":
        distinct = min(b * cr, c)
        meta.record("routed", scan_work(
            b, d, k, cap=cap, distinct=distinct, live_rows=distinct * cap,
            pairs=b * cr * cap, dtype=buf_emb.dtype,
            filtered=buf_attrs is not None))
        return out_s, out_i
    # the counting sort's counts, starts, fill, slot groups, item offsets,
    # work counter and sorted pairs, then the item records; the queries'
    # bf16 terms
    max_items = (-(-b * cr // slots) + c + 1) * n_chunks
    work = torch.empty(5 * (c + 1) + 6 + b * cr
                       + ITEM_RECORD // 4 * max_items,
                       dtype=torch.int32, device=dev)
    qsplit = torch.empty((b, Q_TERMS, 64 * shape["kb"]), dtype=torch.int16,
                         device=dev)
    part_key = torch.empty((b * n_lists, k), dtype=torch.int64, device=dev)
    part_id = torch.empty((b * n_lists, k), dtype=torch.int32, device=dev)
    with meta.launch_range("routed"):
        err = _lib().fts_routed(
            _ptr(q_emb), _ptr(q_loc), _ptr(w_st), _ptr(top_c),
            _ptr(buf_emb), _EMB_KIND[buf_emb.dtype], _ptr(buf_scale),
            _ptr(buf_loc), _ptr(buf_ids), _ptr(buf_attrs), _ptr(q_filt),
            _ptr(w_hat), int(buf_attrs is not None), b, cr, c, cap, d,
            w_hat.shape[0], k, float(dist_max), shape["chunk_rows"], slots,
            shape["stages"], wgs, shape["smem_bytes"], _ptr(work), max_items,
            _ptr(qsplit), _ptr(part_key), _ptr(part_id), _ptr(out_s),
            _ptr(out_i), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fts_routed launch failed: cudaError {err}")
    launches["routed"] += 1
    return out_s, out_i


def fused_topk_score_cluster_major(q_emb, q_loc, w_st, u, roster, buf_emb,
                                   buf_loc, buf_ids, w_hat, *, k: int,
                                   dist_max: float, cr: int, buf_scale=None,
                                   buf_attrs=None, q_filt=None):
    """Cluster-major fused score + top-k over a batch plan.

    Replaces ``repro/kernels/fused_topk_score.py::
    fused_topk_score_cluster_major``. Bound by the bytes of the distinct
    routed clusters' rows: a work item (:func:`cluster_major_items`)
    streams one chunk of a cluster's live rows once by TMA for up to 16
    roster slots (:func:`launch_shape`), the products on the tensor
    cores; the chunk partials are merged by key.

    ``u (u_max,)`` / ``roster (u_max, qcap)`` int32 from
    ``serving.cluster_major_plan`` (``B·cr`` marks an empty slot), which
    puts every (query, route) pair in exactly one slot; query row of slot
    value ``o`` is ``o // cr``, read from ``q_emb (B, d)`` directly.
    Returns per-pair partial lists ``(scores (B·cr, k) f32, ids (B·cr, k)
    int32)``, every row written by the kernel; fold them with
    ``engine.merge_cluster_major``."""
    if (buf_attrs is None) != (q_filt is None):
        raise ValueError("pass buf_attrs and q_filt together or not at all")
    if q_emb.device.type == "cpu":
        return cluster_major_partials_plain(
            q_emb, q_loc, w_st, u, roster, buf_emb, buf_loc, buf_ids, w_hat,
            k=k, dist_max=dist_max, cr=cr, buf_scale=buf_scale,
            buf_attrs=buf_attrs, q_filt=q_filt)
    if q_emb.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q_emb.device}")
    dev = q_emb.device
    c, cap, d = _check_buffers(buf_emb, buf_loc, buf_ids, buf_scale,
                               buf_attrs, w_hat, k=k, device=dev)
    b = q_emb.shape[0]
    u_max, qcap = roster.shape
    _check("q_emb", q_emb, dtype=torch.float32, shape=(b, d), device=dev)
    _check("q_loc", q_loc, dtype=torch.float32, shape=(b, 2), device=dev)
    _check("w_st", w_st, dtype=torch.float32, shape=(b, 2), device=dev)
    _check("u", u, dtype=torch.int32, shape=(u_max,), device=dev)
    _check("roster", roster, dtype=torch.int32, shape=(u_max, qcap),
           device=dev)
    if q_filt is not None:
        _check("q_filt", q_filt, dtype=torch.int32, shape=(b, 4), device=dev)
    n_total = b * cr
    out_s = torch.empty((n_total, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_total, k), dtype=torch.int32, device=dev)
    if n_total == 0 or u_max == 0 or qcap == 0:
        return out_s, out_i
    shape = launch_shape(cap=cap, d=d, k=k, elem_size=buf_emb.element_size())
    n_chunks, slots, wgs = shape["n_chunks"], shape["slots"], shape["wgs"]
    max_items = u_max * -(-qcap // slots) * n_chunks
    _check_grid(max_items, n_chunks * wgs, cap, c * cap)
    if dev.type == "meta":
        meta.record("cluster_major", scan_work(
            b, d, k, cap=cap, distinct=u_max, live_rows=u_max * cap,
            pairs=min(n_total, u_max * qcap) * cap, dtype=buf_emb.dtype,
            filtered=buf_attrs is not None))
        return out_s, out_i
    # slot groups, item offsets, work counter, then the item records
    work = torch.empty(2 * u_max + 5 + ITEM_RECORD // 4 * max_items,
                       dtype=torch.int32, device=dev)
    qsplit = torch.empty((b, Q_TERMS, 64 * shape["kb"]), dtype=torch.int16,
                         device=dev)
    part_key = torch.empty((n_total * n_chunks * wgs, k), dtype=torch.int64,
                           device=dev)
    part_id = torch.empty((n_total * n_chunks * wgs, k), dtype=torch.int32,
                          device=dev)
    with meta.launch_range("cluster_major"):
        err = _lib().fts_cluster_major(
            _ptr(q_emb), _ptr(q_loc), _ptr(w_st), _ptr(u), _ptr(roster),
            _ptr(buf_emb), _EMB_KIND[buf_emb.dtype], _ptr(buf_scale),
            _ptr(buf_loc), _ptr(buf_ids), _ptr(buf_attrs), _ptr(q_filt),
            _ptr(w_hat), int(buf_attrs is not None), b, u_max, qcap, cr, c,
            cap, d, w_hat.shape[0], k, float(dist_max), shape["chunk_rows"],
            slots, shape["stages"], wgs, shape["smem_bytes"], _ptr(work),
            max_items, _ptr(qsplit), _ptr(part_key), _ptr(part_id),
            _ptr(out_s), _ptr(out_i),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fts_cluster_major launch failed: cudaError {err}")
    launches["cluster_major"] += 1
    return out_s, out_i


def fused_topk_score(q_emb, q_loc, w_st, cand_emb, cand_loc, cand_ids, w_hat,
                     *, k: int, dist_max: float, cand_scale=None):
    """Gather-path fused score + top-k: ``(scores (B, k) f32, positions
    (B, k) int32)`` over each query's materialized candidates.

    Replaces ``repro/kernels/fused_topk_score.py::fused_topk_score``.
    Bound by the bytes of the live candidate rows: work items of (query,
    1,024-row chunk of its ``N`` candidates), one slot each, walked by
    the tiled scan's persistent blocks (padding skipped by id before its
    row is read); the chunk partials are merged by key into local
    positions, -1 past the last valid candidate; equal scores rank by
    position (:func:`gather_partials_plain`).

    ``q_emb (B, d)`` f32; ``q_loc``/``w_st (B, 2)`` f32; ``cand_emb (B,
    N, d)`` f32, bf16, or int8 with ``cand_scale (B, N)`` f32;
    ``cand_loc (B, N, 2)`` f32; ``cand_ids (B, N)`` int32 (-1 pad);
    ``w_hat (t,)`` f32."""
    if q_emb.device.type == "cpu":
        return gather_topk_plain(q_emb, q_loc, w_st, cand_emb, cand_loc,
                                 cand_ids, w_hat, k=k, dist_max=dist_max,
                                 cand_scale=cand_scale)
    if q_emb.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q_emb.device}")
    dev = q_emb.device
    if cand_emb.dtype not in _EMB_KIND:
        raise TypeError(f"cand_emb dtype {cand_emb.dtype} not in "
                        f"{list(_EMB_KIND)}")
    b, n, d = cand_emb.shape
    if d % 16 or d > D_MAX:
        raise ValueError(f"embedding width {d} must be a multiple of 16 "
                         f"and at most {D_MAX}")
    if (cand_emb.dtype == torch.int8) != (cand_scale is not None):
        raise ValueError("int8 candidates need cand_scale (the dequant "
                         "body); f32/bf16 candidates take none")
    _check("cand_emb", cand_emb, dtype=cand_emb.dtype, shape=(b, n, d),
           device=dev)
    _check("cand_loc", cand_loc, dtype=torch.float32, shape=(b, n, 2),
           device=dev)
    _check("cand_ids", cand_ids, dtype=torch.int32, shape=(b, n), device=dev)
    if cand_scale is not None:
        _check("cand_scale", cand_scale, dtype=torch.float32, shape=(b, n),
               device=dev)
    _check("q_emb", q_emb, dtype=torch.float32, shape=(b, d), device=dev)
    _check("q_loc", q_loc, dtype=torch.float32, shape=(b, 2), device=dev)
    _check("w_st", w_st, dtype=torch.float32, shape=(b, 2), device=dev)
    _check("w_hat", w_hat, dtype=torch.float32, shape=w_hat.shape, device=dev)
    if n == 0:                          # no candidates: every slot empty
        return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev))
    shape = gather_launch_shape(cap=n, k=k,
                                elem_size=cand_emb.element_size())
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    n_chunks = shape["n_chunks"]
    _check_grid(b * n_chunks, n_chunks, n)
    if dev.type == "meta":
        meta.record("gather", gather_work(b, n, d, k, t=w_hat.shape[0],
                                          dtype=cand_emb.dtype))
        return out_s, out_i
    work = torch.empty(1, dtype=torch.int32, device=dev)
    part_key = torch.empty((b * n_chunks, k), dtype=torch.int64, device=dev)
    with meta.launch_range("gather"):
        err = _lib().fts_gather(
            _ptr(q_emb), _ptr(q_loc), _ptr(w_st), _ptr(cand_emb),
            _EMB_KIND[cand_emb.dtype], _ptr(cand_scale), _ptr(cand_loc),
            _ptr(cand_ids), _ptr(w_hat), b, n, d, w_hat.shape[0], k,
            float(dist_max), shape["chunk_rows"], shape["smem_bytes"],
            _ptr(work), _ptr(part_key), _ptr(out_s), _ptr(out_i),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fts_gather launch failed: cudaError {err}")
    launches["gather"] += 1
    return out_s, out_i
