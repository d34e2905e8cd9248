"""Flash attention (block-wise online softmax) with GQA, causal and
sliding-window masks.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` for a CUDA tensor; it replaces the Pallas
kernel ``repro/kernels/flash_attention.py::flash_attention`` with the
same contract: ``q (B, S, H, D)``, ``k``/``v (B, S, KV, D)``, head ``h``
reads KV head ``h // (H // KV)``, f32 accumulation, output in q's dtype,
masked scores at the finite ``NEG_INF`` and ``l`` floored at 1e-30. Bound
by operations, both bodies on Hopper's TMA and ``wgmma`` (TMA loads by a
producer warpgroup, products in two consumer warpgroups, f32
accumulation). bf16/fp16 inputs: the warpgroups ping-pong, and P is split
into two 16-bit parts so P·V keeps f32 precision. f32 inputs: q, k, v and
P are carried as three bf16 terms each (x = hi + mid + lo) and S = Q·Kᵀ
and O += P·V each sum the six products down to the 2^-16 terms, within
the f32 contract of 2e-5; a small pass first writes K and V as rows of
their three terms (the launch's bf16 scratch), and the key tile is 64.
:func:`forward_launch_shape` mirrors each body's launch. For a CPU tensor
it runs :func:`flash_attention_plain`; any other device raises.

The backward (:func:`flash_attention_backward`, kernels in the same
source) replaces no Pallas kernel: the reference differentiates its jnp
path. From the forward's output and its row log-sum-exp ``lse (B, H, S)``
f32 it recomputes P, takes ``Dvec = rowsum(dO∘O)`` and returns dQ, dK, dV
in the inputs' dtype, f32 sums rounded once, in two kernels built on TMA,
mbarriers and ``wgmma`` (a dK/dV pass over blocks of keys and a dQ pass
over blocks of query rows): in 16 bits P and dS split in two 16-bit parts;
in f32 q·scale, k, v, dO, P and dS in three bf16 terms each and six
products for each of S, dP, dV, dK and dQ, after a pass that writes the
four inputs' terms into the launch's scratch.
:func:`backward_launch_shape` mirrors both kernels' launch.
:class:`FlashAttentionFn`
joins the two for autograd: :func:`flash_attention` goes through it
whenever autograd needs a gradient of q, k or v, and only then has the
forward write ``lse``.

:func:`work` and :func:`backward_work` declare each kernel's FLOPs and
bytes; for a ``meta`` tensor the wrappers launch nothing, return outputs
of the kernel's shapes on ``meta`` and record that work
(``kernels.meta``), the backward's too when a gradient flows.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta

NEG_INF = -1e30

# kernel launches since the last reset (kernels.ops.reset_launch_counts);
# ``flash_attention_f32`` and ``flash_attention_backward_f32`` count the f32
# launches, which ``flash_attention`` and ``flash_attention_backward`` count
# too
launches = {"flash_attention": 0, "flash_attention_f32": 0,
            "flash_attention_backward": 0, "flash_attention_backward_f32": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128)


def _bind(lib) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [ptr, ptr, ptr] + [i32] * 9 + [f32] + [
        ptr] * 4
    lib.flash_attention.restype = i32
    lib.flash_attention_backward.argtypes = ([ptr] * 6 + [i32] * 8 + [f32]
                                             + [ptr] * 6)
    lib.flash_attention_backward.restype = i32
    for name in ("flash_forward_shape", "flash_backward_shape"):
        getattr(lib, name).argtypes = [i32, i32, ctypes.POINTER(i32)]
        getattr(lib, name).restype = i32


_lib = build.KernelLibrary("flash_attention", ["flash_attention.cu"], _bind)


# the forward's ring of K and V tiles, by head dim (flash_attention.cu
# fwd_stages / f32_stages): in 16 bits three 64 KB stages at D 128, four
# below; in f32 (three bf16 terms of K and V, 64 keys) two 96 KB stages at
# D 128, four below
_FWD_STAGES = {16: 4, 32: 4, 64: 4, 128: 3}
_F32_STAGES = {16: 4, 32: 4, 64: 4, 128: 2}
SMEM_LIMIT = 232_448             # dynamic shared memory a block may use (227 KB)
FWD_CHUNK_BYTES = 24 << 20       # K and V of a chunk of heads, kept in the L2


@dataclasses.dataclass(frozen=True)
class ForwardLaunch:
    """One forward body's launch, as ``flash_attention.cu`` makes it:
    ``rows`` query rows of one head a block over key tiles of ``key_tile``,
    a ring of ``stages`` K/V stages, ``threads`` a block, ``smem_bytes`` of
    dynamic shared memory. The grid is one dimension: the heads in chunks
    (:meth:`chunk`), each chunk's query tiles heaviest first across its
    heads."""
    dtype: torch.dtype
    d: int
    rows: int
    key_tile: int
    stages: int
    threads: int
    smem_bytes: int

    @property
    def kv_bytes(self) -> int:
        """Bytes the kernel loads per element of K or V: 2 in 16 bits, 6
        in f32 (its three bf16 terms)."""
        return 6 if self.dtype == torch.float32 else 2

    def chunk(self, b: int, s: int, h: int, kv: int) -> int:
        """Query heads a chunk of the launch order, which :func:`_launch`
        passes to the kernel: the KV groups whose K and V (as loaded,
        :attr:`kv_bytes`) fit in ``FWD_CHUNK_BYTES`` (at least one), at
        most B·H."""
        groups = max(1, FWD_CHUNK_BYTES // (s * self.d * self.kv_bytes * 2))
        return min(groups * (h // kv), b * h)

    def blocks(self, b: int, s: int, h: int, kv: int):
        """``(batch, head, first query row)`` of every block, in launch
        order (the linear block index)."""
        tiles = -(-s // self.rows)
        chunk, out = self.chunk(b, s, h, kv), []
        for c0 in range(0, b * h, chunk):
            nh = min(chunk, b * h - c0)
            for r in range(nh * tiles):
                bh = c0 + r % nh
                out.append((bh // h, bh % h, (tiles - 1 - r // nh) * self.rows))
        return out

    def key_tiles(self, q0: int, s: int, *, causal: bool, window: int):
        """The block's live key tiles ``range(t_lo, t_hi + 1)``: those some
        of its rows may see."""
        t_hi = (s - 1) // self.key_tile
        if causal:
            t_hi = min(t_hi, (q0 + self.rows - 1) // self.key_tile)
        t_lo = 0
        if window > 0:
            x = q0 - window - self.key_tile + 1
            if x >= 0:
                t_lo = x // self.key_tile + 1
        return range(t_lo, t_hi + 1)


@functools.lru_cache(maxsize=None)
def forward_launch_shape(d: int, dtype) -> ForwardLaunch:
    """The forward kernel's launch for head dim ``d`` and ``dtype``, a
    mirror of ``flash_attention.cu`` (``flash_forward_shape`` there gives
    its rows, key tile, stages, threads and shared memory)."""
    if d not in HEAD_DIMS or dtype not in _DTYPE:
        raise ValueError(f"no forward body for D={d}, {dtype}")
    if dtype == torch.float32:
        # f32_smem_bytes: alignment slack, the ring (K's and V's three terms
        # of 64 keys a stage), the barriers; Q stays in registers
        stages = _F32_STAGES[d]
        smem = 1024 + stages * 6 * 64 * d * 2 + 128
        return ForwardLaunch(dtype, d, 128, 64, stages, 384, smem)
    stages = _FWD_STAGES[d]
    # fwd_smem_bytes: alignment slack, Q (128 rows), the ring, the barriers
    smem = 1024 + 128 * d * 2 + stages * 2 * 128 * d * 2 + 128
    return ForwardLaunch(dtype, d, 128, 128, stages, 384, smem)


def kernel_forward_shape(d: int, dtype):
    """``flash_forward_shape`` of the built library (needs the card's
    toolkit) → ``(rows, key_tile, stages, threads, smem_bytes)``."""
    out = (ctypes.c_int * 5)()
    err = _lib().flash_forward_shape(_DTYPE[dtype], d, out)
    if err:
        raise RuntimeError(f"flash_forward_shape failed: cudaError {err}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BackwardLaunch:
    """One backward kernel's launch, as ``flash_attention.cu`` makes it:
    ``kind`` "dkdv" keeps ``rows`` keys of one KV head resident and streams
    tiles of ``tile`` query rows of each query head of its group; "dq"
    keeps ``rows`` query rows of one head and streams tiles of ``tile``
    keys. A ring of ``stages``, ``threads`` a block, ``smem_bytes`` of
    dynamic shared memory; ``split``: the two consumer warpgroups own 64
    resident rows each and read every tile, else they own the same rows
    and take alternate tiles (the f32 kernels at D 128)."""
    kind: str
    dtype: torch.dtype
    d: int
    rows: int
    tile: int
    stages: int
    threads: int
    smem_bytes: int
    split: bool

    def blocks(self, b: int, s: int, h: int, kv: int):
        """``(batch, head, first resident row)`` of every block in launch
        order; the head is the KV head for "dkdv". In 16 bits a grid of
        (heads, blocks), heads fastest; in f32 one dimension, a head's
        blocks in a row. Heaviest causal block first: dK/dV's first keys,
        dQ's last rows."""
        heads = b * (kv if self.kind == "dkdv" else h)
        n = -(-s // self.rows)
        first = ((lambda i: i * self.rows) if self.kind == "dkdv"
                 else (lambda i: (n - 1 - i) * self.rows))
        per = h if self.kind == "dq" else kv
        if self.dtype == torch.float32:
            order = [(x, i) for x in range(heads) for i in range(n)]
        else:
            order = [(x, i) for i in range(n) for x in range(heads)]
        return [(x // per, x % per, first(i)) for x, i in order]

    def tiles(self, r0: int, s: int, *, causal: bool, window: int):
        """The streamed tiles of the block whose resident rows start at
        ``r0``: those some of its rows may see."""
        if self.kind == "dkdv":
            lo = r0 if causal else 0
            hi = min(s - 1, r0 + self.rows - 2 + window) if window > 0 \
                else s - 1
            return range(lo // self.tile, hi // self.tile + 1)
        t_hi = (s - 1) // self.tile
        if causal:
            t_hi = min(t_hi, (r0 + self.rows - 1) // self.tile)
        t_lo = 0
        if window > 0:
            x = r0 - window - self.tile + 1
            if x >= 0:
                t_lo = x // self.tile + 1
        return range(t_lo, t_hi + 1)


@functools.lru_cache(maxsize=None)
def backward_launch_shape(d: int, dtype):
    """``(dkdv, dq)``: the backward kernels' launches for head dim ``d`` and
    ``dtype``, a mirror of ``flash_attention.cu`` (``flash_backward_shape``
    there gives them). 16 bits: 128 resident rows, 64-row tiles, three
    stages. f32 (three bf16 terms of each operand): from D 64 down as 16
    bits with four stages below D 64 and two at D 64; at D 128 64 resident
    rows and alternate 32-row tiles, two stages."""
    if d not in HEAD_DIMS or dtype not in _DTYPE:
        raise ValueError(f"no backward kernels for D={d}, {dtype}")
    out = []
    for kind in ("dkdv", "dq"):
        if dtype == torch.float32:
            split = d <= 64
            rows, tile = (128 if split else 64), (32 if d == 128 else 64)
            stages = 2 if d >= 64 else 4
            # b32_smem_bytes: alignment slack, the resident operands' six
            # bf16 planes, per stage the streamed ones' six (and dK/dV's
            # lse and Dvec, 1024 bytes), the barriers
            smem = (1024 + 6 * rows * d * 2 + stages * (
                6 * tile * d * 2 + (1024 if kind == "dkdv" else 0)) + 128)
        else:
            split, rows, tile, stages = True, 128, 64, 3
            # dkdv_smem_bytes / dq_smem_bytes: K and V (or Q and dO) of 128
            # rows, per stage two 64-row tiles (and dK/dV's lse and Dvec)
            smem = (1024 + 4 * 64 * d * 2 + stages * (
                2 * 64 * d * 2 + (1024 if kind == "dkdv" else 0)) + 128)
        out.append(BackwardLaunch(kind, dtype, d, rows, tile, stages, 384,
                                  smem, split))
    return tuple(out)


def kernel_backward_shape(d: int, dtype):
    """``flash_backward_shape`` of the built library (needs the card's
    toolkit) → two ``(rows, tile, stages, threads, smem_bytes, split)``:
    dK/dV's, dQ's."""
    out = (ctypes.c_int * 12)()
    err = _lib().flash_backward_shape(_DTYPE[dtype], d, out)
    if err:
        raise RuntimeError(f"flash_backward_shape failed: cudaError {err}")
    return tuple(out[:6]), tuple(out[6:])


def attention_mask(sq: int, sk: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """``(sq, sk)`` bool, True where query position i may see key j."""
    pos_q = torch.arange(sq, device=device)[:, None]
    pos_k = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= pos_q >= pos_k
    if window > 0:
        mask &= (pos_q - pos_k) < window
    return mask


def visible_pairs(s: int, *, causal: bool, window: int) -> int:
    """The (query, key) pairs of one head that :func:`attention_mask`
    lets through at ``S = s``: the pairs the kernels compute (they skip
    the tiles no query row sees)."""
    if causal:
        if not window or window >= s:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if not window or window >= s:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


def work(b: int, s: int, h: int, kv: int, d: int, *, causal: bool = True,
         window: int = 0, dtype=torch.bfloat16, with_lse: bool = False):
    """``(flops, bytes)`` of one forward launch on ``q (b, s, h, d)``,
    ``k``/``v (b, s, kv, d)``: 4·d FLOPs (q·kᵀ and p·v) per visible pair
    (:func:`visible_pairs`) and head; q, k, v read once, the output
    written once, and ``lse`` (f32) when it is asked for."""
    pairs = visible_pairs(s, causal=causal, window=window) * h * b
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * meta.itemsize(dtype)
    return 4 * d * pairs, nbytes + (b * h * s * 4 if with_lse else 0)


def backward_work(b: int, s: int, h: int, kv: int, d: int, *,
                  causal: bool = True, window: int = 0,
                  dtype=torch.bfloat16):
    """``(flops, bytes)`` of one backward launch: 10·d FLOPs per visible
    pair and head (five products: S again, dP, dV, dK, dQ); q, o, dO read
    and dQ written, k, v read and dK, dV written, ``lse`` read, each
    once."""
    pairs = visible_pairs(s, causal=causal, window=window) * h * b
    nbytes = (4 * b * s * h * d + 4 * b * s * kv * d) * meta.itemsize(dtype)
    return 10 * d * pairs, nbytes + b * h * s * 4


def _grouped_scores(q, k, *, causal: bool, window: int):
    """``(scores (B, KV, G, Sq, Sk), q (B, Sq, KV, G, D))``: the oracle's
    scaled f32 scores, ``NEG_INF`` where masked, and q grouped by KV head,
    in f32 and scaled."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    qg = q.reshape(b, sq, n_kv, h // n_kv, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.float())
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    return torch.where(mask, s, torch.full((), NEG_INF, device=q.device)), qg


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """Dense softmax attention in f32 (the reference's oracle form); with
    ``return_lse`` also each row's log-sum-exp of its scaled, masked
    scores, ``(B, H, S)`` f32."""
    b, sq, h, d = q.shape
    s, _ = _grouped_scores(q, k, causal=causal, window=window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bkgqd", p, v.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = True, window: int = 0):
    """The backward's formulas in f32 eager torch, the kernel's oracle: P =
    exp(scale·q·k − lse) (0 where masked), Dvec = rowsum(dO∘O), dS = P ∘
    (dO·vᵀ − Dvec); dQ = scale·dS·k, dK = scale·dSᵀ·q, dV = Pᵀ·dO, each
    KV head summing its G query heads → ``(dq, dk, dv)`` in the inputs'
    dtype."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    s, qg = _grouped_scores(q, k, causal=causal, window=window)
    p = torch.exp(s - lse.float().reshape(b, n_kv, g, sq)[..., None])
    dog = do.reshape(b, sq, n_kv, g, d).float()
    dvec = (dog * o.reshape(b, sq, n_kv, g, d).float()).sum(-1)
    dp = torch.einsum("bqkgd,bjkd->bkgqj", dog, v.float())
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqj,bjkd->bqkgd", ds, k.float()) * (
        1.0 / math.sqrt(d))
    dk = torch.einsum("bkgqj,bqkgd->bjkd", ds, qg)
    dv = torch.einsum("bkgqj,bqkgd->bjkd", p, dog)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, *more):
    """Raises for what the kernels do not take → ``(B, S, H, KV, D)``;
    ``more`` are tensors shaped and typed like q (o, dO). A ``meta``
    tensor passes the same checks."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, S, H, D), k and v (B, S, KV, D)")
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if n_kv == 0 or h % n_kv:
        raise ValueError(f"H={h} is not a multiple of KV={n_kv}")
    if b * h > 65535:
        raise ValueError(f"B·H={b * h} exceeds the grid's y limit")
    for x in more:
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"o and dO must be shaped and typed like q, got "
                             f"{tuple(x.shape)} {x.dtype}")
    for name, x in [("q", q), ("k", k), ("v", v)] + [("o/dO", x)
                                                      for x in more]:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA and "
                             f"vector loads)")
    return b, s, h, n_kv, d


def _launch(q, k, v, causal: bool, window: int, with_lse: bool):
    """The forward kernel → ``(out, lse or None)``; ``lse (B, H, S)`` f32
    only when asked (the output is the same either way)."""
    b, s, h, n_kv, d = _check(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if q.device.type == "meta":
        meta.record("flash_attention", work(
            b, s, h, n_kv, d, causal=causal, window=window, dtype=q.dtype,
            with_lse=with_lse))
        return out, lse
    chunk = forward_launch_shape(d, q.dtype).chunk(b, s, h, n_kv)
    # the f32 body's scratch: K's and V's three bf16 terms a row
    scratch = (torch.empty(6 * b * s * n_kv * d, dtype=torch.bfloat16,
                           device=q.device)
               if q.dtype == torch.float32 else None)
    # the f32 body is counted and traced under its own name too
    f32 = "flash_attention_f32" if q.dtype == torch.float32 else None
    with meta.launch_range("flash_attention"), meta.launch_range(f32):
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE[q.dtype], b, s,
            h, n_kv, d, int(causal), int(window), chunk, 1.0 / math.sqrt(d),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches["flash_attention"] += 1
    if f32:
        launches[f32] += 1
    return out, lse


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0):
    """``(dq, dk, dv)`` of the attention that gave ``o`` and ``lse`` (B, H,
    S) f32, for the output gradient ``do``: the backward kernels for a CUDA
    tensor, :func:`flash_attention_backward_plain` for a CPU one, the meta
    path (:func:`backward_work` recorded) for a meta one. A launch takes
    scratch device memory besides its outputs: Dvec and a copy of lse, 8
    bytes a row of each head; in f32 also the three bf16 terms of q·scale,
    k, v and dO, 12·B·S·(H + KV)·D bytes (1.6 GB at stablelm-1.6b's 8 ×
    4,096 layer)."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do,
                                              causal=causal, window=window)
    b, s, h, n_kv, d = _check(q, k, v, o, do)
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {s}) float32 "
                         f"tensor on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    if q.device.type == "meta":
        meta.record("flash_attention_backward", backward_work(
            b, s, h, n_kv, d, causal=causal, window=window, dtype=q.dtype))
        return dq, dk, dv
    # the kernels' scratch: Dvec and a copy of lse, rows padded to a multiple
    # of 4 (16-byte aligned TMA boxes); in f32 the four inputs' three bf16
    # terms a row
    dvec = torch.empty(2 * b * h * (-(-s // 4) * 4), dtype=torch.float32,
                       device=q.device)
    f32 = q.dtype == torch.float32
    terms = (torch.empty(6 * b * s * (h + n_kv) * d, dtype=torch.bfloat16,
                         device=q.device) if f32 else None)
    name = "flash_attention_backward_f32" if f32 else None
    with meta.launch_range("flash_attention_backward"), \
            meta.launch_range(name):
        err = _lib().flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), _DTYPE[q.dtype], b, s, h, n_kv, d,
            int(causal), int(window), 1.0 / math.sqrt(d), dvec.data_ptr(),
            None if terms is None else terms.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_backward launch failed: "
                           f"cudaError {err}")
    launches["flash_attention_backward"] += 1
    if name:
        launches[name] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the backward kernel as its gradient: the
    forward keeps q, k, v, o and lse; the backward recomputes P from
    them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window, return_lse=True)
        else:
            out, lse = _launch(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """``q (B, S, H, D)``, ``k``/``v (B, S, KV, D)`` → ``(B, S, H, D)``;
    through :class:`FlashAttentionFn` when autograd needs a gradient of
    q, k or v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window, False)[0]
