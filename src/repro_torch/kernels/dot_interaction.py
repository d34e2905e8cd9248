"""DLRM pairwise-dot feature interaction: ``(B, F, d) → (B, F(F-1)/2)``.

:func:`dot_interaction` launches the hand-written CUDA kernel
``csrc/dot_interaction.cu`` for a CUDA tensor; it replaces the Pallas
kernel ``repro/kernels/dot_interaction.py::dot_interaction`` and writes
the upper triangle (``np.triu_indices(F, k=1)``, row-major) directly
instead of the full Gram matrix. Bound by the bytes of ``feats``; each
thread keeps a 4×4 tile of pairs in registers while ``cp.async`` streams
the next chunk of rows (:func:`launch_shape` sizes the launch). For a
CPU tensor it runs :func:`dot_interaction_plain`; any other device
raises. Sums are f32, rounded once to ``feats``' dtype.

The backward (:func:`dot_interaction_backward`, kernel
``dot_interaction_backward`` in the same source) replaces no Pallas
kernel: the reference differentiates its jnp path. ``dX[b] =
Gsym[b]·X[b]`` with ``Gsym`` the symmetric, zero-diagonal matrix of the
pairs' gradients; persistent blocks stream whole rows of X through a ring
of TMA bulk copies (:func:`backward_launch_shape`), bound by the bytes of
X, the gradient and dX. :class:`DotInteractionFn` joins the
two for autograd, and :func:`dot_interaction` goes through it whenever
autograd needs a gradient of ``feats``.

:func:`work` and :func:`backward_work` declare each kernel's FLOPs and
bytes; for a ``meta`` tensor the wrappers launch nothing, return outputs
of the kernel's shapes on ``meta`` and record that work
(``kernels.meta``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta

# kernel launches since the last reset (kernels.ops.reset_launch_counts)
launches = {"dot_interaction": 0, "dot_interaction_backward": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256                    # the most threads a block runs (one tile each)
STAGES = 2                       # the cp.async double buffer (kStages in the .cu)
SMEM_MAX = 227 * 1024            # shared memory one block may have
_SMEM_TARGET = 100 * 1024        # both stages; room for two blocks per SM
BWD_STAGES = 4                   # the backward's TMA ring (units in flight)
BWD_STAGE_BYTES = 16 * 1024      # one unit of X: a whole row up to this size


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dot_interaction.argtypes = [ptr] + [i32] * 9 + [ptr, ptr]
    lib.dot_interaction.restype = i32
    lib.dot_interaction_backward.argtypes = [ptr, ptr] + [i32] * 9 + [ptr,
                                                                     ptr]
    lib.dot_interaction_backward.restype = i32


_lib = build.KernelLibrary("dot_interaction", ["dot_interaction.cu"], _bind)


def triu_pairs(f: int, device=None):
    """``(i, j)`` of the pairs i < j in ``np.triu_indices(f, k=1)`` order."""
    return tuple(torch.triu_indices(f, f, offset=1, device=device))


def pair_tiles(f: int):
    """The kernel's tiles: ``(ib, jb)`` with ``ib <= jb`` over the
    ``ceil(f/4)`` blocks of 4 features, row-major; tile t covers the pairs
    ``(4·ib + ii, 4·jb + jj)`` with ``i < j < f``."""
    nb = -(-f // 4)
    return [(ib, jb) for ib in range(nb) for jb in range(ib, nb)]


def launch_shape(f: int, elem_size: int) -> dict:
    """Rows per block, threads, stage layout and shared bytes of the kernel
    for ``x (B, f, d)`` with ``elem_size``-byte elements and f >= 2. d does
    not enter: it streams through the stages 128 bytes at a time.

    A stage holds ``rows`` batch rows × ``fp`` features (f padded to a
    multiple of 4) × one 128-byte chunk of d, rows ``row_elems`` elements
    apart (16 bytes past a multiple of 128); two of them form the double
    buffer. A block runs one thread per (row, tile), at most 256. The grid,
    the blocks the card holds at once, is the kernel's to compute."""
    fp = -(-f // 4) * 4
    tiles = len(pair_tiles(f))
    if tiles > THREADS:
        raise ValueError(f"F={f}: {tiles} tiles of 4×4 pairs exceed the "
                         f"{THREADS} threads of a block")
    chunk = 128 // elem_size
    row_elems = fp * chunk + 16 // elem_size
    row_bytes = row_elems * elem_size
    rows = max(1, min(THREADS // tiles, _SMEM_TARGET // (STAGES * row_bytes)))
    if rows >= 8:
        rows -= rows % 8             # a quarter-warp reads 8 rows' banks
    smem = STAGES * rows * row_bytes
    if smem > SMEM_MAX:
        raise ValueError(f"F={f}: {smem} bytes of shared memory exceed "
                         f"{SMEM_MAX}")
    return dict(rows=rows, threads=-(-rows * tiles // 32) * 32, tiles=tiles,
                fp=fp, chunk=chunk, row_elems=row_elems, smem_bytes=smem)


def backward_launch_shape(f: int, d: int, elem_size: int) -> dict:
    """Stage layout, threads and shared bytes of the backward kernel for
    ``x (B, f, d)``. A stage holds one unit: ``fp`` rows (f padded to a
    multiple of 4, the padding zero) × ``chunk`` elements of d, all of d
    when that fits ``BWD_STAGE_BYTES`` (else a multiple of 16 bytes);
    ``BWD_STAGES`` of them form the TMA ring. Beside them: Gsym (``fp²``
    floats), the next unit's gradient row staged as 4-byte words, a table
    of the pairs' (i, j) and one mbarrier a stage
    (``backward_smem_bytes`` in the .cu). A block runs one thread per
    (4-feature block, 16-byte piece of the chunk), at most 256."""
    fp = -(-f // 4) * 4
    vec = 16 // elem_size
    if fp * d * elem_size <= BWD_STAGE_BYTES:
        chunk = d
    else:
        chunk = max(vec, BWD_STAGE_BYTES // (fp * elem_size) // vec * vec)
    n_pairs = f * (f - 1) // 2
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    smem = (a16(BWD_STAGES * fp * chunk * elem_size) + fp * fp * 4
            + a16(n_pairs * elem_size + 4) + a16(n_pairs * 4) + 8 * BWD_STAGES)
    if smem > SMEM_MAX:
        raise ValueError(f"F={f}: {smem} bytes of shared memory exceed "
                         f"{SMEM_MAX}")
    items = (fp // 4) * -(-chunk // vec)
    return dict(chunk=chunk, stages=BWD_STAGES, fp=fp,
                threads=min(THREADS, -(-items // 32) * 32), smem_bytes=smem)


def work(b: int, f: int, d: int, *, dtype=torch.float32):
    """``(flops, bytes)`` of one forward launch on ``feats (b, f, d)``: 2·d
    FLOPs per pair i < j; feats read once, the pairs written once."""
    n_pairs = f * (f - 1) // 2
    return 2 * d * b * n_pairs, (b * f * d + b * n_pairs) * meta.itemsize(
        dtype)


def backward_work(b: int, f: int, d: int, *, dtype=torch.float32):
    """``(flops, bytes)`` of one backward launch: ``Gsym·X``, 2·f·f·d FLOPs
    a row; X and the pairs' gradient read once, dX written once."""
    n_pairs = f * (f - 1) // 2
    return 2 * f * f * d * b, (2 * b * f * d + b * n_pairs) * meta.itemsize(
        dtype)


def dot_interaction_plain(feats: torch.Tensor) -> torch.Tensor:
    """The Gram matrix X·Xᵀ in f32, its upper triangle, in feats' dtype."""
    x = feats.float()
    gram = x @ x.transpose(-1, -2)
    iu, ju = triu_pairs(feats.shape[1], feats.device)
    return gram[:, iu, ju].to(feats.dtype)


def dot_interaction_backward_plain(feats: torch.Tensor, grad: torch.Tensor
                                   ) -> torch.Tensor:
    """``dX = Gsym·X`` in f32, ``Gsym`` the pairs' gradients ``grad (B,
    F(F-1)/2)`` placed at (i, j) and (j, i), zero on the diagonal; in
    feats' dtype."""
    b, f, _ = feats.shape
    iu, ju = triu_pairs(f, feats.device)
    gsym = torch.zeros((b, f, f), dtype=torch.float32, device=feats.device)
    gsym[:, iu, ju] = grad.float()
    gsym = gsym + gsym.transpose(1, 2)
    return (gsym @ feats.float()).to(feats.dtype)


def _check(feats: torch.Tensor) -> None:
    """Raises for what the kernels do not take; a ``meta`` tensor passes
    the same checks."""
    if feats.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {feats.device}")
    if feats.dtype not in _DTYPE:
        raise TypeError(f"feats dtype {feats.dtype} not in {list(_DTYPE)}")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous (B, F, d) tensor")


def _vec(feats: torch.Tensor) -> int:
    """1 when every row and chunk starts 16-byte aligned (the kernels'
    cp.async and vector path)."""
    return int((feats.shape[2] * feats.element_size()) % 16 == 0
               and feats.data_ptr() % 16 == 0)


def _forward(feats: torch.Tensor) -> torch.Tensor:
    if feats.device.type == "cpu":
        return dot_interaction_plain(feats)
    _check(feats)
    b, f, d = feats.shape
    out = torch.empty((b, f * (f - 1) // 2), dtype=feats.dtype,
                      device=feats.device)
    if out.numel() == 0:
        return out
    shape = launch_shape(f, feats.element_size())
    if feats.device.type == "meta":
        meta.record("dot_interaction", work(b, f, d, dtype=feats.dtype))
        return out
    with meta.launch_range("dot_interaction"):
        err = _lib().dot_interaction(
            feats.data_ptr(), _DTYPE[feats.dtype], b, f, d, shape["rows"],
            shape["row_elems"], shape["threads"], shape["smem_bytes"],
            _vec(feats), out.data_ptr(),
            torch.cuda.current_stream(feats.device).cuda_stream)
    if err:
        raise RuntimeError(f"dot_interaction launch failed: cudaError {err}")
    launches["dot_interaction"] += 1
    return out


def dot_interaction_backward(feats: torch.Tensor, grad: torch.Tensor
                             ) -> torch.Tensor:
    """``feats (B, F, d)``, ``grad (B, F(F-1)/2)`` in feats' dtype → ``dX
    (B, F, d)``: the backward kernel for a CUDA tensor, the plain version
    for a CPU one, the meta path (:func:`backward_work` recorded) for a
    meta one."""
    if feats.device.type == "cpu":
        return dot_interaction_backward_plain(feats, grad)
    _check(feats)
    b, f, d = feats.shape
    if grad.shape != (b, f * (f - 1) // 2) or grad.dtype != feats.dtype:
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} does not "
                         f"match the output of feats {tuple(feats.shape)} "
                         f"{feats.dtype}")
    if grad.device != feats.device:
        raise ValueError(f"grad is on {grad.device}, feats on "
                         f"{feats.device}")
    grad = grad.contiguous()
    if grad.data_ptr() % 4:          # the kernel copies g in 4-byte words
        grad = grad.clone()
    dx = torch.empty_like(feats)
    if dx.numel() == 0:
        return dx
    if grad.numel() == 0:
        return dx.zero_()
    shape = backward_launch_shape(f, d, feats.element_size())
    if feats.device.type == "meta":
        meta.record("dot_interaction_backward",
                    backward_work(b, f, d, dtype=feats.dtype))
        return dx
    with meta.launch_range("dot_interaction_backward"):
        err = _lib().dot_interaction_backward(
            feats.data_ptr(), grad.data_ptr(), _DTYPE[feats.dtype], b, f, d,
            shape["chunk"], shape["stages"], shape["threads"],
            shape["smem_bytes"], _vec(feats), dx.data_ptr(),
            torch.cuda.current_stream(feats.device).cuda_stream)
    if err:
        raise RuntimeError(f"dot_interaction_backward launch failed: "
                           f"cudaError {err}")
    launches["dot_interaction_backward"] += 1
    return dx


class DotInteractionFn(torch.autograd.Function):
    """The pairwise dots with the backward kernel as their gradient."""

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        return _forward(feats)

    @staticmethod
    def backward(ctx, grad):
        (feats,) = ctx.saved_tensors
        return dot_interaction_backward(feats, grad)


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """``feats (B, F, d)`` f32/bf16/f16 → ``(B, F(F-1)/2)`` pairwise dots;
    through :class:`DotInteractionFn` when autograd needs ``feats``'
    gradient."""
    if torch.is_grad_enabled() and feats.requires_grad:
        return DotInteractionFn.apply(feats)
    return _forward(feats)
