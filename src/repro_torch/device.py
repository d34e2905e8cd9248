"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` (a CUDA device with its index);
    raises when it names CUDA and no CUDA device is present. The entry
    points default to ``"cuda"`` and never fall back to the CPU on their
    own: pass ``device="cpu"``. ``meta`` is accepted too: a module
    initialised there has shapes and dtypes and no storage (the cell
    plans' shape path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def full_f32_products(device) -> None:
    """Compute f32 products in full f32 on a CUDA ``device``: TF32 off for
    matmuls and convolutions, process-wide, as the reference computes
    them. A no-op on the CPU."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
