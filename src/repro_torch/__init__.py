"""repro_torch — the PyTorch/CUDA port of the LIST reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
module paths (``repro_torch.core.engine`` is the twin of
``repro.core.engine``) and imports nothing from it. Entry points
(:func:`repro_torch.api.load`, :class:`repro_torch.api.Searcher`,
:class:`repro_torch.core.engine.QueryEngine`) run on the CUDA device
unless the caller passes ``device="cpu"``.
"""
