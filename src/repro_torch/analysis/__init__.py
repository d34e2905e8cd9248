"""Work and roofline analysis of the cells (reference: ``repro.analysis``):
``roofline`` (the H100's peaks, ring arithmetic, the three terms),
``op_cost`` (a call's work counted on meta tensors) and ``op_top`` (the
top operations of one call, profiled on the card or counted on meta)."""
from repro_torch.analysis.roofline import (  # noqa: F401
    collectives,
    model_flops,
    roofline_terms,
    wire_bytes,
)
