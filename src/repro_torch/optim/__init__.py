"""Optimizers, gradient clipping and learning-rate schedules of the port
(reference: ``repro.optim``): functions over lists of tensors, the
reference's arithmetic."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_lr,
    cosine_schedule,
    linear_warmup_cosine,
    linear_warmup_linear_decay,
)
