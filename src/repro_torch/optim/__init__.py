"""Optimizers of the port (mirror of ``repro.optim``): AdamW and Adafactor
on trees of tensors (each also in an in-place form), learning-rate
schedules, global-norm clipping and gradient compression."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, adamw_update_
from repro_torch.optim.adafactor import (
    AdafactorState,
    FactoredLeaf,
    adafactor_init,
    adafactor_update,
    adafactor_update_,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.grad_utils import (
    all_finite,
    clip_by_global_norm,
    clip_by_global_norm_,
    global_norm,
)

__all__ = [
    "AdamWState",
    "AdafactorState",
    "FactoredLeaf",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "adafactor_init",
    "adafactor_update",
    "adafactor_update_",
    "cosine_schedule",
    "linear_warmup_cosine",
    "all_finite",
    "clip_by_global_norm",
    "clip_by_global_norm_",
    "global_norm",
]
