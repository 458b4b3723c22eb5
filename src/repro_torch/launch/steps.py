"""Step functions for train / prefill / decode (mirror of the one-device
half of ``repro.launch.steps``).

``make_train_step`` keeps the JAX step's order: the loss and its gradient,
clipping by the global norm, then AdamW (weight decay 0.01) or Adafactor on
a linear-warmup cosine schedule. Where the JAX step is jitted with its
parameters and optimizer state donated, the port's step updates them in
place under ``torch.no_grad()``, leaf by leaf (a slice of a leaf at a time),
and the clipped gradient overwrites the gradient: it never holds a second
copy of the parameters or the state. The mesh half (shardings, FSDP,
ZeRO-1, abstract inputs, ``jit_for_cell``) is ROADMAP queue 1 item 13 part
3; a ``mesh`` raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import decode_step, forward, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (
    adafactor_update_,
    adamw_update_,
    clip_by_global_norm_,
    linear_warmup_cosine,
)
from repro_torch.utils import tree_flatten, tree_map

ADAFACTOR_THRESHOLD = 50_000_000_000  # >=50B params -> factored optimizer


def pick_optimizer(cfg: ModelConfig) -> str:
    return "adafactor" if cfg.param_count() >= ADAFACTOR_THRESHOLD else "adamw"


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a mesh for the LM steps (shardings, FSDP, ZeRO-1) is not ported yet: "
            "ROADMAP queue 1 item 13 part 3"
        )


def make_train_step(
    cfg: ModelConfig,
    mesh=None,
    optimizer: Optional[str] = None,
    lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    clip_norm: float = 1.0,
):
    """(train_step, optimizer name). ``train_step(params, opt_state, batch,
    step)`` returns (params, opt_state, {'loss', 'ce', 'aux', 'grad_norm'})
    with the parameters and state updated in place (the same objects) and
    the metrics as float32 scalar tensors on the parameters' device
    (``grad_norm`` before clipping)."""
    _no_mesh(mesh)
    optimizer = optimizer or pick_optimizer(cfg)
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    schedule = linear_warmup_cosine(lr, warmup, total_steps)

    def train_step(params, opt_state, batch, step):
        leaves = tree_flatten(params)[0]
        before = [p.requires_grad for p in leaves]
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss, metrics = loss_fn(cfg, params, batch)
                flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p, r in zip(leaves, before):
                p.requires_grad_(r)
        # A leaf the loss does not reach (an audio encoder's token table) gets
        # a zero gradient, as jax.grad gives it.
        by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, flat)}
        del flat
        grads = tree_map(lambda p: by_id[id(p)], params)
        gnorm = clip_by_global_norm_(grads, clip_norm)
        if optimizer == "adamw":
            adamw_update_(params, grads, opt_state, step, lr=schedule, weight_decay=0.01)
        else:
            adafactor_update_(params, grads, opt_state, step, lr=schedule)
        out_metrics = {
            "loss": loss.detach(),
            "ce": metrics["ce"].detach(),
            "aux": metrics["aux"].detach(),
            "grad_norm": gnorm,
        }
        return params, opt_state, out_metrics

    return train_step, optimizer


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch)``: the next-token logits (B, V) of the
    last position (the full frame-level logits for an encoder)."""
    _no_mesh(mesh)

    def prefill_step(params, batch):
        logits, _aux = forward(cfg, params, batch)
        if cfg.family == "encoder":
            return logits          # full frame-level logits (504-way)
        return logits[:, -1, :]    # TTFT: next-token logits only

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, cache, tokens, pos)`` -> (next tokens, cache),
    the cache updated in place (the JAX step donates it). The JAX package's
    ``batch_shardable`` and ``weight_gather`` choose shardings and wait for
    the mesh."""
    _no_mesh(mesh)

    def serve_step(params, cache, tokens, pos):
        next_tokens, _logits, cache = decode_step(cfg, params, cache, tokens, pos)
        return next_tokens, cache

    return serve_step
