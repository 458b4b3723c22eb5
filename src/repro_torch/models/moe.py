"""Top-k mixture-of-experts with per-group capacity dispatch (mirror of
``repro.models.moe``).

Dispatch is per GROUP = batch row: each row's S*k assignments are ranked
within their expert by a stable sort on the expert id; the first
``capacity`` of each expert keep a slot, the rest go to a trash slot at
``capacity`` and are dropped (GShard semantics). The combine weights each
slot in expert space and scatter-adds it back to its token.

The dispatch is a ``torch.autograd.Function`` with the backward of the JAX
package's ``custom_vjp``: each slot's gradient is scatter-added straight to
its token, where autograd through ``x[:, tok]`` would build the (B, S*k, D)
gradient of the gather first. The router and the aux loss keep their
natural gradients (the top-k ids carry none, the probabilities do).

The aux loss is a product of batch means. A batch split over data rows
(``launch/steps.py``'s mesh step) runs its rows' forwards inside
:func:`record_router_stats`, which keeps each layer's expert counts and mean
router probabilities, and builds the whole batch's loss from them with
:func:`global_load_balance_loss`.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import torch

from repro_torch.models.layers import no_constrain


# The list :func:`load_balance_loss` appends its (counts, mean probabilities,
# tokens) to, inside record_router_stats; None elsewhere (a remat recompute
# in the backward runs outside it and records nothing).
_ROUTER_STATS: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "router_stats", default=None)


def router_topk(
    logits: torch.Tensor,   # (..., E)
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights (..., k), ids (..., k)); renormalized over top-k.

    ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk`` on CUDA
    promises no order among equal values (float32 router probabilities of
    real inputs are practically never equal)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor, n_experts: int):
    """Switch-style aux loss: E * sum_e f_e * p_e, counts by a scatter-add."""
    probs = torch.softmax(logits.float(), dim=-1)
    p_mean = probs.reshape(-1, n_experts).mean(0)
    flat = ids.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.float32, device=logits.device)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                          device=logits.device))
    sink = _ROUTER_STATS.get()
    if sink is not None:
        sink.append((counts, p_mean, probs.numel() // n_experts))
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return n_experts * (f * p_mean).sum()


@contextlib.contextmanager
def record_router_stats():
    """Within the block every :func:`load_balance_loss` also appends its
    layer's (expert counts, mean router probabilities, tokens) to the list
    this yields, in call order."""
    sink: list = []
    token = _ROUTER_STATS.set(sink)
    try:
        yield sink
    finally:
        _ROUTER_STATS.reset(token)


def global_load_balance_loss(rows: List[list], n_experts: int, device) -> torch.Tensor:
    """The aux loss of the whole batch from each row's
    :func:`record_router_stats` list: per layer, E * sum_e f_e * p_e with the
    counts summed over the rows and p the token-weighted mean of the rows'
    mean probabilities (differentiable through them), summed over layers on
    ``device``. The mean of the rows' own losses would be another number."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for layer in zip(*rows, strict=True):
        counts = sum(c.to(device) for c, _, _ in layer)
        tokens = sum(n for _, _, n in layer)
        p_mean = sum(p.to(device) * n for _, p, n in layer) / tokens
        f = counts / torch.clamp(counts.sum(), min=1.0)
        aux = aux + n_experts * (f * p_mean).sum()
    return aux


def capacity_of(cfg, S: int) -> int:
    return max(int(S * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor),
               min(8, S))


def expert_slots(eid: torch.Tensor, n_experts: int, capacity: int):
    """eid (B, A) expert of each assignment -> (pos, keep, slot) (B, A):
    the assignment's rank among its group's assignments to that expert (in
    assignment order), whether it fits the capacity, and its slot (the
    trash slot ``capacity`` when dropped)."""
    B, A = eid.shape
    e_sorted, order = torch.sort(eid, dim=-1, stable=True)
    experts = torch.arange(n_experts, dtype=eid.dtype, device=eid.device)
    seg_start = torch.searchsorted(e_sorted, experts.expand(B, n_experts).contiguous())
    pos_sorted = (torch.arange(A, device=eid.device)
                  - torch.gather(seg_start, 1, e_sorted))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = (pos >= 0) & (pos < capacity)
    slot = torch.where(keep, pos, capacity)
    return pos, keep, slot


class _Dispatch(torch.autograd.Function):
    """x (B, S, D) -> (B, E*(C+1), D) slots; saves (eid, slot) only."""

    @staticmethod
    def forward(ctx, x, eid, slot, n_experts, capacity, k):
        S = x.shape[1]
        tok = torch.arange(S, device=x.device).repeat_interleave(k)
        flat_slot = eid * (capacity + 1) + slot
        xe = torch.zeros(x.shape[0], n_experts * (capacity + 1), x.shape[2], dtype=x.dtype,
                         device=x.device)
        xe.scatter_(1, flat_slot[..., None].expand(-1, -1, x.shape[2]), x[:, tok])
        ctx.save_for_backward(eid, slot)
        ctx.args = (S, n_experts, capacity, k)
        return xe

    @staticmethod
    def backward(ctx, dxe):
        """Each slot's gradient scatter-added to its token's row; the trash
        slots (dropped assignments, and slots no assignment filled) go to
        row S, which is cut off."""
        eid, slot = ctx.saved_tensors
        S, E, capacity, k = ctx.args
        B, _, D = dxe.shape
        tok = torch.arange(S, device=dxe.device).repeat_interleave(k).expand(B, -1)
        tok_slot = torch.full((B, E * (capacity + 1)), S, dtype=torch.int64, device=dxe.device)
        tok_slot.scatter_(1, eid * (capacity + 1) + slot, torch.where(slot < capacity, tok, S))
        dx = torch.zeros(B, S + 1, D, dtype=dxe.dtype, device=dxe.device)
        dx.scatter_add_(1, tok_slot[..., None].expand(-1, -1, D), dxe)
        return dx[:, :S], None, None, None, None, None


def moe_ffn(
    p: dict,            # {'router' (D,E), 'w1' (E,D,F), 'w3' (E,D,F), 'w2' (E,F,D)}
    x: torch.Tensor,    # (B, S, D)
    cfg,
    constrain=no_constrain,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux_loss ())."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    A = S * k  # assignments per group (= per batch row)
    dev = x.device

    logits = x.float() @ p["router"].float()          # f32 accumulation
    weights, ids = router_topk(logits, k)            # (B, S, k)
    aux = load_balance_loss(logits, ids, E)

    capacity = capacity_of(cfg, S)
    eid = ids.reshape(B, A)
    _, keep, slot = expert_slots(eid, E, capacity)
    flat_slot = eid * (capacity + 1) + slot          # (B, A) into E*(C+1)
    tok = torch.arange(S, device=dev).repeat_interleave(k)   # (A,)

    # --- dispatch: each kept assignment's token into its (expert, slot);
    # dropped ones all land in the trash slot, which is cut off. ---
    xe = _Dispatch.apply(x, eid, slot, E, capacity, k)
    xe = xe.view(B, E, capacity + 1, D)[:, :, :capacity]
    # The expert all-to-all in the JAX package: batch on data, experts on model.
    xe = constrain(xe, ("batch", "experts", None, None))

    # --- expert computation (SwiGLU), batched over (B, E) ---
    a = torch.einsum("becd,edf->becf", xe, p["w1"])
    silu = a * torch.sigmoid(a.float()).to(a.dtype)
    h = silu * torch.einsum("becd,edf->becf", xe, p["w3"])
    ye = torch.einsum("becf,efd->becd", h, p["w2"])
    ye = constrain(ye, ("batch", "experts", None, None))

    # --- combine: weight the slots in expert space, scatter-add each slot
    # to its token (an empty slot goes to the dropped row S). ---
    wts = torch.where(keep, weights.reshape(B, A), 0.0).to(x.dtype)
    wslot = torch.zeros(B, E * (capacity + 1), dtype=x.dtype, device=dev)
    wslot.scatter_(1, flat_slot, wts)
    tok_slot = torch.full((B, E * (capacity + 1)), S, dtype=torch.int64, device=dev)
    tok_slot.scatter_(1, flat_slot, tok.expand(B, A).contiguous())
    wslot = wslot.view(B, E, capacity + 1)[:, :, :capacity]
    tok_slot = tok_slot.view(B, E, capacity + 1)[:, :, :capacity]
    contrib = ye * wslot[..., None]                  # (B, E, C, D)
    out = torch.zeros(B, S + 1, D, dtype=x.dtype, device=dev)
    out.scatter_add_(1, tok_slot.reshape(B, E * capacity, 1).expand(-1, -1, D),
                     contrib.reshape(B, E * capacity, D))
    return out[:, :S], aux
