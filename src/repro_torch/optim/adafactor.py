"""Adafactor (Shazeer & Stern, arXiv:1804.04235) with a factored second
moment (mirror of ``repro.optim.adafactor``).

Picked for the >= 50B configs (``launch/steps.py::pick_optimizer``): the
factored rows and columns of the second moment cost O(n + m) instead of
O(nm), and there is no first moment. The state's leaves and their order are
the JAX package's (``AdafactorState(stats)`` of ``FactoredLeaf(vr, vc, v)``),
so a checkpoint of either package holds the same leaves.

A stacked-layer leaf (U, ...) is updated one unit slice at a time: each
slice is one layer's tensor, and its float32 temporaries then cost 1/U of
the leaf. The JAX package unrolls the slices for U <= 4 and ``lax.map``s
them above; both are the same arithmetic per slice, as this loop is.
``adafactor_update_`` writes the step in place; ``adafactor_update`` runs
it on a copy and returns new trees.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils import tree_copy, tree_map


class FactoredLeaf(NamedTuple):
    vr: Any   # row statistics   (shape[:-1])
    vc: Any   # col statistics   (shape[:-2] + shape[-1:])
    v: Any    # full statistics for <2D leaves ((1,) placeholder otherwise)


class AdafactorState(NamedTuple):
    stats: Any  # tree of FactoredLeaf


def _factored(shape) -> bool:
    return len(shape) >= 2


def stacked(shape) -> bool:
    """A stacked-layer leaf, updated one unit slice at a time."""
    return len(shape) >= 3 and shape[0] > 1 and _factored(shape[1:])


def adafactor_init(params) -> AdafactorState:
    def init_leaf(p):
        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return FactoredLeaf(vr=zeros(p.shape[:-1]), vc=zeros(p.shape[:-2] + p.shape[-1:]),
                                v=zeros((1,)))
        return FactoredLeaf(vr=zeros((1,)), vc=zeros((1,)), v=zeros(p.shape))

    return AdafactorState(stats=tree_map(init_leaf, params))


def _hyper(step, lr, decay, device):
    if callable(lr):
        lr = lr(step)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=device)
    t = torch.as_tensor(step, dtype=torch.float32, device=device) + 1.0
    return lr, 1.0 - torch.pow(t, -decay)


def _update(p, g, s: FactoredLeaf, lr, beta2, eps1, eps2, clip_threshold, weight_decay):
    """One (unstacked) tensor's (new p, new FactoredLeaf)."""
    g = g.to(torch.float32)
    g2 = torch.square(g) + eps1
    if _factored(p.shape):
        vr = beta2 * s.vr + (1 - beta2) * torch.mean(g2, dim=-1)
        vc = beta2 * s.vc + (1 - beta2) * torch.mean(g2, dim=-2)
        # rank-1 reconstruction of the second moment
        denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps1)
        vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
        u = g / torch.sqrt(vhat + eps1)
        new_s = FactoredLeaf(vr=vr, vc=vc, v=s.v)
    else:
        v = beta2 * s.v + (1 - beta2) * g2
        u = g / torch.sqrt(v + eps1)
        new_s = FactoredLeaf(vr=s.vr, vc=s.vc, v=v)
    # update clipping (RMS)
    rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps1)
    u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
    p32 = p.to(torch.float32)
    scale = torch.clamp(torch.sqrt(torch.mean(torch.square(p32))), min=eps2)
    new_p = p32 - lr * scale * u - lr * weight_decay * p32
    return new_p.to(p.dtype), new_s


@torch.no_grad()
def adafactor_update_(
    params,
    grads,
    state: AdafactorState,
    step,
    lr=1e-2,
    decay: float = 0.8,
    eps1: float = 1e-30,
    eps2: float = 1e-3,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """One Adafactor step in place, a unit slice of a stacked leaf at a
    time. Returns (params, state), the same objects."""
    kw = dict(eps1=eps1, eps2=eps2, clip_threshold=clip_threshold, weight_decay=weight_decay)

    def write(p, g, s: FactoredLeaf, lr_t, beta2):
        new_p, new_s = _update(p, g, s, lr_t, beta2, **kw)
        p.copy_(new_p)
        for dst, src in zip(s, new_s):
            if dst is not src:
                dst.copy_(src)

    def leaf(p, g, s):
        lr_t, beta2 = _hyper(step, lr, decay, p.device)
        if not stacked(p.shape):
            write(p, g, s, lr_t, beta2)
            return
        for i in range(p.shape[0]):
            write(p[i], g[i], FactoredLeaf(vr=s.vr[i], vc=s.vc[i], v=s.v), lr_t, beta2)

    tree_map(leaf, params, grads, state.stats)
    return params, state


def leaf_update(p, g, s: FactoredLeaf, step, lr=1e-2, decay: float = 0.8, eps1: float = 1e-30,
                eps2: float = 1e-3, clip_threshold: float = 1.0, weight_decay: float = 0.0):
    """One unstacked tensor's (new p, new FactoredLeaf), out of place: the
    arithmetic :func:`adafactor_update_` applies to it (a mesh step runs it
    on a leaf gathered whole from its shards, so the factored statistics are
    the whole leaf's)."""
    lr_t, beta2 = _hyper(step, lr, decay, p.device)
    return _update(p, g, s, lr_t, beta2, eps1, eps2, clip_threshold, weight_decay)


def adafactor_update(params, grads, state: AdafactorState, step, *args, **kw):
    """One Adafactor step; returns (new params, new state) and leaves its
    inputs as they are (``adafactor_update_`` on copies; the same arguments)."""
    return adafactor_update_(tree_copy(params), grads, tree_copy(state), step, *args, **kw)
