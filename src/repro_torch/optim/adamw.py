"""AdamW on trees of tensors (mirror of ``repro.optim.adamw``).

The parameters are a tree of tensors: a dataclass whose fields are tensors,
such as a ``GaussianScene``, or the nested dicts of a language model. The
learning rate is a scalar, a schedule ``fn(step)``, or a tree of the
parameters' structure holding one scalar per leaf (3D-GS scene training
gives each parameter group its own rate). The arithmetic is the JAX
package's, in its order: the moments in float32, the update in float32 and
cast to the parameter's dtype (a bf16 parameter's weight-decay product is
taken in bf16 first, as JAX's weak-typed scalar keeps it).

``adamw_update_`` writes the step into the parameters and the state in
place, a slice of a leaf at a time, so that a step never holds a second
copy of the state (the JAX step donates its buffers instead).
``adamw_update`` runs it on a copy and returns new trees.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.utils import tree_copy, tree_flatten, tree_map

# Elements of a leaf updated at once by the in-place form: bounds its float32
# temporaries to a few times 128 MiB whatever the leaf's size.
INPLACE_CHUNK = 1 << 25


class AdamWState(NamedTuple):
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _is_tree(lr) -> bool:
    return isinstance(lr, Mapping) or (dataclasses.is_dataclass(lr) and not isinstance(lr, type))


def _corrections(step, b1, b2, dev):
    # Bias corrections in float32, as jnp.power on a float32 t computes them
    # (a Python float power would be float64 and drift by ulps).
    t = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), t)
    return c1, c2


def _prepare(params, step, lr, b1, b2):
    """(bias corrections c1, c2, the rate tree) on the parameters' device."""
    if callable(lr):
        lr = lr(step)
    dev = tree_flatten(params)[0][0].device
    c1, c2 = _corrections(step, b1, b2, dev)
    as_rate = lambda r: torch.as_tensor(r, dtype=torch.float32, device=dev)
    if _is_tree(lr):
        rates = tree_map(lambda p, r: as_rate(r), params, lr)
    else:
        rate = as_rate(lr)
        rates = tree_map(lambda p: rate, params)
    return c1, c2, rates


def _leaf(p, g, m, v, rate, c1, c2, b1, b2, eps, weight_decay):
    """One leaf's (new p, new m, new v)."""
    m = b1 * m + (1 - b1) * g.to(torch.float32)
    v = b2 * v + (1 - b2) * torch.square(g.to(torch.float32))
    p = (p - rate * ((m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p)).to(p.dtype)
    return p, m, v


@torch.no_grad()
def adamw_update_(
    params,
    grads,
    state: AdamWState,
    step,
    lr: Union[float, Any, Callable] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """One AdamW step in place: the parameters and moments are overwritten,
    a slice of a leaf at a time (the arithmetic is elementwise, so slicing
    changes no value). ``step`` counts from 0. Returns (params, state), the
    same objects."""
    c1, c2, rates = _prepare(params, step, lr, b1, b2)

    def one(p, g, m, v, rate):
        flat = [x.view(-1) for x in (p, m, v)] + [g.reshape(-1)]
        for lo in range(0, p.numel(), INPLACE_CHUNK):
            pc, mc, vc, gc = (x[lo:lo + INPLACE_CHUNK] for x in flat)
            new = _leaf(pc, gc, mc, vc, rate, c1, c2, b1, b2, eps, weight_decay)
            for dst, src in zip((pc, mc, vc), new):
                dst.copy_(src)

    tree_map(one, params, grads, state.mu, state.nu, rates)
    return params, state


def adamw_scalars(step, lr, device, b1: float = 0.9, b2: float = 0.999):
    """(c1, c2, rate) of step ``step`` on ``device``, as the in-place form
    computes them for a scalar rate or a schedule."""
    if callable(lr):
        lr = lr(step)
    c1, c2 = _corrections(step, b1, b2, device)
    return c1, c2, torch.as_tensor(lr, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_piece_(p, g, m, v, scalars, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> None:
    """One AdamW step in place on a slice of a leaf: ``p`` and ``g`` may be
    strided views of a larger piece (a ZeRO-1 state shard's part of its
    parameter), ``m`` and ``v`` its moments. Updated a block of axis 0 at a
    time; elementwise, so the values are those of :func:`adamw_update_`."""
    c1, c2, rate = scalars
    rows = max(1, INPLACE_CHUNK // max(1, p[0].numel()))
    for lo in range(0, p.shape[0], rows):
        sl = slice(lo, lo + rows)
        pc, gc, mc, vc = p[sl], g[sl], m[sl], v[sl]
        new = _leaf(pc, gc, mc, vc, rate, c1, c2, b1, b2, eps, weight_decay)
        for dst, src in zip((pc, mc, vc), new):
            dst.copy_(src)


def adamw_update(params, grads, state: AdamWState, step, *args, **kw):
    """One AdamW step; returns (new params, new state) and leaves its inputs
    as they are (``adamw_update_`` on copies; the same arguments)."""
    return adamw_update_(tree_copy(params), grads, tree_copy(state), step, *args, **kw)
