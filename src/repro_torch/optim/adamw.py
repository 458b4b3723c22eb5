"""AdamW on dataclasses of tensors (mirror of ``repro.optim.adamw``).

The parameters are a dataclass whose fields are tensors, such as a
``GaussianScene``; each field is one leaf. The learning rate is a scalar, a
schedule ``fn(step)``, or a dataclass of the same type holding one scalar per
leaf (3D-GS scene training gives each parameter group its own rate). The
arithmetic is the JAX package's, in float32 throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch


class AdamWState(NamedTuple):
    mu: Any
    nu: Any


def _leaves(tree) -> dict:
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def _map(fn, tree, *rest):
    """``fn`` over the fields of one or more dataclasses of the same type."""
    others = [_leaves(r) for r in rest]
    return type(tree)(**{
        name: fn(leaf, *(o[name] for o in others)) for name, leaf in _leaves(tree).items()
    })


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(mu=_map(zeros, params), nu=_map(zeros, params))


def adamw_update(
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
    """One AdamW step; returns (new params, new state). ``step`` counts from
    0. Call it under ``torch.no_grad()`` when the parameters require grad."""
    if callable(lr):
        lr = lr(step)
    dev = next(iter(_leaves(params).values())).device
    # Bias corrections in float32, as jnp.power on a float32 t computes them
    # (a Python float power would be float64 and drift by ulps).
    t = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), t)

    mu = _map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
              state.nu, grads)

    def step_leaf(p, m, v, rate):
        return (p - rate * ((m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p)).to(p.dtype)

    if dataclasses.is_dataclass(lr):
        rates = _map(lambda r: torch.as_tensor(r, dtype=torch.float32, device=dev), lr)
        new_params = _map(step_leaf, params, mu, nu, rates)
    else:
        rate = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        new_params = _map(lambda p, m, v: step_leaf(p, m, v, rate), params, mu, nu)
    return new_params, AdamWState(mu=mu, nu=nu)
