"""Gradient utilities: global-norm clipping, finite checks (mirror of
``repro.optim.grad_utils``)."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_copy, tree_flatten

# Elements of a leaf widened to float32 at once by ``global_norm``.
NORM_CHUNK = 1 << 25


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) with float32 accumulation. A bf16 leaf is
    widened a slice at a time (exact), never as a whole float32 copy; the
    JAX package contracts it with ``preferred_element_type`` instead."""
    leaves = tree_flatten(tree)[0]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = add_squares(total, x)
    return torch.sqrt(total)


def add_squares(total: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``total`` plus the sum of squares of ``x`` (float32, a slice of
    NORM_CHUNK elements at a time, each added in turn)."""
    flat = x.reshape(-1)
    for lo in range(0, flat.numel(), NORM_CHUNK):
        c = flat[lo:lo + NORM_CHUNK].to(torch.float32)
        total = total + torch.dot(c, c)
    return total


@torch.no_grad()
def clip_by_global_norm_(tree, max_norm: float) -> torch.Tensor:
    """Scales ``tree``'s leaves in place to a global norm of at most
    ``max_norm``; returns the norm before clipping. The scale is cast to
    each leaf's dtype before the multiply: bf16 * float32 would promote the
    leaf to float32."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for x in tree_flatten(tree)[0]:
        x.mul_(scale.to(x.dtype))
    return norm


def clip_by_global_norm(tree, max_norm: float):
    """(a copy of ``tree`` clipped by ``clip_by_global_norm_``, the norm
    before clipping); ``tree`` is left as it is."""
    out = tree_copy(tree)
    return out, clip_by_global_norm_(out, max_norm)


def all_finite(tree) -> torch.Tensor:
    return torch.stack([torch.isfinite(x).all() for x in tree_flatten(tree)[0]]).all()
