"""Gradient compression for a slow cross-node all-reduce (mirror of
``repro.optim.compression``).

Two schemes, both with the standard convergence safeguards:

  * top-k sparsification with ERROR FEEDBACK (Stich et al.): each worker
    keeps the residual of what it did not transmit and adds it to the next
    step's gradient — unbiased in the limit, required for convergence.
  * int8 quantization with per-chunk scales and STOCHASTIC ROUNDING, its
    noise drawn from a ``torch.Generator`` (the JAX package draws it from a
    ``jax.random`` key: the same distribution, not the same numbers).

``compressed_psum`` wraps ``torch.distributed.all_reduce`` (a process group
the caller has initialized), where the JAX package wraps ``lax.psum`` inside
``shard_map``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.utils import tree_flatten, tree_map


class TopKState(NamedTuple):
    residual: torch.Tensor  # error-feedback memory, same shape as grad


def topk_compress(
    grad: torch.Tensor,
    state: TopKState,
    k_frac: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor, TopKState]:
    """Returns (values (k,), indices (k,), new_state). Transmits only the
    top-k |grad + residual| entries, largest first; the rest accumulates in
    the residual. (``jax.lax.top_k`` takes the lower index among equal
    magnitudes; ``torch.topk`` promises no order among them.)"""
    flat = (grad + state.residual).reshape(-1)
    k = max(1, int(flat.numel() * k_frac))
    _, idx = torch.topk(torch.abs(flat), k)
    sel = flat[idx]
    sparse = torch.zeros_like(flat).index_put_((idx,), sel)
    new_state = TopKState(residual=(flat - sparse).reshape(grad.shape))
    return sel, idx, new_state


def topk_decompress(values, indices, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.zeros(n, dtype=values.dtype, device=values.device)
    return flat.index_put_((indices,), values).reshape(tuple(shape))


def int8_quantize(
    x: torch.Tensor, generator: torch.Generator, chunk: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk absmax int8 with stochastic rounding.
    Returns (q (N,) int8, scales (N/chunk,) float32)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % chunk
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, chunk)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    y = blocks / scale
    noise = torch.rand(y.shape, generator=generator, device=generator.device).to(y.device) - 0.5
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor, shape, chunk: int = 256):
    blocks = q.reshape(-1, chunk).to(torch.float32) * scales[:, None]
    n = 1
    for s in shape:
        n *= int(s)
    return blocks.reshape(-1)[:n].reshape(tuple(shape))


def compressed_psum(grads, generator: torch.Generator, scheme: str = "int8",
                    group: Optional[object] = None):
    """The sum over the process group of each gradient leaf, after an int8
    quantize-dequantize round trip (``scheme='int8'``; anything else sums the
    leaves as they are). The dequantized payloads are summed, so the sum is
    associative. Returns a tree of ``grads``' structure; needs an initialized
    ``torch.distributed`` process group."""
    import torch.distributed as dist

    def one(g):
        out = g
        if scheme == "int8":
            q, s = int8_quantize(g, generator)
            out = int8_dequantize(q, s, g.shape)
        out = out.clone() if out is g else out
        dist.all_reduce(out, group=group)
        return out

    # The noise is drawn leaf by leaf in jax's order, as the JAX package
    # splits one key a leaf in that order.
    done = {id(g): one(g) for g in tree_flatten(grads)[0]}
    return tree_map(lambda g: done[id(g)], grads)
