"""Shared model layers: norms, embeddings, rotary embeddings, losses (mirror
of ``repro.models.layers``)."""
from __future__ import annotations

import torch


def no_constrain(x, axes):
    """The identity sharding hook (``constrain(x, logical_axes)``) that the
    model's functions take by default: one device, or a mesh whose hook
    (``sharding/policies.py::make_constrain``) the caller passes."""
    return x


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """RMSNorm: the statistics in float32, the normalize multiply in the
    activation dtype (as the JAX package casts them)."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None]
    return x * inv.to(x.dtype) * weight.to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim//2) in float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, hd); cos/sin (..., S, hd//2) broadcast over heads.

    Each rotation pairs element i with element i + hd/2 (the two halves),
    which is what the JAX package's code does, whatever its docstring says."""
    half = x.shape[-1] // 2
    x1 = x[..., :half]
    x2 = x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor):
    """Token embedding lookup (the JAX package's gather form; its one-hot
    matmul form serves vocab-sharded tables and has no caller here)."""
    return table[tokens]


def softmax_xent(
    logits: torch.Tensor,     # (B, S, V)
    labels: torch.Tensor,     # (B, S) int
    mask: torch.Tensor,       # (B, S) 0/1 valid positions
    vocab: int,               # logical (unpadded) vocab size
):
    """Stable mean cross-entropy; padded vocab tail masked out."""
    nll, count = softmax_xent_parts(logits, labels, mask, vocab)
    return nll / torch.clamp(count, min=1.0)


def softmax_xent_parts(logits, labels, mask, vocab: int):
    """(the masked sum of the cross-entropy, the mask's sum): the numerator
    and denominator of :func:`softmax_xent`, which a batch split over data
    rows adds up row by row before it divides."""
    logits = logits.float()
    V = logits.shape[-1]
    if V > vocab:
        pad_mask = torch.arange(V, device=logits.device) >= vocab
        logits = torch.where(pad_mask, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()
