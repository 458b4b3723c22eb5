"""GQA attention: chunked online-softmax prefill and training + KV-cache
decode (mirror of ``repro.models.attention``).

The full (S, S) score matrix is never materialized: the kv axis is walked in
``chunk``-sized blocks with running (max, sum, acc) online-softmax state.
Operands keep their dtype, the contractions accumulate in float32 (the JAX
package's ``preferred_element_type``): bf16 operands are widened, which is
exact, and the products taken in float32.

``chunked_attention`` is a ``torch.autograd.Function`` with the flash
backward of the JAX package's ``custom_vjp``: it saves only (q, k, v, out,
m, l) and recomputes each block's probabilities in the backward, where
plain autograd would keep every block's (B, H, Sq, chunk) float32 tiles.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import apply_rope, no_constrain, rope_angles

NEG_INF = -1e30


class AttnParams(NamedTuple):
    """Empty, kept for documentation as in the JAX package: the attention
    weights are packed in ``lm.py``'s parameter dicts (``wq``, ``wk``,
    ``wv``, ``wo`` and the optional ``bq``, ``bk``, ``bv``)."""


def _repeat_kv(x: torch.Tensor, n_rep: int):
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd): each kv head repeated n_rep
    times in a row (heads g*n_rep .. g*n_rep + n_rep - 1 share kv head g)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _scaled(x: torch.Tensor, scale: float):
    """``x * scale`` in x's dtype, the scalar first rounded to that dtype (as
    JAX rounds a Python scalar against a bf16 array)."""
    s = torch.tensor(scale, dtype=x.dtype).item()
    return (x * s).to(x.dtype)


def chunked_attention(
    q: torch.Tensor,             # (B, Sq, H, hd)
    k: torch.Tensor,             # (B, Skv, H, hd)   (already GQA-expanded)
    v: torch.Tensor,             # (B, Skv, H, hd)
    causal: bool,
    chunk: int = 512,
    q_offset: int = 0,           # absolute position of q[0] (for causal mask)
) -> torch.Tensor:
    """Online-softmax attention over kv blocks. O(Sq * chunk) memory, in the
    forward and in the backward."""
    return _ChunkedAttention.apply(q, k, v, causal, chunk, q_offset)


def _blocks(Skv: int, chunk: int):
    """(start, length) of each kv block. The last block is cut short where
    the JAX package pads it with zeros and masks the pad: a masked score
    adds exp(-1e30 - m) = 0 either way, in the forward and the backward."""
    return [(start, min(chunk, Skv - start)) for start in range(0, Skv, chunk)]


def _block_scores(qf, kc, start, q_pos, causal):
    """The block's (B,H,Sq,c) float32 scores of the scaled q, masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float())
    if causal:
        kv_pos = start + torch.arange(kc.shape[1], device=qf.device)
        s = torch.where(kv_pos[None, :] <= q_pos[:, None], s, NEG_INF)
    return s


def _chunked_attention_fwd_impl(q, k, v, causal, chunk, q_offset):
    """Returns (out (B,Sq,H,hd), m (B,H,Sq), l (B,H,Sq))."""
    B, Sq, H, hd = q.shape
    dev = q.device
    qf = _scaled(q, hd ** -0.5).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    for start, n in _blocks(k.shape[1], chunk):
        kc, vc = k[:, start:start + n], v[:, start:start + n]
        s = _block_scores(qf, kc, start, q_pos, causal)    # (B,H,Sq,c) f32
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float()
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.to(k.dtype)
    return out.transpose(1, 2), m, l  # out (B, Sq, H, hd)


def _chunked_attention_bwd(q, k, v, out, m, l, dout, causal, chunk, q_offset):
    """The flash backward of ``repro.models.attention._chunked_attention_bwd``:
    each block's normalized probabilities recomputed from the saved (m, l),
    per-block transients only. dq accumulates in float32 and is scaled once
    at the end; dk and dv are cast to the operands' dtype a block at a
    time. Returns (dq, dk, dv)."""
    B, Sq, H, hd = q.shape
    scale = hd ** -0.5
    qs = _scaled(q, scale)
    qf = qs.float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    l_safe = torch.clamp(l, min=1e-30)

    # delta_i = rowsum(dout * out) (B,H,Sq): the softmax backward's diagonal.
    dout_t = dout.transpose(1, 2)                         # (B,H,Sq,hd)
    delta = torch.einsum("bhqd,bhqd->bhq", dout_t.float(), out.transpose(1, 2).float())
    do16 = dout_t.to(v.dtype).float()

    dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dk, dv = [], []
    for start, n in _blocks(k.shape[1], chunk):
        kc, vc = k[:, start:start + n], v[:, start:start + n]
        s = _block_scores(qf, kc, start, q_pos, causal)
        p = torch.exp(s - m[..., None]) / l_safe[..., None]          # normalized
        dv.append(torch.einsum("bhqk,bhqd->bkhd", p.to(v.dtype).float(), do16)
                  .to(v.dtype))
        dp = torch.einsum("bhqd,bkhd->bhqk", do16, vc.float())
        ds16 = (p * (dp - delta[..., None])).to(q.dtype).float()     # f32 tile, cast
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds16, kc.float())
        dk.append(torch.einsum("bhqk,bqhd->bkhd", ds16, qf).to(k.dtype))
    dq = (dq * scale).to(q.dtype)
    return dq, torch.cat(dk, dim=1), torch.cat(dv, dim=1)


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, q_offset):
        out, m, l = _chunked_attention_fwd_impl(q, k, v, causal, chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _chunked_attention_bwd(q, k, v, out, m, l, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def _qkv(p: dict, x: torch.Tensor, cfg):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, hd)
        k = k + p["bk"].reshape(KV, hd)
        v = v + p["bv"].reshape(KV, hd)
    return q, k, v


def attention_forward(
    p: dict,                    # {'wq','wk','wv','wo'[,'bq','bk','bv']} flat
    x: torch.Tensor,            # (B, S, D)
    cfg,
    positions: torch.Tensor,    # (S,) absolute positions
    causal: bool,
    constrain=no_constrain,     # fn(tensor, logical_axes) -> tensor
) -> torch.Tensor:
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, ("batch", None, "heads", "head_dim"))
    k = constrain(k, ("batch", None, "kv_heads", "head_dim"))
    v = constrain(v, ("batch", None, "kv_heads", "head_dim"))
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    out = chunked_attention(q, k, v, causal, cfg.attn_chunk, 0)
    out = constrain(out, ("batch", None, "heads", "head_dim"))
    out = out.reshape(B, S, H * hd).to(x.dtype)
    return out @ p["wo"]


def attention_decode(
    p: dict,
    x: torch.Tensor,            # (B, 1, D) current token activations
    cache_k: torch.Tensor,      # (B, S_max, KV, hd)
    cache_v: torch.Tensor,
    pos: int,                   # current position
    cfg,
    constrain=no_constrain,
):
    """One decode step against the KV cache, which it updates in place at
    ``pos``. Returns (out (B,1,D), cache_k, cache_v)."""
    B, _, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_max = cache_k.shape[1]

    q, k, v = _qkv(p, x, cfg)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(posv, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    cache_k = constrain(cache_k, ("cache_batch", "cache_seq", "kv_heads", "head_dim"))
    cache_v = constrain(cache_v, ("cache_batch", "cache_seq", "kv_heads", "head_dim"))

    # Grouped-query attention over the whole cache in float32: query head
    # g*(H//KV) + r reads kv head g (the order of _repeat_kv).
    qg = q.reshape(B, KV, H // KV, hd).float() * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float())   # (B, KV, G, S_max)
    valid = torch.arange(S_max, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, cache_v.float())
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v
