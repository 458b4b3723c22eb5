"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), chunked form
(mirror of ``repro.models.mamba2``, forward and decode; plain autograd
differentiates the forward, finite through ``_segsum``'s -inf mask).

The SSD recurrence per head (state N, head dim P):
    h_t = a_t * h_{t-1} + b_t^T (dt_t * x_t)      h in R^{N x P}
    y_t = c_t h_t + D * x_t
with a_t = exp(-dt_t * exp(A_log)) scalar per head, b/c shared across heads
(n_groups=1). Within a chunk the quadratic term C_i (prod a) B_j^T is masked
lower-triangular; across chunks a short loop carries the (H, N, P) state.
Contractions accumulate in float32 (bf16 operands widened, which is exact).

Decode is the O(1) recurrent update on a persistent (B, H, N, P) state plus a
depthwise-conv ring buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import no_constrain


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    threshold (torch's softplus returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(log_a: torch.Tensor):
    """log_a (..., L) -> (..., L, L) lower-tri cumulative segment sums:
    out[i, j] = sum_{k=j+1..i} log_a_k for i >= j, -inf otherwise."""
    L = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(L, device=log_a.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P) inputs (dt applied by caller)
    log_a: torch.Tensor,  # (B, S, H) per-step log decay (negative)
    b: torch.Tensor,      # (B, S, N)  input projections (n_groups=1)
    c: torch.Tensor,      # (B, S, N)  output projections
    chunk: int,
) -> torch.Tensor:
    """Returns y (B, S, H, P) in float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = chunk
    pad = (-S) % L
    if pad:
        # zero-padded tail: b=0 adds nothing to the state, log_a=0 (decay 1)
        # carries it unchanged; padded outputs are sliced off below.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        S = S + pad
    nc = S // L

    xr = x.reshape(B, nc, L, H, P)
    ar = log_a.reshape(B, nc, L, H)
    br = b.reshape(B, nc, L, N)
    cr = c.reshape(B, nc, L, N)

    # --- intra-chunk (quadratic) term; the decay masks stay float32 and are
    # cast to x's dtype before the contraction, as in the JAX package ---
    seg = _segsum(ar.permute(0, 1, 3, 2))                 # (B,nc,H,L,L)
    decay = torch.exp(seg)
    scores = torch.einsum("bcln,bcmn->bclm", cr.float(), br.float())
    mat = (scores[:, :, None, :, :] * decay).to(x.dtype)  # (B,nc,H,L,L)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", mat.float(), xr.float())

    # --- chunk states: sum_j (prod_{j+1..L} a) b_j x_j ---
    a_cum = torch.cumsum(ar, dim=2)                       # (B,nc,L,H)
    a_tail = a_cum[:, :, -1:, :] - a_cum                  # decay to chunk end
    w = torch.exp(a_tail).to(x.dtype)
    states = torch.einsum("bcln,bclh,bclhp->bchnp", br.float(), w.float(), xr.float())

    # --- inter-chunk recurrence over nc (short sequential loop) ---
    a_chunk = a_cum[:, :, -1, :]                          # (B,nc,H) total decay
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    h_before = []
    for ci in range(nc):
        h_before.append(h)
        h = h * torch.exp(a_chunk[:, ci])[..., None, None] + states[:, ci]
    h_before = torch.stack(h_before, dim=1)               # (B,nc,H,N,P)

    # --- inter-chunk contribution: y += (c_t * decay_to_chunk_start) h_prev
    w_in = torch.exp(a_cum).to(x.dtype)
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", cr.float(), w_in.float(),
                           h_before.to(x.dtype).float())
    y = (y_intra + y_inter).reshape(B, S, H, P)
    if pad:
        y = y[:, : S - pad]
    return y


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg):
    din, N = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, [din, din, 2 * N, zxbcdt.shape[-1] - 2 * din - 2 * N],
                       dim=-1)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, norm_w: torch.Tensor, dtype):
    """y * silu(z), RMS-normalized in float32, cast to ``dtype``, times the
    norm weight (Mamba-2's norm before out_proj)."""
    y = y * F.silu(z.float()).to(y.dtype)
    y32 = y.float()
    y = (y32 * torch.rsqrt((y32 * y32).mean(-1, keepdim=True) + 1e-6)).to(dtype)
    return y * norm_w


def mamba_forward(
    p: dict,
    x: torch.Tensor,     # (B, S, D)
    cfg,
    constrain=no_constrain,
) -> torch.Tensor:
    """Full Mamba-2 mixer block (in_proj -> conv -> SSD -> gate -> out_proj)."""
    B, S, D = x.shape
    din, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim

    z, xin, bc, dt = _split_zxbcdt(x @ p["in_proj"], cfg)
    # depthwise causal conv over (x, b, c)
    xbc = _causal_conv(torch.cat([xin, bc], dim=-1), p["conv_w"], p["conv_b"], cfg.ssm_conv)
    xin, b, c = torch.split(xbc, [din, N, N], dim=-1)

    dt = softplus(dt.float() + p["dt_bias"].float())      # (B,S,H)
    a = -torch.exp(p["A_log"].float())                    # (H,)
    log_a = dt * a[None, None, :]

    xh = xin.reshape(B, S, H, P)
    xh = constrain(xh, ("batch", None, "ssm_heads", None))
    xdt = xh * dt[..., None].to(x.dtype)
    y = ssd_chunked(xdt, log_a, b, c, cfg.ssm_chunk)
    y = y + (xh * p["D"].to(x.dtype)[None, None, :, None]).float()
    y = y.reshape(B, S, din).to(x.dtype)
    return _gated_norm(y, z, p["norm_w"], x.dtype) @ p["out_proj"]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, width: int):
    """Depthwise causal conv1d. x (B,S,C), w (width,C)."""
    S = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):  # small static width (4)
        out = out + xp[:, i : i + S, :].float() * w[i][None, None, :]
    out = out + bias[None, None, :]
    return F.silu(out).to(x.dtype)


def mamba_decode(
    p: dict,
    x: torch.Tensor,           # (B, 1, D)
    ssm_state: torch.Tensor,   # (B, H, N, P)
    conv_state: torch.Tensor,  # (B, width-1, din+2N)
    cfg,
):
    """Single-token recurrent step. Returns (y, new_ssm_state, new_conv_state)."""
    B = x.shape[0]
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim

    z, xin, bc, dt = _split_zxbcdt((x @ p["in_proj"])[:, 0], cfg)   # (B, .)
    xbc = torch.cat([xin, bc], dim=-1)                    # (B, din+2N)

    # conv ring buffer
    hist = torch.cat([conv_state, xbc[:, None, :]], dim=1)   # (B,width,C)
    new_conv_state = hist[:, 1:, :]
    conv = torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float())
    conv = F.silu(conv + p["conv_b"][None, :].float())
    xin, b, c = torch.split(conv.to(x.dtype), [din, N, N], dim=-1)
    b = b.float()
    c = c.float()

    dt_ = softplus(dt.float() + p["dt_bias"][None, :])     # (B,H)
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt_ * a[None, :])                   # (B,H)

    xh = xin.reshape(B, H, P).float() * dt_[..., None]
    upd = torch.einsum("bn,bhp->bhnp", b, xh)
    new_state = ssm_state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c, new_state)
    y = y + xin.reshape(B, H, P).float() * p["D"][None, :, None]
    y = y.reshape(B, din)

    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6)
    y = (y.to(x.dtype) * p["norm_w"])[:, None, :]
    return y @ p["out_proj"], new_state, new_conv_state


def w_full(p, width):
    """The packed causal-conv weight ``p["conv_w"]`` in float32 (``width``
    is unused, as in the JAX package)."""
    return p["conv_w"].float()
