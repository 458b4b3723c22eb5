"""Unified language model covering the assigned architecture pool (mirror of
``repro.models.lm``: forward, loss and its gradient, greedy decode).

One parameterized decoder/encoder stack supporting:
  * dense GQA transformers (qwen, smollm, granite, phi4, llava backbone)
  * MoE FFNs (kimi-k2, granite-moe, jamba's MoE layers)
  * Mamba-2 mixers (mamba2-370m, jamba hybrid 1:7 interleave)
  * encoder-only bidirectional (hubert)
  * frontend stubs (vision patches / audio frames) prepended to the sequence

The parameter tree is the JAX package's: layers stacked per pattern position
on a leading unit axis U (``units/pos{j}/mixer|ffn|norm1|norm2``), weights
with explicit head axes (wq (U, D, H, hd)) and split mamba weights, so a JAX
tree crosses by ``spec.params_from_numpy``. Where the JAX package scans over
U, the port loops over it, each stacked tensor unbound once (views; the
backward stacks the U gradients in one copy). With ``cfg.remat`` and
gradients on, each unit runs under ``torch.utils.checkpoint``
(non-reentrant): its activations are recomputed in the backward, the
port's counterpart of ``jax.checkpoint`` around the scan body. Eager: no
compilation, no CUDA graphs.

``constrain`` (``fn(tensor, logical_axes)``) is called at the JAX
package's sharding-constraint sites and ``unit_constrain`` (``fn(unit
params)``) on each unit's weights inside the unit loop, under remat too, as
JAX applies it inside the scan body; both default to nothing. Over a mesh
(``launch/steps.py``) the units are ``MeshTensor`` stacks, and
``unit_constrain`` gathers one unit's shards onto the data row's device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attention_decode, attention_forward
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_tokens, no_constrain, rms_norm, softmax_xent_parts
from repro_torch.models.mamba2 import mamba_decode, mamba_forward
from repro_torch.models.moe import moe_ffn
from repro_torch.models.spec import LeafSpec, map_spec, torch_dtype
from repro_torch.utils import resolve_device


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

def build_param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.d_model
    U = cfg.n_units
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype

    def leaf(shape, axes, init="normal", fan_in=None):
        return LeafSpec(tuple(shape), tuple(axes), dt, init, fan_in)

    def attn_spec():
        s = {
            "wq": leaf((U, D, H, hd), (None, "attn_embed", "heads", "head_dim"), fan_in=D),
            "wk": leaf((U, D, KV, hd), (None, "attn_embed", "kv_heads", "head_dim"), fan_in=D),
            "wv": leaf((U, D, KV, hd), (None, "attn_embed", "kv_heads", "head_dim"), fan_in=D),
            "wo": leaf((U, H, hd, D), (None, "heads", "head_dim", "attn_embed"), fan_in=H * hd),
        }
        if cfg.qkv_bias:
            s["bq"] = leaf((U, H, hd), (None, "heads", "head_dim"), init="zeros")
            s["bk"] = leaf((U, KV, hd), (None, "kv_heads", "head_dim"), init="zeros")
            s["bv"] = leaf((U, KV, hd), (None, "kv_heads", "head_dim"), init="zeros")
        return s

    def mamba_spec():
        din, N, SH = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        W = cfg.ssm_conv
        return {
            "wz": leaf((U, D, din), (None, None, "ssm_inner"), fan_in=D),
            "wx": leaf((U, D, din), (None, None, "ssm_inner"), fan_in=D),
            "wbc": leaf((U, D, 2 * N), (None, None, None), fan_in=D),
            "wdt": leaf((U, D, SH), (None, None, "ssm_heads"), fan_in=D),
            "conv_x": leaf((U, W, din), (None, None, "ssm_inner"), init="small_normal"),
            "conv_bc": leaf((U, W, 2 * N), (None, None, None), init="small_normal"),
            "conv_bx": leaf((U, din), (None, "ssm_inner"), init="zeros"),
            "conv_bbc": leaf((U, 2 * N), (None, None), init="zeros"),
            "A_log": leaf((U, SH), (None, "ssm_heads"), init="ones"),
            "D": leaf((U, SH), (None, "ssm_heads"), init="ones"),
            "dt_bias": leaf((U, SH), (None, "ssm_heads"), init="zeros"),
            "norm_w": leaf((U, din), (None, "ssm_inner"), init="ones"),
            "out_proj": leaf((U, din, D), (None, "ssm_inner", None), fan_in=din),
        }

    def dense_ffn_spec():
        F = cfg.d_ff
        return {
            "w1": leaf((U, D, F), (None, None, "ffn"), fan_in=D),
            "w2": leaf((U, F, D), (None, "ffn", None), fan_in=F),
            "w3": leaf((U, D, F), (None, None, "ffn"), fan_in=D),
        }

    def moe_spec():
        E = cfg.n_experts
        F = cfg.d_ff_expert or cfg.d_ff
        return {
            "router": leaf((U, D, E), (None, None, "experts"), fan_in=D),
            "w1": leaf((U, E, D, F), (None, "experts", None, "expert_ffn"), fan_in=D),
            "w3": leaf((U, E, D, F), (None, "experts", None, "expert_ffn"), fan_in=D),
            "w2": leaf((U, E, F, D), (None, "experts", "expert_ffn", None), fan_in=F),
        }

    units: Dict[str, Any] = {}
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        pos: Dict[str, Any] = {"norm1": leaf((U, D), (None, None), init="ones")}
        pos["mixer"] = attn_spec() if mixer == "attn" else mamba_spec()
        if ffn != "none":
            pos["norm2"] = leaf((U, D), (None, None), init="ones")
            pos["ffn"] = dense_ffn_spec() if ffn == "dense" else moe_spec()
        units[f"pos{j}"] = pos

    spec: Dict[str, Any] = {
        "embed": leaf((cfg.vocab_padded, D), (None, "embed_tbl"), fan_in=D),
        "units": units,
        "final_norm": leaf((D,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = leaf((D, cfg.vocab_padded), (None, "vocab"), fan_in=D)
    if cfg.frontend in ("vision_stub", "audio_stub"):
        spec["frontend_proj"] = leaf((D, D), (None, None), fan_in=D)
    return spec


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _mlp(p, x, act: str, constrain=no_constrain):
    h1 = constrain(x @ p["w1"], ("batch", None, "ffn"))
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; torch to erf.
        h = torch.nn.functional.gelu(h1.float(), approximate="tanh").to(x.dtype)
    else:
        silu = h1 * torch.sigmoid(h1.float()).to(x.dtype)
        h = silu * constrain(x @ p["w3"], ("batch", None, "ffn"))
    return h @ p["w2"]


def _flat_attn(p):
    """(D,H,hd)/(H,hd,D) weights of one unit -> flat views for attention.py."""
    D, H, hd = p["wq"].shape
    KV = p["wk"].shape[1]
    q = {"wq": p["wq"].reshape(D, H * hd),
         "wk": p["wk"].reshape(D, KV * hd),
         "wv": p["wv"].reshape(D, KV * hd),
         "wo": p["wo"].reshape(H * hd, D)}
    for b in ("bq", "bk", "bv"):
        if b in p:
            q[b] = p[b].reshape(-1)
    return q


def _mamba_p(p):
    """Assemble the packed views mamba2.py expects from split weights."""
    out = dict(p)
    out["in_proj"] = torch.cat([p["wz"], p["wx"], p["wbc"], p["wdt"]], dim=-1)
    out["conv_w"] = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    out["conv_b"] = torch.cat([p["conv_bx"], p["conv_bbc"]], dim=-1)
    return out


def _unbind_units(tree, n: int) -> list:
    """The ``n`` units of a tree of U-stacked tensors, each leaf unbound
    once: views, so writes land in the stack, and one stack of the U
    gradients in the backward (indexing unit by unit would add U
    full-size gradients). A ``MeshTensor`` leaf unbinds each of its pieces
    once."""
    if isinstance(tree, dict):
        parts = {k: _unbind_units(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _ffn(cfg: ModelConfig, kind: str, p, h, constrain=no_constrain):
    """(output, aux loss) of a dense or MoE FFN."""
    if kind == "dense":
        act = "gelu" if cfg.family == "encoder" else "swiglu"
        return _mlp(p, h, act, constrain), None
    return moe_ffn(p, h, cfg, constrain)


def _unit_forward(cfg: ModelConfig, x, unit_params, positions, constrain=no_constrain,
                  unit_constrain=None):
    if unit_constrain is not None:
        unit_params = unit_constrain(unit_params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        pj = unit_params[f"pos{j}"]
        h = rms_norm(x, pj["norm1"])
        if mixer == "attn":
            y = attention_forward(_flat_attn(pj["mixer"]), h, cfg, positions,
                                  causal=cfg.causal, constrain=constrain)
        else:
            y = mamba_forward(_mamba_p(pj["mixer"]), h, cfg, constrain)
        x = x + y
        if ffn != "none":
            y2, a = _ffn(cfg, ffn, pj["ffn"], rms_norm(x, pj["norm2"]), constrain)
            if a is not None:
                aux = aux + a
            x = x + y2
        x = constrain(x, ("batch", "act_seq", None))
    return x, aux


def _embed_inputs(cfg: ModelConfig, params, batch):
    """Token (+frontend) embedding. Returns (x (B,S,D), loss_mask (B,S))."""
    if cfg.frontend == "text":
        x = embed_tokens(params["embed"], batch["tokens"])
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(batch["tokens"].shape, dtype=torch.float32, device=x.device)
        return x, mask
    if cfg.frontend == "vision_stub":
        tok = embed_tokens(params["embed"], batch["tokens"])
        patches = batch["patch_embeds"].to(tok.dtype) @ params["frontend_proj"]
        x = torch.cat([patches, tok], dim=1)
        mask = torch.cat([
            torch.zeros(patches.shape[:2], dtype=torch.float32, device=x.device),
            torch.ones(tok.shape[:2], dtype=torch.float32, device=x.device),
        ], dim=1)
        return x, mask
    if cfg.frontend == "audio_stub":
        x = batch["frames"].to(torch_dtype(cfg.activation_dtype)) @ params["frontend_proj"]
        return x, torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    raise ValueError(cfg.frontend)


def _logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            constrain=no_constrain, unit_constrain=None):
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss ()). The
    padded vocab tail is not masked here. ``unit_constrain`` runs on each
    unit's weights inside the unit loop (inside the remat boundary, so a
    gather it makes is recomputed in the backward, not held).
    ``params["units"]`` may also be the list of its units, already unbound
    (forwards that share one unbinding also share its gradient's stack), as
    in :func:`decode_step`."""
    x, _ = _embed_inputs(cfg, params, batch)
    x = x.to(torch_dtype(cfg.activation_dtype))
    x = constrain(x, ("batch", "act_seq", None))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    units = params["units"]
    for up in units if isinstance(units, list) else _unbind_units(units, cfg.n_units):
        if remat:
            x, a = checkpoint(_unit_forward, cfg, x, up, positions, constrain, unit_constrain,
                              use_reentrant=False)
        else:
            x, a = _unit_forward(cfg, x, up, positions, constrain, unit_constrain)
        aux = aux + a
    logits = constrain(_logits(cfg, params, x), ("batch", None, "vocab"))
    return logits, aux


def loss_parts(cfg: ModelConfig, params, batch, constrain=no_constrain, unit_constrain=None):
    """(the masked cross-entropy sum, the mask's sum, the aux loss) of a
    batch: what a batch split over data rows adds up row by row."""
    logits, aux = forward(cfg, params, batch, constrain, unit_constrain)
    if cfg.frontend == "vision_stub":
        logits = logits[:, batch["patch_embeds"].shape[1]:, :]
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    nll, count = softmax_xent_parts(logits, labels, mask, cfg.vocab)
    return nll, count, aux


def loss_fn(cfg: ModelConfig, params, batch, constrain=no_constrain, unit_constrain=None):
    """(loss, {'ce', 'aux'}): mean cross-entropy over the text positions plus
    the weighted router aux loss; its gradient holds both terms."""
    nll, count, aux = loss_parts(cfg, params, batch, constrain, unit_constrain)
    ce = nll / torch.clamp(count, min=1.0)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------

def build_cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """LeafSpec tree for the decode cache (shapes + logical axes)."""
    U = cfg.n_units
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    din, N = cfg.d_inner, cfg.ssm_state
    SH, P, W = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    cdt = cfg.activation_dtype
    cache: Dict[str, Any] = {}
    for j, (mixer, _) in enumerate(cfg.pattern):
        if mixer == "attn":
            cache[f"pos{j}"] = {
                "k": LeafSpec((U, batch, max_seq, KV, hd),
                              (None, "cache_batch", "cache_seq", "kv_heads", "head_dim"), cdt, "zeros"),
                "v": LeafSpec((U, batch, max_seq, KV, hd),
                              (None, "cache_batch", "cache_seq", "kv_heads", "head_dim"), cdt, "zeros"),
            }
        else:
            cache[f"pos{j}"] = {
                "ssm": LeafSpec((U, batch, SH, N, P),
                                (None, "cache_batch", "ssm_heads", None, None), "float32", "zeros"),
                "conv_x": LeafSpec((U, batch, W - 1, din),
                                   (None, "cache_batch", None, "ssm_inner"), cdt, "zeros"),
                "conv_bc": LeafSpec((U, batch, W - 1, 2 * N),
                                    (None, "cache_batch", None, None), cdt, "zeros"),
            }
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """The zeroed decode cache on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    return map_spec(
        lambda l: torch.zeros(l.shape, dtype=torch_dtype(l.dtype), device=dev),
        build_cache_spec(cfg, batch, max_seq),
    )


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor, pos: int,
                constrain=no_constrain, unit_constrain=None):
    """One greedy decode step at position ``pos``: writes that position into
    ``cache`` in place. Returns (next_tokens (B,), logits (B, V), cache);
    the vocab tail past ``cfg.vocab`` never wins the argmax (first index on
    ties)."""
    h = embed_tokens(params["embed"], tokens[:, None]).to(torch_dtype(cfg.activation_dtype))
    units = params["units"]
    for up, uc in zip(units if isinstance(units, list) else _unbind_units(units, cfg.n_units),
                      _unbind_units(cache, cfg.n_units)):
        if unit_constrain is not None:
            up = unit_constrain(up)
        for j, (mixer, ffn) in enumerate(cfg.pattern):
            pj, cj = up[f"pos{j}"], uc[f"pos{j}"]
            hin = rms_norm(h, pj["norm1"])
            if mixer == "attn":
                y, _, _ = attention_decode(_flat_attn(pj["mixer"]), hin, cj["k"], cj["v"],
                                           pos, cfg, constrain)
            else:
                y = _mamba_decode_into(_mamba_p(pj["mixer"]), hin, cj, cfg)
            h = h + y
            if ffn != "none":
                y2, _ = _ffn(cfg, ffn, pj["ffn"], rms_norm(h, pj["norm2"]), constrain)
                h = h + y2
    logits = constrain(_logits(cfg, params, h)[:, 0, :], ("batch", "vocab"))
    in_vocab = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    next_tokens = torch.argmax(torch.where(in_vocab, logits, -torch.inf), dim=-1)
    return next_tokens.to(torch.int32), logits, cache


def _mamba_decode_into(mp, hin, cj, cfg):
    """Split conv cache -> packed mamba_decode -> the new states written
    back into the cache views ``cj``."""
    conv_state = torch.cat([cj["conv_x"], cj["conv_bc"]], dim=-1)
    y, new_ssm, new_conv = mamba_decode(mp, hin, cj["ssm"], conv_state, cfg)
    din = cfg.d_inner
    cj["ssm"].copy_(new_ssm)
    cj["conv_x"].copy_(new_conv[..., :din])
    cj["conv_bc"].copy_(new_conv[..., din:])
    return y


# --------------------------------------------------------------------------
# module form
# --------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested dict of tensors registered as parameters (one submodule per
    inner dict), read back as the same nested dict by ``tree()``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        return {k: getattr(self, k).tree() if isinstance(getattr(self, k), _Tree)
                else getattr(self, k) for k in self._keys}


class LanguageModel(nn.Module):
    """The parameter tree as an ``nn.Module`` (``.to``, ``state_dict``,
    ``parameters``) over the functions of this module. Its parameters do
    not require gradients: training goes through the functions on a plain
    tree (``launch/steps.py::make_train_step``)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = _Tree(params)

    def forward(self, batch: Dict[str, torch.Tensor]):
        return forward(self.cfg, self.params.tree(), batch)

    def init_cache(self, batch: int, max_seq: int):
        return init_cache(self.cfg, batch, max_seq, self.params.final_norm.device)

    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        return decode_step(self.cfg, self.params.tree(), cache, tokens, pos)
