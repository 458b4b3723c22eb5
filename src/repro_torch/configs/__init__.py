"""Config registry of the port (mirror of ``repro.configs``): one module per
language-model architecture, plus the GS-TG scenes.

``get_config(name)`` returns the full production ModelConfig;
``get_smoke_config(name)`` returns the reduced same-family variant used by
CPU smoke tests (small layers/width/experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.gs_scenes import (
    EVAL_RESOLUTION,
    PAPER_SCENES,
    SceneSpec,
    scene_and_camera,
)
from repro_torch.models.config import ModelConfig

from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.granite_3_2b import CONFIG as _granite3
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite_moe

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _llava,
        _mamba2,
        _qwen,
        _smollm,
        _granite3,
        _phi4,
        _jamba,
        _hubert,
        _kimi,
        _granite_moe,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: one scan unit, narrow dims, small vocab."""
    cfg = get_config(name)
    plen = len(cfg.pattern)
    hd = 16
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=plen,          # one scan unit
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 8),
        param_dtype="float32",
        activation_dtype="float32",
        attn_chunk=32,
        remat=False,
        attn_sharding="replicated",
        mlp_sharding="replicated",
        shard_vocab=False,
    )
    if cfg.n_experts:
        changes.update(
            n_experts=min(cfg.n_experts, 8),
            experts_per_token=min(cfg.experts_per_token, 2),
            d_ff_expert=64,
            # ample capacity: decode equals the batched forward only when
            # no token is capacity-dropped
            capacity_factor=8.0,
        )
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ARCHS",
    "EVAL_RESOLUTION",
    "PAPER_SCENES",
    "SceneSpec",
    "get_config",
    "get_smoke_config",
    "scene_and_camera",
]
