"""Unified model configuration for the assigned architecture pool (mirror of
``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.utils import round_up


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True              # False for encoder-only
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1              # MoE ffn every `period` layers (1 = all)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    attn_period: int = 0             # hybrid: attention every `period` layers
    attn_offset: int = 0             # position of the attn layer inside period

    # --- frontends (stubs per assignment) ---
    frontend: str = "text"           # text | vision_stub | audio_stub
    n_frontend_tokens: int = 0       # patches / frames prepended to the seq

    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 512            # online-softmax KV chunk
    logical_max_seq: int = 524_288

    # --- sharding policy knobs (see sharding/policies.py) ---
    force_fsdp: Optional[bool] = None  # pin the FSDP decision (calibration)
    unroll_for_costing: bool = False   # unroll scans so cost_analysis counts
                                       # every iteration (roofline calibration)
    attn_sharding: str = "heads"     # heads | row | replicated | head_dim
    mlp_sharding: str = "ff"         # ff | replicated
    shard_vocab: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ----- derived -----
    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pattern(self) -> Tuple[Tuple[str, str], ...]:
        """Layer pattern of one scan unit: ((mixer, ffn), ...).

        mixer in {attn, mamba}; ffn in {dense, moe, none}.
        """
        if self.family == "ssm":
            return (("mamba", "none"),)
        if self.family == "hybrid":
            period = self.attn_period or 8
            out = []
            for j in range(period):
                mixer = "attn" if j == (self.attn_offset % period) else "mamba"
                ffn = (
                    "moe"
                    if (self.n_experts and j % self.moe_period == self.moe_period - 1)
                    else "dense"
                )
                out.append((mixer, ffn))
            return tuple(out)
        ffn = "moe" if self.n_experts else "dense"
        if self.n_experts and self.moe_period > 1:
            out = []
            for j in range(self.moe_period):
                out.append(("attn", "moe" if j == self.moe_period - 1 else "dense"))
            return tuple(out)
        return (("attn", ffn),)

    @property
    def n_units(self) -> int:
        plen = len(self.pattern)
        if self.n_layers % plen:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {plen}"
            )
        return self.n_layers // plen

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        D, V = self.d_model, self.vocab_padded
        hd = self.head_dim
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V
        for mixer, ffn in self.pattern:
            reps = self.n_units
            if mixer == "attn":
                qkv = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                o = self.n_heads * hd * D
                bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
                n += reps * (qkv + o + bias + D)
            else:
                din = self.d_inner
                G = 1  # n_groups
                inproj = D * (2 * din + 2 * G * self.ssm_state + self.n_ssm_heads)
                n += reps * (
                    inproj
                    + self.ssm_conv * (din + 2 * G * self.ssm_state)
                    + 3 * self.n_ssm_heads
                    + din * D
                    + din
                    + D
                )
            if ffn == "dense":
                n += reps * (3 * D * self.d_ff + D)
            elif ffn == "moe":
                fe = self.d_ff_expert or self.d_ff
                n += reps * (D * self.n_experts + 3 * D * fe * self.n_experts + D)
        n += D  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        D = self.d_model
        fe = self.d_ff_expert or self.d_ff
        n_moe_layers = sum(
            1 for _, f in self.pattern if f == "moe"
        ) * self.n_units
        inactive = n_moe_layers * 3 * D * fe * (
            self.n_experts - self.experts_per_token
        )
        return self.param_count() - inactive
