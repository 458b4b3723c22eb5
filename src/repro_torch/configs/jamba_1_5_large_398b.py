"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Pattern per 8-layer unit: attention at position 4, Mamba elsewhere (1:7);
MoE FFN on every second layer (16 experts, top-2), dense FFN otherwise.
Runs long_500k: the Mamba layers are O(n); the sparse attention layers see
the full 500k KV cache sequence-sharded across the model axis.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    experts_per_token=2,
    d_ff_expert=24576,
    moe_period=2,
    attn_period=8,
    attn_offset=4,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=64,
    attn_sharding="heads",
    mlp_sharding="ff",
)
