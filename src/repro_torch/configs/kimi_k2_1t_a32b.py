"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384e top-8, expert d_ff=2048 — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].

Expert parallelism: 384 experts / 16-way model axis = 24 experts per device.
Training uses Adafactor (launch/train.py picks it for >=100B param counts) so
optimizer state fits v5e HBM.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,               # dense-FFN dim unused: every layer is MoE
    vocab=163840,
    n_experts=384,
    experts_per_token=8,
    d_ff_expert=2048,
    moe_period=1,
    attn_sharding="heads",
    mlp_sharding="replicated",
)
