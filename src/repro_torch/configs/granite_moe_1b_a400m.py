"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) vocab=49155,
MoE 32e top-8, expert d_ff=512 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    experts_per_token=8,
    d_ff_expert=512,
    moe_period=1,
    attn_sharding="heads",
    mlp_sharding="replicated",
)
