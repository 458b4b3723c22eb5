"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=49155,
    attn_sharding="heads",
    mlp_sharding="ff",
)
