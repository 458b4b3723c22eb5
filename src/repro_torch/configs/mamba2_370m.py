"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,            # unused (attn-free); kept for config completeness
    n_kv_heads=16,
    d_ff=0,                # no separate FFN: the Mamba block is the layer
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=64,
    tie_embeddings=True,
    attn_sharding="replicated",
    mlp_sharding="replicated",
)
