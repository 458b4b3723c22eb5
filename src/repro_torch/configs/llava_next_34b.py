"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

The transformer BACKBONE only; the anyres vision frontend is a stub per the
assignment: input_specs provide precomputed patch embeddings (anyres 2x2 grid
+ base view of 576 patches each => 2880 frontend tokens).

56 heads do not divide the 16-way model axis -> 'row' attention sharding
(weights sharded on d_model, partial-sum reduce). See §Perf for the head_dim
alternative explored in the hillclimb.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    frontend="vision_stub",
    n_frontend_tokens=2880,   # anyres: 4 tiles + base view, 576 patches each
    attn_sharding="row",
    mlp_sharding="ff",
)
