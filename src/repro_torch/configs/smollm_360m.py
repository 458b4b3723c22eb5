"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

15 heads (kv=5) divide neither 16-way TP nor anything useful — at 360M the
model is replicated on the model axis except the MLP hidden and vocab.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    tie_embeddings=True,
    attn_sharding="replicated",
    mlp_sharding="ff",
)
