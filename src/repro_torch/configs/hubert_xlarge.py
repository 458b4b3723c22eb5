"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
encoder-only, same arch as w2v2 [arXiv:2106.07447; unverified].

Encoder-only: bidirectional attention, no decode step (decode_32k/long_500k
cells are skipped — see DESIGN.md). The CNN waveform frontend is a stub:
input_specs provide precomputed frame embeddings (B, S, d_model); the 504
'vocab' is the masked-unit prediction target space.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend="audio_stub",
    attn_sharding="heads",
    mlp_sharding="ff",
    shard_vocab=False,       # 504-way output head: too small to shard
)
