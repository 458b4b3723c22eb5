"""The language models of the port (mirror of ``repro.models``): one
parameterized stack for the ten LM configs, its forward and loss (with its
gradient, for ``launch/steps.py``), and the greedy KV-cache decode step
that ``launch/serve.py`` drives."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (
    LanguageModel,
    build_cache_spec,
    build_param_spec,
    decode_step,
    forward,
    init_cache,
    loss_fn,
    loss_parts,
)

__all__ = [
    "LanguageModel",
    "ModelConfig",
    "build_cache_spec",
    "build_param_spec",
    "decode_step",
    "forward",
    "init_cache",
    "loss_fn",
    "loss_parts",
]
