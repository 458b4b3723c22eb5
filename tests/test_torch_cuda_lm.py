"""The port's LM serving path on a card. Every test here is marked ``cuda``
and skips without one.

The module imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lm.py

Weights and tokens come from seeded torch generators. Tolerances: float32
decode against the full forward within 2e-3 (the JAX package's own bound,
``tests/test_models_attention.py``); the card's float32 decode logits within
1e-4 of the host's from the same weights (cuBLAS and the CPU's BLAS sum in
other orders). TF32 is off for these tests.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import build_param_spec, forward
from repro_torch.models.spec import init_from_spec
from repro_torch.utils import tree_map
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

DECODERS = sorted(a for a in ARCHS if get_config(a).family != "encoder")
DECODE_VS_FORWARD = 2e-3
CARD_VS_HOST = 1e-4


@pytest.fixture()
def no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def teacher_forced(cfg, params, tokens):
    """Logits (B, T, V) of ``tokens`` stepped through decode_step by the
    serve loop."""
    logits = []
    generate(cfg, params, tokens, 0, on_step=lambda phase, pos, lg, nxt: logits.append(lg))
    return torch.stack(logits, dim=1)


def text_batch(cfg, tokens):
    batch = {"tokens": tokens}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.zeros(tokens.shape[0], 0, cfg.d_model,
                                            device=tokens.device)
    return batch


def test_granite_full_width_float32_decode_matches_forward(cuda_device, no_tf32):
    """granite-3-2b at full width and depth in float32 (10.5 GB): 32
    teacher-forced positions of 2 prompts through decode_step against
    forward."""
    cfg = dataclasses.replace(get_config("granite-3-2b"), param_dtype="float32",
                              activation_dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    with torch.inference_mode():
        params = init_from_spec(build_param_spec(cfg), gen, cuda_device)
        toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=cuda_device)
        dec = teacher_forced(cfg, params, toks)
        full, _ = forward(cfg, params, {"tokens": toks})
    assert dec.shape == (2, 32, cfg.vocab_padded)
    assert float((dec - full).abs().max()) <= DECODE_VS_FORWARD


@pytest.mark.parametrize("arch", DECODERS)
def test_smoke_decode_on_the_card_matches_the_host(arch, cuda_device, no_tf32):
    cfg = get_smoke_config(arch)
    with torch.inference_mode():
        params_h = init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(2), "cpu")
        toks_h = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(3))
        params_d = tree_map(lambda x: x.to(cuda_device), params_h)
        dec_d = teacher_forced(cfg, params_d, toks_h.to(cuda_device))
        dec_h = teacher_forced(cfg, params_h, toks_h)
        fwd_d, _ = forward(cfg, params_d, text_batch(cfg, toks_h.to(cuda_device)))
    assert dec_d.device.type == "cuda"
    assert float((dec_d.cpu() - dec_h).abs().max()) <= CARD_VS_HOST
    assert float((dec_d - fwd_d).abs().max()) <= DECODE_VS_FORWARD
