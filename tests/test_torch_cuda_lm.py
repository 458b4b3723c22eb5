"""The port's LM serving and training paths on a card. Every test here is
marked ``cuda`` and skips without one.

The module imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lm.py

Weights and tokens come from seeded torch generators. Tolerances: float32
decode against the full forward within 2e-3 (the JAX package's own bound,
``tests/test_models_attention.py``); the card's float32 decode logits within
1e-4 of the host's from the same weights (cuBLAS and the CPU's BLAS sum in
other orders). Training: the flash and MoE-dispatch Functions within 5e-5
of autograd through their plain versions (the JAX package's own bound for
its flash VJP); a smoke config's loss within 1e-5 relative of the host's
and each gradient leaf within 1e-4 of its largest magnitude (other
summation orders, and CUDA's scatter-adds in no fixed order; the CPU tests
measure up to 8.7e-6 between the port and JAX). Steps over a mesh of the
card against the one-device steps on the card, at the CPU tests' bounds:
metrics at atol/rtol 1e-5 (the gradient norm at rtol 1e-4), prefill
logits at 1e-5, decode tokens equal, and each parameter element after two
steps within 1e-5 of its leaf's largest magnitude plus what Adam makes of
rounding: the mesh sums a gradient element's batch terms in another order,
and Adam divides each element by its own scale, so an element's steps (the
sum of the rates, lr) move by about lr * n / |g|. The bound takes n = 1e-8
of the global gradient norm (chip_smoke's ``lm_mesh`` reads up to 1.2e-9)
and the smaller |g| / norm of the two steps. TF32 is off for these tests.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import TokenStream, make_batch
from repro_torch.launch.serve import generate
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import device_batch
from repro_torch.models import attention, build_param_spec, forward, init_cache, loss_fn, moe
from repro_torch.models.spec import init_from_spec
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.sharding.policies import gather
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

DECODERS = sorted(a for a in ARCHS if get_config(a).family != "encoder")
DECODE_VS_FORWARD = 2e-3
CARD_VS_HOST = 1e-4
FUNCTION_VS_AUTOGRAD = 5e-5
LOSS_CARD_VS_HOST = 1e-5
GRAD_CARD_VS_HOST = 1e-4
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
GRAD_NOISE = 1e-8
MESH_LR = (1e-3, 1, 10)   # rate, warm-up steps, total steps
MESH_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-370m"]


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


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def naive_attention(q, k, v, causal):
    s = torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_function_matches_autograd_on_the_card(causal, cuda_device, no_tf32):
    """Output and dq, dk, dv of the flash Function against autograd through
    a full-softmax attention: S 200 over chunk 64 (the last block cut)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, w = (torch.randn(2, 200, 4, 32, generator=gen, device=cuda_device)
                  for _ in range(4))
    outs = []
    for fn in (lambda a, b, c: attention.chunked_attention(a, b, c, causal, 64, 0),
               lambda a, b, c: naive_attention(a, b, c, causal)):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        outs.append([out.detach(), *torch.autograd.grad((out * w).sum(), xs)])
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= FUNCTION_VS_AUTOGRAD


def test_dispatch_function_matches_autograd_on_the_card(cuda_device):
    """The MoE dispatch Function's slots and gradient against autograd
    through the plain gather and scatter, with dropped assignments."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    B, S, D, E, k, cap = 2, 64, 16, 8, 2, 12
    weights = 1.0 / torch.arange(1, E + 1, dtype=torch.float32, device=cuda_device)
    eid = torch.multinomial(weights, B * S * k, replacement=True, generator=gen).view(B, S * k)
    _, keep, slot = moe.expert_slots(eid, E, cap)
    assert not bool(keep.all())
    x = torch.randn(B, S, D, generator=gen, device=cuda_device)
    w = torch.randn(B, E, cap, D, generator=gen, device=cuda_device)
    tok = torch.arange(S, device=cuda_device).repeat_interleave(k)
    index = (eid * (cap + 1) + slot)[..., None].expand(-1, -1, D)
    outs = []
    for fn in (lambda xx: moe._Dispatch.apply(xx, eid, slot, E, cap, k),
               lambda xx: torch.zeros(B, E * (cap + 1), D, device=cuda_device)
               .scatter(1, index, xx[:, tok])):
        xx = x.clone().requires_grad_(True)
        xe = fn(xx).view(B, E, cap + 1, D)[:, :, :cap]
        outs.append((xe.detach(), torch.autograd.grad((xe * w).sum(), xx)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert float((outs[0][1] - outs[1][1]).abs().max()) <= FUNCTION_VS_AUTOGRAD


def smoke_loss_and_grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_flatten(params)[0]]
    loss, _ = loss_fn(cfg, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_gradients_on_the_card_match_the_host(arch, cuda_device, no_tf32):
    cfg = get_smoke_config(arch)
    params_h = init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(2), "cpu")
    batch_h = device_batch(make_batch(TokenStream(cfg.vocab, 2, 32, seed=3), 0, cfg.frontend,
                                      cfg.n_frontend_tokens, cfg.d_model), "cpu")
    loss_h, grads_h = smoke_loss_and_grads(cfg, params_h, batch_h)
    loss_d, grads_d = smoke_loss_and_grads(cfg, tree_map(lambda x: x.to(cuda_device), params_h),
                                           tree_map(lambda x: x.to(cuda_device), batch_h))
    assert abs(loss_d.item() - loss_h.item()) <= LOSS_CARD_VS_HOST * abs(loss_h.item())
    for d, h in zip(grads_d, grads_h):
        assert d.device.type == "cuda"
        assert float((d.cpu() - h).abs().max()) <= GRAD_CARD_VS_HOST * float(h.abs().max())


def test_bf16_train_steps_on_the_card(cuda_device):
    """granite-3-2b's smoke config in bf16 with remat: five AdamW steps on
    one batch on the card, finite and falling, the parameters still bf16
    and on the card."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), param_dtype="bfloat16",
                              activation_dtype="bfloat16", remat=True)
    params = init_from_spec(build_param_spec(cfg),
                            torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    step, _ = make_train_step(cfg, lr=1e-3, warmup=0)
    opt = adamw_init(params)
    batch = device_batch(make_batch(TokenStream(cfg.vocab, 2, 64, seed=0), 0), cuda_device)
    losses = [step(params, opt, batch, i)[2]["loss"].item() for i in range(5)]
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 and p.is_cuda for p in tree_flatten(params)[0])


# --------------------------------------------------------------------------
# steps over a mesh of the card
# --------------------------------------------------------------------------

def mesh_against_one_device(cfg, mesh, device, n_steps=2):
    """Two train steps over ``mesh`` and on ``device`` from the same
    parameters and batches: the metrics and the parameters after them, each
    element within the bound of the module docstring."""
    params = init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), device)
    placed = steps.place_params(cfg, mesh, params)
    rate, warmup, total = MESH_LR
    one, _ = make_train_step(cfg, lr=rate, warmup=warmup, total_steps=total)
    over, _ = make_train_step(cfg, mesh, lr=rate, warmup=warmup, total_steps=total)
    lr_sum = sum(float(linear_warmup_cosine(rate, warmup, total)(i)) for i in range(n_steps))
    opt, mopt = adamw_init(params), steps.init_opt_state(placed, "adamw")
    stream = TokenStream(cfg.vocab, 4, 32, seed=3)
    ratio = []   # each leaf's least |g| / global norm, element by element
    for i in range(n_steps):
        b = device_batch(make_batch(stream, i, cfg.frontend, cfg.n_frontend_tokens, cfg.d_model),
                         device)
        grads = smoke_loss_and_grads(cfg, params, b)[1]
        gnorm = float(sum(g.double().square().sum() for g in grads).sqrt())
        ratio = [torch.minimum(r, g.abs() / gnorm) for r, g in zip(ratio, grads)] or [
            g.abs() / gnorm for g in grads]
        del grads
        _, _, m1 = one(params, opt, b, i)
        _, _, mm = over(placed, mopt, b, i)
        for key in ("loss", "ce", "aux"):
            assert abs(mm[key].item() - m1[key].item()) <= TOL["atol"] + TOL["rtol"] * abs(
                m1[key].item()), key
        assert abs(mm["grad_norm"].item() - m1["grad_norm"].item()) <= GRAD_TOL * abs(
            m1["grad_norm"].item())
    pairs = list(zip(tree_flatten(gather(placed, device))[0], tree_flatten(params)[0]))
    for (a, b), r in zip(pairs, ratio, strict=True):
        assert a.device == b.device
        bound = PARAM_TOL * float(b.abs().max()) + lr_sum * GRAD_NOISE / r.clamp(min=1e-30)
        assert bool(((a - b).abs() <= bound).all())
    return placed


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_train_steps_on_the_card_match_one_device(arch, fsdp, cuda_device, no_tf32):
    """A (2, 2) mesh of the card listed four times, FSDP off and on, ZeRO-1
    state: every shard lives on the card."""
    cfg = dataclasses.replace(get_smoke_config(arch), force_fsdp=fsdp)
    mesh = make_host_mesh(2, 2, devices=[cuda_device] * 4)
    placed = mesh_against_one_device(cfg, mesh, cuda_device)
    assert all(t.is_cuda for m in tree_flatten(placed)[0] for _, _, t in m.distinct())


def test_mesh_train_step_over_the_card_and_the_host(cuda_device, no_tf32):
    """A (2, 1) mesh of [card, host]: row 1 computes on the host, the
    replicas of each slice on the two devices add their gradients and
    refresh each other after the ZeRO-1 update."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    mesh = make_host_mesh(2, 1, devices=[cuda_device, "cpu"])
    placed = mesh_against_one_device(cfg, mesh, cuda_device)
    assert {t.device.type for m in tree_flatten(placed)[0] for _, _, t in m.distinct()} == {
        "cuda", "cpu"}


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_prefill_and_decode_on_the_card_match_one_device(arch, cuda_device, no_tf32):
    cfg = dataclasses.replace(get_smoke_config(arch), force_fsdp=True)
    mesh = make_host_mesh(2, 2, devices=[cuda_device] * 4)
    with torch.inference_mode():
        params = init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0),
                                cuda_device)
        placed = steps.place_params(cfg, mesh, params)
        b = device_batch(make_batch(TokenStream(cfg.vocab, 4, 16, seed=2), 0), cuda_device)
        want = steps.make_prefill_step(cfg)(params, b)
        got = steps.make_prefill_step(cfg, mesh)(placed, b).gather()
        assert float((got - want).abs().max()) <= TOL["atol"] + TOL["rtol"] * float(
            want.abs().max())
        cache1, cachem = init_cache(cfg, 4, 6, cuda_device), steps.mesh_cache(cfg, mesh, 4, 6)
        one, over = steps.make_decode_step(cfg), steps.make_decode_step(cfg, mesh)
        t1 = tm = b["tokens"][:, 0]
        for pos in range(4):
            t1, cache1 = one(params, cache1, t1, pos)
            tm, cachem = over(placed, cachem, tm, pos)
            assert torch.equal(tm.gather(), t1)
