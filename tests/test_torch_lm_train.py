"""The port's LM training path against the JAX package's, on the CPU: the
flash backward of ``chunked_attention`` and the MoE dispatch backward (the
JAX package's two ``custom_vjp``s, here ``torch.autograd.Function``s),
``loss_fn``'s gradient on the granite-3-2b, granite-moe-1b-a400m and
mamba2-370m smoke configs (float32), three ``make_train_step`` steps with
AdamW and with Adafactor, and the port's own: remat bitwise no remat, a
finite step for every arch's smoke config, ``train()`` resuming a bf16 run
bitwise, the CLI, ``examples/train_lm.py``, and the three step builders over
a mesh against one device.

The JAX parameters come from ``repro.models.spec.init_from_spec`` and
cross through ``params_from_numpy``; other inputs from numpy seeds.
Tolerances (stated, never loosened):
  * values (outputs, losses, metrics): atol/rtol 1e-5 in float32, as the
    serving path's tests hold them;
  * gradients: each leaf's max-abs difference within GRAD_TOL = 1e-4 of
    that leaf's largest magnitude (max |g|), and a step's gradient norm
    within rtol GRAD_TOL (JAX's jitted step is 2.2e-5 from its own eager
    ``global_norm`` on the first step here). Measured: flash 1.3e-7-5.6e-7,
    MoE dispatch 2.2e-7-4.5e-7, loss_fn 1.3e-6 (granite), 1.4e-6 (MoE),
    8.7e-6 (mamba2): float32 sums of other orders, amplified through the
    SSD's exp and cumsum;
  * parameters after three steps: each leaf within PARAM_TOL = 1e-5 of its
    largest magnitude (the updates are lr-sized; a gradient at noise level
    can flip an Adam step's sign, which stays far inside the bound at lr
    1e-4);
  * bfloat16 (the dtype the full-width configs train in): a leaf's
    max-abs difference within BF16_MAX = 2**-8 of its largest magnitude
    (one bf16 ulp of it) and its mean-abs difference within BF16_MEAN =
    1e-4 of its mean magnitude. Measured, flash: max 4.7e-4, mean 1.8e-6
    (most elements bitwise); with the backward's products taken in float32
    (p16 and ds16 not cast to bf16) the mean gap is 1.5e-3-1.8e-3 on every
    one of dq, dk, dv, so that code fails the bound tenfold. The MoE
    expert weights: max 1.2e-4, mean 8.6e-8. Where bf16 rounding differs
    between the packages through a whole chain of ops (the router's path
    to x and the router; every leaf of ``loss_fn``), the bound is
    BF16_CHAIN_MAX = 2**-5 of the largest and BF16_CHAIN_MEAN = 5e-2 of
    the mean magnitude, against 7.8e-3 and 1.6e-2 measured (float32
    control of the same code: 1.5e-6): it holds the gap, and the
    per-Function bounds above catch a misplaced cast.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import spec as jspec
from repro import optim as joptim
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenStream, make_batch
from repro_torch.examples import train_lm as train_lm_example
from repro_torch.launch import steps, train as train_mod
from repro_torch.launch.train import device_batch
from repro_torch.models import attention, build_param_spec, loss_fn, moe, spec
from repro_torch.optim import adafactor_init, adamw_init
from repro_torch.utils import tree_flatten, tree_map

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
BF16_MAX, BF16_MEAN = 2.0**-8, 1e-4
BF16_CHAIN_MAX, BF16_CHAIN_MEAN = 2.0**-5, 5e-2
IDENT = lambda x, a: x  # noqa: E731
ARCHS = sorted(jconfigs.ARCHS)
LOSS_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-370m"]


def jax_params(cfg, seed=0):
    return jspec.init_from_spec(jmodels.build_param_spec(cfg), jax.random.key(seed))


def carry(tree):
    return spec.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def grad_close(port, ref, what=""):
    """``port``'s max-abs difference from ``ref`` within GRAD_TOL of the
    largest magnitude of ``ref``."""
    a = port.detach().float().numpy()
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape, what
    gap = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert gap <= GRAD_TOL, f"{what}: {gap}"


def bf16_close(port, ref, what="", max_rel=BF16_MAX, mean_rel=BF16_MEAN):
    """A bf16 ``port`` against a bf16 ``ref``: the max-abs difference within
    ``max_rel`` of ref's largest magnitude, the mean-abs difference within
    ``mean_rel`` of its mean magnitude."""
    assert port.dtype == torch.bfloat16 and np.asarray(ref).dtype.name == "bfloat16", what
    a = port.detach().float().numpy()
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape, what
    d = np.abs(a - b)
    assert d.max() <= max_rel * np.abs(b).max(), f"{what}: max {d.max() / np.abs(b).max()}"
    assert d.mean() <= mean_rel * np.abs(b).mean(), f"{what}: mean {d.mean() / np.abs(b).mean()}"


def as_dtype(x, dtype):
    """A float32 numpy array in ``dtype`` ("float32" or "bfloat16"), as numpy."""
    return np.asarray(jnp.asarray(x, jnp.dtype(dtype)))


def text_batch(cfg, B=2, S=32, seed=1):
    b = make_batch(TokenStream(cfg.vocab, B, S, seed=seed), 0, cfg.frontend,
                   cfg.n_frontend_tokens, cfg.d_model)
    return b, device_batch(b, "cpu")


# --------------------------------------------------------------------------
# the flash backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,skv", [(40, 40), (24, 40), (32, 64)])
def test_flash_gradients_match_the_custom_vjp(causal, sq, skv, dtype):
    """dq, dk, dv of sum(out * w) against JAX's custom_vjp: chunk 16, Skv
    40 (not a multiple: the last block is cut short) or 64, and q rows at
    the end of the kv axis (q_offset = Skv - Sq); in float32 and in bf16,
    where the backward's casts (p16, ds16, dk and dv a block at a time)
    change the values."""
    rng = np.random.default_rng(sq + skv + causal)
    B, H, hd, chunk = 2, 3, 16, 16
    q, k, v = (as_dtype(rng.standard_normal((B, s, H, hd)), dtype) for s in (sq, skv, skv))
    w = as_dtype(rng.standard_normal((B, sq, H, hd)), dtype)
    off = skv - sq

    def f(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal, chunk, off, False)
        return jnp.sum((out * w).astype(jnp.float32))

    jout = jattn.chunked_attention(q, k, v, causal, chunk, off, False)
    jg = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (spec.params_from_numpy(x, "cpu").requires_grad_(True) for x in (q, k, v))
    out = attention.chunked_attention(tq, tk, tv, causal, chunk, off)
    (out.float() * spec.params_from_numpy(w, "cpu").float()).sum().backward()
    if dtype == "bfloat16":
        bf16_close(out, jout, "out")
        for name, a, b in zip("qkv", (tq, tk, tv), jg):
            bf16_close(a.grad, b, f"d{name}")
        return
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name, a, b in zip("qkv", (tq, tk, tv), jg):
        grad_close(a.grad, b, f"d{name}")


def test_flash_gradients_through_gqa_attention_forward():
    """attention_forward with GQA (4 heads on 2 kv heads, repeat_interleave
    summed back by autograd), RoPE and S = 40 over chunk 32: the gradients
    of every weight and of x."""
    cfg, jcfg = (configs.get_smoke_config("granite-3-2b"),
                 jconfigs.get_smoke_config("granite-3-2b"))
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.attn_chunk) == (4, 2, 32)
    rng = np.random.default_rng(7)
    D, H, KV, hd, S = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 40
    p = {"wq": rng.standard_normal((D, H * hd)), "wk": rng.standard_normal((D, KV * hd)),
         "wv": rng.standard_normal((D, KV * hd)), "wo": rng.standard_normal((H * hd, D))}
    p = {k: (v * D ** -0.5).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    w = rng.standard_normal((2, S, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)

    def f(p, x):
        return jnp.sum(jattn.attention_forward(p, x, jcfg, pos, True, IDENT) * w)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(p, x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = attention.attention_forward(tp, tx, cfg, torch.from_numpy(pos), True)
    (out * torch.from_numpy(w)).sum().backward()
    grad_close(tx.grad, jgx, "dx")
    for k in p:
        grad_close(tp[k].grad, jgp[k], k)


# --------------------------------------------------------------------------
# the MoE dispatch backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_gradients_match_with_drops(dtype):
    """moe_ffn's gradients (x, router, w1, w3, w2) of sum(out * w) + 3 aux
    against JAX's at capacity factor 1: some assignments are dropped (their
    gradient must not reach their token through the dispatch). In bf16 the
    expert weights' gradients are held per Function (BF16_MAX, BF16_MEAN);
    x's and the router's, which also pass the router's path, per chain."""
    kw = dict(capacity_factor=1.0, param_dtype=dtype, activation_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("granite-moe-1b-a400m"), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-1b-a400m"), **kw)
    rng = np.random.default_rng(0)
    D, E, F, S = cfg.d_model, cfg.n_experts, cfg.d_ff_expert, 32
    p = {"router": rng.standard_normal((D, E)) * 0.3, "w1": rng.standard_normal((E, D, F)) * 0.1,
         "w3": rng.standard_normal((E, D, F)) * 0.1, "w2": rng.standard_normal((E, F, D)) * 0.1}
    p = {k: as_dtype(v, dtype) for k, v in p.items()}
    x = as_dtype(rng.standard_normal((2, S, D)), dtype)
    w = as_dtype(rng.standard_normal((2, S, D)), dtype)

    def f(p, x):
        out, aux = jmoe.moe_ffn(p, x, jcfg, IDENT)
        return jnp.sum((out * w).astype(jnp.float32)) + 3.0 * aux

    jgp, jgx = jax.grad(f, argnums=(0, 1))(p, x)
    tp = {k: spec.params_from_numpy(v, "cpu").requires_grad_(True) for k, v in p.items()}
    tx = spec.params_from_numpy(x, "cpu").requires_grad_(True)
    with torch.no_grad():
        ids = moe.router_topk(tx.float() @ tp["router"].float(), cfg.experts_per_token)[1]
        _, keep, _ = moe.expert_slots(ids.reshape(2, -1), E, moe.capacity_of(cfg, S))
    assert 0 < int((~keep).sum()) < keep.numel()
    out, aux = moe.moe_ffn(tp, tx, cfg)
    ((out.float() * spec.params_from_numpy(w, "cpu").float()).sum() + 3.0 * aux).backward()
    if dtype == "bfloat16":
        chain = dict(max_rel=BF16_CHAIN_MAX, mean_rel=BF16_CHAIN_MEAN)
        bf16_close(tx.grad, jgx, "dx", **chain)
        bf16_close(tp["router"].grad, jgp["router"], "router", **chain)
        for k in ("w1", "w3", "w2"):
            bf16_close(tp[k].grad, jgp[k], k)
        return
    grad_close(tx.grad, jgx, "dx")
    for k in p:
        grad_close(tp[k].grad, jgp[k], k)


def test_dispatch_function_equals_autograd_through_the_gather():
    """The dispatch Function's backward against autograd through the plain
    ``x[:, tok]`` gather and scatter, at a drop-heavy capacity."""
    g = torch.Generator().manual_seed(3)
    B, S, D, E, k, cap = 2, 24, 8, 4, 2, 3
    eid = torch.randint(0, E, (B, S * k), generator=g)
    _, keep, slot = moe.expert_slots(eid, E, cap)
    assert not bool(keep.all())
    x = torch.randn(B, S, D, generator=g, requires_grad=True)
    w = torch.randn(B, E, cap, D, generator=g)
    xe = moe._Dispatch.apply(x, eid, slot, E, cap, k).view(B, E, cap + 1, D)[:, :, :cap]
    (dx,) = torch.autograd.grad((xe * w).sum(), x)
    x2 = x.detach().clone().requires_grad_(True)
    tok = torch.arange(S).repeat_interleave(k)
    plain = torch.zeros(B, E * (cap + 1), D).scatter(
        1, (eid * (cap + 1) + slot)[..., None].expand(-1, -1, D), x2[:, tok])
    plain = plain.view(B, E, cap + 1, D)[:, :, :cap]
    assert torch.equal(plain, xe)
    (dx2,) = torch.autograd.grad((plain * w).sum(), x2)
    torch.testing.assert_close(dx, dx2, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# loss_fn's gradient
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_value_and_grad(arch):
    cfg = jconfigs.get_smoke_config(arch)
    return jax.jit(jax.value_and_grad(lambda p, b: jmodels.loss_fn(cfg, p, b, IDENT), has_aux=True))


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_every_gradient_leaf_match(arch):
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    ref = jax_params(jcfg)
    params = carry(ref)
    np_batch, batch = text_batch(cfg)
    (jloss, jm), jg = jax_value_and_grad(arch)(ref, {k: jnp.asarray(v) for k, v in np_batch.items()})
    leaves = tree_flatten(params)[0]
    for p in leaves:
        p.requires_grad_(True)
    loss, m = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, a, b in zip(names, grads, jleaves):
        grad_close(a, b, name)
    if arch == "granite-moe-1b-a400m":   # the aux term reaches the router
        assert m["aux"].item() > 0 and all(float(g.abs().max()) > 0 for g in grads)


def test_bf16_loss_and_every_gradient_leaf_within_the_chain_bound():
    """granite-moe-1b-a400m's smoke config (attention's flash Function and
    the MoE dispatch) in bf16, as the full-width configs train: the loss
    within rtol 1e-4 of JAX's (measured 2.0e-5) and every gradient leaf
    within the chain bound (measured 1.6e-2 of the max, 1.3e-2 of the
    mean)."""
    arch = "granite-moe-1b-a400m"
    kw = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **kw)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **kw)
    ref = jax_params(jcfg)
    params = carry(ref)
    np_batch, batch = text_batch(cfg)
    (jloss, _), jg = jax.value_and_grad(lambda p, b: jmodels.loss_fn(jcfg, p, b, IDENT),
                                        has_aux=True)(ref, {k: jnp.asarray(v)
                                                            for k, v in np_batch.items()})
    leaves = tree_flatten(params)[0]
    assert {p.dtype for p in leaves} == {torch.bfloat16}
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, a, b in zip(names, grads, jax.tree.leaves(jg), strict=True):
        bf16_close(a, b, name, max_rel=BF16_CHAIN_MAX, mean_rel=BF16_CHAIN_MEAN)


def test_remat_is_bitwise_no_remat():
    """Each unit under torch.utils.checkpoint (recomputed in the backward)
    gives the same loss and gradients, bit for bit, on the CPU."""
    cfg = dataclasses.replace(configs.get_smoke_config("jamba-1.5-large-398b"), n_layers=16)
    assert cfg.n_units == 2
    params = spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), "cpu")
    _, batch = text_batch(cfg)
    leaves = tree_flatten(params)[0]
    for p in leaves:
        p.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss, _ = loss_fn(dataclasses.replace(cfg, remat=remat), params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_three_train_steps_match(optimizer):
    """granite-3-2b's smoke config from the same JAX parameters, three steps
    on the token stream's batches (warmup 1, so step 0 moves nothing but
    the optimizer state): the metrics of every step and the parameters
    after the last, with AdamW (picked) and Adafactor (forced)."""
    arch = "granite-3-2b"
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    kw = dict(optimizer=optimizer, lr=1e-4, warmup=1, total_steps=10)
    jstep, jname = jsteps.make_train_step(jcfg, None, **kw)
    tstep, tname = steps.make_train_step(cfg, None, **kw)
    assert jname == tname == optimizer
    assert steps.pick_optimizer(cfg) == jsteps.pick_optimizer(jcfg) == "adamw"
    jstep = jax.jit(jstep)
    ref = jax_params(jcfg, seed=1)
    params = carry(ref)
    jopt = (joptim.adamw_init if optimizer == "adamw" else joptim.adafactor_init)(ref)
    opt = (adamw_init if optimizer == "adamw" else adafactor_init)(params)
    stream = TokenStream(cfg.vocab, 2, 32, seed=3)
    for i in range(3):
        b = make_batch(stream, i)
        ref, jopt, jm = jstep(ref, jopt, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
        same_p, same_o, m = tstep(params, opt, device_batch(b, "cpu"), i)
        assert same_p is params and same_o is opt
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), **TOL, err_msg=key)
        # A norm of the gradients: held as they are (JAX's own jitted step and
        # its eager global_norm differ by 2.2e-5 relative here).
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=GRAD_TOL)
    for a, b in zip(tree_flatten(params)[0], jax.tree.leaves(ref)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= PARAM_TOL * np.abs(b).max()
    for a, b in zip(tree_flatten(opt)[0], jax.tree.leaves(jopt)):
        grad_close(a, b, "optimizer state")
    assert not any(p.requires_grad for p in tree_flatten(params)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_config_takes_a_finite_step(arch):
    """Port only: finite loss, gradient norm and parameters after a step of
    each arch's smoke config (its own frontend's batch)."""
    cfg = configs.get_smoke_config(arch)
    params = spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), "cpu")
    before = tree_map(lambda x: x.clone(), params)
    step, name = steps.make_train_step(cfg, lr=1e-3, warmup=0)
    _, batch = text_batch(cfg)
    _, _, m = step(params, adamw_init(params), batch, 0)
    assert all(np.isfinite(float(v)) for v in m.values()), m
    assert float(m["grad_norm"]) > 0
    assert all(bool(torch.isfinite(p).all()) for p in tree_flatten(params)[0])
    assert any(not torch.equal(a, b) for a, b in zip(tree_flatten(params)[0], tree_flatten(before)[0]))


def test_prefill_and_decode_steps():
    cfg = configs.get_smoke_config("granite-3-2b")
    params = spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), "cpu")
    _, batch = text_batch(cfg)
    from repro_torch.models import forward, init_cache

    with torch.inference_mode():
        logits = steps.make_prefill_step(cfg)(params, batch)
        torch.testing.assert_close(logits, forward(cfg, params, batch)[0][:, -1], rtol=0, atol=0)
        nxt, cache = steps.make_decode_step(cfg)(params, init_cache(cfg, 2, 4, "cpu"),
                                                 batch["tokens"][:, 0], 0)
    assert nxt.shape == (2,) and nxt.dtype == torch.int32
    assert float(cache["pos0"]["k"].abs().sum()) > 0


def test_unported_mesh_train_step():
    """The mesh half of launch/steps.py (ROADMAP queue 1 item 13 part 3,
    once unported) against one device: the three builders over a (2, 2)
    mesh of virtual CPU devices on granite-3-2b's smoke config, FSDP on. A
    train step's metrics at TOL and its parameters within PARAM_TOL, the
    prefill logits at TOL, a decode step's tokens equal."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_cache
    from repro_torch.sharding.policies import gather

    cfg = dataclasses.replace(configs.get_smoke_config("granite-3-2b"), force_fsdp=True)
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    params = spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), "cpu")
    placed = steps.place_params(cfg, mesh, params)
    _, batch = text_batch(cfg)
    with torch.inference_mode():
        want = steps.make_prefill_step(cfg)(params, batch)
        torch.testing.assert_close(steps.make_prefill_step(cfg, mesh)(placed, batch).gather(),
                                   want, **TOL)
        nxt, _ = steps.make_decode_step(cfg)(params, init_cache(cfg, 2, 4, "cpu"),
                                             batch["tokens"][:, 0], 0)
        nxt_mesh, _ = steps.make_decode_step(cfg, mesh)(placed, steps.mesh_cache(cfg, mesh, 2, 4),
                                                        batch["tokens"][:, 0], 0)
        assert torch.equal(nxt_mesh.gather(), nxt)
    step, _ = steps.make_train_step(cfg, lr=1e-3, warmup=0)
    step_mesh, _ = steps.make_train_step(cfg, mesh, lr=1e-3, warmup=0)
    _, _, m = step(params, adamw_init(params), batch, 0)
    _, _, m_mesh = step_mesh(placed, steps.init_opt_state(placed, "adamw"), batch, 0)
    for key in m:
        np.testing.assert_allclose(m_mesh[key].item(), m[key].item(), **TOL, err_msg=key)
    for a, b in zip(tree_flatten(gather(placed, "cpu"))[0], tree_flatten(params)[0]):
        assert float((a - b).abs().max()) <= PARAM_TOL * float(b.abs().max())


# --------------------------------------------------------------------------
# train(), its CLI and the example
# --------------------------------------------------------------------------

def test_train_resumes_a_bf16_run_bitwise(tmp_path, monkeypatch):
    """granite-3-2b's smoke config in bf16: 4 steps straight through against
    2 steps, a checkpoint (bf16 leaves as 2-byte voids) and a resume for 2
    more: the same losses and the same parameters, bit for bit."""
    bf16 = lambda a: dataclasses.replace(configs.get_smoke_config(a), param_dtype="bfloat16",
                                         activation_dtype="bfloat16")
    monkeypatch.setattr(train_mod, "get_smoke_config", bf16)
    kw = dict(batch=2, seq=16, lr=1e-2, ckpt_every=2, log_every=1, device="cpu")
    p_straight, h_straight = train_mod.train("granite-3-2b", steps=4,
                                             ckpt_dir=str(tmp_path / "a"), **kw)
    train_mod.train("granite-3-2b", steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    leaves, manifest = CheckpointManager(str(tmp_path / "b")).restore()
    assert manifest["step"] == 2
    assert any(x.dtype == torch.bfloat16 for x in leaves)
    p_resumed, h_resumed = train_mod.train("granite-3-2b", steps=4,
                                           ckpt_dir=str(tmp_path / "b"), **kw)
    assert [h["step"] for h in h_resumed] == [2, 3]
    for got, want in zip(h_resumed, h_straight[2:]):
        assert got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
    assert h_straight[-1]["loss"] < h_straight[0]["loss"]
    for a, b in zip(tree_flatten(p_resumed)[0], tree_flatten(p_straight)[0]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.fixture()
def one_thread():
    """One intra-op thread for a loop of tiny steps. Where several test
    processes share the host's cores, torch's default (a thread per core in
    each process) spins on every small op: the CLI and example tests took
    80 and 168 s in such a run against 1-2 s on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys, one_thread):
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "granite-moe-1b-a400m", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", ckpt, "--seed", "1"]
    train_mod.main(args + ["--steps", "50"])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "step    49 loss=" in out
    assert CheckpointManager(ckpt).all_steps() == [50]
    train_mod.main(args + ["--steps", "52"])
    out = capsys.readouterr().out
    assert "resumed from step 50" in out and "step    51 loss=" in out
    assert "step     0 loss=" not in out


def test_train_lm_example(tmp_path, capsys, one_thread):
    train_lm_example.main(["--device", "cpu", "--steps", "120", "--batch", "2", "--seq", "32",
                           "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "loss" in out and "(step 119)" in out
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [100]


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.train("granite-3-2b", steps=1)
