"""The port's whole language model against the JAX package's, on the CPU:
the ten configs and their specs, the parameter carry (``params_from_numpy``),
``forward`` and ``loss_fn`` for the smoke config of every architecture, and
``decode_step`` over 8 teacher-forced steps for every decoder, cache
included.

The JAX parameters come from ``repro.models.spec.init_from_spec``; the port
gets the same values through ``params_from_numpy``. Inputs come from numpy
seeds. Tolerance (stated, never loosened): atol 1e-5, rtol 1e-5 on float32
logits, losses and caches.
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
from repro.models import spec as jspec
from repro_torch import configs
from repro_torch.models import (
    LanguageModel,
    build_cache_spec,
    build_param_spec,
    decode_step,
    forward,
    init_cache,
    loss_fn,
)
from repro_torch.models import spec

TOL = dict(atol=1e-5, rtol=1e-5)
IDENT = lambda x, a: x  # noqa: E731
ARCHS = sorted(jconfigs.ARCHS)
DECODERS = [a for a in ARCHS if jconfigs.get_config(a).family != "encoder"]
B, T, STEPS = 2, 12, 8


def jax_params(cfg, seed=0):
    return jspec.init_from_spec(jmodels.build_param_spec(cfg), jax.random.key(seed))


def carry(tree):
    """A JAX tree -> the port's tree on the CPU, through numpy."""
    return spec.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def batch_for(cfg, seed=1):
    """Numpy inputs of the smoke config's frontend: B x T positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
                "labels": labels}
    if cfg.frontend == "vision_stub":
        n = cfg.n_frontend_tokens // 2
        return {"tokens": toks[:, n:], "labels": labels[:, n:],
                "patch_embeds": rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)}
    return {"tokens": toks, "labels": labels}


def to_port(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# --------------------------------------------------------------------------
# configs and specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_specs_match(arch):
    """Every field, the derived properties and the parameter counts of the
    full and the smoke config; every param and cache LeafSpec (shape, axes,
    dtype, init, fan_in)."""
    for get in ("get_config", "get_smoke_config"):
        cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for prop in ("vocab_padded", "d_inner", "n_ssm_heads", "pattern", "n_units"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        for mine, theirs in ((build_param_spec(cfg), jmodels.build_param_spec(jcfg)),
                             (build_cache_spec(cfg, 3, 17), jmodels.build_cache_spec(jcfg, 3, 17))):
            a, b = leaves(mine), leaves(theirs)
            assert list(a) == list(b)
            for name in a:
                assert dataclasses.astuple(a[name]) == dataclasses.astuple(b[name]), name
        assert spec.spec_bytes(build_param_spec(cfg)) == jspec.spec_bytes(
            jmodels.build_param_spec(jcfg))


def test_full_granite_is_the_documented_size():
    cfg = configs.get_config("granite-3-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
        40, 2048, 32, 8, 8192, 49155)
    assert cfg.param_count() == 2_635_237_376
    assert spec.spec_bytes(build_param_spec(cfg)) == 2 * 2_635_237_376
    meta = spec.abstract_from_spec(build_param_spec(cfg))
    assert meta["units"]["pos0"]["ffn"]["w1"].shape == (40, 2048, 8192)
    assert meta["units"]["pos0"]["ffn"]["w1"].device.type == "meta"
    assert meta["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_is_bitwise(dtype):
    """The JAX tree's leaves (bf16 ones arrive as ml_dtypes.bfloat16) carry
    over bit for bit, and the port's init draws the spec's distributions."""
    cfg = dataclasses.replace(configs.get_smoke_config("jamba-1.5-large-398b"),
                              param_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("jamba-1.5-large-398b"),
                               param_dtype=dtype)
    ref = jax.tree.map(np.asarray, jax_params(jcfg))
    got = spec.params_from_numpy(ref, "cpu")
    bits = np.int16 if dtype == "bfloat16" else np.int32
    tbits = torch.int16 if dtype == "bfloat16" else torch.int32
    a, b = leaves(got), leaves(ref)
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(a[name].view(tbits).numpy(), b[name].view(bits), name)

    mine = leaves(spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0),
                                      "cpu"))
    specs = leaves(build_param_spec(cfg))
    for name, x in mine.items():
        s = specs[name]
        assert tuple(x.shape) == s.shape and x.dtype == getattr(torch, dtype)
        if s.init in ("zeros", "ones"):
            assert bool((x == (s.init == "ones")).all()), name
        elif x.numel() >= 4096:
            fan = s.fan_in or s.shape[-2]
            want = fan ** -0.5 * (0.1 if s.init == "small_normal" else 1.0)
            assert abs(float(x.float().std()) / want - 1) < 0.1, name


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spec.init_from_spec(build_param_spec(configs.get_smoke_config("granite-3-2b")),
                            torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(configs.get_smoke_config("granite-3-2b"), 1, 4)


# --------------------------------------------------------------------------
# forward and loss
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_forward_fn(arch):
    cfg = jconfigs.get_smoke_config(arch)
    return jax.jit(lambda p, b: jmodels.loss_fn(cfg, p, b, IDENT)[1] | {
        "logits": jmodels.forward(cfg, p, b, IDENT)[0]})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match(arch):
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    ref = jax_params(jcfg)
    params = carry(ref)
    batch = batch_for(cfg)
    want = jax_forward_fn(arch)(ref, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        logits, aux = forward(cfg, params, to_port(batch))
        loss, parts = loss_fn(cfg, params, to_port(batch))
    assert logits.shape == (B, T, cfg.vocab_padded)
    close(logits, want["logits"])
    close(aux, want["aux"])
    close(parts["ce"], want["ce"])
    close(loss, np.asarray(want["ce"]) + cfg.router_aux_weight * np.asarray(want["aux"]))


def test_language_model_module_wraps_the_functions():
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    params = carry(jax_params(jconfigs.get_smoke_config("granite-moe-1b-a400m")))
    model = LanguageModel(cfg, params)
    names = dict(model.named_parameters())
    assert "params.units.pos0.ffn.router" in names and len(names) == len(leaves(params))
    assert not any(p.requires_grad for p in model.parameters())
    batch = to_port(batch_for(cfg))
    with torch.inference_mode():
        assert torch.equal(model(batch)[0], forward(cfg, params, batch)[0])
        cache = model.init_cache(B, 4)
        nxt, logits, _ = model.decode_step(cache, batch["tokens"][:, 0], 0)
        want = decode_step(cfg, params, init_cache(cfg, B, 4, "cpu"), batch["tokens"][:, 0], 0)
    assert torch.equal(logits, want[1]) and torch.equal(nxt, want[0])


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_step_fn(arch):
    cfg = jconfigs.get_smoke_config(arch)
    return jax.jit(lambda p, c, tok, pos: jmodels.decode_step(cfg, p, c, tok, pos, IDENT))


def jax_cache(cfg, max_seq):
    return jax.tree.map(
        lambda l: jnp.zeros(l.shape, jnp.dtype(l.dtype)),
        jmodels.build_cache_spec(cfg, B, max_seq), is_leaf=jspec.is_leaf)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_and_cache_match(arch):
    """8 teacher-forced steps: logits, every cache leaf after every step and
    the greedy tokens (where the top two logits are apart by more than
    100x the tolerance) equal the JAX package's."""
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    ref = jax_params(jcfg, seed=3)
    params = carry(ref)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
    jc = jax_cache(jcfg, STEPS)
    cache = init_cache(cfg, B, STEPS, "cpu")
    step = jax_step_fn(arch)
    for pos in range(STEPS):
        jn, jl, jc = step(ref, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        with torch.inference_mode():
            nxt, logits, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, pos]),
                                             pos)
        close(logits, jl)
        for name, leaf in leaves(cache).items():
            close(leaf, leaves(jc)[name])
        top2 = torch.topk(logits[:, : cfg.vocab], 2).values
        clear = (top2[:, 0] - top2[:, 1]) > 100 * (1e-5 + 1e-5 * logits.abs().amax(-1))
        np.testing.assert_array_equal(nxt.numpy()[clear.numpy()], np.asarray(jn)[clear.numpy()])
        assert nxt.dtype == torch.int32


def test_decode_masks_the_vocab_tail():
    """Tail columns of the head set to twice each row's winning column: the
    tail would win an unmasked argmax; both packages pick inside the vocab,
    and the same token."""
    cfg = dataclasses.replace(configs.get_smoke_config("granite-3-2b"), vocab=300)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("granite-3-2b"), vocab=300)
    ref = jax_params(jcfg, seed=5)
    toks = np.array([3, 7], np.int32)
    _, jl, _ = jmodels.decode_step(jcfg, ref, jax_cache(jcfg, 2), jnp.asarray(toks),
                                   jnp.int32(0), IDENT)
    head = np.array(ref["lm_head"])
    for b, v in enumerate(np.asarray(jl)[:, :300].argmax(-1)):
        head[:, 300 + b] = 2.0 * head[:, v]
    ref = dict(ref, lm_head=jnp.asarray(head))
    params = carry(ref)
    jn, jl, _ = jmodels.decode_step(jcfg, ref, jax_cache(jcfg, 2), jnp.asarray(toks),
                                    jnp.int32(0), IDENT)
    with torch.inference_mode():
        nxt, logits, _ = decode_step(cfg, params, init_cache(cfg, B, 2, "cpu"),
                                     torch.from_numpy(toks), 0)
    assert bool((logits.argmax(-1) >= 300).all())
    assert bool((nxt < 300).all())
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    close(logits, jl)
