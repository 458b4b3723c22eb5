"""The port's LM building blocks against the JAX package's, on the CPU:
``models/layers.py``, ``models/attention.py`` (forward), ``models/moe.py``
(forward) and ``models/mamba2.py`` (forward and decode).

Inputs come from numpy seeds and cross to both packages as the same float32
arrays. Tolerance (stated, never loosened): atol 1e-5, rtol 1e-5 — float32
contractions that XLA and torch may sum in another order. The MoE slots are
integers and equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.models import attention, layers, lm, mamba2, moe
from repro_torch.models.config import ModelConfig

TOL = dict(atol=1e-5, rtol=1e-5)
IDENT = lambda x, a: x  # noqa: E731


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def both_configs(**kw):
    """The same config in each package (the port's and the JAX package's)."""
    base = dict(name="unit", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=16, d_ff=64, vocab=500,
                param_dtype="float32", activation_dtype="float32")
    base.update(kw)
    return ModelConfig(**base), JaxModelConfig(**base)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm():
    x, w = rnd(0, 2, 5, 32), rnd(1, 32)
    close(layers.rms_norm(t(x), t(w)), jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_rope_pairs_the_two_halves():
    """rope_angles + apply_rope: element i rotates with element i + hd/2 (the
    JAX code's pairing), not the even/odd pairing its docstring names."""
    pos = np.array([0, 1, 7, 300], np.int32)
    x = rnd(2, 2, 4, 3, 16)
    cos, sin = layers.rope_angles(t(pos), 16, 10000.0)
    jcos, jsin = jlayers.rope_angles(jnp.asarray(pos), 16, 10000.0)
    close(cos, jcos)
    close(sin, jsin)
    close(layers.apply_rope(t(x), cos, sin), jlayers.apply_rope(jnp.asarray(x), jcos, jsin))
    # the pairing itself: a vector with only element 0 set rotates into
    # element hd/2 = 8 and nowhere else
    e0 = torch.zeros(1, 1, 1, 16)
    e0[..., 0] = 1.0
    out = layers.apply_rope(e0, cos[1:2], sin[1:2])[0, 0, 0]
    assert out[8] != 0 and out[1] == 0


def test_embed_tokens():
    table = rnd(3, 50, 8)
    toks = np.random.default_rng(4).integers(0, 50, (2, 6)).astype(np.int32)
    got = layers.embed_tokens(t(table), t(toks).long())
    close(got, jlayers.embed_tokens(jnp.asarray(table), jnp.asarray(toks)), atol=0, rtol=0)


def test_softmax_xent_masks_the_padded_vocab():
    logits = rnd(5, 2, 6, 512, scale=3.0)
    labels = np.random.default_rng(6).integers(0, 500, (2, 6)).astype(np.int32)
    mask = (np.random.default_rng(7).random((2, 6)) > 0.3).astype(np.float32)
    got = layers.softmax_xent(t(logits), t(labels), t(mask), 500)
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), 500)
    close(got, want)
    # the tail counts: without the mask the loss differs
    assert abs(float(layers.softmax_xent(t(logits), t(labels), t(mask), 512)) - float(got)) > 1e-3


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_activation(act):
    """The encoder's GELU is the tanh approximation (jax.nn.gelu's default),
    which differs from torch's erf default by about 1e-3."""
    p = {"w1": rnd(8, 32, 64, scale=0.3), "w2": rnd(9, 64, 32, scale=0.2),
         "w3": rnd(10, 32, 64, scale=0.3)}
    x = rnd(11, 2, 5, 32, scale=2.0)
    got = lm._mlp({k: t(v) for k, v in p.items()}, t(x), act)
    want = jlm._mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act, IDENT)
    close(got, want)
    if act == "gelu":
        h = t(x) @ t(p["w1"])
        erf = torch.nn.functional.gelu(h) @ t(p["w2"])
        assert float((erf - got).abs().max()) > 1e-4


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(32, 16), (40, 16), (12, 32)])
def test_chunked_attention_forward(causal, S, chunk):
    q, k, v = (rnd(20 + i, 2, S, 4, 16) for i in range(3))
    got, m, l = attention._chunked_attention_fwd_impl(t(q), t(k), t(v), causal, chunk, 0)
    want, jm, jl = jattn._chunked_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, chunk, 0)
    close(got, want)
    close(m, jm)
    close(l, jl)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_forward_gqa(qkv_bias):
    """H / KV = 2: query heads 2g and 2g + 1 read kv head g."""
    cfg, jcfg = both_configs(qkv_bias=qkv_bias, attn_chunk=8)
    p = {"wq": rnd(30, 32, 64, scale=0.2), "wk": rnd(31, 32, 32, scale=0.2),
         "wv": rnd(32, 32, 32, scale=0.2), "wo": rnd(33, 64, 32, scale=0.2)}
    if qkv_bias:
        p.update(bq=rnd(34, 64, scale=0.1), bk=rnd(35, 32, scale=0.1), bv=rnd(36, 32, scale=0.1))
    x = rnd(37, 2, 11, 32)
    pos = np.arange(11, dtype=np.int32)
    got = attention.attention_forward({k: t(v) for k, v in p.items()}, t(x), cfg, t(pos), True)
    want = jattn.attention_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                   jcfg, jnp.asarray(pos), True, IDENT)
    close(got, want)


def test_attention_decode_gqa():
    cfg, jcfg = both_configs()
    p = {"wq": rnd(40, 32, 64, scale=0.2), "wk": rnd(41, 32, 32, scale=0.2),
         "wv": rnd(42, 32, 32, scale=0.2), "wo": rnd(43, 64, 32, scale=0.2)}
    x = rnd(44, 2, 1, 32)
    ck, cv = rnd(45, 2, 9, 2, 16), rnd(46, 2, 9, 2, 16)
    pos = 5
    got, gk, gv = attention.attention_decode({k: t(v) for k, v in p.items()}, t(x),
                                             t(ck), t(cv), pos, cfg)
    want, wk, wv = jattn.attention_decode({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                          jnp.int32(pos), jcfg, IDENT)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


def test_repeat_kv_is_repeat_interleave():
    x = rnd(47, 2, 3, 2, 4)
    got = attention._repeat_kv(t(x), 3)
    close(got, jattn._repeat_kv(jnp.asarray(x), 3), atol=0, rtol=0)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def moe_config(capacity_factor):
    return both_configs(family="moe", n_experts=8, experts_per_token=2, d_ff_expert=16,
                        capacity_factor=capacity_factor)


def moe_params(seed):
    E, D, F = 8, 32, 16
    return {"router": rnd(seed, D, E, scale=0.5), "w1": rnd(seed + 1, E, D, F, scale=0.2),
            "w3": rnd(seed + 2, E, D, F, scale=0.2), "w2": rnd(seed + 3, E, F, D, scale=0.2)}


def test_router_topk_and_load_balance_loss():
    logits = rnd(50, 2, 7, 8, scale=2.0)
    w, ids = moe.router_topk(t(logits), 2)
    jw, jids = jmoe.router_topk(jnp.asarray(logits), 2)
    close(w, jw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(moe.load_balance_loss(t(logits), ids, 8),
          jmoe.load_balance_loss(jnp.asarray(logits), jids, 8))


def jax_keep(ids, n_experts, capacity):
    """The JAX package's keep mask (moe.py's sort-based position-in-expert),
    on its own router ids."""
    B = ids.shape[0]
    eid = ids.reshape(B, -1)
    A = eid.shape[1]

    def positions_one_group(e):
        order = jnp.argsort(e, stable=True)
        e_sorted = e[order]
        seg_start = jnp.searchsorted(e_sorted, jnp.arange(n_experts, dtype=e.dtype))
        pos_sorted = jnp.arange(A, dtype=jnp.int32) - seg_start[e_sorted]
        return jnp.zeros((A,), jnp.int32).at[order].set(pos_sorted)

    pos = jax.vmap(positions_one_group)(eid)
    return np.asarray((pos >= 0) & (pos < capacity))


@pytest.mark.parametrize("capacity_factor,drops", [(8.0, False), (1.0, True)])
def test_moe_ffn(capacity_factor, drops):
    """moe_ffn with ample capacity and at capacity_factor 1.0, where tokens
    are dropped: the kept and dropped assignments, the output and the aux
    loss equal the JAX package's."""
    cfg, jcfg = moe_config(capacity_factor)
    p = moe_params(60)
    x = rnd(64, 2, 40, 32)
    got, aux = moe.moe_ffn({k: t(v) for k, v in p.items()}, t(x), cfg)
    want, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                              jcfg, IDENT)
    close(got, want)
    close(aux, jaux)

    capacity = moe.capacity_of(cfg, 40)
    logits = t(x) @ t(p["router"])
    _, ids = moe.router_topk(logits, 2)
    _, keep, slot = moe.expert_slots(ids.reshape(2, -1), 8, capacity)
    _, jids = jmoe.router_topk(jnp.asarray(x) @ jnp.asarray(p["router"]), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(keep.numpy(), jax_keep(jids, 8, capacity))
    assert bool((~keep).any()) == drops
    assert bool((slot[~keep] == capacity).all())


# --------------------------------------------------------------------------
# Mamba-2
# --------------------------------------------------------------------------

def mamba_config():
    return both_configs(family="ssm", d_model=32, ssm_state=8, ssm_head_dim=8, ssm_chunk=8,
                        ssm_conv=4)


def mamba_params(seed, cfg):
    D, din, N, H, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv
    C = din + 2 * N
    return {"in_proj": rnd(seed, D, 2 * din + 2 * N + H, scale=0.2),
            "conv_w": rnd(seed + 1, W, C, scale=0.3), "conv_b": rnd(seed + 2, C, scale=0.1),
            "A_log": rnd(seed + 3, H, scale=0.5), "D": rnd(seed + 4, H),
            "dt_bias": rnd(seed + 5, H, scale=0.5), "norm_w": 1.0 + rnd(seed + 6, din, scale=0.1),
            "out_proj": rnd(seed + 7, din, D, scale=0.2)}


def test_segsum():
    la = -np.abs(rnd(70, 2, 3, 8))
    close(mamba2._segsum(t(la)), jmamba._segsum(jnp.asarray(la)))


def test_softplus_is_jaxs():
    x = np.linspace(-30, 40, 701, dtype=np.float32)
    close(mamba2.softplus(t(x)), jax.nn.softplus(jnp.asarray(x)))


@pytest.mark.parametrize("S", [16, 20])
def test_ssd_chunked(S):
    """S = 20 at chunk 8 pads a tail of 4 with zeros."""
    x, b, c = rnd(71, 2, S, 4, 8), rnd(72, 2, S, 8), rnd(73, 2, S, 8)
    la = -np.abs(rnd(74, 2, S, 4, scale=0.3))
    got = mamba2.ssd_chunked(t(x), t(la), t(b), t(c), 8)
    want = jmamba.ssd_chunked(jnp.asarray(x), jnp.asarray(la), jnp.asarray(b), jnp.asarray(c), 8)
    close(got, want)


def test_mamba_forward():
    cfg, jcfg = mamba_config()
    p = mamba_params(80, cfg)
    x = rnd(90, 2, 20, 32)
    got = mamba2.mamba_forward({k: t(v) for k, v in p.items()}, t(x), cfg)
    want = jmamba.mamba_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                jcfg, IDENT)
    close(got, want)


def test_mamba_decode():
    cfg, jcfg = mamba_config()
    p = mamba_params(100, cfg)
    x = rnd(110, 2, 1, 32)
    st = rnd(111, 2, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, scale=0.5)
    conv = rnd(112, 2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    got = mamba2.mamba_decode({k: t(v) for k, v in p.items()}, t(x), t(st), t(conv), cfg)
    want = jmamba.mamba_decode({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                               jnp.asarray(st), jnp.asarray(conv), jcfg)
    for g, w in zip(got, want):
        close(g, w)


def test_configs_agree_field_for_field():
    """both_configs builds the same dataclass in each package."""
    cfg, jcfg = moe_config(1.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
