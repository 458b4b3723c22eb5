"""The port's LM serving slice end to end on the CPU: the serve loop
(``repro_torch.launch.serve.generate``) against a JAX loop written as
``repro/launch/serve.py`` writes it, from the same carried weights and
prompts; the bf16 model against the JAX package's; the serve CLI and the
example.

Tolerances (stated, never loosened): float32 logits atol 1e-5, rtol 1e-5,
and the greedy tokens equal at every step, where every step's top-2 margin
is asserted to exceed 100x that tolerance, so that the exact compare means
something. bf16 (the granite smoke config in its full config's dtypes):
max-abs within 5e-2 x max |logit|, because XLA computes fused chains of
bf16 elementwise ops in float32 and rounds once where torch rounds after
every op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import spec as jspec
from repro_torch import configs
from repro_torch.examples import serve_lm
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.models.spec import params_from_numpy

IDENT = lambda x, a: x  # noqa: E731
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REL = 5e-2
DECODERS = sorted(a for a in configs.ARCHS if configs.get_config(a).family != "encoder")


def jax_serve_loop(cfg, params, prompts, gen_len):
    """The JAX package's serve loop (``repro/launch/serve.py:33-54``) with
    the weights and prompts given. Returns (tokens (B, gen_len), logits of
    every step)."""
    batch, prompt_len = prompts.shape
    max_seq = prompt_len + gen_len
    cache = jax.tree.map(
        lambda l: jnp.zeros(l.shape, jnp.dtype(l.dtype)),
        jmodels.build_cache_spec(cfg, batch, max_seq), is_leaf=jspec.is_leaf)
    step = jax.jit(lambda p, c, t, pos: jmodels.decode_step(cfg, p, c, t, pos, IDENT))
    logits = []
    for pos in range(prompt_len):
        nxt, lg, cache = step(params, cache, jnp.asarray(prompts[:, pos]), jnp.int32(pos))
        logits.append(np.asarray(lg))
    generated = [np.asarray(nxt)]
    for pos in range(prompt_len, max_seq - 1):
        nxt, lg, cache = step(params, cache, jnp.asarray(generated[-1]), jnp.int32(pos))
        logits.append(np.asarray(lg))
        generated.append(np.asarray(nxt))
    return np.stack(generated, axis=1), logits


def carried(arch, seed, **dtypes):
    """(port cfg, JAX cfg, JAX params, the same params in the port)."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **dtypes)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **dtypes)
    ref = jspec.init_from_spec(jmodels.build_param_spec(jcfg), jax.random.key(seed))
    return cfg, jcfg, ref, params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-370m"])
def test_serve_loop_gives_the_jax_loops_tokens(arch):
    """Prompt 4, gen 5 (8 steps), batch 2: the greedy tokens of every step
    equal the JAX loop's, and so do every step's logits."""
    cfg, jcfg, ref, params = carried(arch, seed=11)
    prompts = np.random.default_rng(12).integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    want_tokens, want_logits = jax_serve_loop(jcfg, ref, prompts, 5)

    seen = []
    with torch.inference_mode():
        got = serve.generate(cfg, params, torch.from_numpy(prompts), 5,
                             on_step=lambda phase, pos, lg, nxt: seen.append((phase, pos, lg)))
    assert [(ph, pos) for ph, pos, _ in seen] == (
        [("prefill", p) for p in range(4)] + [("decode", p) for p in range(4, 8)])
    assert got.shape == (2, 5) and got.dtype == torch.int32
    for (_, pos, lg), want in zip(seen, want_logits):
        np.testing.assert_allclose(lg.numpy(), want, **TOL, err_msg=f"step {pos}")
        top2 = np.sort(want[:, : cfg.vocab], axis=-1)[:, -2:]
        tol = TOL["atol"] + TOL["rtol"] * np.abs(want).max(-1)
        assert ((top2[:, 1] - top2[:, 0]) > 100 * tol).all(), f"step {pos}: near tie"
    np.testing.assert_array_equal(got.numpy(), want_tokens)


def test_bf16_model_within_its_tolerance():
    """The granite smoke config in bf16 (the full config's dtypes): the
    forward logits and 8 teacher-forced decode steps within 5e-2 x max
    |logit| of the JAX package's."""
    cfg, jcfg, ref, params = carried("granite-3-2b", seed=13, param_dtype="bfloat16",
                                     activation_dtype="bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(14).integers(0, cfg.vocab, (2, 8)).astype(np.int32)

    def within(got, want):
        want = np.asarray(want).astype(np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())

    want, _ = jax.jit(lambda p, b: jmodels.forward(jcfg, p, b, IDENT))(
        ref, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    within(got, want)

    _, want_logits = jax_serve_loop(jcfg, ref, toks, 0)
    cache = init_cache(cfg, 2, 8, "cpu")
    assert cache["pos0"]["k"].dtype == torch.bfloat16
    with torch.inference_mode():
        for pos in range(8):
            _, lg, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, pos]), pos)
            within(lg, want_logits[pos])


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_cli_runs_every_decoder_on_the_cpu(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "3",
                "--gen-len", "3", "--seed", "1"])
    out = capsys.readouterr().out
    assert f"{arch}: served batch=2 prompt=3 gen=3 in " in out and "tok/s" in out


def test_serve_is_seeded_and_has_no_cpu_fallback(monkeypatch):
    with torch.inference_mode():
        a = serve.serve("smollm-360m", batch=2, prompt_len=3, gen_len=4, seed=5, device="cpu")
        b = serve.serve("smollm-360m", batch=2, prompt_len=3, gen_len=4, seed=5, device="cpu")
    assert a.shape == (2, 4) and torch.equal(a, b)
    assert bool((a < configs.get_smoke_config("smollm-360m").vocab).all())
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.serve("hubert-xlarge", device="cpu")
    with pytest.raises(ValueError, match="prompt_len"):
        serve.generate(configs.get_smoke_config("smollm-360m"), None,
                       torch.zeros((2, 0), dtype=torch.int64), 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "smollm-360m"])


def test_serve_example(capsys):
    serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "granite-3-2b: served batch=2 prompt=4 gen=4" in out
    assert "sample continuation token ids: [" in out
