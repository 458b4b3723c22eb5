"""The port's optimizers (repro_torch.optim) against the JAX package's
(repro.optim), on the CPU: the schedules, the global norm and clipping on
bf16 and float32 leaves, AdamW on nested-dict trees with a scalar, a
schedule and a per-leaf learning rate, Adafactor with factored, unfactored
and stacked (U = 3 and U = 6) leaves, each held in its in-place form (the
one the train step runs) while the functional form (the in-place form on
a copy) leaves its inputs untouched, and gradient compression (tests/
test_compression.py's properties, plus top-k exact against JAX's on
distinct values). Inputs come from numpy seeds.

Tolerances (stated, never loosened): schedules rtol 1e-6 (float32 scalars
of the same formula); the global norm rtol 1e-6; AdamW and Adafactor rtol
1e-5, atol 1e-6 over 3 steps given the same gradients (reductions of other
orders: Adafactor's means), bf16 AdamW parameters bitwise JAX's (it is
elementwise), a bf16 clip within one bf16 ulp; int8 within one quantization
step, its mean within 1e-3 (tests/test_compression.py's bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim import compression as jcomp
from repro_torch import optim
from repro_torch.optim import compression
from repro_torch.utils import tree_flatten, tree_map

OPT_TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _nested(flat: dict) -> dict:
    """{'a/b': x} -> {'a': {'b': x}}: the LM's nested-dict shape."""
    out: dict = {}
    for name, x in flat.items():
        node = out
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = x
    return out


SHAPES = {"embed": (12, 4), "units/pos0/w1": (3, 4, 5), "units/pos0/norm": (3, 4),
          "final_norm": (4,)}


def _close_trees(port, ref, **tol):
    a = tree_flatten(port)[0]
    b = jax.tree.leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.float().numpy(), np.asarray(y, np.float32), **tol)


# -- schedules -------------------------------------------------------------------

def test_schedules_match_reference():
    for steps in (0, 1, 5, 99, 100, 101, 2500, 9999, 10_000, 12_000):
        for mine, theirs in (
            (optim.cosine_schedule(3e-4, 1000), joptim.cosine_schedule(3e-4, 1000)),
            (optim.linear_warmup_cosine(3e-4, 100, 10_000),
             joptim.linear_warmup_cosine(3e-4, 100, 10_000)),
            (optim.linear_warmup_cosine(1e-3, 0, 50), joptim.linear_warmup_cosine(1e-3, 0, 50)),
        ):
            got = mine(steps)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(theirs(steps)), rtol=1e-6)


# -- global norm and clipping --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype, monkeypatch):
    """The norm accumulates in float32 (bf16 leaves widened a slice at a
    time: the slice is made small here); the in-place clip keeps each
    leaf's dtype; the functional clip returns the same values in a copy."""
    monkeypatch.setattr(optim.grad_utils, "NORM_CHUNK", 7)
    arrs = _tree(0, SHAPES)
    jt = _nested({k: jnp.asarray(v, jnp.dtype(dtype)) * 3 for k, v in arrs.items()})
    tt = _nested({k: torch.from_numpy(v).to(getattr(torch, dtype)) * 3 for k, v in arrs.items()})
    # The bf16 leaves are bitwise the same on both sides.
    for x, y in zip(tree_flatten(tt)[0], jax.tree.leaves(jt)):
        np.testing.assert_array_equal(x.float().numpy(), np.asarray(y, np.float32))
    np.testing.assert_allclose(float(optim.global_norm(tt)), float(joptim.global_norm(jt)),
                               rtol=1e-6)
    before = tree_map(lambda x: x.clone(), tt)
    clipped = tree_map(lambda x: x.clone(), tt)
    norm = optim.clip_by_global_norm_(clipped, 1.0)
    jclipped, jnorm = joptim.clip_by_global_norm(jt, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert [x.dtype for x in tree_flatten(clipped)[0]] == [getattr(torch, dtype)] * len(SHAPES)
    # bf16: within one ulp (2**-7 relative), should the norms' last bits
    # round the scale apart.
    _close_trees(clipped, jclipped, rtol=2**-7 if dtype == "bfloat16" else 1e-6)
    copy, norm2 = optim.clip_by_global_norm(tt, 1.0)
    assert float(norm2) == float(norm)
    for a, b, c in zip(tree_flatten(copy)[0], tree_flatten(clipped)[0], tree_flatten(tt)[0]):
        assert torch.equal(a, b) and a is not c
    for a, b in zip(tree_flatten(tt)[0], tree_flatten(before)[0]):
        assert torch.equal(a, b)
    assert bool(optim.all_finite(tt))
    tt["final_norm"][0] = float("nan")
    assert not bool(optim.all_finite(tt))


# -- AdamW -----------------------------------------------------------------------

@pytest.mark.parametrize("lr_kind", ["scalar", "schedule", "per_leaf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_on_dict_trees_matches_reference(lr_kind, dtype, monkeypatch):
    """Three in-place steps (slices of 5 elements here) on a nested-dict
    tree given the same gradients, weight decay 0.01; the functional form's
    first step equals the in-place one and leaves its inputs untouched."""
    monkeypatch.setattr(optim.adamw, "INPLACE_CHUNK", 5)
    p0 = _tree(1, SHAPES)
    grads = [_tree(10 + i, SHAPES) for i in range(3)]
    if lr_kind == "scalar":
        j_lr = t_lr = 1e-2
    elif lr_kind == "schedule":
        j_lr, t_lr = (joptim.linear_warmup_cosine(1e-2, 1, 10),
                      optim.linear_warmup_cosine(1e-2, 1, 10))
    else:
        rates = {k: 1e-2 * (i + 1) for i, k in enumerate(SHAPES)}
        j_lr, t_lr = _nested(rates), _nested(rates)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = _nested({k: jnp.asarray(v, jdt) for k, v in p0.items()})
    tp = _nested({k: torch.from_numpy(v).to(tdt) for k, v in p0.items()})
    js, ts = joptim.adamw_init(jp), optim.adamw_init(tp)
    for i, g in enumerate(grads):
        jg = _nested({k: jnp.asarray(v, jdt) for k, v in g.items()})
        tg = _nested({k: torch.from_numpy(v).to(tdt) for k, v in g.items()})
        jp, js = joptim.adamw_update(jp, jg, js, i, lr=j_lr, weight_decay=0.01)
        if i == 0:
            before = tree_map(lambda x: x.clone(), (tp, ts))
            functional = optim.adamw_update(tp, tg, ts, i, lr=t_lr, weight_decay=0.01)
            for a, b in zip(tree_flatten((tp, ts))[0], tree_flatten(before)[0]):
                assert torch.equal(a, b)
        same = optim.adamw_update_(tp, tg, ts, i, lr=t_lr, weight_decay=0.01)
        assert same[0] is tp and same[1] is ts
        if i == 0:
            for a, b in zip(tree_flatten(functional)[0], tree_flatten((tp, ts))[0]):
                assert torch.equal(a, b) and a is not b
    assert [x.dtype for x in tree_flatten(tp)[0]] == [tdt] * len(SHAPES)
    if dtype == "bfloat16":  # elementwise, so the bf16 results are bitwise JAX's
        for x, y in zip(tree_flatten(tp)[0], jax.tree.leaves(jp)):
            np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                          np.asarray(y).view(np.int16))
    else:
        _close_trees(tp, jp, **OPT_TOL)
    _close_trees(ts.mu, js.mu, **OPT_TOL)
    _close_trees(ts.nu, js.nu, **OPT_TOL)


# -- Adafactor -------------------------------------------------------------------

@pytest.mark.parametrize("units", [3, 6])
def test_adafactor_matches_reference(units):
    """A stacked (U, 8, 6) leaf (JAX unrolls U = 3 and ``lax.map``s U = 6),
    a 2-D and a 1-D leaf, three in-place steps, weight decay 0.01; the
    state's leaves in JAX's order; the functional form's first step equals
    the in-place one and leaves its inputs untouched."""
    shapes = {"stack": (units, 8, 6), "mat": (5, 7), "vec": (9,)}
    p0 = _tree(2, shapes)
    grads = [_tree(20 + i, shapes) for i in range(3)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = joptim.adafactor_init(jp), optim.adafactor_init(tp)
    sched = (joptim.linear_warmup_cosine(0.1, 1, 10), optim.linear_warmup_cosine(0.1, 1, 10))
    for i, g in enumerate(grads):
        jp, js = joptim.adafactor_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, i,
                                         lr=sched[0], weight_decay=0.01)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if i == 0:
            before = tree_map(lambda x: x.clone(), (tp, ts))
            functional = optim.adafactor_update(tp, tg, ts, i, lr=sched[1], weight_decay=0.01)
            for a, b in zip(tree_flatten((tp, ts))[0], tree_flatten(before)[0]):
                assert torch.equal(a, b)
        same = optim.adafactor_update_(tp, tg, ts, i, lr=sched[1], weight_decay=0.01)
        assert same[0] is tp and same[1] is ts
        if i == 0:
            for a, b in zip(tree_flatten(functional)[0], tree_flatten((tp, ts))[0]):
                assert torch.equal(a, b)
    _close_trees(tp, jp, **OPT_TOL)
    assert [tuple(x.shape) for x in tree_flatten(ts)[0]] == [
        tuple(x.shape) for x in jax.tree.leaves(js)]
    _close_trees(ts, js, **OPT_TOL)


def test_optimizers_converge_on_the_quadratic():
    """tests/test_optim.py's quadratic: AdamW and Adafactor converge, and a
    per-leaf rate of 0 freezes its leaf."""
    target = torch.arange(1.0, 9.0)

    def loss_and_grad(p):
        w = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        loss = ((w["w"] - target) ** 2).sum() + ((w["b"] + 1.0) ** 2).sum()
        g = torch.autograd.grad(loss, [w["w"], w["b"]])
        return loss.item(), {"w": g[0], "b": g[1]}

    params = {"w": torch.zeros(8), "b": torch.zeros(2, 8)}
    state = optim.adamw_init(params)
    for i in range(600):
        params, state = optim.adamw_update(params, loss_and_grad(params)[1], state, i, lr=5e-2)
    assert loss_and_grad(params)[0] < 1e-2
    params = {"w": torch.zeros(8), "b": torch.zeros(2, 8)}
    state = optim.adamw_init(params)
    for i in range(50):
        params, state = optim.adamw_update(params, loss_and_grad(params)[1], state, i,
                                           lr={"w": 5e-2, "b": 0.0})
    assert float(params["b"].abs().max()) == 0.0 and float(params["w"].abs().max()) > 0.1
    params = {"w": torch.zeros(8), "b": torch.zeros(2, 8)}
    state = optim.adafactor_init(params)
    l0 = loss_and_grad(params)[0]
    for i in range(200):
        params, state = optim.adafactor_update(params, loss_and_grad(params)[1], state, i, lr=0.3)
    assert loss_and_grad(params)[0] < 0.5 * l0


# -- compression -------------------------------------------------------------------

def test_topk_matches_reference_on_distinct_values():
    """Distinct magnitudes (normal draws): the same values, indices
    (largest first) and residual as JAX's, exactly, over three rounds of
    error feedback."""
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal((6, 10)).astype(np.float32) for _ in range(3)]
    jst = jcomp.TopKState(residual=jnp.zeros((6, 10), jnp.float32))
    tst = compression.TopKState(residual=torch.zeros(6, 10))
    for g in grads:
        jv, ji, jst = jcomp.topk_compress(jnp.asarray(g), jst, k_frac=0.1)
        tv, ti, tst = compression.topk_compress(torch.from_numpy(g), tst, k_frac=0.1)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tst.residual.numpy(), np.asarray(jst.residual))
        np.testing.assert_array_equal(
            compression.topk_decompress(tv, ti, (6, 10)).numpy(),
            np.asarray(jcomp.topk_decompress(jv, ji, (6, 10))))


def test_topk_error_feedback_catches_up():
    g0 = torch.tensor([1.0, 0.01, 0.0, 0.0])
    st = compression.TopKState(residual=torch.zeros(4))
    vals, idx, st = compression.topk_compress(g0, st, k_frac=0.25)
    sent = compression.topk_decompress(vals, idx, g0.shape)
    assert float(sent[1]) == 0.0
    for _ in range(2):
        vals, idx, st = compression.topk_compress(torch.zeros(4), st, k_frac=0.25)
        sent = sent + compression.topk_decompress(vals, idx, g0.shape)
    assert float(sent[1]) > 0.0
    np.testing.assert_allclose((sent + st.residual).numpy(), g0.numpy(), atol=1e-6)


def test_int8_error_bound_and_unbiased():
    """Within one quantization step of each chunk, padded tails cut off,
    and the stochastic rounding unbiased (the mean of 16 draws within
    1e-3), as tests/test_compression.py states them."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(1000).astype(np.float32)) * 3
    q, s = compression.int8_quantize(x, torch.Generator().manual_seed(1))
    assert q.dtype == torch.int8 and q.shape == (1024,) and s.shape == (4,)
    y = compression.int8_dequantize(q, s, x.shape)
    assert y.shape == x.shape
    assert bool(((x - y).abs() <= s.repeat_interleave(256)[:1000] + 1e-6).all())
    gen = torch.Generator().manual_seed(2)
    x = torch.full((4096,), 0.05)
    means = [float(compression.int8_dequantize(*compression.int8_quantize(x, gen), x.shape)
                   .mean()) for _ in range(16)]
    assert abs(np.mean(means) - 0.05) < 1e-3


def test_compressed_psum_in_a_one_process_group(tmp_path):
    """A gloo group of one (a file store, no network): the int8 scheme
    returns each leaf's quantize-dequantize round trip, the plain scheme
    the leaf itself, leaves in place."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        grads = {"b": torch.linspace(-1, 1, 300), "a": torch.ones(3, 5) * 0.25}
        out = compression.compressed_psum(grads, torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        for name in ("a", "b"):      # jax's order: the noise is drawn a leaf at a time
            g = grads[name]
            want = compression.int8_dequantize(*compression.int8_quantize(g, gen), g.shape)
            assert torch.equal(out[name], want)
        plain = compression.compressed_psum(grads, gen, scheme="none")
        assert all(torch.equal(plain[k], grads[k]) and plain[k] is not grads[k] for k in grads)
    finally:
        dist.destroy_process_group()
