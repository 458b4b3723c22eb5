"""The port's LM sharding rules and its mesh steps against the JAX
package's, on the CPU.

Spec parity: for every one of the ten configs (full width) and stand-in
meshes of shape (16, 16), (2, 16, 16) and (2, 2) (the last also as a real
``RenderMesh`` of virtual CPU devices on the port's side), each spec
function of ``sharding/policies.py``, ``models/spec.py`` and
``launch/steps.py`` returns what the JAX package's does, as tuples, or
raises the same ``ValueError``. No forced-device JAX subprocess: the stand-in
is an object with ``shape`` and ``axis_names`` on both sides, and JAX's
``NamedSharding`` and ``with_sharding_constraint`` are patched to hand back
the spec they are given.

Mesh step parity: the port's train, prefill and decode steps over virtual
CPU meshes (2, 1), (1, 2), (2, 2) against the port's one-device steps, on
the granite-3-2b, granite-moe-1b-a400m (its aux loss is a product of
batch means) and mamba2-370m smoke configs, FSDP on and off, ZeRO-1
state, one Adafactor case, and the replica paths (one copy a position, as
distinct cards hold them). Tolerances, stated and not loosened: the metrics
at ``TOL`` (atol/rtol 1e-5), the parameters and optimizer state after two
steps each leaf within ``PARAM_TOL`` = 1e-5 of its largest magnitude
(``tests/test_torch_lm_train.py``'s bounds; measured up to 4e-7 and 1.1e-6
of state). The loss under a (2, 4) mesh on the JAX package's own
``test_sharded_loss_matches_single_device`` config within ``TOL`` of JAX's
one-device ``loss_fn``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import steps as jsteps
from repro.models import spec as jspec
from repro.sharding import policies as jpolicies
from repro_torch import configs
from repro_torch.data import TokenStream, make_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import RenderMesh, make_host_mesh
from repro_torch.launch.train import device_batch
from repro_torch.models import build_cache_spec, build_param_spec, decode_step, forward
from repro_torch.models import init_cache
from repro_torch.models import spec
from repro_torch.optim import adafactor_init, adamw_init
from repro_torch.sharding import policies
from repro_torch.sharding.policies import MeshTensor, P, gather, map_mesh, place, spec_region
from repro_torch.utils import tree_flatten

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = 1e-5
ARCHS = sorted(jconfigs.ARCHS)
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
STEP_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-370m"]
# Every logical-axes tuple the JAX package's model passes to constrain
# (models/lm.py, attention.py, moe.py, mamba2.py).
SITES = [
    ("batch", None, "ffn"),
    ("batch", "act_seq", None),
    ("batch", None, "vocab"),
    ("batch", "vocab"),
    ("batch", None, "heads", "head_dim"),
    ("batch", None, "kv_heads", "head_dim"),
    ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    ("batch", "experts", None, None),
    ("batch", None, "ssm_heads", None),
]


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke shapes: one intra-op thread (several test processes share the
    host's cores, and many threads over tiny tensors spin)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class StandIn:
    """A mesh as the spec functions see it: ``shape`` and ``axis_names``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def norm(tree):
    """Specs as plain tuples (JAX's PartitionSpec is not a tuple); dicts and
    NamedTuples kept."""
    if isinstance(tree, dict):
        return {k: norm(v) for k, v in tree.items()}
    if isinstance(tree, jax.sharding.PartitionSpec):
        return tuple(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(norm(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(norm(x) for x in tree)
    return tree


def outcome(fn):
    """("ok", value) or ("raises", type name, message)."""
    try:
        return ("ok", norm(fn()))
    except ValueError as e:
        return ("raises", type(e).__name__, str(e))


@pytest.fixture()
def jax_specs(monkeypatch):
    """JAX's NamedSharding and with_sharding_constraint hand back their
    spec, and _fsdp_reshard its (compute, storage) pair, so JAX's hooks
    answer with the specs they would impose."""
    monkeypatch.setattr(jpolicies, "NamedSharding", lambda mesh, s: s)
    monkeypatch.setattr(jsteps, "NamedSharding", lambda mesh, s: s)
    monkeypatch.setattr(jsteps, "_fsdp_reshard", lambda x, c, s: (c, s))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)


def port_mesh(name):
    if name == "2x2":
        return make_host_mesh(2, 2, devices=["cpu"] * 4)
    return StandIn(MESHES[name])


# --------------------------------------------------------------------------
# spec parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, mesh_name, jax_specs):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    jm, pm = StandIn(MESHES[mesh_name]), port_mesh(mesh_name)
    same = lambda port, ref: outcome(port) == outcome(ref)  # noqa: E731

    assert same(lambda: policies.param_rules(cfg, pm), lambda: jpolicies.param_rules(jcfg, jm))
    assert same(lambda: policies.activation_rules(cfg, pm),
                lambda: jpolicies.activation_rules(jcfg, jm))
    assert same(lambda: policies.batch_specs(cfg, pm), lambda: jpolicies.batch_specs(jcfg, jm))
    for shardable in (True, False):
        assert same(
            lambda: [policies.make_constrain(cfg, pm, shardable).spec(a) for a in SITES],
            lambda: [jpolicies.make_constrain(jcfg, jm, shardable)(None, a) for a in SITES])
    pspec, jpspec = build_param_spec(cfg), jmodels.build_param_spec(jcfg)
    assert same(lambda: spec.partition_from_spec(pspec, policies.param_rules(cfg, pm)),
                lambda: jspec.partition_from_spec(jpspec, jpolicies.param_rules(jcfg, jm)))
    assert same(
        lambda: spec.partition_from_spec(build_cache_spec(cfg, 32, 64),
                                         policies.activation_rules(cfg, pm)),
        lambda: jspec.partition_from_spec(jmodels.build_cache_spec(jcfg, 32, 64),
                                          jpolicies.activation_rules(jcfg, jm)))
    assert steps.use_fsdp(cfg, pm) == jsteps.use_fsdp(jcfg, jm)
    for fsdp in (None, True, False):
        assert same(lambda: steps.param_pspecs(cfg, pm, fsdp),
                    lambda: jsteps.param_pspecs(jcfg, jm, fsdp))
    assert steps.FSDP_THRESHOLD_BYTES == jsteps.FSDP_THRESHOLD_BYTES

    def zero1(mod, specs, sp, rules, mesh):
        base = specs.partition_from_spec(sp, rules)
        return jax.tree.map(lambda l, ps: mod.zero1_axis(l, ps, mesh), sp, base,
                            is_leaf=lambda x: isinstance(x, (spec.LeafSpec, jspec.LeafSpec)))

    assert same(lambda: zero1(steps, spec, pspec, policies.param_rules(cfg, pm), pm),
                lambda: zero1(jsteps, jspec, jpspec, jpolicies.param_rules(jcfg, jm), jm))

    def unit_specs():
        uc = steps.make_unit_constrain(cfg, pm)
        return jax.tree.map(lambda c, s: (c, s), uc.compute, uc.storage,
                            is_leaf=lambda x: isinstance(x, P))

    def jax_unit_specs():
        base = jspec.partition_from_spec(jpspec, jpolicies.param_rules(jcfg, jm))["units"]
        return jsteps.make_unit_constrain(jcfg, jm)(base)

    assert same(unit_specs, jax_unit_specs)


def test_a_model_extent_of_three_raises_jax_value_error():
    mesh = StandIn({"data": 2, "model": 3})
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for port, ref in ((policies.param_rules, jpolicies.param_rules),
                          (policies.activation_rules, jpolicies.activation_rules),
                          (steps.param_pspecs, jsteps.param_pspecs)):
            with pytest.raises(ValueError) as got:
                port(cfg, mesh)
            with pytest.raises(ValueError) as want:
                ref(jcfg, mesh)
            assert str(got.value) == str(want.value), arch


def test_render_specs_keep_their_values_on_a_render_mesh():
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    stub = StandIn({"data": 2, "model": 2})
    for name in ("camera_batch_pspec", "scene_shard_pspec", "feature_shard_pspec"):
        assert tuple(getattr(policies, name)(mesh)) == tuple(getattr(jpolicies, name)(stub))
    assert policies.data_extent(mesh) == jpolicies.data_extent(stub) == 2
    assert tuple(policies.render_replicated_pspec()) == tuple(jpolicies.render_replicated_pspec())
    pod = StandIn(MESHES["2x16x16"])
    assert policies.data_extent(pod) == jpolicies.data_extent(pod) == 32
    assert tuple(policies.camera_batch_pspec(pod)) == tuple(jpolicies.camera_batch_pspec(pod))


def test_the_model_calls_constrain_where_jax_does():
    """The set of logical axes each package's forward and decode step pass
    to constrain, on jamba's smoke config (attention, mamba, MoE and dense
    FFNs) and hubert's (the GELU MLP): the same, and all in SITES."""
    for arch in ("jamba-1.5-large-398b", "hubert-xlarge"):
        cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
        seen = {"port": set(), "jax": set()}

        def rec(key):
            def constrain(x, axes):
                seen[key].add(tuple(axes))
                return x
            return constrain

        # JAX records at trace time: abstract inputs, traced, never run.
        jparams = jspec.abstract_from_spec(jmodels.build_param_spec(jcfg))
        params = spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), "cpu")
        np_batch = make_batch(TokenStream(cfg.vocab, 2, 16, seed=1), 0, cfg.frontend,
                              cfg.n_frontend_tokens, cfg.d_model)
        with torch.inference_mode():
            forward(cfg, params, device_batch(np_batch, "cpu"), rec("port"))
            jax.eval_shape(lambda p, b: jmodels.forward(jcfg, p, b, rec("jax")),
                           jparams, {k: jnp.asarray(v) for k, v in np_batch.items()})
            if cfg.family != "encoder":
                decode_step(cfg, params, init_cache(cfg, 2, 8, "cpu"),
                            torch.zeros(2, dtype=torch.long), 0, rec("port"))
                jax.eval_shape(lambda p, c: jmodels.decode_step(
                    jcfg, p, c, jnp.zeros(2, jnp.int32), 0, rec("jax")),
                    jparams, jspec.abstract_from_spec(jmodels.build_cache_spec(jcfg, 2, 8)))
        assert seen["port"] == seen["jax"], arch
        assert seen["port"] <= set(SITES)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def per_position(tree):
    """A placed tree with each position's piece its own copy, as distinct
    cards hold them: a mesh of virtual devices then runs the replica paths
    (the gradient all-reduce, the ZeRO-1 refresh, gather's choice among
    replicas)."""
    return map_mesh(lambda m: MeshTensor(m.shape, m.dtype, m.mesh, m.spec,
                                         {pos: t.clone() for pos, t in m.pieces.items()}), tree)


@pytest.mark.parametrize("share", [True, False], ids=["per_device", "per_position"])
def test_placed_shards_and_their_inverse(share):
    """Every stored shard has the shape its spec selects and lives on its
    position's device; gather gives back the tree bit for bit, also from a
    copy a position. Positions on one device share a shard only where their
    slices are equal."""
    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-1b-a400m"), n_layers=4,
                              force_fsdp=True)
    params = spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), "cpu")
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    placed = steps.place_params(cfg, mesh, params)
    if not share:
        placed = per_position(placed)
    specs = steps.param_pspecs(cfg, mesh, fsdp=True)
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    for m, x, s in zip(tree_flatten(placed)[0], tree_flatten(params)[0], flat_specs, strict=True):
        assert isinstance(m, MeshTensor) and m.spec == s
        for pos in mesh.positions:
            t = m.pieces[pos]
            region = spec_region(mesh, s, x.shape, pos)
            assert t.shape == tuple(hi - lo for lo, hi in region)
            assert t.device == mesh.grid[pos[0]][pos[1]]
            assert torch.equal(t, x[tuple(slice(lo, hi) for lo, hi in region)])
            assert t.data_ptr() != x.data_ptr()
        n_regions = len({spec_region(mesh, s, x.shape, p) for p in mesh.positions})
        assert len(m.distinct()) == (n_regions if share else mesh.size)
    back = gather(placed, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(back)[0], tree_flatten(params)[0]))
    # the unit axis (4 units over 2 data rows under FSDP) splits its shards
    wq = placed["units"]["pos0"]["mixer"]["wq"]
    assert wq.spec[0] == "data" and wq.pieces[(1, 0)].shape[0] == 2
    x = torch.arange(48.0).reshape(4, 12)
    for s in (P(), P("data"), P(None, "model"), P(("data", "model")), P("model", "data")):
        assert torch.equal(place(x, mesh, s).gather(), x)
    with pytest.raises(ValueError, match="does not split"):
        place(torch.zeros(3, 4), mesh, P("data"))


# --------------------------------------------------------------------------
# mesh steps against one device
# --------------------------------------------------------------------------

def smoke_params(cfg, seed=0):
    return spec.init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(seed), "cpu")


def leaf_close(port, ref, what):
    for a, b in zip(tree_flatten(port)[0], tree_flatten(ref)[0], strict=True):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= PARAM_TOL * scale, what


def run_two_steps(cfg, shape, optimizer="adamw", replicas=False):
    """Two steps over a virtual CPU mesh (of ``shape``, or the mesh given)
    against one device; ``replicas`` gives each position its own copy
    (:func:`per_position`)."""
    mesh = (shape if isinstance(shape, RenderMesh)
            else make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1])))
    params = smoke_params(cfg)
    placed = steps.place_params(cfg, mesh, params)
    mopt = steps.init_opt_state(placed, optimizer)
    if replicas:
        placed, mopt = per_position(placed), per_position(mopt)
    opt = (adamw_init if optimizer == "adamw" else adafactor_init)(params)
    kw = dict(optimizer=optimizer, lr=1e-3, warmup=1, total_steps=10)
    one, _ = steps.make_train_step(cfg, None, **kw)
    over, name = steps.make_train_step(cfg, mesh, **kw)
    assert name == optimizer
    stream = TokenStream(cfg.vocab, 4, 32, seed=3)
    metrics = []
    for i in range(2):
        b = device_batch(make_batch(stream, i, cfg.frontend, cfg.n_frontend_tokens, cfg.d_model),
                         "cpu")
        _, _, m1 = one(params, opt, b, i)
        same_p, same_o, mm = over(placed, mopt, b, i)
        assert same_p is placed and same_o is mopt
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(mm[key].item(), m1[key].item(), **TOL, err_msg=key)
        metrics.append(mm)
    leaf_close(gather(placed, "cpu"), params, "parameters")
    leaf_close(gather(mopt, "cpu"), opt, "optimizer state")
    assert not any(t.requires_grad for m in tree_flatten(placed)[0] for _, _, t in m.distinct())
    return mesh, placed, metrics


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_mesh_train_steps_match_one_device(arch, shape, fsdp):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), force_fsdp=fsdp)
    _, _, metrics = run_two_steps(cfg, shape)
    if arch == "granite-moe-1b-a400m":
        assert all(m["aux"].item() > 0 for m in metrics)


@pytest.mark.parametrize("case", ["adafactor", "replicas_remat", "units_on_data"])
def test_mesh_train_step_variants(case):
    """Adafactor (factored statistics of whole leaves, two units a leaf);
    one copy a position (the replica all-reduce and the ZeRO-1 refresh) with
    remat; and FSDP's data axis on the unit axis (two units over two rows)."""
    arch = {"adafactor": "jamba-1.5-large-398b", "replicas_remat": "granite-moe-1b-a400m",
            "units_on_data": "granite-3-2b"}[case]
    cfg = configs.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=2 * len(cfg.pattern), force_fsdp=True,
                              remat=case == "replicas_remat")
    if case == "adafactor":
        run_two_steps(cfg, (2, 2), optimizer="adafactor")
    elif case == "replicas_remat":
        mesh, placed, _ = run_two_steps(cfg, (2, 2), replicas=True)
        assert any(len(r) > 1 for m in tree_flatten(placed)[0] for r in m.replicas().values())
    else:
        mesh, placed, _ = run_two_steps(cfg, (2, 1))
        assert placed["units"]["pos0"]["mixer"]["wq"].spec[0] == "data"


def test_the_aux_loss_is_the_whole_batch():
    """granite-moe's aux over a (2, 1) mesh equals one device's, and not the
    mean of the rows' own losses."""
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    params = smoke_params(cfg)
    b = device_batch(make_batch(TokenStream(cfg.vocab, 4, 32, seed=3), 0), "cpu")
    from repro_torch.models import loss_fn

    with torch.no_grad():
        whole = loss_fn(cfg, params, b)[1]["aux"].item()
        rows = [loss_fn(cfg, params, {k: v[2 * r:2 * r + 2] for k, v in b.items()})[1]["aux"]
                for r in range(2)]
    mesh, _, metrics = run_two_steps(cfg, (2, 1))
    np.testing.assert_allclose(metrics[0]["aux"].item(), whole, **TOL)
    assert abs(sum(float(a) for a in rows) / 2 - whole) > 1e-4


def test_remat_gathers_each_unit_again_in_the_backward(monkeypatch):
    """Under remat the unit gather runs in the recompute too (it is not
    held): twice a unit and row with remat, once without."""
    calls = []
    real = steps.UnitConstrain.__call__

    def counting(self, up, row=0):
        calls.append(row)
        return real(self, up, row)

    monkeypatch.setattr(steps.UnitConstrain, "__call__", counting)
    base = configs.get_smoke_config("granite-3-2b")
    for remat, want in ((False, 1), (True, 2)):
        cfg = dataclasses.replace(base, n_layers=2, remat=remat, force_fsdp=True)
        mesh = make_host_mesh(2, 1, devices=["cpu"] * 2)
        placed = steps.place_params(cfg, mesh, smoke_params(cfg))
        step, _ = steps.make_train_step(cfg, mesh)
        calls.clear()
        step(placed, steps.init_opt_state(placed, "adamw"),
             device_batch(make_batch(TokenStream(cfg.vocab, 2, 16, seed=0), 0), "cpu"), 0)
        assert len(calls) == want * cfg.n_units * mesh.rows, remat


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_mesh_prefill_and_decode_match_one_device(arch, shape):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), force_fsdp=True)
    prefill_and_decode_match_one_device(
        cfg, make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1])))


def prefill_and_decode_match_one_device(cfg, mesh):
    """The mesh prefill step and four decode steps (the batch split over
    the data rows, and not) against one device's, at ``TOL``."""
    params = smoke_params(cfg)
    placed = steps.place_params(cfg, mesh, params)
    b = device_batch(make_batch(TokenStream(cfg.vocab, 4, 16, seed=2), 0), "cpu")
    with torch.inference_mode():
        want = steps.make_prefill_step(cfg)(params, b)
        got = steps.make_prefill_step(cfg, mesh)(placed, b)
        assert isinstance(got, MeshTensor)
        torch.testing.assert_close(got.gather(), want, **TOL)
        for shardable in (True, False):
            one = steps.make_decode_step(cfg)
            over = steps.make_decode_step(cfg, mesh, batch_shardable=shardable,
                                          weight_gather=shardable)
            cache1, cachem = init_cache(cfg, 4, 6, "cpu"), steps.mesh_cache(cfg, mesh, 4, 6,
                                                                              shardable)
            t1 = tm = b["tokens"][:, 0]
            for pos in range(4):
                t1, cache1 = one(params, cache1, t1, pos)
                tm, cachem = over(placed, cachem, tm, pos)
                assert torch.equal(tm.gather(), t1), pos
            for a, c in zip(tree_flatten(gather(cachem))[0], tree_flatten(cache1)[0]):
                torch.testing.assert_close(a, c, **TOL)
            held = {len(m.distinct()) for m in tree_flatten(cachem)[0]}
            assert held == {mesh.rows if shardable else 1}


def test_sharded_loss_on_jax_config_matches_jax_single_device():
    """tests/test_sharding.py::test_sharded_loss_matches_single_device's
    config and batch over a (2, 4) mesh of virtual CPU devices: the mesh
    step's loss (taken before its update) within TOL of JAX's one-device
    loss_fn from the same weights (drawn by numpy from a seed)."""
    kw = dict(mlp_sharding="ff", d_ff=128, shard_vocab=True, vocab=512)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("granite-3-2b"), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config("granite-3-2b"), **kw)
    rng = np.random.default_rng(0)

    def weight(leaf):   # the init's scales, drawn by numpy from a seed
        if leaf.init in ("zeros", "ones"):
            return np.full(leaf.shape, leaf.init == "ones", np.float32)
        fan = leaf.fan_in or (leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1])
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan)).astype(np.float32)

    np_params = jax.tree.map(weight, jmodels.build_param_spec(jcfg),
                             is_leaf=lambda x: isinstance(x, jspec.LeafSpec))
    tokens = np.ones((8, 32), np.int32)
    labels = np.tile(np.arange(32, dtype=np.int32)[None], (8, 1))
    want = float(jax.jit(lambda p, b: jmodels.loss_fn(jcfg, p, b, lambda x, a: x)[0])(
        jax.tree.map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}))
    mesh = make_host_mesh(2, 4, devices=["cpu"] * 8)
    params = spec.params_from_numpy(np_params, "cpu")
    placed = steps.place_params(cfg, mesh, params)
    assert placed["lm_head"].spec == P(None, "model")
    step, _ = steps.make_train_step(cfg, mesh)
    _, _, m = step(placed, steps.init_opt_state(placed, "adamw"),
                   {"tokens": torch.from_numpy(tokens).long(),
                    "labels": torch.from_numpy(labels).long()}, 0)
    np.testing.assert_allclose(m["loss"].item(), want, **TOL)


def test_mesh_step_checks():
    cfg = configs.get_smoke_config("granite-3-2b")
    with pytest.raises(ValueError, match="RenderMesh"):
        steps.make_train_step(cfg, StandIn(MESHES["2x16x16"]))
    with pytest.raises(ValueError, match="RenderMesh"):
        steps.make_prefill_step(cfg, StandIn(MESHES["2x2"]))
    mesh = make_host_mesh(2, 1, devices=["cpu"] * 2)
    step, _ = steps.make_train_step(cfg, mesh)
    placed = steps.place_params(cfg, mesh, smoke_params(cfg))
    with pytest.raises(ValueError, match="does not split"):
        step(placed, steps.init_opt_state(placed, "adamw"),
             device_batch(make_batch(TokenStream(cfg.vocab, 3, 8, seed=0), 0), "cpu"), 0)
