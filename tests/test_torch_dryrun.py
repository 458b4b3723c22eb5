"""The port's dry-run tools (launch/{shapes,roofline,report,meminspect,
dryrun}.py, ``make_production_mesh``, ``steps.abstract_*``) against the JAX
package's, on the CPU, and the LM steps over a ``'pod'`` mesh.

The JAX package's ``dryrun`` and ``meminspect`` set ``XLA_FLAGS`` when
imported, which would change every later JAX backend of this process: they
are imported only in a subprocess (``buffer_table``). Parity: ``SHAPES``,
``cell_supported`` and ``model_flops_for_cell`` on all 40 (arch, shape)
pairs, exactly; the HLO parsers on ``tests/test_launch.py``'s text;
``fmt_table``'s text on the same records (one of them a record of the
port's ``run_cell`` on a smoke config); the shapes, dtypes and specs of
``abstract_*`` for the ten configs (JAX through stand-in meshes, the port
on ``meta`` meshes), token ids int64 where JAX's are int32, and the cache
under JAX's spec with its ``'model'`` entries dropped (the port holds a
row's cache whole on its lead device). ``calibrated_costs``'s extrapolation
from 1 and 2 units against a direct count at 3 units, on smoke configs,
and the collective counts per position against the bytes each position
holds.
The pod-mesh steps against one device at ``test_torch_lm_sharding.py``'s
bounds.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import utils as jutils
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import mamba2 as jmamba2
from repro_torch import configs, utils
from repro_torch.launch import dryrun, meminspect, report, roofline, shapes, steps
from repro_torch.launch.mesh import RenderMesh, make_host_mesh, make_production_mesh
from repro_torch.models import attention, mamba2
from repro_torch.sharding.policies import (
    MeshTensor,
    P,
    data_only,
    mesh_zeros,
    per_device,
    position_bytes,
    record_collectives,
)
from test_torch_lm_sharding import StandIn, prefill_and_decode_match_one_device, run_two_steps

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jconfigs.ARCHS)
PAIRS = [(a, s) for a in ARCHS for s in jshapes.SHAPES]
# tests/test_launch.py::test_collective_parser's module text
HLO = """
  %ar = bf16[128,256]{1,0} all-reduce(%x), replica_groups={}
  %ag-start = (f32[64]{0}, f32[1024]{0}) all-gather-start(%y)
  %ag-done = f32[1024]{0} all-gather-done(%ag-start)
  %a2a = u32[16,16]{1,0} all-to-all(%z)
  %cp = s8[8]{0} collective-permute(%w)
  %dot = f32[2,2]{1,0} dot(%a, %b)
"""
PEAK_RTOL = 1e-4   # the extrapolated peak of a train step against 3 units (measured: 0)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    assert [(a, s.name) for a, s in shapes.all_cells()] == [
        (a, s.name) for a, s in jshapes.all_cells()]


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_model_flops_match_jax(arch):
    """cell_supported (reasons word for word) and model_flops_for_cell,
    exactly, on every shape of ``arch``."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name in jshapes.SHAPES:
        s, js = shapes.SHAPES[name], jshapes.SHAPES[name]
        assert shapes.cell_supported(cfg, s) == jshapes.cell_supported(jcfg, js)
        assert roofline.model_flops_for_cell(cfg, s) == jroofline.model_flops_for_cell(jcfg, js)


def test_nine_cells_are_skipped():
    skips = [(a, s) for a, s in PAIRS
             if not shapes.cell_supported(configs.get_config(a), shapes.SHAPES[s])[0]]
    assert len(PAIRS) == 40 and len(skips) == 9


def test_hlo_parsers_match_jax():
    """collective_bytes in process; buffer_table through a subprocess (the
    JAX meminspect sets XLA_FLAGS when imported)."""
    assert roofline.collective_bytes(HLO) == jroofline.collective_bytes(HLO)
    code = ("import json, sys; from repro.launch.meminspect import buffer_table; "
            "print(json.dumps([[list(k), v] for k, v in buffer_table(sys.stdin.read(), 0)]))")
    out = subprocess.run([sys.executable, "-c", code], input=HLO, capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": str(ROOT / "src"),
                                                     "JAX_PLATFORMS": "cpu", "PATH": ""},
                         timeout=120)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = [[list(k), v] for k, v in meminspect.buffer_table(HLO, 0)]
    assert got == want and len(got) == 6


def test_derive_terms_on_h100_constants():
    t = roofline.derive_terms(
        arch="x", shape_name="train_4k", mesh_name="16x16", chips=256,
        cost={"flops": 1e15, "bytes accessed": 1e10},
        hlo_text="%ar = bf16[1024]{0} all-reduce(%x)\n", model_flops=6e17)
    assert t.dominant == "compute" and t.collective_bytes_total == 2048
    assert t.compute_s == 1e15 / 989e12 and t.memory_s == 1e10 / 3.35e12
    assert t.collective_s == 2048 / (25e9 * 18)
    assert list(t.as_dict()) == list(jroofline.derive_terms(
        arch="x", shape_name="train_4k", mesh_name="16x16", chips=256,
        cost={}, hlo_text="", model_flops=1.0).as_dict())
    by_kind = roofline.derive_terms(arch="x", shape_name="s", mesh_name="m", chips=4, cost={},
                                    model_flops=1.0, collectives={"all-gather": 7})
    assert by_kind.collective_bytes_total == 7


def test_run_cell_records_render_as_in_jax(monkeypatch, tmp_path):
    """A skip record word for word as JAX's, an ok record of the port's
    run_cell (mamba2-370m's smoke config on a small decode cell of batch 1
    over a (2, 1, 2) meta pod mesh: a batch that does not split) with JAX's
    keys and its basis, and fmt_table's text equal to JAX's on them and on
    a JAX-shaped record."""
    skip = dryrun.run_cell("hubert-xlarge", "decode_32k", False, verbose=False)
    ok, reason = jshapes.cell_supported(jconfigs.get_config("hubert-xlarge"),
                                        jshapes.SHAPES["decode_32k"])
    assert skip == {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "16x16",
                    "status": "skip", "reason": reason} and not ok
    tiny = shapes.ShapeCell("long_tiny", 64, 1, "decode")
    monkeypatch.setattr(dryrun, "get_config", configs.get_smoke_config)
    monkeypatch.setattr(dryrun, "meta_mesh", lambda multi_pod: _pod_mesh(2, 1, 2, "meta"))
    monkeypatch.setitem(dryrun.SHAPES, tiny.name, tiny)
    rec = dryrun.run_cell("mamba2-370m", tiny.name, True, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16" and rec["device"] == "meta"
    assert set(rec["basis"]) >= set(rec["memory_analysis"]) and rec["basis"]["alias_bytes_per_device"] is None
    r = rec["roofline"]
    assert r["chips"] == 4 and r["flops_per_device"] > 0 and r["arg_bytes_per_device"] > 0
    assert r["model_flops"] == jroofline.model_flops_for_cell(
        jconfigs.get_smoke_config("mamba2-370m"), jshapes.ShapeCell(*dataclasses.astuple(tiny)))
    jax_like = {"arch": "x", "shape": "train_4k", "mesh": "16x16", "status": "ok",
                "memory_analysis": {"argument_bytes_per_device": 3 << 30,
                                    "temp_bytes_per_device": 1 << 29},
                "roofline": {"compute_s": 1.5, "memory_s": 0.25, "collective_s": 2e-3,
                             "dominant": "compute", "useful_flops_ratio": 0.61}}
    records = json.loads(json.dumps([rec, skip, jax_like]))
    assert report.fmt_table(records) == jreport.fmt_table(records)
    # the CLI on a skip cell: its record in --report, exit 0
    path = tmp_path / "r.json"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "hubert-xlarge", "--shape",
                                      "long_500k", "--report", str(path)])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0 and json.loads(path.read_text())[0]["status"] == "skip"


class _Struct:
    """JAX's ShapeDtypeStruct as the patched JAX steps build it: a leaf
    holding the shape, dtype name and the spec its NamedSharding was
    given."""

    def __init__(self, shape, dtype, sharding=None):
        self.shape, self.dtype, self.spec = tuple(shape), jnp.dtype(dtype).name, sharding


def _same(port, ref, cache=False):
    """The port's MeshTensor tree against JAX's (patched) ShapeDtypeStructs:
    shapes, dtypes (int64 ids where JAX's are int32) and specs."""
    if isinstance(ref, _Struct):
        shape, dtype, spec = ref.shape, ref.dtype, ref.spec
        assert isinstance(port, MeshTensor) and port.shape == shape
        want = "int64" if dtype == "int32" else dtype
        assert str(port.dtype).removeprefix("torch.") == want
        want_spec = data_only(tuple(spec)) if cache else tuple(spec)
        assert tuple(port.spec) == tuple(want_spec), (port.spec, spec)
        return
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _same(port[k], ref[k], cache)
        return
    assert type(port).__name__ == type(ref).__name__ and port._fields == ref._fields
    for a, b in zip(port, ref):
        _same(a, b, cache)


PORT_MESHES = {"16x16": lambda: make_production_mesh(devices=["meta"] * 256),
               "2x16x16": lambda: make_production_mesh(multi_pod=True, devices=["meta"] * 512),
               "2x2": lambda: make_host_mesh(2, 2, devices=["meta"] * 4)}
JAX_MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
              "2x2": {"data": 2, "model": 2}}


@pytest.mark.parametrize("mesh_name", sorted(PORT_MESHES))
def test_abstract_inputs_match_jax(mesh_name, monkeypatch):
    """abstract_params, abstract_opt_state (both optimizers; ZeRO-1, the
    only layout of AdamW's state), abstract_batch and abstract_cache of the
    ten configs at full width against JAX's, with JAX's NamedSharding
    handing back its spec."""
    monkeypatch.setattr(jsteps, "NamedSharding", lambda mesh, s: s)
    monkeypatch.setattr(jax, "ShapeDtypeStruct", _Struct)
    mesh, jm = PORT_MESHES[mesh_name](), StandIn(JAX_MESHES[mesh_name])
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        try:
            jparams = jsteps.abstract_params(jcfg, jm)
        except ValueError as e:   # a spec that does not divide, as in JAX
            with pytest.raises(ValueError, match=str(e)):
                steps.abstract_params(cfg, mesh)
            continue
        _same(steps.abstract_params(cfg, mesh), jparams)
        for opt in ("adamw", "adafactor"):
            _same(steps.abstract_opt_state(cfg, mesh, opt, True),
                  jsteps.abstract_opt_state(jcfg, jm, opt, True))
        with pytest.raises(ValueError, match="ZeRO-1 only"):
            steps.abstract_opt_state(cfg, mesh, "adamw", False)
        for name, s in shapes.SHAPES.items():
            js = jshapes.SHAPES[name]
            assert steps._batch_shardable(s, mesh) == jsteps._batch_shardable(js, jm)
            if steps._batch_shardable(s, mesh):
                _same(steps.abstract_batch(cfg, s, mesh), jsteps.abstract_batch(jcfg, js, jm))
            else:   # JAX's struct names a split it cannot make; the port's placing raises
                with pytest.raises(ValueError, match="does not split"):
                    steps.abstract_batch(cfg, s, mesh)
            if s.kind == "decode" and shapes.cell_supported(cfg, s)[0]:
                _same(steps.abstract_cache(cfg, s, mesh), jsteps.abstract_cache(jcfg, js, jm),
                      cache=True)


def test_jit_for_cell_runs_each_kind_on_meta():
    """The step of each kind on its abstract inputs over a (2, 2) meta mesh,
    its kwargs named as JAX's."""
    cfg = configs.get_smoke_config("granite-3-2b")
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    want = {"train": ["params", "opt_state", "batch", "step"], "prefill": ["params", "batch"],
            "decode": ["params", "cache", "tokens", "pos"]}
    for kind, batch in (("train", 4), ("prefill", 4), ("decode", 4), ("decode", 1)):
        fn, kw = steps.jit_for_cell(cfg, shapes.ShapeCell("c", 32, batch, kind), mesh)
        assert list(kw) == want[kind] and (kind != "prefill" or "labels" not in kw["batch"])
        fn(**kw)
    assert steps.abstract_inputs_for_cell(cfg, shapes.ShapeCell("c", 32, 4, "prefill"),
                                          mesh)[1].keys() == {"params", "batch"}


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-370m"])
def test_calibration_extrapolates_to_three_units(arch):
    """On a (2, 2) meta mesh, calibrated_costs' fixed + 3 x per_unit equals
    a direct count of 3 units: FLOPs exactly, the peak within PEAK_RTOL,
    bytes and each position's collective bytes exactly where the placement
    of every leaf is the same at 1, 2 and 3 units. mamba2's state is not:
    at 2 units its unit axis divides the data axes and ZeRO-1 shards it, at
    1 and 3 another axis (JAX's zero1_axis, the same in both packages), so
    its bytes and its ZeRO-1 all-gather move by at most 1e-5 and 1e-2 of
    their totals."""
    cfg = configs.get_smoke_config(arch)
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    shape = shapes.ShapeCell("t", 32, 4, "train")
    cal = dryrun.calibrated_costs(cfg, shape, mesh)
    three = dataclasses.replace(cfg, n_layers=3 * len(cfg.pattern),
                                force_fsdp=steps.use_fsdp(cfg, mesh))
    got = dryrun._cell_costs(three, shape, mesh)
    got.pop("seconds")
    ext = {k: cal["fixed"][k] + 3 * cal["per_unit"][k] for k in cal["fixed"]}
    assert ext["flops"] == got["flops"] > 0
    assert abs(ext["temp"] - got["temp"]) <= PEAK_RTOL * got["temp"]
    exact = sorted(set(got) - {"flops", "temp"}, key=str)   # bytes, each (kind, position)
    if arch == "granite-3-2b":
        assert {k: ext.get(k, 0) for k in exact} == {k: got[k] for k in exact}
        assert per_device(got)["all-gather"] > 0 and per_device(got)["all-reduce"] > 0
    else:
        assert abs(ext["bytes"] - got["bytes"]) <= 1e-5 * got["bytes"]
        for k in exact:
            if k != "bytes":
                assert abs(ext.get(k, 0) - got[k]) <= 1e-2 * max(got[k], 1.0), k


def test_all_reduce_counts_a_replicated_leaf_once_a_device():
    """A leaf replicated over 'data' and split over 'model' on a (2, 2)
    meta mesh: each position all-reduces its own region, once."""
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    grad = mesh_zeros((8, 6), torch.bfloat16, mesh, P(None, "model"))
    with record_collectives() as log:
        steps._all_reduce_replicas({"w": grad})
    assert log == {("all-reduce", pos): 8 * 3 * 2 for pos in mesh.positions}
    assert per_device(log) == {"all-gather": 0, "all-reduce": 48, "reduce-scatter": 0}


def test_train_step_all_reduce_is_each_positions_gradient_bytes():
    """The (2, 2) meta train step of a smoke config without FSDP: every
    parameter region is held by both data rows, so each position
    all-reduces exactly the bytes of parameters it holds."""
    cfg = configs.get_smoke_config("granite-3-2b")
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    assert not steps.use_fsdp(cfg, mesh)
    fn, kw = steps.jit_for_cell(cfg, shapes.ShapeCell("t", 32, 4, "train"), mesh)
    held = position_bytes(kw["params"])
    with record_collectives() as log:
        fn(**kw)
    assert {pos: log[("all-reduce", pos)] for pos in mesh.positions} == held
    assert per_device(log)["all-reduce"] == max(held.values())


def test_production_mesh():
    m = make_production_mesh(devices=["meta"] * 256)
    assert dict(m.shape) == {"data": 16, "model": 16} and m.axis_names == ("data", "model")
    pod = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert dict(pod.shape) == {"pod": 2, "data": 16, "model": 16} and pod.rows == 32
    from repro_torch.sharding.policies import spec_region

    # rows are pod x data, row-major, as JAX orders ('pod', 'data')
    assert spec_region(pod, (("pod", "data"),), (64,), (17, 3)) == ((34, 36),)
    assert spec_region(pod, ("pod",), (64,), (17, 3)) == ((32, 64),)
    assert spec_region(pod, ("data",), (64,), (17, 3)) == ((4, 8),)
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=["meta"] * 255)
    with pytest.raises((RuntimeError, ValueError)):   # fewer than 256 visible cards
        make_production_mesh()
    with pytest.raises(ValueError, match="pods"):
        RenderMesh(pod.grid[:3], ("pod", "data", "model"), pods=2)


def _pod_mesh(pods, data, model, device="cpu"):
    devs = [torch.device(device)] * model
    return RenderMesh(tuple(tuple(devs) for _ in range(pods * data)),
                      ("pod", "data", "model"), pods=pods)


def test_pod_mesh_train_step_matches_one_device():
    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-1b-a400m"), force_fsdp=True)
    mesh, placed, _ = run_two_steps(cfg, _pod_mesh(2, 2, 1))
    assert ("pod", "data") in placed["units"]["pos0"]["ffn"]["w1"].spec


def test_pod_mesh_prefill_and_decode_match_one_device():
    cfg = dataclasses.replace(configs.get_smoke_config("granite-3-2b"), force_fsdp=True)
    prefill_and_decode_match_one_device(cfg, _pod_mesh(2, 1, 2))


def test_leftovers_match_jax():
    assert attention.AttnParams._fields == jattention.AttnParams._fields == ()
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        mamba2.w_full({"conv_w": torch.from_numpy(w).bfloat16()}, 4).numpy(),
        np.asarray(jmamba2.w_full({"conv_w": jnp.asarray(w, jnp.bfloat16)}, 4)))
    tree = {"a": rng.standard_normal((3, 4)), "b": [rng.standard_normal(5), {"c": np.ones(())}]}
    assert utils.pytree_count(jax.tree.map(torch.from_numpy, tree)) == jutils.pytree_count(
        tree) == 18
