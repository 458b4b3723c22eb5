"""The port's render mesh (``repro_torch.launch.mesh``,
``repro_torch.sharding.policies``) and rendering over it, on the CPU.

Meshes here list one CPU device several times (virtual devices), the
counterpart of the JAX package's forced host device count in
``tests/test_sharding.py::_DEVICE_SCRIPT``. The checks of that script run
in process:

  * ``make_render_mesh``, ``data_extent`` and the five render specs equal
    the JAX package's for the same mesh shapes;
  * over (data, model) = (2, 1), (1, 2), (2, 2) and (1, 4), every
    ``render_batch_sharded`` lane is bitwise the one-device ``render_batch``
    (image and counters), gstg and tile_baseline on ``reference`` and
    ``cuda`` (whose kernel wrappers run their plain versions here);
  * a physical commit runs the psum gather, with the JAX package's
    ``feature_mb_per_device``, and a budget only a physical commit meets
    escalates an ``'auto'`` open; shard ``d`` lives on model column ``d``;
  * submits, stream frames, served requests and the serve CLI over a mesh
    are bitwise one device's, and one mesh render is within the parity
    contract (atol 5e-6, rtol 1e-5, counters exact) of the JAX package's
    one-device render of the same numpy-seeded scene.

The scene is ``tests/test_sharding.py``'s (300 gaussians, key 3) at 96x96.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import orbit_cameras as jax_orbit_cameras
from repro.core import random_scene as jax_random_scene
from repro.core.pipeline import RenderConfig as JConfig
from repro_torch import engine
from repro_torch.core.camera import orbit_cameras
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.core.pipeline import RenderConfig, RenderStats, render_batch
from repro_torch.core.projection import (
    Projected,
    ShardedProjected,
    proj_take,
    projected_bytes_per_gaussian,
)
from repro_torch.launch.mesh import make_host_mesh, make_render_mesh
from repro_torch.sharding import policies
from repro_torch.utils import pytree_bytes
from torch_parity import assert_counters_equal, n, single_thread  # noqa: F401

CPU = torch.device("cpu")
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
COMBOS = [("gstg", "reference"), ("tile_baseline", "reference"),
          ("gstg", "cuda"), ("tile_baseline", "cuda")]
CFG_KW = dict(group_capacity=256, tile_capacity=256, span=6)
COUNTERS = [f.name for f in dataclasses.fields(RenderStats)]


@pytest.fixture(scope="module")
def jax_scene():
    return jax_random_scene(jax.random.key(3), 300, extent=3.0)


@pytest.fixture(scope="module")
def scene(jax_scene):
    return scene_from_numpy(jax_scene, "cpu")


@pytest.fixture(scope="module")
def cams():
    return orbit_cameras(3, 4.5, 96, 96)      # ragged over the data axis


def _mesh(data, model):
    return make_render_mesh([CPU] * (data * model), scene_shards=model)


def _bitwise(a, b, what):
    assert torch.equal(a.image, b.image), f"{what}: image"
    for name in COUNTERS:
        assert torch.equal(getattr(a.stats, name), getattr(b.stats, name)), f"{what}: {name}"


# -- the mesh and the specs against the JAX package ------------------------------


class _JaxMeshStub(SimpleNamespace):
    """What the JAX package's builders and specs read of a mesh."""


@pytest.mark.parametrize("devices", [1, 2, 4, 6])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_make_render_mesh_matches_jax(devices, shards, monkeypatch):
    """The JAX builder over ``devices`` host devices (``jax.make_mesh``
    recorded, not run: the process has one JAX device) against the port's
    over as many virtual CPU devices: the same axes and shape, or both
    raise."""
    import repro.launch.mesh as jax_mesh

    monkeypatch.setattr(jax_mesh.jax, "make_mesh", lambda shape, axes, **kw: _JaxMeshStub(
        axis_names=tuple(axes), shape=dict(zip(axes, shape))))
    try:
        want = jax_mesh.make_render_mesh(devices, scene_shards=shards)
    except ValueError:
        with pytest.raises(ValueError, match="divide"):
            make_render_mesh([CPU] * devices, scene_shards=shards)
        return
    got = make_render_mesh([CPU] * devices, scene_shards=shards)
    assert got.axis_names == want.axis_names
    assert dict(got.shape) == want.shape
    assert got.size == devices and got.devices == (CPU,) * devices
    assert got.lead(got.rows - 1) == CPU
    host = make_host_mesh(got.rows, got.columns, [CPU] * devices)
    assert dict(host.shape) == {"data": got.rows, "model": got.columns}


def test_make_render_mesh_device_arguments():
    """None and an int name cards (raising without them), a list may repeat
    a device, an empty or non-positive one raises, as the JAX builder's
    ``n <= 0`` does; meshes compare by value."""
    with pytest.raises(ValueError, match=">= 1 device"):
        make_render_mesh([])
    if not torch.cuda.is_available():
        for arg in (None, 2):
            with pytest.raises(RuntimeError, match="CUDA"):
                make_render_mesh(arg)
    assert make_render_mesh(["cpu", "cpu"]) == make_render_mesh([CPU, CPU])
    assert make_render_mesh(["cpu", "cpu"]) != make_render_mesh(["cpu", "cpu"], scene_shards=2)


@pytest.mark.parametrize("axes,shape", [
    (("data",), (1,)), (("data",), (4,)),
    (("data", "model"), (2, 1)), (("data", "model"), (1, 4)), (("data", "model"), (3, 2)),
])
def test_render_specs_match_jax(axes, shape):
    """camera_batch_pspec, data_extent, render_replicated_pspec,
    scene_shard_pspec and feature_shard_pspec hold the JAX package's values
    (PartitionSpecs compared as tuples) for the same mesh shape."""
    from repro.sharding import policies as jax_policies

    stub = _JaxMeshStub(axis_names=axes, shape=dict(zip(axes, shape)))
    data = shape[0]
    model = shape[1] if len(shape) > 1 else 1
    mesh = (make_render_mesh([CPU] * data) if len(axes) == 1
            else make_host_mesh(data, model, [CPU] * (data * model)))
    assert tuple(policies.camera_batch_pspec(mesh)) == tuple(jax_policies.camera_batch_pspec(stub))
    assert policies.data_extent(mesh) == jax_policies.data_extent(stub) == data
    assert tuple(policies.render_replicated_pspec()) == tuple(jax_policies.render_replicated_pspec())
    assert tuple(policies.scene_shard_pspec(mesh)) == tuple(jax_policies.scene_shard_pspec(stub))
    assert tuple(policies.feature_shard_pspec(mesh)) == tuple(
        jax_policies.feature_shard_pspec(stub))


# -- renders over virtual meshes, bitwise one device -----------------------------


_ONE_DEVICE = {}     # (mode, backend) -> the one-device render_batch


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("mode,backend", COMBOS)
@pytest.mark.parametrize("data,model", MESHES)
def test_mesh_render_bitwise_one_device(scene, cams, data, model, mode, backend,
                                        single_thread):
    """``render_batch_sharded(mesh=, scene_shards=model)`` over a virtual
    mesh against the one-device ``render_batch``: every lane's image and
    counters bitwise; a model axis commits the psum gather."""
    from repro_torch.serving.sharded import render_batch_sharded

    cfg = RenderConfig(mode=mode, backend=backend, **CFG_KW)
    if (mode, backend) not in _ONE_DEVICE:
        _ONE_DEVICE[mode, backend] = render_batch(scene, cams, cfg)
    want = _ONE_DEVICE[mode, backend]
    mesh = _mesh(data, model)
    got = render_batch_sharded(scene, cams, cfg, mesh=mesh, scene_shards=model)
    _bitwise(got, want, f"{mode}/{backend} over {dict(mesh.shape)}")
    stats = engine.default_renderer(scene, dataclasses.replace(cfg, scene_shards=model),
                                    mesh=mesh).stats()
    assert stats["mesh"] == dict(mesh.shape)
    assert stats["physical_shards"] == model
    assert stats["feature_gather"] == ("psum" if model > 1 else "flat")
    engine.close_default_renderers()


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4)])
def test_physical_commit_psum_feature_mb_and_placement(scene, cams, data, model):
    """A physical commit runs 'psum' with the JAX formula's per-device
    feature MB (padded N / D), physical_shards = D, and shard d of every
    data row (scene and per-camera features) on that row's model column
    d."""
    cfg = RenderConfig(scene_shards=model, **CFG_KW)
    mesh = _mesh(data, model)
    with engine.open(scene, cfg, mesh=mesh) as h:
        hs = h.stats()
        n_pad = -(-scene.num_gaussians // model) * model
        want_mb = n_pad * projected_bytes_per_gaussian() / 2**20 / model
        assert hs["feature_gather"] == "psum" and hs["physical_shards"] == model
        assert abs(hs["feature_mb_per_device"] - want_mb) <= 1e-9
        assert hs["scene_mb_per_device"] == pytree_bytes(scene) / 2**20 / model
        rows = h._placed
        assert len(rows) == data
        for r, row in enumerate(rows):
            assert row.physical and row.num_shards == model
            for d in range(model):
                part = row.shard(d)
                assert part.num_gaussians == n_pad // model
                assert part.device == mesh.grid[r][d]
        front = h.render_frontend(cams[0])
        assert isinstance(front.proj, ShardedProjected) and front.proj.physical
        assert [p.depth.shape[0] for p in front.proj.shards] == [n_pad // model] * model
        assert [p.depth.device for p in front.proj.shards] == list(mesh.grid[0])


def test_budget_escalates_to_a_physical_commit(scene):
    """A budget only a physical 2-way commit meets escalates a
    scene_shards=1 'auto' open over four devices to at least 2 physical
    shards with psum gathers; an explicit mesh cannot grow its model axis,
    so there the same budget raises."""
    n_pad = scene.num_gaussians
    full_mb = pytree_bytes(scene) / 2**20 + n_pad * projected_bytes_per_gaussian() / 2**20
    budget = full_mb / 2 * 1.2
    with engine.open(scene, RenderConfig(**CFG_KW), devices=[CPU] * 4,
                     device_budget_mb=budget) as h:
        hs = h.stats()
        assert hs["physical_shards"] >= 2 and hs["feature_gather"] == "psum"
        assert hs["mesh"] == {"data": 4 // hs["physical_shards"],
                              "model": hs["physical_shards"]}
    with pytest.raises(ValueError, match="over the"):
        engine.open(scene, RenderConfig(**CFG_KW), mesh=_mesh(4, 1), device_budget_mb=budget)


def test_mesh_submit_stream_and_server_bitwise(scene, cams, single_thread):
    """Over a (2, 2) virtual mesh: submits (one padded dispatch) and stream
    frames are bitwise render; a RenderServer over a (2, 1) mesh pads each
    dispatch to its data extent and serves bitwise one device's renders."""
    from repro_torch.serving import RenderRequest
    from repro_torch.serving.server import RenderServer

    cfg = RenderConfig(**CFG_KW)
    with engine.open(scene, cfg, device="cpu") as one:
        want = [one.render(c) for c in cams]
    with engine.open(scene, dataclasses.replace(cfg, scene_shards=2), mesh=_mesh(2, 2),
                     max_batch=3, max_wait=60.0) as h:
        futs = [h.submit(c) for c in cams]
        h.flush(timeout=60)
        for f, w in zip(futs, want):
            _bitwise(f.result(timeout=60), w, "submit over (2, 2)")
        assert h.stats()["padded_lanes"] == 1 and h.stats()["batches"] == 1
        with h.open_stream(speculate=False) as s:
            for c, w in zip(cams, want):
                _bitwise(s.render(c), w, "stream frame over (2, 2)")
            _bitwise(s.render(cams[0]), want[0], "stream hit over (2, 2)")
            assert s.stats()["hits"] == 1
            assert h.frontend_cache_mb() * 2**20 == s.cache_bytes() > 0
    with RenderServer({"s": scene}, mesh=_mesh(2, 1), max_batch=3) as server:
        res = server.run([(0.0, RenderRequest(i, "s", c, cfg)) for i, c in enumerate(cams)],
                         realtime=False)
        assert server.stats.summary()["padded"] == 1
    for i, w in enumerate(want):
        assert torch.equal(res[i].image, w.image)


def test_mesh_render_within_parity_of_jax(jax_scene, scene, cams, jit_render_fn):
    """One render over a (2, 2) mesh with physical shards against the JAX
    package's one-device render of the same scene: image within atol 5e-6 /
    rtol 1e-5, every counter exact."""
    jcams = jax_orbit_cameras(3, 4.5, 96, 96)
    jcfg = JConfig(**CFG_KW)
    with engine.open(scene, RenderConfig(scene_shards=2, **CFG_KW), mesh=_mesh(2, 2)) as h:
        got = h.render_batch(cams)
    for i in (0, 2):
        want = jit_render_fn(jax_scene, jcams[i], jcfg)
        np.testing.assert_allclose(n(got.image[i]), np.asarray(want.image), atol=5e-6, rtol=1e-5)
        assert_counters_equal({k: int(getattr(got.stats, k)[i]) for k in COUNTERS}, want.stats)


# -- the gathers on the physical form -----------------------------------------------


@pytest.mark.parametrize("gather", ["psum", "index"])
def test_physical_gathers_bitwise_the_flat_gather(gather):
    """The owner gathers of a physical ShardedProjected (one Projected a
    shard) give the flat gather's bits, signed zeros and NaN payloads too,
    as the stacked form does."""
    rng = np.random.default_rng(0)
    D, Ns = 3, 5
    fields = {}
    for f in dataclasses.fields(Projected):
        if f.name == "valid":
            fields[f.name] = torch.from_numpy(rng.random((D, Ns)) > 0.5)
            continue
        width = {"depth": (), "radius": (), "alpha": ()}.get(f.name, (2,))
        fields[f.name] = torch.from_numpy(rng.standard_normal((D, Ns) + width).astype(np.float32))
    fields["depth"][1, 2] = -0.0
    fields["depth"][2, 0] = torch.from_numpy(np.array([0x7FC01234], np.int32).view(np.float32))[0]
    stacked = Projected(**fields)
    parts = tuple(Projected(**{k: v[d] for k, v in fields.items()}) for d in range(D))
    idx = torch.from_numpy(rng.integers(0, D * Ns, size=(4, 6)).astype(np.int32))
    idx[0, :3] = torch.tensor([7, 10, 0], dtype=torch.int32)
    for name, x in fields.items():
        flat = x.flatten(0, 1)[idx.long()]
        for proj in (ShardedProjected(stacked, gather), ShardedProjected(parts, gather)):
            got = proj_take(proj, name, idx)
            view = torch.uint8 if x.dtype == torch.bool else torch.int32
            assert torch.equal(got.view(view), flat.view(view)), (name, proj.physical)


# -- the CLIs over a mesh ------------------------------------------------------------


def test_render_serve_cli_devices(capsys, single_thread):
    """render_serve --device cpu --devices 2 --scene-shards 2: a (1, 2) mesh
    of virtual CPU devices, physical shards, every request bitwise the
    one-shard render (--parity-check); --devices 3 keeps the shard axis
    logical and says so."""
    from repro_torch.launch.render_serve import main

    common = ["--device", "cpu", "--gaussians", "300", "--resolutions", "64x64",
              "--requests", "5", "--max-batch", "2", "--no-realtime", "--parity-check",
              "--scenes", "train"]
    assert main(common + ["--devices", "2", "--scene-shards", "2"]) == 0
    out = capsys.readouterr().out
    assert "render_serve: OK" in out and "parity-check: 5/5" in out
    assert "{'data': 1, 'model': 2}" in out
    assert main(common + ["--devices", "3", "--scene-shards", "2"]) == 0
    out = capsys.readouterr().out
    assert "shard axis stays logical" in out and "{'data': 3}" in out


def test_render_serve_cli_multi_device(tmp_path, capsys, single_thread):
    """The JAX package's ``--devices 2`` CLI test on the port, in process
    (``--device cpu``: two virtual CPU devices): all 6 requests complete,
    the trace passes the schema with the stats summary riding along (2
    devices; 2 batches of 3 each padded to 4, so 2 padded lanes), one
    request span a request, and the metrics snapshot agrees."""
    import json

    from repro_torch.launch.render_serve import main
    from repro_torch.obs import Tracer, get_registry, set_tracer, validate_chrome_trace

    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    prev = set_tracer(Tracer())
    before = get_registry().snapshot()["counters"]
    try:
        rc = main(["--device", "cpu", "--requests", "6", "--rate", "500", "--devices", "2",
                   "--gaussians", "400", "--resolutions", "64x64", "--scenes", "train",
                   "--max-batch", "3", "--max-wait", "0.02", "--no-realtime",
                   "--trace-json", str(trace), "--metrics-json", str(metrics)])
    finally:
        set_tracer(prev)
    assert rc == 0, capsys.readouterr().out
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) == []
    data = doc["summary"]
    assert data["completed"] == 6 and data["devices"] == 2 and data["mesh"] == {"data": 2}
    assert len(data["requests"]) == 6 and data["padded"] == 2
    reqs = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("name") == "request"]
    assert len(reqs) == 6
    snap = json.loads(metrics.read_text())
    assert snap["schema"] == "repro.metrics/v1"
    assert snap["counters"]["serving.requests_total"] - before.get("serving.requests_total", 0) == 6


def test_worker_main_devices_builds_the_worker_mesh():
    """worker_main --devices (without spawning a worker): the mesh over N
    virtual CPU devices, physical shards where --scene-shards divides N;
    worker_argv passes --devices on."""
    from repro_torch.gateway.transport import worker_argv
    from repro_torch.gateway.worker_main import parse_args, worker_mesh

    base = ["--worker-id", "w0", "--scenes", "train", "--device", "cpu"]
    assert dict(worker_mesh(parse_args(base)).shape) == {"data": 1}
    mesh = worker_mesh(parse_args(base + ["--devices", "4", "--scene-shards", "2"]))
    assert dict(mesh.shape) == {"data": 2, "model": 2} and mesh.devices == (CPU,) * 4
    mesh = worker_mesh(parse_args(base + ["--devices", "3", "--scene-shards", "2"]))
    assert dict(mesh.shape) == {"data": 3}
    argv = worker_argv("w0", ["train"], device="cpu", devices=2)
    assert argv[argv.index("--devices") + 1] == "2"
