"""The port's fault-tolerance modules (``repro_torch.ft``) and the gateway's
fleet plan: every case of the JAX package's ``tests/test_ft.py`` on the
port's objects, then the same report sequences and plan arguments through
both packages, which must give identical results."""
import dataclasses

import pytest

from repro.ft import HeartbeatMonitor as RefMonitor, plan_elastic_mesh as ref_plan
from repro.gateway import plan_fleet as ref_plan_fleet
from repro_torch.ft import HeartbeatMonitor, plan_elastic_mesh
from repro_torch.gateway import plan_fleet


def test_straggler_detection():
    mon = HeartbeatMonitor(n_hosts=8, window=4, min_factor=1.5)
    for step in range(4):
        for h in range(8):
            lat = 1.0 if h != 3 else 3.5
            mon.report(h, step, lat, now_s=step * 1.0)
    rep = mon.check(3)
    assert rep is not None
    assert rep.stragglers == [3]
    assert rep.slow_factor[3] > 2.0


def test_no_false_positives_on_uniform():
    mon = HeartbeatMonitor(n_hosts=8, window=4)
    for h in range(8):
        mon.report(h, 0, 1.0 + 0.01 * h, now_s=0.0)
    assert mon.check(0) is None


def test_dead_host_detection():
    mon = HeartbeatMonitor(n_hosts=4, miss_timeout_s=30.0)
    for h in range(3):
        mon.report(h, 0, 1.0, now_s=100.0)
    dead = mon.dead_hosts(now_s=120.0)
    assert dead == [3]


def test_elastic_plan_shrinks_data_axis():
    # lost 3 of 32 hosts (8 chips each): 232 chips left, model=16
    plan = plan_elastic_mesh(232, model_parallel=16, global_batch=256)
    assert plan is not None
    assert plan.mesh_shape[-1] == 16
    data = plan.mesh_shape[-2] if len(plan.mesh_shape) == 2 else plan.mesh_shape[1]
    assert 256 % data == 0


def test_elastic_plan_multi_pod():
    plan = plan_elastic_mesh(512, model_parallel=16, global_batch=256)
    assert plan.mesh_shape == (2, 16, 16)
    assert plan.mesh_axes == ("pod", "data", "model")


def test_elastic_plan_infeasible():
    assert plan_elastic_mesh(8, model_parallel=16, global_batch=256) is None


# -- edge cases brought live by the gateway tier (DESIGN.md §16) --------------


def test_miss_timeout_boundary_is_strict():
    # dead_hosts uses a STRICT > comparison: exactly at the timeout a host
    # is still alive — the gateway polices this every router step, so an
    # off-by-one here would flap workers at the boundary.
    mon = HeartbeatMonitor(n_hosts=2, miss_timeout_s=10.0)
    mon.report(0, 0, 1.0, now_s=100.0)
    mon.report(1, 0, 1.0, now_s=100.0)
    assert mon.dead_hosts(now_s=110.0) == []
    assert mon.dead_hosts(now_s=110.0 + 1e-6) == [0, 1]


def test_never_seen_hosts_are_dead():
    # A host that never reported is dead from the start: liveness must be
    # proven, not presumed (the gateway seeds a ping at dispatcher start
    # precisely because of this).
    mon = HeartbeatMonitor(n_hosts=3, miss_timeout_s=10.0)
    mon.report(1, 0, 1.0, now_s=0.0)
    assert mon.dead_hosts(now_s=5.0) == [0, 2]


def test_straggler_quorum_suppresses_report():
    # Below quorum (max(2, n//2) reporters) check() must stay silent — a
    # mostly-idle fleet cannot out-vote itself into straggler flags.
    mon = HeartbeatMonitor(n_hosts=8, window=4, min_factor=1.5)
    for h in range(3):                       # 3 < 8 // 2
        mon.report(h, 0, 5.0 if h == 0 else 1.0, now_s=0.0)
    assert mon.check(0) is None
    for h in range(3, 8):                    # full fleet reporting
        mon.report(h, 0, 1.0, now_s=0.0)
    assert mon.check(0).stragglers == [0]


def test_straggler_window_eviction_forgives():
    # A recovered host ages its slow samples out of the bounded window:
    # only the LATEST latency is judged, so one fast report clears the flag.
    mon = HeartbeatMonitor(n_hosts=8, window=4, min_factor=1.5)
    for h in range(8):
        mon.report(h, 0, 4.0 if h == 2 else 1.0, now_s=0.0)
    assert mon.check(0).stragglers == [2]
    mon.report(2, 1, 1.0, now_s=1.0)
    assert mon.check(1) is None


def test_dead_host_revives_on_report():
    mon = HeartbeatMonitor(n_hosts=2, miss_timeout_s=10.0)
    mon.report(0, 0, 1.0, now_s=0.0)
    mon.report(1, 0, 1.0, now_s=0.0)
    assert mon.dead_hosts(now_s=50.0) == [0, 1]
    mon.report(0, 1, 1.0, now_s=50.0)
    assert mon.dead_hosts(now_s=50.0) == [1]


def test_elastic_prime_batch_collapses_data_axis():
    # A prime global batch only divides by itself: with 6 surviving groups
    # the largest divisor of 7 that fits is 1 — the plan degrades to a
    # single data replica (correct, never a non-divisor) and reports the
    # idle devices honestly.
    plan = plan_elastic_mesh(6 * 4, model_parallel=4, global_batch=7)
    assert plan.mesh_shape == (1, 4)
    assert "(20 idle)" in plan.note
    # with 7 groups the prime fits exactly
    plan = plan_elastic_mesh(7 * 4, model_parallel=4, global_batch=7)
    assert plan.mesh_shape == (7, 4)


def test_elastic_exact_fit_uses_everything():
    plan = plan_elastic_mesh(32, model_parallel=8, global_batch=4)
    assert plan.mesh_shape == (4, 8)
    assert plan.mesh_axes == ("data", "model")
    assert "(0 idle)" in plan.note


def test_elastic_prefer_pods_false_stays_2d():
    plan = plan_elastic_mesh(512, model_parallel=16, global_batch=256,
                             prefer_pods=False)
    assert plan.mesh_axes == ("data", "model")
    assert plan.mesh_shape == (32, 16)


def test_elastic_pod_axis_requires_divisibility():
    # devices_per_pod not divisible by model_parallel: pod grouping is
    # skipped even with prefer_pods=True.
    plan = plan_elastic_mesh(512, model_parallel=16, global_batch=256,
                             devices_per_pod=100)
    assert plan.mesh_axes == ("data", "model")


def test_elastic_model_parallel_exact_boundary():
    # Exactly one surviving group is feasible (data=1); one fewer device
    # is not.
    assert plan_elastic_mesh(16, model_parallel=16, global_batch=8) is not None
    assert plan_elastic_mesh(15, model_parallel=16, global_batch=8) is None


def test_gateway_plan_fleet_maps_workers_to_groups():
    # The gateway treats each worker as one fixed per-host mesh: survivors
    # land on the data axis 1:1 (no divisibility constraint — the gateway
    # pads per-worker dispatches, encoded by global_batch == group count).
    plan = plan_fleet(["w0", "w1", "w2"], devices_per_worker=2)
    assert plan.routable == ("w0", "w1", "w2")
    assert plan.mesh_shape == (3, 2)
    assert plan.mesh_axes == ("data", "model")
    shrunk = plan_fleet(["w2"], devices_per_worker=2)
    assert shrunk.mesh_shape == (1, 2)
    assert plan_fleet([], devices_per_worker=2) is None


# -- the same inputs through both packages -------------------------------------


def _reports(kind):
    """(n_hosts, window, min_factor, [(host, step, latency, now), ...])."""
    if kind == "straggler":
        return 8, 4, 1.5, [(h, s, 3.5 if h == 3 else 1.0, float(s))
                           for s in range(4) for h in range(8)]
    if kind == "uniform":
        return 8, 4, 3.0, [(h, 0, 1.0 + 0.01 * h, 0.0) for h in range(8)]
    if kind == "quorum":
        return 8, 4, 1.5, [(h, 0, 5.0 if h == 0 else 1.0, 0.0) for h in range(3)]
    if kind == "recovery":
        return 8, 4, 1.5, ([(h, 0, 4.0 if h == 2 else 1.0, 0.0) for h in range(8)]
                           + [(2, 1, 1.0, 1.0)])
    if kind == "drift":
        return 6, 3, 2.0, [(h, s, 1.0 + 0.3 * s * (h == 5) + 0.05 * h, 0.5 * s)
                           for s in range(6) for h in range(6)]
    raise AssertionError(kind)


@pytest.mark.parametrize("case", [
    *[("reports", k) for k in ("straggler", "uniform", "quorum", "recovery", "drift")],
    *[("elastic", a) for a in ((232, 16, 256, True, 256), (512, 16, 256, True, 256),
                               (8, 16, 256, True, 256), (24, 4, 7, True, 256),
                               (28, 4, 7, True, 256), (32, 8, 4, True, 256),
                               (512, 16, 256, False, 256), (512, 16, 256, True, 100),
                               (16, 16, 8, True, 256), (15, 16, 8, True, 256),
                               (1024, 8, 96, True, 128), (3, 1, 3, False, 256))],
    *[("fleet", a) for a in ((("w0", "w1", "w2"), 2), (("w2",), 2), ((), 2),
                             (("b", "a", "c", "d"), 1), (("w0", "w1"), 3))],
], ids=lambda c: f"{c[0]}-{c[1]}")
def test_same_results_as_the_jax_package(case):
    kind, arg = case
    if kind == "reports":
        n, window, factor, reports = _reports(arg)
        ours = HeartbeatMonitor(n_hosts=n, window=window, min_factor=factor,
                                miss_timeout_s=2.0)
        ref = RefMonitor(n_hosts=n, window=window, min_factor=factor, miss_timeout_s=2.0)
        for h, step, lat, now in reports:
            ours.report(h, step, lat, now_s=now)
            ref.report(h, step, lat, now_s=now)
            got, want = ours.check(step), ref.check(step)
            assert (got is None) == (want is None)
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for t in (now, now + 1.9, now + 2.5, now + 10.0):
                assert ours.dead_hosts(t) == ref.dead_hosts(t)
    elif kind == "elastic":
        devices, mp, batch, pods, per_pod = arg
        got = plan_elastic_mesh(devices, mp, batch, prefer_pods=pods, devices_per_pod=per_pod)
        want = ref_plan(devices, mp, batch, prefer_pods=pods, devices_per_pod=per_pod)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        ids, dpw = arg
        got, want = plan_fleet(ids, devices_per_worker=dpw), ref_plan_fleet(ids, dpw)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
