"""Gateway fleet driver: Poisson load over N render workers + chaos hook
(mirror of ``repro.launch.render_gateway``).

  PYTHONPATH=src python -m repro_torch.launch.render_gateway --backend cuda \\
      --workers 2 --requests 24 --kill-worker auto --kill-after 4
  PYTHONPATH=src python -m repro_torch.launch.render_gateway --device cpu \\
      --inproc --gaussians 300 --resolutions 64x64 --requests 8 --no-realtime \\
      --kill-worker auto --kill-after 2 --parity-check

Spawns a worker fleet — subprocess children by default (each with its OWN
torch runtime and CUDA context on the one device, speaking line-JSON over
pipes), or in-process with ``--inproc`` — fronted by a
:class:`RenderGateway` (admission, scene-affinity + stream-sticky routing,
heartbeats, failover; DESIGN.md §16), replays a Poisson arrival stream
through it, and reports fleet-level latency/routing/failover stats and,
for subprocess workers, each child's start-up seconds and its wire
(round trips against the child's own latency, split into the wait for the
reply's first byte, its transfer, its parse and the image decode; the
largest reply).
``--kill-worker/--kill-after`` is the chaos hook: the named worker is
SIGKILLed (subprocess) or flag-killed (inproc) mid-load and the run must
still complete every request; ``--parity-check`` proves failover is
invisible in the pixels.

Differences from the JAX package's CLI: ``--device`` (CUDA unless the
caller names another; no fallback) and ``--backend reference|cuda``; every
worker serves from that one device, so ``--devices-per-worker`` above 1
raises (ROADMAP item 8). Under ``--backend cuda`` on a CUDA device the
kernels are built once before any child is spawned.

Exits non-zero if any request was lost, p99 is not finite, parity fails,
or an induced kill produced no failover.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.render_gateway")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--devices-per-worker", type=int, default=1,
                    help="devices per worker; every worker of the port serves "
                         "from one device, so only 1 is taken (ROADMAP item 8)")
    ap.add_argument("--device", default="cuda",
                    help="device every worker (and the parity reference) "
                         "renders on (no fallback)")
    ap.add_argument("--inproc", action="store_true",
                    help="in-process workers (one shared torch runtime) "
                         "instead of subprocess children")
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "cuda"])
    ap.add_argument("--scenes", default="train,truck")
    ap.add_argument("--gaussians", type=int, default=1500)
    ap.add_argument("--scene-shards", type=int, default=1)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=60.0)
    ap.add_argument("--streams", type=int, default=0,
                    help="serve N camera streams (stream_id-sticky routing) "
                         "instead of the stateless mix")
    ap.add_argument("--stream-frames", type=int, default=16)
    ap.add_argument("--resolutions", default="96x96")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait", type=float, default=0.05)
    ap.add_argument("--queue-depth", type=int, default=256)
    ap.add_argument("--worker-queue-depth", type=int, default=128)
    ap.add_argument("--mode", default="gstg",
                    choices=["gstg", "tile_baseline", "group_baseline"])
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="per-device memory cap forwarded to EVERY worker: "
                         "each worker's RenderServer pages its committed "
                         "scenes in/out LRU against this budget "
                         "(DESIGN.md §17), and the gateway's router "
                         "prefers workers holding the request's scene "
                         "resident")
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0)
    ap.add_argument("--kill-worker", default=None,
                    help="worker id to kill mid-load ('auto' = first)")
    ap.add_argument("--kill-after", type=int, default=None,
                    help="kill once this many requests completed")
    ap.add_argument("--parity-check", action="store_true",
                    help="re-render every completed request on a direct "
                         "handle's render_batch, padded as a worker pads, and "
                         "require BITWISE identical images (failover must be "
                         "invisible in the pixels)")
    ap.add_argument("--no-realtime", action="store_true")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the per-worker warmup dispatch (first real "
                         "dispatch then pays its first-use costs under "
                         "heartbeat timing)")
    ap.add_argument("--trace-json", default=None)
    ap.add_argument("--metrics-json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _parse_resolutions(spec: str):
    out = []
    for item in spec.split(","):
        w, h = item.lower().split("x")
        out.append((int(w), int(h)))
    return out


def main(argv=None):
    args = parse_args(argv)

    from repro_torch.utils.misc import ITEM_SHARDING

    if args.devices_per_worker > 1:
        raise NotImplementedError(
            f"--devices-per-worker {args.devices_per_worker}: a worker on several "
            f"devices is not ported yet (ROADMAP queue 1, item {ITEM_SHARDING}); "
            f"each worker serves from one device (--device)"
        )

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core.camera import orbit_cameras
    from repro_torch.core.gaussians import scene_like_paper
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.gateway import RenderGateway
    from repro_torch.obs import get_registry, get_tracer
    from repro_torch.serving.queue import RenderRequest
    from repro_torch.serving.server import poisson_arrivals
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device)
    tracer = get_tracer()
    if args.trace_json or args.metrics_json:
        tracer.enable()

    scene_ids = [s.strip() for s in args.scenes.split(",") if s.strip()]
    shards = max(args.scene_shards, 1)
    cfg = RenderConfig(
        mode=args.mode,
        backend=args.backend,
        group_capacity=args.capacity,
        tile_capacity=args.capacity,
        span=6,
        scene_shards=shards,
    )

    # -- fleet ----------------------------------------------------------------
    worker_ids = [f"w{i}" for i in range(max(args.workers, 1))]
    scenes = None
    if args.inproc:
        from repro_torch.gateway.worker import InprocWorker

        scenes = {sid: scene_like_paper(sid, args.gaussians, device=device)
                  for sid in scene_ids}
        workers = [
            InprocWorker(
                wid, scenes, device=device,
                max_batch=args.max_batch, max_wait=args.max_wait,
                queue_depth=args.worker_queue_depth, scene_shards=shards,
                device_budget_mb=args.device_budget_mb,
            )
            for wid in worker_ids
        ]
    else:
        from repro_torch.gateway.transport import SubprocessWorker, worker_argv

        if args.backend == "cuda" and device.type == "cuda":
            # Build every kernel here, once, so the children load the
            # libraries instead of racing one another's nvcc.
            from repro_torch.kernels import build

            built = build.build()
            print("kernels built: " + ", ".join(f"{k} {v:.1f}s" for k, v in built.items()))
        extra = [
            "--gaussians", str(args.gaussians),
            "--scene-shards", str(shards),
            "--max-batch", str(args.max_batch),
            "--max-wait", str(args.max_wait),
            "--queue-depth", str(args.worker_queue_depth),
            "--mode", args.mode,
            "--backend", args.backend,
            "--capacity", str(args.capacity),
        ]
        if args.device_budget_mb is not None:
            extra += ["--device-budget-mb", str(args.device_budget_mb)]
        # The children import the same package as this process.
        src = str(Path(repro_torch.__file__).resolve().parents[1])
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        print(f"spawning {len(worker_ids)} workers on {device} ...")
        workers = [
            SubprocessWorker(
                wid, scene_ids,
                worker_argv(wid, scene_ids, device=str(device), extra=extra),
                max_batch=args.max_batch, env=env,
            )
            for wid in worker_ids
        ]
        for w in workers:
            print(f"worker {w.worker_id}: started in {w.startup_s:.2f} s "
                  f"(spawn to ready banner)")

    gw = RenderGateway(
        workers,
        queue_depth=args.queue_depth,
        max_retries=args.max_retries,
        heartbeat_timeout_s=args.heartbeat_timeout,
        devices_per_worker=1,
    )

    # Pre-commit scenes round-robin (worker i gets scene i, i+N, ...): the
    # affinity signal the router prefers — and warm every worker once per
    # (scene, resolution) so heartbeat timing sees steady-state dispatches,
    # not first-use costs (kernel loads, allocator growth).
    resolutions = _parse_resolutions(args.resolutions)
    pools = {(w, h): orbit_cameras(16, 4.5, w, h) for w, h in resolutions}
    for i, sid in enumerate(scene_ids):
        workers[i % len(workers)].commit(sid, cfg)
    if not args.no_warmup:
        warm_id = -1
        for w in workers:
            for sid in scene_ids:
                for res in resolutions:
                    w.dispatch([RenderRequest(
                        warm_id, sid, pools[res][0], cfg)])
                    warm_id -= 1
        for w in workers:
            getattr(w, "wire", []).clear()     # report the load's dispatches only

    # -- load -----------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    if args.streams > 0:
        total = args.streams * args.stream_frames
        offsets = poisson_arrivals(total, args.rate, seed=args.seed)
        load, i = [], 0
        for frame in range(args.stream_frames):
            for s in range(args.streams):
                res = resolutions[s % len(resolutions)]
                sid = scene_ids[s % len(scene_ids)]
                cam = pools[res][frame % len(pools[res])]
                load.append((offsets[i], RenderRequest(
                    i, sid, cam, cfg, stream_id=f"s{s}")))
                i += 1
    else:
        total = args.requests
        offsets = poisson_arrivals(total, args.rate, seed=args.seed)
        load = []
        for i, t in enumerate(offsets):
            res = resolutions[rng.integers(len(resolutions))]
            sid = scene_ids[rng.integers(len(scene_ids))]
            cam = pools[res][i % len(pools[res])]
            load.append((t, RenderRequest(i, sid, cam, cfg)))

    kill_worker = args.kill_worker
    if kill_worker == "auto":
        kill_worker = worker_ids[0]
    print(f"gateway: {total} requests @ {args.rate:.0f} req/s over "
          f"{len(workers)} workers ({'inproc' if args.inproc else 'subproc'}"
          f", backend={args.backend}, device={device}"
          + (f", killing {kill_worker} after {args.kill_after}"
             if kill_worker else "") + ")")
    results = gw.run(
        load,
        realtime=not args.no_realtime,
        kill_worker=kill_worker,
        kill_after=args.kill_after if kill_worker else None,
    )
    summary = gw.summary()
    print(gw.format())
    transport = {}
    for w in workers:
        wire = getattr(w, "wire", None)
        if wire is None:
            continue
        transport[w.worker_id] = {"startup_s": w.startup_s, "dispatches": wire}
        if wire:
            sums = {k: sum(d[k] for d in wire) for k in (
                "round_trip_s", "child_latency_s", "reply_wait_s", "transfer_s",
                "parse_s", "decode_s")}
            print(f"worker {w.worker_id} wire: {len(wire)} dispatches, round trip "
                  f"{sums['round_trip_s']:.3f} s against the child's "
                  f"{sums['child_latency_s']:.3f} s (first byte after "
                  f"{sums['reply_wait_s']:.3f} s, transfer {sums['transfer_s']:.3f} s, "
                  f"parse {sums['parse_s']:.3f} s, decode {sums['decode_s']:.3f} s), "
                  f"largest reply {max(d['line_bytes'] for d in wire)} bytes")
    if args.device_budget_mb is not None:
        # Residency roll call: cached on the parent (subprocess replies
        # piggyback the set), a server property for inproc — no RPC, safe
        # even for a killed worker.
        for w in workers:
            try:
                resident = sorted(w.resident_scene_ids())
            except Exception:       # noqa: BLE001 — reporting only
                resident = ["?"]
            print(f"worker {w.worker_id}: "
                  f"resident={','.join(resident) or '-'} / "
                  f"committed={','.join(sorted(w.committed_scene_ids()))}")

    # -- parity ---------------------------------------------------------------
    parity_failures = 0
    if args.parity_check:
        import dataclasses as _dc

        from repro_torch import engine
        from repro_torch.serving.bucketing import padded_size

        if scenes is None:
            scenes = {sid: scene_like_paper(sid, args.gaussians, device=device)
                      for sid in scene_ids}
        cfg_one = _dc.replace(cfg, scene_shards=1)
        pad = padded_size(args.max_batch, 1)
        by_id = {r.request_id: r for _, r in load}
        refs = {sid: engine.open(scenes[sid], cfg_one, device=device)
                for sid in scene_ids}
        for rid, res in sorted(results.items()):
            req = by_id[rid]
            expect = (refs[req.scene_id]
                      .render_batch([req.camera], pad_to=pad).image[0].cpu())
            if not torch.equal(expect, res.image):
                parity_failures += 1
                print(f"parity MISMATCH: request {rid} "
                      f"(worker {res.worker_id}, attempts {res.attempts})")
        for ref in refs.values():
            ref.close()
        retried = sum(1 for r in results.values() if r.attempts > 1)
        print(f"parity-check: {len(results) - parity_failures}/"
              f"{len(results)} bitwise-identical to the direct handle "
              f"({retried} of them failover retries)")

    if args.trace_json:
        doc = tracer.chrome_trace()
        doc["summary"] = {
            "config": vars(args),
            **summary,
            "transport": transport,
            "requests": [
                {
                    "request_id": r.request_id,
                    "latency_ms": r.latency_s * 1e3,
                    "worker_id": r.worker_id,
                    "attempts": r.attempts,
                }
                for r in sorted(results.values(), key=lambda r: r.request_id)
            ],
        }
        with open(args.trace_json, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"wrote {args.trace_json} "
              f"({len(doc['traceEvents'])} events, {doc['dropped']} dropped)")

    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(get_registry().snapshot(), f, indent=2)
        print(f"wrote {args.metrics_json}")

    gw.close()

    # Exit gate: nothing lost, latency sane, parity holds, and an induced
    # kill must actually have exercised failover.
    lost = total - len(results) - summary["rejected"] - summary["failed"]
    p99 = summary["p99_ms"]
    ok = (
        lost == 0
        and summary["failed"] == 0
        and len(results) > 0
        and math.isfinite(p99)
        and parity_failures == 0
        and (kill_worker is None or summary["failovers"] >= 1)
    )
    print(f"render_gateway: {'OK' if ok else 'FAILED'} "
          f"(completed={len(results)}/{total}, "
          f"rejected={summary['rejected']}, failed={summary['failed']}, "
          f"lost={lost}, retries={summary['retries']}, "
          f"failovers={summary['failovers']}, p99={p99:.1f}ms)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
