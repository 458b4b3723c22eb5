"""The serve CLI: synthetic Poisson load through the RenderServer
(mirror of ``repro.launch.render_serve``).

  PYTHONPATH=src python -m repro_torch.launch.render_serve --backend cuda
  PYTHONPATH=src python -m repro_torch.launch.render_serve --device cpu \\
      --gaussians 600 --resolutions 64x64 --requests 8 --parity-check
  PYTHONPATH=src python -m repro_torch.launch.render_serve --backend cuda \\
      --streams 2 --stream-frames 20 --trace-json trace.json --metrics-json m.json

Generates an open-loop Poisson arrival stream over a mix of scenes and
resolutions, replays it through queue -> bucketing -> committed engine
handles (``RenderServer``, a thin loop over ``repro_torch.engine.Renderer``
handles), and reports per-bucket latency, throughput and renderer-cache
counters, the residency counters and, with ``--streams``, each stream's
cache and speculation counters.

``--devices N`` serves over a render mesh of N devices of ``--device``'s
type (``launch/mesh.py::cli_devices``): with ``--device cpu`` N virtual
CPU devices, as the JAX CLI forces N virtual host devices; on CUDA the
first min(N, cards) cards, with the JAX CLI's warning when fewer are
visible. ``--scene-shards D`` shards the gaussian axis D ways: physically
over the mesh's model axis when D divides the device count, logically
otherwise (with the JAX CLI's note).

Differences from the JAX package's CLI: ``--device`` (CUDA unless the
caller names another; no fallback) beside ``--devices``,
``--backend reference|cuda``, and under ``--autotune`` the parity check
renders each scene at its handle's tuned triple.

Exits non-zero unless every request completes with a finite p99 and, under
``--parity-check``, every image is bitwise equal to the handle's
``render`` of its camera.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.render_serve")
    ap.add_argument("--backend", default="reference", choices=["reference", "cuda"])
    ap.add_argument("--device", default="cuda",
                    help="device every scene is made and committed on (no fallback)")
    ap.add_argument("--devices", type=int, default=None,
                    help="serve over a mesh of N devices: N virtual CPU devices with "
                         "--device cpu, else the first min(N, cards) cards")
    ap.add_argument("--scene-shards", type=int, default=1,
                    help="shard the gaussian axis D ways over the mesh's 'model' axis "
                         "(DESIGN.md §10); D must divide the device count to be "
                         "physical, otherwise the shard axis stays logical")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="per-device memory cap counting the scene parameters plus "
                         "the per-camera projected features (DESIGN.md §12). A "
                         "scene over it alone refuses to serve; scenes that fit "
                         "one at a time but not together page in and out LRU "
                         "through the server's residency manager, bitwise "
                         "invisibly (DESIGN.md §17)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the admission-time residency prefetch")
    ap.add_argument("--parity-check", action="store_true",
                    help="render every completed request's camera again through a "
                         "one-shard handle's render and require bitwise equal images")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=60.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--streams", type=int, default=0,
                    help="serve N camera STREAMS instead of the stateless request "
                         "mix (DESIGN.md §15): each stream replays an orbit path in "
                         "frame order through its own stream session; frames of "
                         "different streams interleave round-robin")
    ap.add_argument("--stream-frames", type=int, default=24,
                    help="frames per stream (orbit poses cycle every 16 frames, so "
                         "longer streams lap into the exact-reuse cache)")
    ap.add_argument("--spec-depth", type=int, default=2,
                    help="per-stream speculation queue depth (0 disables speculation)")
    ap.add_argument("--stream-cache-frames", type=int, default=32,
                    help="per-stream frontend-cache capacity (poses, LRU)")
    ap.add_argument("--scenes", default="train,truck",
                    help="comma-separated scene ids to serve")
    ap.add_argument("--gaussians", type=int, default=1500,
                    help="gaussians per synthetic scene")
    ap.add_argument("--resolutions", default="128x128,192x128",
                    help="comma-separated WxH mix; each request draws one")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="bucket flush deadline (s)")
    ap.add_argument("--queue-depth", type=int, default=128)
    ap.add_argument("--mode", default="gstg",
                    choices=["gstg", "tile_baseline", "group_baseline"])
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--autotune", action="store_true",
                    help="open every handle with tile_params='auto': the first dispatch "
                         "of each (scene, config) pays a tuning search, or hits the "
                         "autotune cache, then serves the tuned triple")
    ap.add_argument("--no-realtime", action="store_true",
                    help="replay arrivals as fast as possible (throughput mode)")
    ap.add_argument("--trace-json", default=None,
                    help="write a Chrome trace of every serving/request/residency/"
                         "stream span, with the stats summary and per-request "
                         "records under the top-level 'summary' key")
    ap.add_argument("--metrics-json", default=None,
                    help="write a repro.metrics/v1 snapshot of the process metrics "
                         "registry (serving.*, engine.*, residency.*, stream.*, spec.*)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _parse_resolutions(spec: str):
    out = []
    for item in spec.split(","):
        w, h = item.lower().split("x")
        out.append((int(w), int(h)))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import engine
    from repro_torch.core.camera import orbit_cameras
    from repro_torch.core.gaussians import scene_like_paper
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.launch.mesh import cli_devices, make_render_mesh, render_mesh_shards
    from repro_torch.obs import get_registry, get_tracer, trace_env_enabled
    from repro_torch.serving.queue import RenderRequest
    from repro_torch.serving.server import RenderServer, poisson_arrivals

    # Asking for a trace (or metrics) file opts the process into span
    # recording; REPRO_TRACE=1 also turns on fenced per-stage timing
    # (RenderConfig.timing: bitwise the same images).
    tracer = get_tracer()
    if args.trace_json or args.metrics_json:
        tracer.enable()
    timing = trace_env_enabled()
    shards = max(args.scene_shards, 1)
    devices = cli_devices(args.device, args.devices)
    phys_shards = render_mesh_shards(len(devices), shards)
    if shards > 1 and phys_shards == 1:
        print(f"note: scene_shards={shards} does not divide "
              f"{len(devices)} devices; shard axis stays logical")
    mesh = make_render_mesh(devices, scene_shards=phys_shards)

    scene_ids = [s.strip() for s in args.scenes.split(",") if s.strip()]
    scenes = {sid: scene_like_paper(sid, args.gaussians, device=args.device)
              for sid in scene_ids}
    cfg = RenderConfig(
        mode=args.mode,
        backend=args.backend,
        group_capacity=args.capacity,
        tile_capacity=args.capacity,
        span=6,
        scene_shards=shards,
        timing=timing,
    )

    # Camera pools per resolution: orbit viewpoints, drawn round-robin per
    # request so repeated signatures exercise the renderer caches.
    resolutions = _parse_resolutions(args.resolutions)
    pools = {(w, h): orbit_cameras(16, 4.5, w, h) for w, h in resolutions}

    rng = np.random.default_rng(args.seed)
    load = []
    if args.streams > 0:
        # N orbiting viewers, frames interleaved round-robin across streams
        # (arrival order keeps each stream's frame order).
        total = args.streams * args.stream_frames
        offsets = poisson_arrivals(total, args.rate, seed=args.seed)
        i = 0
        for frame in range(args.stream_frames):
            for s in range(args.streams):
                res = resolutions[s % len(resolutions)]
                sid = scene_ids[s % len(scene_ids)]
                cam = pools[res][frame % len(pools[res])]
                load.append((offsets[i], RenderRequest(i, sid, cam, cfg, stream_id=f"s{s}")))
                i += 1
    else:
        total = args.requests
        offsets = poisson_arrivals(total, args.rate, seed=args.seed)
        for i, t in enumerate(offsets):
            res = resolutions[rng.integers(len(resolutions))]
            sid = scene_ids[rng.integers(len(scene_ids))]
            cam = pools[res][i % len(pools[res])]
            load.append((t, RenderRequest(i, sid, cam, cfg)))

    server = RenderServer(
        scenes,
        mesh=mesh,
        max_batch=args.max_batch,
        max_wait=args.max_wait,
        queue_depth=args.queue_depth,
        scene_shards=shards,
        device_budget_mb=args.device_budget_mb,
        autotune=args.autotune,
        # Serving tunes on the first dispatch's critical path, so the
        # measured phase stays short; the cost-model phase still prunes the
        # whole default grid.
        autotune_opts={"top_k": 2, "warmup": 1, "reps": 2} if args.autotune else None,
        stream_cache_frames=args.stream_cache_frames,
        spec_depth=args.spec_depth,
        prefetch=not args.no_prefetch,
    )

    # Pre-commit every scene: a scene over the budget even alone fails fast
    # here; scenes that fit one at a time page through the residency manager.
    for sid in scene_ids:
        try:
            handle = server.commit(sid, cfg)
        except ValueError as e:
            print(f"render_serve: FAILED (scene {sid!r}: {e})")
            server.close()
            return 2
        if args.device_budget_mb is not None:
            hs = handle.stats()
            print(f"scene {sid!r}: "
                  f"{hs['scene_mb_per_device'] + hs['feature_mb_per_device']:.2f}"
                  f" MB/device ({hs['scene_mb_per_device']:.2f} params + "
                  f"{hs['feature_mb_per_device']:.2f} per-camera features, "
                  f"gather={hs['feature_gather']}) within "
                  f"{args.device_budget_mb} MB budget (resident={handle.resident})")

    where = (f"backend={args.backend}, mesh={dict(mesh.shape)} over "
             f"{len(set(mesh.devices))} distinct device(s), scene_shards={shards}")
    if args.streams > 0:
        print(f"serving {args.streams} streams x {args.stream_frames} frames "
              f"@ {args.rate:.0f} req/s (spec_depth={args.spec_depth}, {where})")
    else:
        print(f"serving {total} requests @ {args.rate:.0f} req/s "
              f"({len(scene_ids)} scenes x {len(resolutions)} resolutions, {where})")
    results = server.run(load, realtime=not args.no_realtime)
    print(server.stats.format())
    rs = server.residency.stats()
    print(f"residency: page_ins={rs['page_ins']} "
          f"page_outs={rs['page_outs']} evictions={rs['evictions']} "
          f"hits={rs['hits']} prefetches={rs['prefetches']} "
          f"resident={rs['resident_entries']}/{rs['entries']} "
          f"({rs['resident_mb']:.2f} MB"
          + (f" / {rs['budget_mb']:.2f} MB budget)" if rs["budget_mb"]
             else ", unbudgeted)"))
    if args.streams > 0:
        # Quiesce speculation before any snapshot: in-flight runs would
        # otherwise race the trace and metrics dumps below.
        for s in server._streams.values():
            s.wait_spec_idle(timeout=60)
    stream_summaries = server.stream_stats() if args.streams > 0 else {}
    for name, st in sorted(stream_summaries.items()):
        print(f"stream {name}: frames={st['frames']} "
              f"hit_rate={st['hit_rate']:.2f} "
              f"(hits={st['hits']} misses={st['misses']}) "
              f"spec: runs={st['spec_runs']} hits={st['spec_hits']} "
              f"dropped={st['spec_dropped']} discarded={st['spec_discarded']}")
    tuned = {}        # scene -> its handle's tuned triple, under --autotune
    if args.autotune:
        for sid in scene_ids:
            tuned[sid] = server.commit(sid, cfg).tile_params
            print(f"autotuned {sid!r}: tile_params={tuned[sid]}")

    parity_failures = 0
    if args.parity_check:
        # The stateless reference: one-shard handles' render of each camera,
        # at the served handle's tuned triple under --autotune. Logical
        # shards, render_batch lanes and stream frames are all bitwise a
        # one-shard render in the port.
        cfg_one = dataclasses.replace(cfg, scene_shards=1)
        by_id = {r.request_id: r for _, r in load}
        refs = {sid: engine.open(scenes[sid], cfg_one, device=mesh.lead(0),
                                 tile_params=tuned.get(sid))
                for sid in sorted({by_id[rid].scene_id for rid in results})}
        for rid, res in sorted(results.items()):
            req = by_id[rid]
            expect = refs[req.scene_id].render(req.camera).image.cpu()
            if not torch.equal(expect, res.image):
                parity_failures += 1
                print(f"parity MISMATCH: request {rid} (scene {req.scene_id!r}) "
                      f"diverges from the one-shard render")
        for ref in refs.values():
            ref.close()
        print(f"parity-check: {len(results) - parity_failures}/{len(results)} "
              f"bitwise equal to the one-shard render")

    if args.trace_json:
        # Chrome trace-event format (repro.trace/v1) with the stats summary
        # and per-request records under "summary".
        doc = tracer.chrome_trace()
        doc["summary"] = {
            "config": vars(args),
            "device": str(server.device),
            "devices": mesh.size,
            "mesh": dict(mesh.shape),
            **server.stats.summary(),
            "requests": [
                {
                    "request_id": r.request_id,
                    "latency_ms": r.latency_s * 1e3,
                    "batch_size": r.batch_size,
                    "signature": repr(r.signature),
                    "deadline_missed": r.deadline_missed,
                }
                for r in sorted(results.values(), key=lambda r: r.request_id)
            ],
        }
        with open(args.trace_json, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"wrote {args.trace_json} "
              f"({len(doc['traceEvents'])} events, {doc['dropped']} dropped)")

    if args.metrics_json:
        # Snapshot before close(): Renderer.close() drops its per-handle
        # engine.<name>.* gauges.
        with open(args.metrics_json, "w") as f:
            json.dump(get_registry().snapshot(), f, indent=2)
        print(f"wrote {args.metrics_json}")

    server.close()   # releases every committed handle (caches, layouts, entries)

    # Exit contract: nothing lost, latency distribution sane, parity holds.
    lost = total - len(results) - server.stats.rejected
    p99 = server.stats.summary()["p99_ms"]
    ok = (
        lost == 0 and len(results) > 0 and math.isfinite(p99)
        and parity_failures == 0
    )
    # A stream load that lapped its orbit must have hit the exact-reuse
    # cache, or the run stopped testing the stream sessions.
    if args.streams > 0 and args.stream_frames > 16:
        hits = sum(st["hits"] for st in stream_summaries.values())
        if hits == 0:
            ok = False
            print("render_serve: stream load lapped its orbit but recorded "
                  "0 exact-reuse hits")
    print(f"render_serve: {'OK' if ok else 'FAILED'} "
          f"(completed={len(results)}/{total}, "
          f"rejected={server.stats.rejected}, lost={lost}, p99={p99:.1f}ms, "
          f"parity_failures={parity_failures})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
