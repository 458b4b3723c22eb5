"""Subprocess worker entrypoint: one RenderServer behind line-JSON stdio
(mirror of ``repro.gateway.worker_main``).

  python -m repro_torch.gateway.worker_main --worker-id w0 --scenes train \\
      --device cuda --backend cuda --gaussians 1500 --max-batch 8

Counterpart of :class:`repro_torch.gateway.transport.SubprocessWorker`.
stdout is RESERVED for the protocol: the real fd 1 is dup'd away for the
JSON channel and fd 1 is re-pointed at stderr before torch loads, so any
library print or warning lands in the log stream instead of corrupting the
wire.

Scenes come from ``core/gaussians.py::scene_like_paper(sid, gaussians,
device=...)``, seeded from the crc32 of the scene's name, as the serve CLI
builds them — so a worker hosting any subset of the fleet's scenes builds
each one bit-identically to a direct single-server run on the same device,
and renders it through the same padded dispatch shape. That is the whole
parity story: the gateway can hand a request to any worker (or retry it on
another after a death) and the pixels cannot tell. ``--scenes`` takes scene
ids or the JAX package's ``sid:index`` pairs; the index keys nothing here.

Differences from the JAX package's worker: ``--device`` (CUDA unless the
caller names another; no fallback) in place of ``--devices``, and
``--backend reference|cuda``. Images go out as ``encode_array`` of the CPU
tensor.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.gateway.worker_main")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--scenes", required=True,
                    help="comma-separated scene ids (a 'sid:index' pair is "
                         "accepted; scenes are seeded from their name)")
    ap.add_argument("--device", default="cuda",
                    help="device the worker's scenes are made and served on "
                         "(no fallback)")
    ap.add_argument("--gaussians", type=int, default=1500)
    ap.add_argument("--scene-shards", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait", type=float, default=0.05)
    ap.add_argument("--queue-depth", type=int, default=128)
    ap.add_argument("--mode", default="gstg",
                    choices=["gstg", "tile_baseline", "group_baseline"])
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "cuda"])
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--device-budget-mb", type=float, default=None)
    return ap.parse_args(argv)


def parse_scene_ids(spec: str) -> list:
    """Scene ids of ``--scenes``: 'train,truck' or 'train:0,truck:1'."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if item:
            sid, sep, idx = item.rpartition(":")
            if sep:
                int(idx)                   # the JAX package's index, checked
            out.append(sid if sep else item)
    return out


def _emit(out, doc: dict) -> None:
    out.write(json.dumps(doc) + "\n")
    out.flush()


def main(argv=None) -> int:
    args = parse_args(argv)

    # Claim the protocol channel, then point fd 1 at stderr so stray prints
    # (library banners and warnings) cannot corrupt the wire.
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    import numpy as np
    import torch

    from repro_torch.core.camera import Camera
    from repro_torch.core.gaussians import scene_like_paper
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.gateway.transport import decode_array, encode_array
    from repro_torch.serving.queue import RenderRequest
    from repro_torch.serving.server import RenderServer

    shards = max(args.scene_shards, 1)
    scenes = {
        sid: scene_like_paper(sid, args.gaussians, device=args.device)
        for sid in parse_scene_ids(args.scenes)
    }
    cfg = RenderConfig(
        mode=args.mode,
        backend=args.backend,
        group_capacity=args.capacity,
        tile_capacity=args.capacity,
        span=6,
        scene_shards=shards,
    )
    server = RenderServer(
        scenes,
        device=args.device,
        max_batch=args.max_batch,
        max_wait=args.max_wait,
        queue_depth=args.queue_depth,
        scene_shards=shards,
        device_budget_mb=args.device_budget_mb,
    )

    def decode_camera(doc: dict) -> Camera:
        return Camera(
            R=np.asarray(decode_array(doc["R"])),
            t=np.asarray(decode_array(doc["t"])),
            fx=doc["fx"], fy=doc["fy"], cx=doc["cx"], cy=doc["cy"],
            width=doc["width"], height=doc["height"],
            znear=doc["znear"], zfar=doc["zfar"],
        )

    def committed() -> list:
        return sorted(server.committed_scene_ids)

    def resident() -> list:
        return sorted(server.resident_scene_ids)

    def do_dispatch(msg: dict) -> dict:
        reqs = [
            RenderRequest(
                request_id=r["request_id"],
                scene_id=r["scene_id"],
                camera=decode_camera(r["camera"]),
                cfg=cfg,
                stream_id=r.get("stream_id"),
            )
            for r in msg["requests"]
        ]
        for req in reqs:
            if not server.submit(req):
                server.drain()
                if not server.submit(req):
                    raise RuntimeError(
                        f"queue jammed at depth {server.queue.maxsize}"
                    )
        server.drain()
        results = []
        for req in reqs:
            res = server.results.pop(req.request_id, None)
            if res is None:
                raise RuntimeError(f"lost request {req.request_id}")
            results.append({
                "request_id": req.request_id,
                "image": encode_array(res.image),
                "latency_s": res.latency_s,
                "batch_size": res.batch_size,
            })
        return {"results": results}

    _emit(proto, {
        "ready": True,
        "worker_id": args.worker_id,
        "device": str(server.device),
        "devices": 1,
        "scenes": sorted(scenes),
        "pid": os.getpid(),
    })
    print(f"[{args.worker_id}] up: {len(scenes)} scenes on {server.device}, "
          f"backend={args.backend}, torch {torch.__version__}", file=sys.stderr)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        rep = {"id": msg.get("id"), "ok": True}
        try:
            op = msg["op"]
            if op == "ping":
                pass
            elif op == "commit":
                server.commit(msg["scene_id"], cfg)
            elif op == "dispatch":
                rep.update(do_dispatch(msg))
            elif op == "shutdown":
                rep["committed"] = committed()
                rep["resident"] = resident()
                _emit(proto, rep)
                break
            else:
                raise ValueError(f"unknown op {op!r}")
            rep["committed"] = committed()
            # Residency piggybacks on every reply, same as the committed
            # set: the parent's placement data stays fresh with no extra RPC.
            rep["resident"] = resident()
        except Exception as e:            # noqa: BLE001 — report, don't die
            rep = {"id": msg.get("id"), "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        _emit(proto, rep)

    server.close()
    print(f"[{args.worker_id}] shut down", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
