"""GS-TG rendering driver: render a paper scene (its synthetic stand-in) with
the tile-grouping pipeline, and report the counters and the cost model's
projections (mirror of ``repro.launch.render``).

  PYTHONPATH=src python -m repro_torch.launch.render --scene train
  PYTHONPATH=src python -m repro_torch.launch.render --backend cuda --stats
  PYTHONPATH=src python -m repro_torch.launch.render --device cpu --gaussians 1200 \\
      --width 96 --height 96 --capacity 256

Either backend goes through the session-style engine handle
(``repro_torch.engine.open``, DESIGN.md §11): the scene is committed once and
one render gives both the image and the RenderStats that feed the cost model.
With ``REPRO_TRACE=1`` or ``--trace-json`` the render runs with fenced
per-stage timing (``RenderConfig(timing=True)``): one warm render, then the
measured one, whose ``stage/<name>`` spans ``--stats`` tabulates and
``--trace-json`` writes as a Chrome trace. The fences serialize the stages,
so the printed wall time is then not the untimed frame time.

``--autotune`` opens the handle with ``tile_params='auto'``: the first
render tunes (tile, group, tile_capacity) on the device, or hits the port's
autotune cache (``REPRO_TORCH_AUTOTUNE_CACHE``), and the first line names
the tuned triple.

Differences from the JAX package's driver: ``--backend reference|cuda``
(``--use-kernels`` is the alias for ``cuda``) and ``--device`` (CUDA unless
the caller names another; there is no fallback).
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import numpy as np

from repro_torch import engine
from repro_torch.configs import scene_and_camera
from repro_torch.core.cost_model import GSTG_ASIC, estimate
from repro_torch.core.pipeline import RenderConfig, render_cache_info
from repro_torch.obs import get_tracer, trace_env_enabled


def _stage_table(events) -> str:
    """Per-stage device-time table from the tracer's ``category == "stage"``
    spans (ms, aggregated by span name over however many renders ran)."""
    agg = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.category == "stage":
            agg[e.name][0] += 1
            agg[e.name][1] += e.duration_s
    if not agg:
        return "  (no stage spans recorded)"
    lines = [f"  {'stage':<18s} {'calls':>5s} {'total ms':>9s} {'mean ms':>9s}"]
    for name, (calls, tot) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {name:<18s} {calls:>5d} {tot * 1e3:>9.3f} "
                     f"{tot * 1e3 / calls:>9.3f}")
    return "\n".join(lines)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.render")
    ap.add_argument("--scene", default="train")
    ap.add_argument("--mode", default="gstg",
                    choices=["gstg", "tile_baseline", "group_baseline"])
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--boundary-group", default="ellipse")
    ap.add_argument("--boundary-tile", default="ellipse")
    ap.add_argument("--backend", default="reference", choices=["reference", "cuda"],
                    help="stage implementation the engine dispatches to")
    ap.add_argument("--use-kernels", action="store_true",
                    help="alias for --backend cuda")
    ap.add_argument("--device", default="cuda",
                    help="device the scene is made and committed on (no fallback)")
    ap.add_argument("--scene-shards", type=int, default=1,
                    help="commit the scene gaussian-sharded D ways (DESIGN.md §10/§11)")
    ap.add_argument("--gaussians", type=int, default=None)
    ap.add_argument("--width", type=int, default=None,
                    help="override camera width (smoke renders)")
    ap.add_argument("--height", type=int, default=None,
                    help="override camera height (smoke renders)")
    ap.add_argument("--capacity", type=int, default=1024,
                    help="group/tile table capacity")
    ap.add_argument("--autotune", action="store_true",
                    help="ignore --tile/--group/--capacity's triple and open the handle "
                         "with tile_params='auto': the first render pays the tuning "
                         "search, or hits the autotune cache, and commits the tuned "
                         "knobs")
    ap.add_argument("--stats", action="store_true",
                    help="print the render-cache statistics after the render (+ a "
                         "per-stage device-time table when timing is on via "
                         "REPRO_TRACE=1 or --trace-json)")
    ap.add_argument("--trace-json", default=None,
                    help="write a Chrome trace (Perfetto-loadable) of the measured "
                         "render's per-stage spans; implies fenced per-stage timing")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    backend = "cuda" if args.use_kernels else args.backend
    timing = trace_env_enabled() or bool(args.trace_json)
    tracer = get_tracer()
    if timing:
        tracer.enable()
    scene, cam = scene_and_camera(
        args.scene, args.gaussians, width=args.width, height=args.height,
        device=args.device,
    )
    cfg = RenderConfig(
        mode=args.mode,
        tile=args.tile,
        group=args.group,
        boundary_group=args.boundary_group,
        boundary_tile=args.boundary_tile,
        tile_capacity=args.capacity,
        group_capacity=args.capacity,
        span=6,
        backend=backend,
        scene_shards=args.scene_shards,
        timing=timing,
    )
    with engine.open(scene, cfg, device=args.device,
                     tile_params="auto" if args.autotune else None) as renderer:
        if timing:
            # The warm render pays first-call costs (kernel loads, allocator
            # growth); drop its spans so the table and trace show the
            # measured render alone.
            renderer.render(cam)
            tracer.clear()
        t0 = time.time()
        out = renderer.render(cam)   # ONE render: image + stats, any backend
        img, stats = out.image.cpu().numpy(), out.stats.as_dict()
        dt = time.time() - t0

        print(f"scene={args.scene} mode={args.mode} backend={backend} "
              f"device={args.device} {img.shape} in {dt:.2f}s"
              + (f" tile_params={renderer.tile_params}" if args.autotune else ""))
        print(f"  visible gaussians : {stats['n_visible']}")
        print(f"  sort keys         : {stats['n_pairs_sort']}")
        print(f"  alpha ops         : {stats['alpha_ops']}")
        print(f"  overflow          : {stats['overflow']}")
        cost = estimate(
            out.stats, GSTG_ASIC,
            boundary_group=args.boundary_group,
            boundary_tile=args.boundary_tile,
            mode=args.mode, execution="asic",
        )
        print(f"  accelerator model : total={cost.total_s*1e3:.3f}ms "
              f"(pre={cost.preprocess_s*1e3:.3f} sort={cost.sort_s*1e3:.3f} "
              f"bgm={cost.bitmask_s*1e3:.3f} raster={cost.raster_s*1e3:.3f} "
              f"dram={cost.dram_s*1e3:.3f})  energy={cost.energy_j*1e3:.2f}mJ")
        if args.stats:
            for kind, info in render_cache_info().items():
                print(f"  render cache [{kind:11s}] : hits={info['hits']} "
                      f"misses={info['misses']} currsize={info['currsize']}/"
                      f"{info['maxsize']}")
            if timing:
                print("  per-stage device time (fenced, steady-state):")
                print(_stage_table(tracer.events()))
        if args.trace_json:
            tracer.write_chrome_trace(args.trace_json)
            print(f"  wrote {args.trace_json}")
    # A PPM for quick eyeballing (no image dependencies).
    out_path = f"results/render_{args.scene}_{args.mode}_{backend}.ppm"
    os.makedirs("results", exist_ok=True)
    with open(out_path, "wb") as f:
        h, w, _ = img.shape
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write((np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes())
    print(f"  wrote {out_path}")


if __name__ == "__main__":
    main()
