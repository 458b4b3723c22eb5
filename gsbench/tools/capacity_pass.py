"""The stats pass that sets a configuration's list capacities and span:
for each seed's scene and each pose on the orbit, the program's frontend
(``render_frontend``) at each candidate span, its ``span_overflow``, its
longest group list and, through the bitmask stage and ``mask_tile_lengths``,
its longest tile list; the reference's own uncut lists beside them.

    python gsbench/tools/capacity_pass.py --config playroom --seeds 12 --poses 16

Prints one JSON line per span and a summary line: the smallest span with
no candidate-window overflow, and the smallest power of two that holds the
longest group and tile lists seen.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=9001)
    p.add_argument("--poses", type=int, default=16)
    p.add_argument("--spans", default="6,8,10,12,16")
    p.add_argument("--ref-poses", type=int, default=2,
                   help="poses a seed on which the reference's uncut lists are read too")
    p.add_argument("--device", default="cuda")
    p.add_argument("--camera-scale", type=float, default=None,
                   help="the orbit's distance over the eval camera's, in place of the configuration's")
    p.add_argument("--size", default=None,
                   help="GAUSSIANS,WIDTH,HEIGHT in place of the configuration's (rehearsals)")
    args = p.parse_args(argv)

    import torch

    from gsbench.cell import build_kernels, render_config
    from gsbench.harness import load_config
    from gsbench.reference import render as reference
    from gsbench.scene import orbit_camera, scene_for, to_program, to_program_scene
    from repro_torch.core.grouping import GridSpec
    from repro_torch.core.pipeline import render_frontend
    from repro_torch.core.stages import get_backend, mask_tile_lengths

    dev = torch.device(args.device)
    config = load_config(args.config)
    if args.size:
        n, w, h = (int(x) for x in args.size.split(","))
        config.update(gaussians=n, width=w, height=h)
    if args.camera_scale is not None:
        config["camera_scale"] = args.camera_scale
    base = render_config(config)
    build_kernels(dev)
    backend = get_backend(base.backend)
    spans = [int(s) for s in args.spans.split(",")]
    worst = {s: {"span_overflow": 0, "group": 0, "tile": 0} for s in spans}
    ref_worst = {"group": 0, "tile": 0}
    azimuths = [360.0 * i / args.poses for i in range(args.poses)]
    with torch.inference_mode():
        for k in range(args.seeds):
            seed = args.first_seed + k
            scene = scene_for(config, seed, dev)
            scene_p = to_program_scene(scene)
            for i, az in enumerate(azimuths):
                cam = orbit_camera(config, az)
                pcam = to_program(cam)
                for s in spans:
                    cfg = dataclasses.replace(base, span=s, group_capacity=65536)
                    front = render_frontend(scene_p, pcam, cfg)
                    grid = GridSpec(cam.width, cam.height, cfg.tile, cfg.group, s)
                    masks = backend.bitmasks(front.proj, front.table, grid, cfg.boundary_tile,
                                             chunk=cfg.chunk)
                    tiles = mask_tile_lengths(front.table, masks, grid)
                    w = worst[s]
                    w["span_overflow"] = max(w["span_overflow"], int(front.span_overflow))
                    w["group"] = max(w["group"], int(front.table.lengths.max()))
                    w["tile"] = max(w["tile"], int(tiles.max()))
                    del front, masks, tiles
                if i < args.ref_poses:
                    r = reference.render(scene, cam, group=base.group, tile=base.tile)
                    ref_worst["group"] = max(ref_worst["group"], r.counts["longest_group_list"])
                    ref_worst["tile"] = max(ref_worst["tile"], r.counts["longest_tile_list"])
            del scene, scene_p
            print(json.dumps({"seed": seed, "worst": worst, "reference": ref_worst}), flush=True)

    def pow2(n):
        return 1 << max(0, (n - 1).bit_length())

    ok = [s for s in spans if worst[s]["span_overflow"] == 0]
    span = min(ok) if ok else None
    summary = {"config": args.config, "seeds": args.seeds, "poses": args.poses,
               "camera_scale": config.get("camera_scale", 1.0),
               "span": span, "worst": worst, "reference": ref_worst}
    if span is not None:
        summary["group_capacity"] = pow2(worst[span]["group"])
        summary["tile_capacity"] = pow2(worst[span]["tile"])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + sys.path[1:]
    sys.exit(main())
