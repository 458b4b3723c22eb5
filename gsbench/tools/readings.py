"""The readings that a cell's correctness limits are set from: the
program's compared numbers over many seeds (sound runs), and the TF32
control's over the same seeds, at the cell's own size and load.

    python gsbench/tools/readings.py --workload train.view --seeds 12 --control-seeds 4 --seconds 2

For each seed, one set-up and a short window of the cell's own traffic,
then the check exactly as a run makes it (the program's sampled images
against the float32 reference); on the control seeds, the same cameras
rendered by the reference computed in TF32 (``render(tf32=True)``, put in
the program's place) against the float32 reference. One JSON line a seed,
then the largest sound reading and the smallest control reading of each
number.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def frame_detail(image, want) -> dict:
    """Where one checked image leaves the reference: its rmse and largest
    gap, and the pixels off by more than 1e-3 and 1e-2 (a splat on a
    cut-off moves a few pixels; a wrong order or a lost list moves
    regions)."""
    import torch

    d = (image.to(want.device) - want).abs().amax(-1)
    return {"rmse": float(torch.sqrt(torch.mean((image.to(want.device) - want).double() ** 2))),
            "max_abs": float(d.max()), "px_1e-3": int((d > 1e-3).sum()),
            "px_1e-2": int((d > 1e-2).sum())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=5_000_000_000)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default=None,
                   help='JSON {"config": {...}, "traffic": {...}} over the cell\'s files (trials)')
    args = p.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else None

    import torch

    from gsbench import check
    from gsbench.cell import Cell, references

    dev = torch.device(args.device)
    sound: dict = {}
    control: dict = {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        c = Cell(args.workload, seed, dev, overrides=overrides)
        t0 = time.perf_counter()
        c.setup()
        out = c.measure(args.seconds)        # closes the program, then checks
        t1 = time.perf_counter()
        line = {"seed": seed, "setup_s": t1 - t0,
                "program": out["readings"], "values": out["values"],
                "frames": [frame_detail(smp.image, want.image) for smp, want in c.checked]}
        if k < args.control_seeds:
            samples = [s for s, _ in c.checked]
            low = references(c.scene, c.config, c.cams, samples, tf32=True)
            line["control"] = check.worst([check.image_gap(lo.image, want.image)
                                           for lo, (_, want) in zip(low, c.checked)])
            for name, v in line["control"].items():
                control[name] = min(control.get(name, math.inf), v)
        for name, v in out["readings"].items():
            if v is not None:
                sound[name] = max(sound.get(name, 0.0), v)
        print(json.dumps(line), flush=True)
        del c
    print(json.dumps({"workload": args.workload, "lower": sound, "upper": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + sys.path[1:]
    sys.exit(main())
