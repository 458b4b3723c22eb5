"""Find the knee of a served cell: the highest offered rate the program
sustains without a growing backlog. One set-up, then the cell's open loop
at each rate in turn.

    python gsbench/tools/serve_sweep.py --workload train.serve --rates 10,15,20,25,30 --seconds 20

Prints one JSON line per rate: requests due and delivered, latency p50 and
p95 over all requests and over the last third of the stretch (a backlog
that grows shows as a last third far above the whole), the mean dispatch,
its lanes and padding.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="train.serve")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=4242)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from gsbench.cell import Cell

    c = Cell(args.workload, args.seed, torch.device(args.device))
    t0 = time.perf_counter()
    c.setup()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        c.traffic["rate_hz"] = rate
        before = c.loop.server.stats.summary()
        w = c.loop.window(args.seconds, f"sweep{rate}")
        after = c.loop.server.stats.summary()
        lat = np.asarray(w.latency_s) * 1e3
        tail = lat[2 * len(lat) // 3:]
        batches = after["batches"] - before["batches"]
        served = after["completed"] - before["completed"]
        print(json.dumps({
            "rate_hz": rate, "due": len(lat), "missing": w.failed,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "last_third_p50_ms": float(np.percentile(tail, 50)),
            "last_third_p95_ms": float(np.percentile(tail, 95)),
            "stretch_s": w.span_s, "delivered_per_s": served / w.span_s,
            "batches": batches, "mean_batch": served / max(batches, 1),
            "padded": after["padded"] - before["padded"],
        }), flush=True)
    c.close()
    return 0


if __name__ == "__main__":
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + sys.path[1:]
    sys.exit(main())
