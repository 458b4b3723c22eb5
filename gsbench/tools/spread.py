"""Run one cell as a check of the benchmark does, each run a new process,
and read the spread of its end-to-end metrics: two sets of runs on the
same seeds, and for each metric each set's median and quartile spread
((Q3 - Q1) / median, ``statistics.quantiles(values, n=4)``), the wider of
the two, and five times it (the bound that spread supports, never under
1%).

    python gsbench/tools/spread.py --workload train.view --seeds 11,12,13,14,15,16 \
        --sets 2 --seconds 51 --traced 21,22,23 --out results/spread

Each run's result line goes to ``<out>/<workload>.jsonl``; the summary is
the last line printed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "gsbench" / "run.py"), "--workload", workload,
                          "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "trace": trace, "rc": out.returncode, "wall_s": wall,
            "result": result, "stderr_tail": out.stderr[-1500:]}


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return {"median": med, "q1": q1, "q3": q3, "spread": (q3 - q1) / med if med else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--traced", default="")
    p.add_argument("--out", default="results/spread")
    args = p.parse_args(argv)

    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    log = open(out_dir / f"{args.workload}.jsonl", "a")
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = one_run(args.workload, seed, args.seconds, 0)
            r["set"] = k
            log.write(json.dumps(r) + "\n")
            log.flush()
            res = r["result"]
            print(json.dumps({"set": k, "seed": seed, "rc": r["rc"], "wall_s": r["wall_s"],
                              "correct": res and res["correct"],
                              "metrics": res and {m: v["value"] for m, v in res["metrics"].items()},
                              "checks": res and {c: v["value"] for c, v in res["checks"].items()}}),
                  flush=True)
            if res is None:
                print(r["stderr_tail"], flush=True)
            runs.append(r)
        sets.append(runs)
    for seed in (int(s) for s in args.traced.split(",") if s):
        r = one_run(args.workload, seed, args.seconds, 1)
        log.write(json.dumps(r) + "\n")
        res = r["result"]
        print(json.dumps({"traced": seed, "rc": r["rc"], "wall_s": r["wall_s"],
                          "correct": res and res["correct"],
                          "metrics": res and {m: v["value"] for m, v in res["metrics"].items()},
                          "device": res and res["device"]}), flush=True)
        if res is None:
            print(r["stderr_tail"], flush=True)
    summary = {"workload": args.workload, "seconds": args.seconds, "metrics": {}}
    ok = [[r for r in runs if r["result"]] for runs in sets]
    names = sorted({m for runs in ok for r in runs for m in r["result"]["metrics"]})
    for m in names:
        per = [spread([r["result"]["metrics"][m]["value"] for r in runs]) for runs in ok
               if len(runs) >= 2]
        wid = max((s["spread"] for s in per if s["spread"] is not None), default=None)
        summary["metrics"][m] = {"sets": per, "widest": wid,
                                 "bound_5x": None if wid is None else max(0.01, 5 * wid)}
    summary["all_correct"] = all(r["result"] and r["result"]["correct"]
                                 for runs in sets for r in runs)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
