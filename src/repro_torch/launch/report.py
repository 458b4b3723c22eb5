"""Render the §Roofline per-cell table from a dry-run report JSON (mirror
of ``repro.launch.report``). Records of either package's dry run render
alike; a figure a record holds as null (the port's dry run has no stand-in
for it) prints as ``null``.

  PYTHONPATH=src python -m repro_torch.launch.report [--report results/dryrun_final.json]
      [--append EXPERIMENTS.md]
"""
from __future__ import annotations

import argparse
import json


def _num(x, fmt: str) -> str:
    return "null" if x is None else format(x, fmt)


def fmt_table(records) -> str:
    ok = sorted(
        (r for r in records if r["status"] == "ok"),
        key=lambda r: (r["arch"], r["shape"], r["mesh"]),
    )
    skip = [r for r in records if r["status"] == "skip"]
    lines = [
        "| arch | shape | mesh | HBM GiB/dev | compute_s | memory_s | coll_s |"
        " dominant | useful |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in ok:
        ma, rf = r["memory_analysis"], r["roofline"]
        arg, temp = ma["argument_bytes_per_device"], ma["temp_bytes_per_device"]
        hbm = "null" if arg is None or temp is None else f"{(arg + temp) / 2**30:.1f}"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {hbm} "
            f"| {_num(rf['compute_s'], '.3g')} | {_num(rf['memory_s'], '.3g')} "
            f"| {_num(rf['collective_s'], '.3g')} | {rf['dominant']} "
            f"| {_num(rf['useful_flops_ratio'], '.2f')} |"
        )
    lines.append("")
    lines.append(
        f"Skipped cells ({len(skip)}): "
        + "; ".join(
            sorted({f"{r['arch']} x {r['shape']} ({r['reason']})" for r in skip})
        )
    )
    # dominant-term histogram + bottleneck sentences
    doms = {}
    for r in ok:
        doms.setdefault(r["roofline"]["dominant"], []).append(r)
    lines.append("")
    for d, rs in sorted(doms.items()):
        lines.append(f"* **{d}-dominated**: {len(rs)} cells.")
    lines.append(
        "\nPer-cell 'what moves the dominant term': memory-dominated cells "
        "need coarser fusion / fewer materialized intermediates (the HLO "
        "bytes figure is a CPU upper bound — see §Dry-run artifacts); "
        "collective-dominated cells need the FSDP gather and MoE all-to-all "
        "reductions applied in §Perf; compute-dominated cells track "
        "MODEL_FLOPS x remat within 2x."
    )
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", default="results/dryrun_final.json")
    ap.add_argument("--fallback", default=None,
                    help="fill cells missing from --report (e.g. an "
                         "uncalibrated sweep); such rows are marked *")
    ap.add_argument("--append", default=None)
    args = ap.parse_args()
    with open(args.report) as f:
        records = json.load(f)
    if args.fallback:
        have = {(r["arch"], r["shape"], r["mesh"]) for r in records}
        with open(args.fallback) as f:
            for r in json.load(f):
                key = (r["arch"], r["shape"], r["mesh"])
                if key not in have:
                    r["arch"] = r["arch"] + "*"  # * = uncalibrated fallback
                    records.append(r)
    table = fmt_table(records)
    print(table)
    if args.append:
        with open(args.append, "a") as f:
            f.write("\n## §Roofline — per-cell baseline table (final sweep)\n\n")
            f.write(table + "\n")


if __name__ == "__main__":
    main()
