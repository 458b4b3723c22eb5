"""Run one cell of the benchmark once and print its result line.

    python gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; ``checks`` comes last: each number compared with
the plain reference beside its limit (also the last lines of standard
error). Without CUDA, with fewer cards than the cell asks for, or if JAX
or the JAX package was loaded, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Every build and kernel cache at a fixed path inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    # The script's own folder would shadow the standard library by name.
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [x for x in sys.path[1:]]

    import torch

    phases = {"torch": time.perf_counter()}
    from gsbench.cell import run_cell
    from gsbench.harness import load_spec, workload

    spec = load_spec(ROOT)
    chips = int(workload(spec, args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gsbench: {args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    phases["cuda"] = time.perf_counter()
    device = torch.device("cuda", 0)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                   t_start=T_START, spec=spec, phases=phases)
    leaked = forbidden_modules()
    if leaked:
        print(f"gsbench: the run loaded {leaked}; the benchmark measures the PyTorch port "
              "alone", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
           "memory_peak_bytes": out["memory_peak_bytes"], "power": power_limit()}
    if args.trace:
        dev.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": dev}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    from gsbench.check import print_table

    print_table(out["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
