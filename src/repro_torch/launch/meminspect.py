"""Buffer inspector for dry-run cells: the largest buffers a step makes
(mirror of ``repro.launch.meminspect``).

The JAX package reads the buffers of a compiled cell's HLO
(:func:`buffer_table`, kept here as a copy to read its dumps). The port
has no HLO: :func:`op_table` runs the cell's step on the ``meta``
production mesh and lists the largest op outputs in the same form,
(op, "dtype[shape]") -> [largest bytes, count].

  PYTHONPATH=src python -m repro_torch.launch.meminspect --arch granite-3-2b \
      --shape train_4k [--multi-pod] [--min-gb 0.5]
"""
from __future__ import annotations

import argparse
import re

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import argument_bytes, count_step, meta_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.steps import jit_for_cell

_DT = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2,
       "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8}
_TYRE = re.compile(r"(pred|[a-z]+\d+)\[([\d,]+)\]")


def buffer_table(hlo_text: str, min_bytes: float, skip_plumbing=True):
    """The value-producing buffers of an XLA HLO module's text of at least
    ``min_bytes``: [((op, type), [largest bytes, count])], largest first."""
    sizes = {}
    for line in hlo_text.splitlines():
        m = re.search(r"=\s*(.*?)\s+([a-z][a-z0-9\-\.]*)\(", line.strip())
        if not m:
            continue
        tstr, op = m.group(1), m.group(2)
        if skip_plumbing and op in ("tuple", "parameter", "get-tuple-element", "while"):
            continue
        total = 0
        for mm in _TYRE.finditer(tstr):
            dt, dims = mm.group(1), mm.group(2)
            if dt not in _DT:
                continue
            n = 1
            for d in dims.split(","):
                n *= int(d)
            total += n * _DT[dt]
        if total >= min_bytes:
            key = (op, tstr[:80])
            e = sizes.setdefault(key, [0, 0])
            e[0] = max(e[0], total)
            e[1] += 1
    return sorted(sizes.items(), key=lambda kv: -kv[1][0])


def op_table(step_fn, kwargs, min_bytes: float):
    """The outputs of at least ``min_bytes`` that the aten ops of
    ``step_fn(**kwargs)`` make, as :func:`buffer_table` lists buffers
    (ops by their aten name, types as "dtype[shape]"), with the run's
    counts (``launch/dryrun.py::count_step``)."""
    got = count_step(step_fn, kwargs, table_bytes=min_bytes)
    return sorted(got["table"].items(), key=lambda kv: -kv[1][0]), got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--min-gb", type=float, default=0.5)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    mesh = meta_mesh(args.multi_pod)
    step_fn, kwargs = jit_for_cell(cfg, SHAPES[args.shape], mesh)
    args_b = argument_bytes(kwargs)
    table, got = op_table(step_fn, kwargs, args.min_gb * 2**30)
    print("on the meta device: the step's buffers over all mesh positions")
    print(f"args={args_b/2**30:.2f}GiB (largest position) "
          f"temp={got['temp']/2**30:.2f}GiB (peak of live tensors, all positions) "
          f"out=null alias=null")
    for (op, t), (tot, cnt) in table[: args.top]:
        print(f"{tot/2**30:8.2f} GiB  x{cnt:3d}  {op:22s} {t}")


if __name__ == "__main__":
    main()
