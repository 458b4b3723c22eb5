"""Multi-pod dry run on the ``meta`` device (mirror of ``repro.launch.dryrun``).

The JAX package lowers and compiles every (arch x shape x mesh) cell
against 512 forced host devices and reads XLA's ``cost_analysis`` and
``memory_analysis``. Torch has no such lowering, and no machine here holds
a pod of 256 cards: the port builds the production mesh over ``meta``
devices (``launch/mesh.py::make_production_mesh``), runs the cell's step on
them (``launch/steps.py::jit_for_cell``: shapes only, no data) and counts
what it does. Every record's ``basis`` names what stands in for each of
XLA's figures (:data:`BASIS`); where nothing does, the field is null.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --report results/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import derive_terms, model_flops_for_cell
from repro_torch.launch.shapes import SHAPES, cell_supported
from repro_torch.launch.steps import _batch_shardable, jit_for_cell, use_fsdp
from repro_torch.sharding.policies import per_device, position_bytes, record_collectives

SCALAR_BYTES = 4   # the step number or decode position, an int32 scalar in JAX

BASIS = {
    "compile_s": "seconds of the step's runs on meta (the 1- and 2-unit steps when "
                 "calibrated, else the full step); nothing is compiled",
    "flops_per_device": "torch.utils.flop_counter.FlopCounterMode over the step on meta, "
                        "divided by the data rows that compute: each row computes on its "
                        "lead device (no tensor-parallel compute over 'model')",
    "bytes_per_device": "the bytes of every non-view aten op's tensor inputs and outputs on "
                        "meta (eager execution, no fusion), divided the same way",
    "collective_bytes": "bytes the one-process mesh step brings to each mesh position from "
                        "the others, by kind, counted where each copy is made "
                        "(sharding/policies.py::record_collectives); the figures of the "
                        "position that receives the most; scalar reductions not counted",
    "argument_bytes_per_device": "exact: the largest position's bytes of parameters, "
                                 "optimizer state, batch, cache and the scalar step",
    "temp_bytes_per_device": "the peak of live tensors the step makes on meta, all positions "
                             "together, divided by the data rows that compute; not proven "
                             "against a card (chip_smoke.py's dryrun phase prints the ratio)",
    "output_bytes_per_device": None,
    "alias_bytes_per_device": None,
}


class StepCounter(TorchDispatchMode):
    """Counts what the aten ops under it do: ``bytes``, the bytes of every
    non-view op's tensor inputs and outputs; ``live`` and ``peak``, the bytes
    of the storages the ops made that are still alive, and their most (a
    storage an op returns that none of its inputs has is new; it leaves
    when Python frees it). With ``table_bytes``, ``table`` maps (op,
    "dtype[shape]") of every new output of at least that many bytes to
    [largest bytes, count]."""

    def __init__(self, table_bytes: Optional[float] = None):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.table_bytes = table_bytes
        self.table: dict = {}
        self._held: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._held:
                continue
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
            if self.table_bytes is not None and n >= self.table_bytes:
                name = func.overloadpacket.__name__
                entry = self.table.setdefault((name, _type_str(t)), [0, 0])
                entry[0] = max(entry[0], n)
                entry[1] += 1
        return out

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)


def _type_str(t: torch.Tensor) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(map(str, t.shape))}]"


def count_step(step_fn, kwargs, table_bytes: Optional[float] = None) -> dict:
    """Run ``step_fn(**kwargs)`` once under the port's counters: total
    FLOPs (``FlopCounterMode``), bytes moved and the peak of live tensors
    made inside the step (:class:`StepCounter`), ``collectives``, the
    (kind, position) -> bytes log of ``record_collectives``, with the
    busiest position's bytes by kind (``per_device``), and the seconds it
    took. On the card as on ``meta``."""
    with record_collectives() as coll, FlopCounterMode(display=False) as flops:
        with StepCounter(table_bytes) as cost:
            t0 = time.perf_counter()
            step_fn(**kwargs)
            seconds = time.perf_counter() - t0
    return {"flops": float(flops.get_total_flops()), "bytes": float(cost.bytes),
            "temp": float(cost.peak), **per_device(coll), "collectives": dict(coll),
            "seconds": seconds, "table": cost.table}


def _rows_computing(shape, mesh) -> int:
    """The data rows that compute a distinct part of the batch. A batch
    that does not split is computed once on meta, where every row's cache
    is one shared tensor; each row of a real mesh computes it whole, the
    same work a device."""
    return mesh.rows if _batch_shardable(shape, mesh) else 1


def _cell_costs(cfg, shape, mesh) -> dict:
    """Counts of one cell's step on ``mesh`` (its devices ``meta``): flops,
    bytes and temp (the peak of live tensors) per device, divided by the
    rows that compute; the collective log's (kind, position) -> bytes as
    counted, each position one device; and the run's seconds."""
    step_fn, kwargs = jit_for_cell(cfg, shape, mesh)
    got = count_step(step_fn, kwargs)
    rows = _rows_computing(shape, mesh)
    out = {k: got[k] / rows for k in ("flops", "bytes", "temp")}
    return {**out, **got["collectives"], "seconds": got["seconds"]}


def calibrated_costs(cfg, shape, mesh) -> dict:
    """Counts of the full model from steps of 1 and 2 pattern units of the
    same config (the same widths and sharding; ``force_fsdp`` pins the FSDP
    decision of the full model), extrapolated linearly: cost(U) = fixed +
    per_unit * U, as the JAX package calibrates its compiles. A step on
    ``meta`` costs time by its ops, so this also spares running the U units;
    the attention chunk is enlarged to seq_len // 8 (the same FLOPs; larger
    attention tiles in the peak), as there."""
    plen = len(cfg.pattern)
    fsdp = use_fsdp(cfg, mesh)
    chunk = max(cfg.attn_chunk, shape.seq_len // 8)
    c1 = dataclasses.replace(cfg, n_layers=plen, force_fsdp=fsdp,
                             unroll_for_costing=True, attn_chunk=chunk)
    c2 = dataclasses.replace(cfg, n_layers=2 * plen, force_fsdp=fsdp,
                             unroll_for_costing=True, attn_chunk=chunk)
    f1 = _cell_costs(c1, shape, mesh)
    f2 = _cell_costs(c2, shape, mesh)
    seconds = f1.pop("seconds") + f2.pop("seconds")
    U = cfg.n_units
    keys = f1.keys() | f2.keys()   # flops, bytes, temp and each (kind, position)
    per_unit = {k: f2.get(k, 0) - f1.get(k, 0) for k in keys}
    fixed = {k: f1.get(k, 0) - per_unit[k] for k in keys}
    total = {k: max(fixed[k] + per_unit[k] * U, 0.0) for k in keys}
    return {**_per_device(total), "per_unit": per_unit, "fixed": fixed, "seconds": seconds}


def _per_device(costs) -> dict:
    """The record's figures from :func:`_cell_costs`' counts (or their
    extrapolation): collectives those of the busiest position."""
    by_kind = per_device(costs)
    return {
        "flops_per_device": costs["flops"],
        "bytes_per_device": costs["bytes"],
        "collective_bytes": sum(by_kind.values()),
        "collective_by_kind": by_kind,
        "temp_bytes_per_device": costs["temp"],
    }


@dataclasses.dataclass
class MemoryStats:
    """The port's stand-in for XLA's ``memory_analysis()`` (see BASIS)."""

    argument_size_in_bytes: int
    temp_size_in_bytes: int


def argument_bytes(kwargs) -> int:
    """The largest mesh position's bytes of a cell's inputs, with the
    scalar step or position."""
    held = position_bytes({k: v for k, v in kwargs.items() if not isinstance(v, int)})
    return max(held.values()) + SCALAR_BYTES * sum(isinstance(v, int) for v in kwargs.values())


def meta_mesh(multi_pod: bool):
    """The production mesh over ``meta`` devices: one process cannot hold
    a pod, so the dry run computes shapes only."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             calibrate: bool = True):
    """One cell's record, with the JAX package's keys (``compile_s`` holds
    the meta runs' seconds) and ``basis``: what stands in for each figure."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        if verbose:
            print(f"SKIP {arch} x {shape_name} [{mesh_name}]: {reason}")
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "skip", "reason": reason,
        }

    mesh = meta_mesh(multi_pod)
    chips = mesh.size
    t0 = time.time()
    if calibrate:
        cal = calibrated_costs(cfg, shape, mesh)
    else:
        cal = _per_device(_cell_costs(cfg, shape, mesh))
    t1 = time.time()
    mem = MemoryStats(argument_bytes(jit_for_cell(cfg, shape, mesh)[1]),
                      int(cal["temp_bytes_per_device"]))
    terms = derive_terms(
        arch=arch,
        shape_name=shape_name,
        mesh_name=mesh_name,
        chips=chips,
        cost={"flops": cal["flops_per_device"], "bytes accessed": cal["bytes_per_device"]},
        model_flops=model_flops_for_cell(cfg, shape),
        mem_stats=mem,
        collectives={k: int(v) for k, v in cal["collective_by_kind"].items()},
    )
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "compile_s": round(t1 - t0, 2),
        "device": "meta",
        "calibrated": calibrate,
        "memory_analysis": {
            "argument_bytes_per_device": mem.argument_size_in_bytes,
            "output_bytes_per_device": None,
            "temp_bytes_per_device": mem.temp_size_in_bytes,
            "alias_bytes_per_device": None,
        },
        "roofline": terms.as_dict(),
        "basis": BASIS,
    }
    if verbose:
        ma = rec["memory_analysis"]
        hbm_gb = (ma["argument_bytes_per_device"] + ma["temp_bytes_per_device"]) / 2**30
        print(
            f"OK   {arch} x {shape_name} [{mesh_name}] "
            f"compile={rec['compile_s']}s  hbm/dev={hbm_gb:.2f}GiB  "
            f"flops/dev={terms.flops_per_device:.3e}  "
            f"coll={terms.collective_bytes_total:.3e}B  dom={terms.dominant}"
        )
        print(f"     memory_analysis (meta stand-in): {ma}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh (default 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--report", default=None, help="append JSON records here")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="run the full-depth step instead of the 1/2-unit calibration steps")
    args = ap.parse_args()

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    print("dry run on the meta device: the production mesh cannot exist on one "
          "machine, so each step computes shapes only (see each record's basis)")

    records = []
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    records.append(
                        run_cell(arch, shape, mp, calibrate=not args.no_calibrate)
                    )
                except Exception as e:
                    failures += 1
                    traceback.print_exc()
                    records.append({
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "fail", "error": f"{type(e).__name__}: {e}",
                    })

    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.report):
            with open(args.report) as f:
                existing = json.load(f)
        # replace same-key records
        keyf = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
        merged = {keyf(r): r for r in existing}
        for r in records:
            merged[keyf(r)] = r
        with open(args.report, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
        print(f"wrote {len(records)} records -> {args.report}")

    n_ok = sum(1 for r in records if r["status"] == "ok")
    n_skip = sum(1 for r in records if r["status"] == "skip")
    print(f"\nsummary: {n_ok} ok, {n_skip} skip, {failures} fail")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
