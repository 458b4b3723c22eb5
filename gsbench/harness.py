"""Finds a cell's parts by name: the cell in ``BENCHMARK.json``, its
configuration in ``gsbench/configs/<config>.json``, its traffic mix in
``gsbench/traffic/<traffic>.json``, the loop that mix names in
``gsbench/loops/<loop>.py`` and each metric's reader in
``gsbench/metrics/<metric>.py`` (``setup_s`` alone is the harness's own).
Adding a cell, a configuration, a mix, a loop or a metric adds files and
entries; no file here names one."""
from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SETUP_S = "setup_s"


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def _data(kind: str, name: str, bench: Path) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{kind[:-1] if kind.endswith('s') else kind} {name!r}: "
                                f"no file {path}")
    return {"name": name, **json.loads(path.read_text())}


def load_config(name: str, bench: Path = BENCH) -> dict:
    """The configuration's sizes and render settings (``configs/<name>.json``)."""
    return _data("configs", name, bench)


def load_traffic(name: str, bench: Path = BENCH) -> dict:
    """The traffic mix's parameters (``traffic/<name>.json``)."""
    return _data("traffic", name, bench)


def _module(kind: str, name: str, bench: Path) -> ModuleType:
    """``<kind>/<name>.py``, loaded from its file: a name may hold dots."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind[:-1]} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"gsbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, bench: Path = BENCH) -> ModuleType:
    """The reader of a metric (``metrics/<name>.py``)."""
    return _module("metrics", name, bench)


def load_loop(name: str, bench: Path = BENCH) -> ModuleType:
    """The loop that drives the program (``loops/<name>.py``): its ``Loop``
    class is set up from the cell, then runs the window or the traced
    run."""
    return _module("loops", name, bench)


def _listed(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported


def end_to_end_for(spec: dict, cell: str) -> List[dict]:
    """The end-to-end metrics this cell reports (``--trace 0``)."""
    return [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(spec: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports (``--trace 1``)."""
    reported = [m["name"] for m in end_to_end_for(spec, cell)]
    return [m for m in spec["per_layer"] if _listed(m, cell, reported)]


def rng(seed: int, salt: str) -> np.random.Generator:
    """A numpy generator from ``seed`` (any whole number) and a salt."""
    digest = hashlib.sha256(f"{salt}:{int(seed)}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


def resolve(spec: dict, cell: str, bench: Path = BENCH) -> Dict[str, object]:
    """Everything one cell needs, found by name."""
    w = workload(spec, cell)
    traffic = load_traffic(w["traffic"], bench)
    return {
        "workload": w,
        "config": load_config(w["config"], bench),
        "traffic": traffic,
        "loop": load_loop(traffic["loop"], bench),
        "end_to_end": [(m, None if m["name"] == SETUP_S else load_metric(m["name"], bench))
                       for m in end_to_end_for(spec, cell)],
        "per_layer": [(m, load_metric(m["name"], bench)) for m in per_layer_for(spec, cell)],
    }
