"""Roofline terms of a dry-run cell (mirror of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh):
    compute    = flops per device / peak FLOP/s
    memory     = bytes per device / HBM bandwidth
    collective = collective bytes per device / (link bandwidth x links)

The port's dry run (``launch/dryrun.py``) gives per-device counts from a
step run on the ``meta`` device, not from XLA's ``cost_analysis``; its
records name what stands in for each figure. The constants are the
H100's, where the JAX package's are TPU v5e's. The collective term assumes
NVLink between every pair of cards: a 16 x 16 mesh of H100s spans 32 nodes
of eight, whose links between nodes are slower, so the term is a lower
bound there (the JAX term likewise assumes ICI throughout).

``collective_bytes`` and ``_type_bytes`` parse the collectives of an XLA
HLO dump, as the JAX package's do. Nothing in the port produces HLO: they
are kept, as copies, to read the JAX package's dumps beside the port's
records.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

# --- NVIDIA H100 80GB HBM3 (SXM5), 700 W: NVIDIA's data-sheet figures, not
# measured here. The names are the JAX package's (whose values are TPU v5e's).
PEAK_FLOPS_BF16 = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12                  # bytes/s per card
ICI_BW = 25e9                     # bytes/s per NVLink 4 link, each way
LINKS_PER_CHIP = 18               # NVLink 4 links per card: 450 GB/s each way

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(",
)
_TYPE_RE = re.compile(r"(pred|[a-z]+\d+)\[([\d,]*)\]")


def _type_bytes(type_str: str) -> int:
    total = 0
    for m in _TYPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Result bytes per collective kind over an XLA HLO module's text.

    -start/-done pairs are counted once (only -start carries the payload
    type on its result tuple; -done lines are skipped)."""
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = _COLL_RE.search(line)
        if not m:
            continue
        kind = m.group(3)
        tstr = m.group(1) or m.group(2) or ""
        out[kind] = out.get(kind, 0) + _type_bytes(tstr)
    return out


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_total: int
    collective_by_kind: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float               # 6*N*D (or 6*N_active*D) global
    useful_flops_ratio: float        # model_flops / (flops_per_device*chips)
    dominant: str
    arg_bytes_per_device: int = 0
    temp_bytes_per_device: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def derive_terms(
    *,
    arch: str,
    shape_name: str,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    hlo_text: str = "",
    model_flops: float,
    mem_stats=None,
    links_per_chip: float = LINKS_PER_CHIP,
    collectives: Optional[Dict[str, int]] = None,
) -> RooflineTerms:
    """The terms of one cell. ``cost`` holds per-device ``flops`` and
    ``bytes accessed``; the collective bytes by kind are ``collectives``
    where given (the port's dry run), else parsed from ``hlo_text``.
    ``mem_stats`` is anything with ``argument_size_in_bytes`` and
    ``temp_size_in_bytes``."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    colls = dict(collectives) if collectives is not None else collective_bytes(hlo_text)
    coll_total = sum(colls.values())

    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    # each card drives links_per_chip NVLink links at once
    collective_s = coll_total / (ICI_BW * links_per_chip)

    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    total_flops = flops_dev * chips
    ratio = model_flops / total_flops if total_flops else 0.0

    arg_b = temp_b = 0
    if mem_stats is not None:
        arg_b = int(mem_stats.argument_size_in_bytes)
        temp_b = int(mem_stats.temp_size_in_bytes)

    return RooflineTerms(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        collective_bytes_total=coll_total,
        collective_by_kind=colls,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        model_flops=model_flops,
        useful_flops_ratio=ratio,
        dominant=dominant,
        arg_bytes_per_device=arg_b,
        temp_bytes_per_device=temp_b,
    )


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D forward-only (N = active params,
    D = tokens processed)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
