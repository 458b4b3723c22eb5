"""Analytic cost model of the GS-TG accelerator (paper §V, Table III; a copy
of ``repro.core.cost_model`` that takes the port's counters).

Replaces the paper's cycle-level simulator: given the RenderStats counters
produced by an actual rendering run, estimate cycles / runtime / energy for a
given hardware configuration. Calibrated to the paper's published config:
4x PM, 4x GS-TG core (BGM: 4 tile-check units; GSM: 16 comparators; RM: 16
rasterization units), 1 GHz, DRAM 51.2 GB/s.

Two execution models:
  * ``asic``  — BGM and GSM run in PARALLEL (stage time = max), the paper's
    headline architectural feature (§V-A).
  * ``gpu``   — bitmask generation serializes with sorting (stage time = sum),
    reproducing the GPU limitation of Fig 13.

Energy: per-op energies for 28nm-class MAC/compare/bit ops plus DRAM energy
per bit (the paper cites Energon's DRAM model [16]).

Its outputs are the model's estimates for the paper's ASIC (or its GPU
serialization), computed from operation counts: they are not times measured
on any chip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    name: str = "gstg-asic"
    freq_hz: float = 1.0e9
    dram_gbps: float = 51.2          # GB/s (paper §VI-A)
    n_pm: int = 4                    # preprocessing modules
    n_cores: int = 4                 # GS-TG cores
    bgm_units: int = 4               # tile-check units per core
    gsm_comparators: int = 16        # comparators per core
    rm_units: int = 16               # rasterization units per core
    # per-op cycle costs
    cyc_feature: float = 4.0         # full per-gaussian feature pipeline (PM)
    cyc_boundary: float = 1.0        # one boundary test (any method base)
    boundary_scale: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"aabb": 1.0, "obb": 2.0, "ellipse": 3.0}
    )
    cyc_compare: float = 1.0         # comparator-tree op (GSM)
    # Sorting is MEMORY-bound in practice: a 64-bit radix sort streams the
    # key array multiple times. passes x (read+write) x key bytes / DRAM bw
    # reproduces Fig 3's stage shares (~35% sorting at 16x16) — the
    # comparator term almost never binds.
    radix_passes: int = 4
    cyc_alpha: float = 1.0           # one alpha computation (RU, pipelined)
    cyc_fifo: float = 1.0 / 16.0     # bitmask AND/OR filter, 16 lanes/cycle
    # per-op energies (pJ), 28nm-class estimates
    pj_feature: float = 30.0
    pj_boundary: float = 6.0
    pj_compare: float = 1.0
    pj_alpha: float = 8.0
    pj_fifo: float = 0.1
    pj_dram_per_byte: float = 20.0   # ~2.5 pJ/bit, Energon-style [16]
    # bytes per record (fp16 deployment per paper §VI-A)
    bytes_gaussian_feat: int = 2 * (2 + 3 + 1 + 3 + 1 + 1)  # fp16 feature set
    bytes_sort_key: int = 8
    bytes_pixel: int = 4


GSTG_ASIC = HardwareConfig()
GSTG_GPU_MODEL = dataclasses.replace(GSTG_ASIC, name="gstg-gpu")


@dataclasses.dataclass
class StageCosts:
    preprocess_s: float
    sort_s: float
    bitmask_s: float
    raster_s: float
    dram_s: float
    total_s: float
    energy_j: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "StageCosts":
        """Inverse of :meth:`as_dict` — the (de)serialization the autotune
        cache and the BENCH_autotune_*.json trajectory files rely on.
        Rejects unknown/missing keys so a schema drift fails loudly instead
        of silently zero-filling a stage."""
        names = [f.name for f in dataclasses.fields(cls)]
        if set(d) != set(names):
            raise ValueError(
                f"StageCosts dict keys {sorted(d)} != fields {sorted(names)}"
            )
        return cls(**{k: float(d[k]) for k in names})


def _f(x) -> float:
    """A counter as a Python float: a torch tensor on any device (one host
    sync), a numpy value or a Python number."""
    if isinstance(x, torch.Tensor):
        return float(x.item())
    return float(np.asarray(x))


def estimate(
    stats,
    hw: HardwareConfig,
    boundary_group: str = "ellipse",
    boundary_tile: str = "ellipse",
    mode: str = "gstg",
    execution: str = "asic",
) -> StageCosts:
    """Map RenderStats counters -> stage seconds + total energy.

    mode: 'gstg' or a baseline ('tile_baseline' / 'group_baseline'); baselines
    have no bitmask/FIFO stage.
    """
    f = hw.freq_hz
    bscale_g = hw.boundary_scale[boundary_group]
    bscale_t = hw.boundary_scale[boundary_tile]

    n_vis = _f(stats.n_visible)
    n_tests = _f(stats.n_candidate_tests)
    n_pairs = _f(stats.n_pairs_sort)
    sort_ops = _f(stats.sort_ops)
    bit_tests = _f(stats.n_bit_tests)
    fifo_ops = _f(stats.fifo_ops)
    alpha_ops = _f(stats.alpha_ops)
    tile_entries = _f(stats.tile_entries)

    # --- preprocessing: feature pipeline + identification tests ---
    pre_cycles = (
        n_vis * hw.cyc_feature + n_tests * hw.cyc_boundary * bscale_g
    ) / hw.n_pm
    pre_s = pre_cycles / f

    # --- sorting (GSM): max(comparator-bound, DRAM-bound radix) ---
    sort_cycles = sort_ops * hw.cyc_compare / (hw.n_cores * hw.gsm_comparators)
    sort_dram_s = (
        n_pairs * hw.bytes_sort_key * 2 * hw.radix_passes
    ) / (hw.dram_gbps * 1e9)
    sort_s = max(sort_cycles / f, sort_dram_s)

    # --- bitmask generation (BGM) ---
    bgm_cycles = bit_tests * hw.cyc_boundary * bscale_t / (
        hw.n_cores * hw.bgm_units
    )
    bgm_s = bgm_cycles / f

    # --- rasterization (RM): FIFO filter + alpha ops over RUs ---
    ru = hw.n_cores * hw.rm_units
    raster_cycles = alpha_ops * hw.cyc_alpha / ru + fifo_ops * hw.cyc_fifo
    raster_s = raster_cycles / f

    # --- DRAM traffic ---
    bytes_total = (
        n_vis * hw.bytes_gaussian_feat          # features read once
        + n_pairs * hw.bytes_sort_key * 2       # keys written + read
        + tile_entries * hw.bytes_gaussian_feat  # raster re-reads per tile list
    )
    dram_s = bytes_total / (hw.dram_gbps * 1e9)

    if mode == "gstg":
        if execution == "asic":
            mid_s = max(sort_s, bgm_s)  # BGM || GSM (the ASIC feature)
        else:
            mid_s = sort_s + bgm_s      # GPU: serialized
    else:
        mid_s = sort_s

    compute_s = pre_s + mid_s + raster_s
    total_s = max(compute_s, dram_s)

    energy = (
        n_vis * hw.pj_feature
        + n_tests * hw.pj_boundary * bscale_g
        + sort_ops * hw.pj_compare
        + bit_tests * hw.pj_boundary * bscale_t
        + fifo_ops * hw.pj_fifo
        + alpha_ops * hw.pj_alpha
        + bytes_total * hw.pj_dram_per_byte
    ) * 1e-12

    return StageCosts(
        preprocess_s=pre_s,
        sort_s=sort_s,
        bitmask_s=bgm_s,
        raster_s=raster_s,
        dram_s=dram_s,
        total_s=total_s,
        energy_j=energy,
    )
