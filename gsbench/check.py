"""The comparison that decides ``correct``: the program's images against the
plain reference's images of the same scene and cameras.

Numbers compared, each against the limit its configuration file states
under ``limits`` (set from sound runs and the TF32 control, PERF.md):

  * ``rmse``: the worst sampled image's root mean square difference from
    the reference, over every pixel and channel. The widest single gap is
    not compared: where two overlapping splats lie at depths that the two
    sides' float32 round apart, they blend in the other order over a patch
    of pixels, a gap of up to a splat's colour that sound runs show;
  * ``cut_entries``: list entries the program dropped (capacity overflow
    and the candidate window's overflow, summed over every frame the window
    drove), exactly 0: the reference's lists are never cut, and losslessness
    holds only on uncut lists;
  * ``missing``: served requests due in the window that were never
    delivered, exactly 0.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, Tuple

import torch


def image_gap(image: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """rmse and max_abs of ``image`` against ``want`` (NaN where either has
    a NaN, which fails every limit)."""
    d = image.to(want.device, torch.float32) - want
    if not bool(torch.isfinite(d).all()):
        return {"rmse": math.nan, "max_abs": math.nan}
    return {"rmse": float(torch.sqrt(torch.mean(d.double() ** 2))),
            "max_abs": float(d.abs().max())}


def worst(gaps: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the sampled answers (NaN wins)."""
    out: Dict[str, float] = {}
    for g in gaps:
        for k, v in g.items():
            prev = out.get(k)
            if prev is None or math.isnan(v) or (not math.isnan(prev) and v > prev):
                out[k] = v
    return out


def judge(readings: Dict[str, Optional[float]], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """Every number this run read at or under its limit; a reading that is
    missing (None) or NaN fails. Returns (correct, {name: {value, limit}})."""
    table, ok = {}, True
    for name, v in readings.items():
        limit = limits[name]
        ok = ok and v is not None and not math.isnan(v) and v <= limit
        table[name] = {"value": v, "limit": limit}
    return ok, table


def print_table(table: dict) -> None:
    """The numbers compared, beside their limits, as the last lines on
    standard error."""
    for name, row in table.items():
        v, lim = row["value"], row["limit"]
        verdict = "ok" if v is not None and not math.isnan(v) and v <= lim else "FAIL"
        print(f"check {name} {v!r} <= {lim!r} {verdict}", file=sys.stderr, flush=True)
