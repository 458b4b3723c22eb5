"""The work a frame's inputs need, and the least time the card could take
for it: the arithmetic behind every roofline share and ``frame_mfu``.

The counts come from the plain reference's own work on the same scene and
camera (``gsbench/reference/render.py``), never from the program's
counters or the shape of its kernels, so a kernel redesigned later is held
to the same bound:

  * ``group_entries``: live (gaussian, group) entries, each group's list
    from the exact ellipse test, uncut;
  * ``entry_tile_tests``: those entries times their group's member tiles
    that lie in the image;
  * ``alpha_tests``: (pixel, entry) alpha evaluations before the pixel's
    transmittance falls to 1e-4 (early exit), over the exact tile lists;
  * ``blends``: the alpha tests that contribute colour;
  * the scene read once and the image written once.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM3. The
run prints the card's power limit beside every share it reports.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Bytes of an entry's features that a kernel must read: the ellipse test
# reads mean x/y and the conic's three terms; the blend also reads opacity
# and rgb (chip_smoke.py's ENTRY_ROWS["ellipse"] and RASTER_ROWS).
ENTRY_ROWS = 5
RASTER_ROWS = 9
F32 = 4
MASK_WORD = 4              # one 32-bit member-tile mask per group entry
# Operations of the blend as written out (float32: add, multiply, divide,
# exp, min, max and compare count one each): an alpha test is the offset
# (2), the quadratic form (9), exp(-q/2) (2), times opacity (1), the 0.99
# clamp (1) and the two cut-offs (2); a blend is alpha times T (1), three
# colour multiply-adds (6) and T's update (2).
OPS_PER_ALPHA = 17
OPS_PER_BLEND = 9
# The bitmask's least work per (entry, in-image member tile): the one
# comparison that gives the bit. A whole ellipse test per pair costs 75
# operations as core/boundary.py writes it (chip_smoke.py's OPS_PER_TEST),
# but a kernel that shares the terms of a group's tile lines does less
# (the program's already does), so 75 is not a bound.
OPS_PER_ENTRY_TILE = 1


def least_seconds(nbytes: float, ops: float) -> Tuple[float, str]:
    """The least time for the work on the card, and what bounds it: the
    bytes over the HBM rate or the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def image_bytes(width: int, height: int) -> int:
    return width * height * 3 * F32


def bgm(counts: Dict[str, int]) -> Tuple[float, float]:
    """(bytes, operations) of the bitmask stage: each live group entry's
    features read once and its mask word written once."""
    nbytes = counts["group_entries"] * (ENTRY_ROWS * F32 + MASK_WORD)
    return nbytes, counts["entry_tile_tests"] * OPS_PER_ENTRY_TILE


def fused_rm(counts: Dict[str, int], width: int, height: int) -> Tuple[float, float]:
    """(bytes, operations) of the group rasterizer: each live group entry's
    features and mask word read once, the image written once; the alpha
    tests and blends the pixels need."""
    nbytes = counts["group_entries"] * (RASTER_ROWS * F32 + MASK_WORD) + image_bytes(width, height)
    ops = OPS_PER_ALPHA * counts["alpha_tests"] + OPS_PER_BLEND * counts["blends"]
    return nbytes, ops


def frame(counts: Dict[str, int], scene_bytes: int, width: int, height: int) -> Tuple[float, float]:
    """(bytes, operations) of a whole frame: the scene read once and the
    image written once; the bitmask's and the blend's operations."""
    nbytes = scene_bytes + image_bytes(width, height)
    ops = (OPS_PER_ENTRY_TILE * counts["entry_tile_tests"]
           + OPS_PER_ALPHA * counts["alpha_tests"] + OPS_PER_BLEND * counts["blends"])
    return nbytes, ops
