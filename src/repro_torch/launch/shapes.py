"""The assigned input-shape cells and the per-arch support rules (mirror of
``repro.launch.shapes``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_supported(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(supported, reason-if-not). Encoder-only archs have no decode step;
    long_500k needs sub-quadratic sequence mixing (SSM or hybrid only)."""
    if cfg.family == "encoder" and shape.kind == "decode":
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic mixing"
    return True, ""


def all_cells():
    """Every (arch name, ShapeCell) pair, supported or not."""
    from repro_torch.configs import ARCHS

    for arch in ARCHS:
        for shape in SHAPES.values():
            yield arch, shape
