"""Batch padding for dispatch (mirror of ``pad_camera_batch`` in
``repro.serving.sharded``). The scene-layout cache of that module waits for
ROADMAP queue 1, item 8; its deprecated ``render_batch_sharded`` raises."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pipeline import CameraBatch
from repro_torch.serving.bucketing import pad_indices_to
from repro_torch.utils.misc import not_ported


def pad_camera_batch(batch: CameraBatch, target: int) -> CameraBatch:
    """Pad the batch axis up to ``target`` lanes by replicating the last
    camera (the ``pad_indices_to`` policy); identity when already there."""
    n = len(batch)
    idx = pad_indices_to(n, target)
    if len(idx) == n:
        return batch
    take = torch.as_tensor(idx, dtype=torch.int64, device=batch.R.device)
    return dataclasses.replace(
        batch,
        R=batch.R[take],
        t=batch.t[take],
        fx=batch.fx[take],
        fy=batch.fy[take],
        cx=batch.cx[take],
        cy=batch.cy[take],
    )


render_batch_sharded = not_ported(
    "render_batch_sharded", "6: the JAX package's deprecated free functions"
)
