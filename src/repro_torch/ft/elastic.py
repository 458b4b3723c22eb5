"""Elastic scaling: replan the mesh after node loss/gain and reshard (a copy
of ``repro.ft.elastic``).

Policy: the 'model' axis extent is a correctness-critical divisor of head /
ffn / expert dims, so elasticity happens on the DATA (and pod) axes — we keep
the model axis fixed and shrink/grow data parallelism to the largest
supported size that fits the surviving hosts, then restore from the latest
checkpoint onto the new devices (CheckpointManager.restore(device=...)).
The deterministic counter-based data stream makes the resume exact: every
(step, row) is recomputable on whichever host now owns it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    dropped_batch_rows: int        # global-batch rows re-balanced per step
    note: str


def plan_elastic_mesh(
    available_devices: int,
    model_parallel: int,
    global_batch: int,
    prefer_pods: bool = True,
    devices_per_pod: int = 256,
) -> Optional[ElasticPlan]:
    """Largest (pod, data, model) mesh with the fixed model axis that fits.

    Returns None when fewer than one model-parallel group survives (training
    cannot continue; caller should hold at the last checkpoint and page ops).
    """
    if available_devices < model_parallel:
        return None
    groups = available_devices // model_parallel  # data-parallel replicas
    # keep batch divisible: largest data size dividing global_batch
    data = groups
    while data > 1 and global_batch % data:
        data -= 1
    pods = 1
    if prefer_pods and devices_per_pod % model_parallel == 0:
        per_pod_groups = devices_per_pod // model_parallel
        if data >= per_pod_groups and data % per_pod_groups == 0:
            pods = data // per_pod_groups
            data = per_pod_groups
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    if pods > 1:
        shape, axes = (pods, data, model_parallel), ("pod", "data", "model")
    else:
        shape, axes = (data, model_parallel), ("data", "model")
    used = pods * data * model_parallel
    return ElasticPlan(
        mesh_shape=shape,
        mesh_axes=axes,
        dropped_batch_rows=0,
        note=(
            f"{available_devices} devices -> mesh {shape} "
            f"({available_devices - used} idle)"
        ),
    )
