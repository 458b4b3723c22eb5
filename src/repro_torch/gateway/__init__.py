"""Gateway tier: one front-end over a fleet of render workers (mirror of
``repro.gateway``, DESIGN.md §16).

``RenderGateway`` admits (bounded queue), routes (scene-affinity +
stream-sticky + least-loaded spill), health-checks (``ft.heartbeat``),
and fails over (bounded retries + ``ft.elastic`` fleet replanning) across
N workers — in-process :class:`InprocWorker`, or :class:`SubprocessWorker`
children over line-JSON pipes for ``python -m
repro_torch.launch.render_gateway``. Importing this package imports no
torch and initialises no CUDA context: the gateway is pure scheduling;
device work lives inside workers (``repro_torch.gateway.worker`` /
``repro_torch.gateway.worker_main`` import torch on first use, mirroring
the serving-layer split).
"""
from repro_torch.gateway.gateway import (
    FleetPlan,
    GatewayResult,
    NoWorkerAvailable,
    RenderGateway,
    WorkerTimeout,
    plan_fleet,
)

__all__ = [
    "FleetPlan",
    "GatewayResult",
    "NoWorkerAvailable",
    "RenderGateway",
    "WorkerTimeout",
    "plan_fleet",
    "InprocWorker",
    "SubprocessWorker",
    "WorkerDied",
]


def __getattr__(name: str):
    # Lazy: InprocWorker pulls in serving.server (torch); SubprocessWorker is
    # pure Python but lives with the wire protocol. Keeping both out of the
    # eager import keeps gateway scheduling free of torch.
    if name == "InprocWorker":
        from repro_torch.gateway.worker import InprocWorker
        return InprocWorker
    if name == "WorkerDied":
        from repro_torch.gateway.errors import WorkerDied
        return WorkerDied
    if name == "SubprocessWorker":
        from repro_torch.gateway.transport import SubprocessWorker
        return SubprocessWorker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
