"""Fault tolerance (a copy of the JAX package's standard-library-only
``repro.ft``): straggler and dead-host detection from per-host heartbeats,
and the elastic mesh plan after a loss. Importing it touches no device."""
from repro_torch.ft.heartbeat import HeartbeatMonitor, StragglerReport
from repro_torch.ft.elastic import ElasticPlan, plan_elastic_mesh

__all__ = [
    "HeartbeatMonitor",
    "StragglerReport",
    "ElasticPlan",
    "plan_elastic_mesh",
]
