"""Gateway error types shared by both worker transports (a copy of
``repro.gateway.errors``).

Pure Python on purpose: :class:`WorkerDied` is raised by the in-process
worker (which imports torch through its ``RenderServer``) AND by the
subprocess transport (which stays importable without torch: it runs in the
gateway process, where all device work is delegated to children).
"""
from __future__ import annotations


class WorkerDied(RuntimeError):
    """A worker is gone (killed, crashed, or unresponsive past the
    heartbeat timeout). The gateway treats every in-flight request on the
    worker as retryable — the batch completed nothing."""
