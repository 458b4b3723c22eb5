"""Paged scene residency under the device budget (mirror of
``repro.residency``, DESIGN.md §17).

``ResidencyManager`` pages committed scenes in and out of device memory
against ``device_budget_mb``: a host copy of each staged layout is the
backing store, ``.to(device)`` pages in, and dropping the manager's device
reference pages out. ``repro_torch.engine.Renderer`` commits through an
entry here; a ``RenderServer`` shares ONE manager across every handle, so
an over-budget commit evicts cold scenes instead of failing fast.
"""
from repro_torch.residency.manager import ResidencyEntry, ResidencyManager

__all__ = ["ResidencyEntry", "ResidencyManager"]
