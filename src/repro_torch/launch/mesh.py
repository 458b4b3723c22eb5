"""Render meshes (mirror of ``repro.launch.mesh``).

A :class:`RenderMesh` is a 2-D grid of ``torch.device``: rows lay over the
``'data'`` axis (camera lanes), columns over ``'model'`` (shards of the
gaussian axis). An LM production mesh (:func:`make_production_mesh`) may
add a ``'pod'`` axis before ``'data'``: its rows are then pod x data,
row-major, as JAX orders a ``('pod', 'data')`` entry. One process drives
every device of a mesh: a scene shard lives on its column's device, the
per-shard frontends run there, and the merge and the backend run once per
lane on the row's lead device (column 0), to which the owner-masked psum
gather copies each shard's contribution (``core/projection.py``).

A mesh may name one device more than once. Such virtual devices (for
instance ``[torch.device("cpu")] * 4``) are the counterpart of the JAX
package's forced host device count: every code path of a several-device
mesh runs, on one device.

:func:`make_production_mesh` builds the LM stack's (16, 16) or (2, 16, 16)
mesh over 256 (512) cards, or over ``meta`` devices: the dry run
(``launch/dryrun.py``) builds it so, since one machine holds no such pod.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.utils.misc import resolve_device

DevicesArg = Union[None, int, Sequence[Union[str, torch.device]]]


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A (data, model) grid of devices. ``grid[r][c]`` is the device of
    data row ``r`` and model column ``c``; a 1-D ``('data',)`` mesh has one
    column. A ``('pod', 'data', 'model')`` mesh has ``pods`` pods of
    ``rows // pods`` data rows each: row ``r`` is pod ``r // data``, data
    index ``r % data``. Hashable and compared by value (devices, axis
    names and pods)."""

    grid: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...]
    pods: int = 1

    def __post_init__(self):
        if not self.grid or not self.grid[0]:
            raise ValueError("a render mesh needs at least one device")
        if len({len(row) for row in self.grid}) != 1:
            raise ValueError("every row of a render mesh has as many devices")
        if self.axis_names not in (("data",), ("data", "model"), ("pod", "data", "model")):
            raise ValueError(f"unknown mesh axes {self.axis_names!r}")
        if self.axis_names == ("data",) and len(self.grid[0]) != 1:
            raise ValueError("a ('data',) mesh has one column")
        pod = self.axis_names[0] == "pod"
        if self.pods < 1 or (not pod and self.pods != 1) or len(self.grid) % self.pods:
            raise ValueError(f"{self.pods} pods do not split the {len(self.grid)} rows "
                             f"of a {self.axis_names!r} mesh")

    @property
    def shape(self) -> Mapping[str, int]:
        """Axis name -> extent, in axis order (``dict(mesh.shape)`` reads as
        the JAX handle's stats do)."""
        extents = (len(self.grid), len(self.grid[0]))
        if self.axis_names[0] == "pod":
            extents = (self.pods, len(self.grid) // self.pods) + extents[1:]
        return dict(zip(self.axis_names, extents))

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Every device, row-major (repeats kept)."""
        return tuple(d for row in self.grid for d in row)

    @property
    def rows(self) -> int:
        return len(self.grid)

    @property
    def columns(self) -> int:
        return len(self.grid[0])

    @functools.cached_property
    def positions(self) -> Tuple[Tuple[int, int], ...]:
        """Every (row, column), row-major."""
        return tuple((r, c) for r in range(self.rows) for c in range(self.columns))

    def lead(self, row: int = 0) -> torch.device:
        """Data row ``row``'s lead device (model column 0): where its lanes'
        merge and backend run."""
        return self.grid[row][0]

    @property
    def device_types(self) -> frozenset:
        return frozenset(d.type for d in self.devices)

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return f"RenderMesh({dict(self.shape)}, [{names}])"


def _canonical(device) -> torch.device:
    """``cuda`` -> ``cuda:0``, so a mesh compares equal however its cards
    were named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def mesh_devices(devices: DevicesArg = None) -> Tuple[torch.device, ...]:
    """The device list a mesh is built from: ``None`` takes every visible
    card, an int ``n`` the first ``n`` cards (raising when there are fewer),
    a sequence those devices, repeats allowed (virtual devices)."""
    if devices is None or isinstance(devices, int):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass a device list such as "
                "devices=['cpu', 'cpu'] to build a mesh on the CPU"
            )
        have = torch.cuda.device_count()
        n = have if devices is None else devices
        if n <= 0:
            raise ValueError(f"render mesh needs >= 1 device, got {n}")
        if n > have:
            raise ValueError(f"render mesh wants {n} cards, and {have} are visible")
        return tuple(torch.device("cuda", i) for i in range(n))
    out = tuple(_canonical(d) for d in devices)
    if not out:
        raise ValueError("render mesh needs >= 1 device, got 0")
    for d in out:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; name CPU devices for a mesh on the CPU")
    return out


def make_host_mesh(data: int = 1, model: int = 1, devices: DevicesArg = None) -> RenderMesh:
    """A small ``(data, model)`` mesh (tests, examples) over the first
    ``data * model`` of ``devices`` (default: the visible cards)."""
    devs = mesh_devices(data * model if devices is None else devices)
    if len(devs) < data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, got {len(devs)}")
    devs = devs[: data * model]
    grid = tuple(tuple(devs[r * model:(r + 1) * model]) for r in range(data))
    return RenderMesh(grid, ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, devices: DevicesArg = None) -> RenderMesh:
    """The LM production mesh: (data=16, model=16), or with ``multi_pod``
    a pure data-parallel ``'pod'`` axis before them, (pod=2, data=16,
    model=16), as the JAX package's (a TPU v5e pod, or two). ``devices``:
    ``None`` takes 256 (512) visible cards and raises when fewer are
    visible; a sequence gives the devices, the first 256 (512) of them (the
    dry run passes ``["meta"] * n``)."""
    pods, data, model = (2, 16, 16) if multi_pod else (1, 16, 16)
    n = pods * data * model
    devs = mesh_devices(n if devices is None else devices)
    if len(devs) < n:
        raise ValueError(f"a production mesh needs {n} devices, got {len(devs)}")
    rows = pods * data
    grid = tuple(tuple(devs[r * model:(r + 1) * model]) for r in range(rows))
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RenderMesh(grid, axes, pods=pods)


def one_device_mesh(device) -> RenderMesh:
    """The ``('data',)`` mesh of one device: what ``device=`` means."""
    return RenderMesh(((_canonical(device),),), ("data",))


def render_mesh_shards(n_devices: int, scene_shards: int) -> int:
    """The physical shard count a render mesh over ``n_devices`` can
    realize: ``scene_shards`` when it divides the device count, else 1 (the
    shard axis stays logical: the same results, no per-device memory
    saving)."""
    if scene_shards > 1 and n_devices % scene_shards == 0:
        return scene_shards
    return 1


def make_render_mesh(devices: DevicesArg = None, scene_shards: int = 1) -> RenderMesh:
    """The render-serving mesh.

    ``scene_shards <= 1``: the 1-D ``('data',)`` mesh, one camera lane per
    device. ``scene_shards = D > 1``: the 2-D ``('data', 'model')`` mesh of
    ``n // D`` rows by D columns; shard ``d`` of a ``ShardedScene`` lives
    on column ``d``. ``devices``: ``None`` (every visible card), an int (the
    first n cards) or a sequence of devices, repeats allowed."""
    devs = mesh_devices(devices)
    n = len(devs)
    if scene_shards <= 1:
        return RenderMesh(tuple((d,) for d in devs), ("data",))
    if n % scene_shards:
        raise ValueError(f"scene_shards={scene_shards} must divide the device count {n}")
    rows = n // scene_shards
    grid = tuple(tuple(devs[r * scene_shards:(r + 1) * scene_shards]) for r in range(rows))
    return RenderMesh(grid, ("data", "model"))


def cli_devices(device, count: Optional[int]) -> Tuple[torch.device, ...]:
    """The devices of a CLI's ``--device`` and ``--devices N``: ``device``
    alone when N is None or 1; on the CPU, N virtual CPU devices (as the
    JAX CLIs force N virtual host devices); on CUDA, the first min(N,
    cards) cards, with the JAX CLI's warning when fewer than N are
    visible."""
    dev = resolve_device(device)
    if count is None or count <= 1:
        return (_canonical(dev),)
    if dev.type != "cuda":
        return (dev,) * count
    have = len(mesh_devices(None))
    if count > have:
        print(f"warning: requested {count} devices, have {have}")
    return mesh_devices(min(count, have))
