"""Logical-axis -> mesh-axis sharding policies and placement over a
:class:`RenderMesh` (mirror of ``repro.sharding.policies``).

A spec is a :class:`PartitionSpec`, a tuple that reads like the JAX one:
per leading axis of an operand, the mesh axis (or axes) it lays over, and
``PartitionSpec()`` for a replicated operand.

The LM rules (``param_rules``, ``activation_rules``, ``make_constrain``,
``batch_specs``) are pure functions of a config and of a mesh's ``shape``
(a mapping) and ``axis_names``, with the JAX package's values and
``ValueError`` messages, so any object with those two attributes serves:
a :class:`RenderMesh` (``('data',)`` or ``('data', 'model')``) or a
stand-in for the JAX package's ``(pod, data, model)`` production mesh,
where the ``'pod'`` axis joins data parallelism (a ``('pod', 'data',
'model')`` :class:`RenderMesh` from ``launch/mesh.py::make_production_mesh``,
whose rows are pod x data). The five render specs hold the JAX package's
values on a ``RenderMesh``.

:func:`place` stands in for ``jax.device_put(x, NamedSharding(mesh,
spec))``. One process drives the mesh. A tensor under any spec over
``'data'``, ``'model'`` or a tuple of them becomes a :class:`MeshTensor`:
each mesh position holds the slice its coordinates select, one copy per
distinct device and slice (positions of a virtual mesh that hold the same
slice share one tensor). :func:`gather` is the inverse. A render operand
(a scene) is returned as each data row holds it, a tuple with one entry a
row: a replicated operand on the row's lead device, a ``ShardedScene``
under ``scene_shard_pspec`` with shard ``d`` on the row's model column
``d``.

:func:`record_collectives` counts, by collective kind and by the position
that receives them, the bytes the one-process mesh code moves between
distinct mesh positions: what NCCL would carry to each card of a mesh of
distinct ones (the dry run's stand-in for the collectives of XLA's HLO).

``make_constrain`` returns the JAX package's ``with_sharding_constraint``
hook with its specs (:meth:`Constrain.spec`), but the port realizes no
tensor-parallel compute over ``'model'``: a data row computes on its lead
device and the hook returns its tensor unchanged (ROADMAP queue 3).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.launch.mesh import RenderMesh
from repro_torch.models.layers import no_constrain
from repro_torch.sharding.pspec import MeshAxes, P, PartitionSpec
from repro_torch.utils import tree_map

Region = Tuple[Tuple[int, int], ...]


def _data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"sharding policy error: {msg}")


# --------------------------------------------------------------------------
# the LM rules
# --------------------------------------------------------------------------

def param_rules(cfg, mesh) -> Dict[str, MeshAxes]:
    """Rules applied to parameter logical axes."""
    m = mesh.shape["model"]
    rules: Dict[str, MeshAxes] = {
        "vocab": "model" if cfg.shard_vocab else None,
        "embed_tbl": "model",
        "attn_embed": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "ffn": None,
        "experts": None,
        "expert_ffn": None,
        "ssm_inner": None,
        "ssm_heads": None,
    }
    if cfg.shard_vocab:
        _check(cfg.vocab_padded % m == 0, f"vocab_padded {cfg.vocab_padded} % {m}")

    if cfg.attn_sharding == "heads":
        _check(cfg.n_heads % m == 0, f"{cfg.name}: n_heads {cfg.n_heads} % {m}")
        rules["heads"] = "model"
        if cfg.n_kv_heads % m == 0:
            rules["kv_heads"] = "model"
        # else: kv replicated (GQA with few kv heads), as Megatron GQA does.
    elif cfg.attn_sharding == "row":
        _check(cfg.d_model % m == 0, f"{cfg.name}: d_model % {m}")
        rules["attn_embed"] = "model"
    elif cfg.attn_sharding == "head_dim":
        _check(cfg.head_dim % m == 0, f"{cfg.name}: head_dim {cfg.head_dim} % {m}")
        rules["head_dim"] = "model"
    elif cfg.attn_sharding != "replicated":
        raise ValueError(cfg.attn_sharding)

    if cfg.mlp_sharding == "ff" and cfg.d_ff:
        _check(cfg.d_ff % m == 0, f"{cfg.name}: d_ff {cfg.d_ff} % {m}")
        rules["ffn"] = "model"

    if cfg.n_experts:
        _check(cfg.n_experts % m == 0, f"{cfg.name}: experts {cfg.n_experts} % {m}")
        rules["experts"] = "model"

    if cfg.family in ("ssm", "hybrid"):
        _check(cfg.d_inner % m == 0, f"{cfg.name}: d_inner % {m}")
        _check(cfg.n_ssm_heads % m == 0, f"{cfg.name}: ssm heads % {m}")
        rules["ssm_inner"] = "model"
        rules["ssm_heads"] = "model"
    return rules


def activation_rules(cfg, mesh) -> Dict[str, MeshAxes]:
    """Rules applied by the model's ``constrain`` calls: the parameter rules
    plus the batch over the data axes, the decode cache's sequence and the
    residual stream's sequence over ``'model'``."""
    rules = dict(param_rules(cfg, mesh))
    rules["batch"] = _data_axes(mesh)
    rules["cache_batch"] = _data_axes(mesh)
    rules["cache_seq"] = "model"
    rules["act_seq"] = "model"
    return rules


class Constrain:
    """``constrain(x, logical_axes)``: the JAX package's sharding
    constraint at a call site of the model. ``spec(axes)`` is the
    PartitionSpec JAX constrains ``x`` to there. The port computes each data
    row on its lead device with no tensor-parallel split, so the call
    returns ``x`` unchanged."""

    def __init__(self, rules: Dict[str, MeshAxes]):
        self.rules = rules

    def spec(self, axes) -> PartitionSpec:
        return P(*[self.rules.get(a) if a is not None else None for a in axes])

    def __call__(self, x, axes):
        return x


def make_constrain(cfg, mesh, batch_shardable: bool = True):
    """``constrain(x, logical_axes) -> x`` (see :class:`Constrain`); the
    identity with ``mesh=None``. ``batch_shardable=False`` replicates the
    batch axis (a decode batch that does not split over the data axes)."""
    if mesh is None:
        return no_constrain
    rules = activation_rules(cfg, mesh)
    if not batch_shardable:
        rules["batch"] = None
        rules["cache_batch"] = None
    return Constrain(rules)


def batch_specs(cfg, mesh) -> Dict[str, PartitionSpec]:
    """PartitionSpecs for input batches: the batch axis over the data axes."""
    dp = _data_axes(mesh)
    return {
        "tokens": P(dp, None),
        "labels": P(dp, None),
        "loss_mask": P(dp, None),
        "mask": P(dp, None),
        "patch_embeds": P(dp, None, None),
        "frames": P(dp, None, None),
    }


def data_only(spec) -> PartitionSpec:
    """``spec`` with every entry that names an axis other than the data
    axes replaced by None: the layout the port realizes for a batch, an
    activation or a decode cache, whose ``'model'`` split it does not
    compute."""
    def data(p):
        names = () if p is None else (p,) if isinstance(p, str) else p
        return bool(names) and all(a in ("pod", "data") for a in names)

    return P(*[p if data(p) else None for p in spec])


# --------------------------------------------------------------------------
# the render specs
# --------------------------------------------------------------------------

def camera_batch_pspec(mesh: RenderMesh) -> PartitionSpec:
    """The camera-batch axis lays over the mesh's data axes: lanes go to
    the data rows contiguously. Pad batches to :func:`data_extent` first."""
    return P(_data_axes(mesh))


def data_extent(mesh: RenderMesh) -> int:
    """The number of camera lanes (or batch rows) a mesh provides: the
    product of its data-axis extents."""
    out = 1
    for a in _data_axes(mesh):
        out *= mesh.shape[a]
    return out


def render_replicated_pspec() -> PartitionSpec:
    """Fully replicated (the background, and a scene that is not
    sharded)."""
    return P()


def scene_shard_pspec(mesh: RenderMesh) -> PartitionSpec:
    """A ``ShardedScene``'s leading shard axis over the ``'model'`` axis;
    on a mesh without one the shard axis stays logical."""
    if "model" in mesh.axis_names:
        return P("model")
    return P()


def feature_shard_pspec(mesh: RenderMesh) -> PartitionSpec:
    """Per-camera projected features in the per-shard layout lay over
    ``'model'`` like the scene they come from: each device holds its own
    N/D feature rows (the budget model's 1/D feature term)."""
    return scene_shard_pspec(mesh)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def _parts(spec, ndim: int) -> Tuple[MeshAxes, ...]:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has more entries than the {ndim} axes of its tensor")
    parts = tuple(spec) + (None,) * (ndim - len(spec))
    seen = []
    for p in parts:
        for a in (() if p is None else (p,) if isinstance(p, str) else p):
            if a in seen:
                raise ValueError(f"mesh axis {a!r} appears twice in {spec!r}")
            seen.append(a)
    return parts


def _axes_of(mesh, entry: MeshAxes) -> Tuple[str, ...]:
    names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    for a in names:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh axis {a!r} is not one of {mesh.axis_names}")
    return names


def _coords(sizes, pos) -> Dict[str, int]:
    """Position ``pos`` = (row, column) along each mesh axis: a row of a
    pod mesh is pod ``row // data``, data index ``row % data``."""
    data = sizes.get("data", 1)
    return {"pod": pos[0] // data, "data": pos[0] % data, "model": pos[1]}


def spec_regions(mesh: RenderMesh, spec, shape, positions) -> Dict[tuple, Region]:
    """Position -> the half-open index range of each axis that it holds of
    a tensor of ``shape`` under ``spec``, for each of ``positions``."""
    sizes = mesh.shape
    dims = []
    for d, (n, entry) in enumerate(zip(shape, _parts(spec, len(shape)))):
        names = _axes_of(mesh, entry)
        extent = math.prod(sizes[a] for a in names)
        if n % extent:
            raise ValueError(f"axis {d} of size {n} does not split over {entry!r} "
                             f"of extent {extent}")
        dims.append((names, n // extent))
    out = {}
    for pos in positions:
        coords = _coords(sizes, pos)
        region = []
        for names, step in dims:
            index = 0
            for a in names:
                index = index * sizes[a] + coords[a]
            region.append((index * step, (index + 1) * step))
        out[pos] = tuple(region)
    return out


def spec_region(mesh: RenderMesh, spec, shape, pos) -> Region:
    """The half-open index range of each axis that position ``pos`` holds
    of a tensor of ``shape`` under ``spec``."""
    return spec_regions(mesh, spec, shape, (pos,))[pos]


def _slices(region: Region, within: Optional[Region] = None) -> Tuple[slice, ...]:
    if within is None:
        return tuple(slice(lo, hi) for lo, hi in region)
    return tuple(slice(lo - w, hi - w) for (lo, hi), (w, _) in zip(region, within))


class MeshTensor:
    """A global tensor laid over a mesh: the port's counterpart of a
    ``jax.Array`` under ``NamedSharding(mesh, spec)``.

    ``pieces`` maps a mesh position (row, column) to the slice of the
    global tensor that position holds (:func:`spec_region`). Positions that
    hold the same slice on one device share one tensor. A tensor held only
    by some positions (a data row's activations or decode cache on its lead
    device, one unit of a stack sharded on its unit axis) lists only
    those. Not a tensor: read it with :func:`gather`."""

    __slots__ = ("shape", "dtype", "mesh", "spec", "pieces")

    def __init__(self, shape, dtype, mesh: RenderMesh, spec, pieces: Dict[tuple, torch.Tensor]):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.mesh = mesh
        self.spec = P(*spec)
        self.pieces = dict(pieces)

    def __repr__(self) -> str:
        return (f"MeshTensor(shape={self.shape}, dtype={self.dtype}, spec={self.spec!r}, "
                f"{len(self.distinct())} pieces)")

    def region(self, pos) -> Region:
        return spec_region(self.mesh, self.spec, self.shape, pos)

    def distinct(self) -> list:
        """[(position, region, tensor)] for each distinct tensor, at the
        first position that holds it (row-major)."""
        seen, out = set(), []
        for pos in self.mesh.positions:
            t = self.pieces.get(pos)
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out.append((pos, self.region(pos), t))
        return out

    def holders(self) -> Dict[Region, list]:
        """Region -> the positions holding it, row-major."""
        out: Dict[Region, list] = {}
        for pos in self.mesh.positions:
            if pos in self.pieces:
                out.setdefault(self.region(pos), []).append(pos)
        return out

    def replicas(self) -> Dict[Region, list]:
        """Region -> the distinct tensors holding it (several on distinct
        devices, one on a virtual mesh)."""
        return {region: list({id(self.pieces[p]): self.pieces[p] for p in ps}.values())
                for region, ps in self.holders().items()}

    def position_bytes(self) -> Dict[tuple, int]:
        """Bytes each position holds (a shared tensor counts at each)."""
        return {pos: t.numel() * t.element_size() for pos, t in self.pieces.items()}

    def unbind(self, dim: int = 0) -> list:
        """The global tensor's slices along axis 0, each a MeshTensor of
        views: each distinct piece is unbound once (autograd stacks its
        slices' gradients in one copy). A slice lists the positions whose
        piece covers it."""
        if dim != 0:
            raise ValueError("a MeshTensor unbinds along axis 0 only")
        parts = _parts(self.spec, len(self.shape))
        views = {id(t): (region[0][0], torch.unbind(t, 0)) for _, region, t in self.distinct()}
        out = []
        for i in range(self.shape[0]):
            pieces = {}
            for pos, t in self.pieces.items():
                lo, vs = views[id(t)]
                if lo <= i < lo + len(vs):
                    pieces[pos] = vs[i - lo]
            out.append(MeshTensor(self.shape[1:], self.dtype, self.mesh, P(*parts[1:]), pieces))
        return out

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the device of the first
        piece), differentiable. One piece of each region is read, the one on
        ``device`` where there is one; a whole tensor already there is
        returned as it is."""
        dev = torch.device(device) if device is not None else None
        chosen: Dict[Region, torch.Tensor] = {}
        for _, region, t in self.distinct():
            cur = chosen.get(region)
            if cur is None or (dev is not None and cur.device != dev and t.device == dev):
                chosen[region] = t
        if dev is None:
            dev = next(iter(chosen.values())).device
        moved = {r: t.to(dev) for r, t in chosen.items()}
        return _assemble(moved, len(self.shape), 0)


def _assemble(parts: Dict[Region, torch.Tensor], ndim: int, dim: int) -> torch.Tensor:
    """Concatenate the tensors of a grid of regions, axis by axis."""
    if dim == ndim or len(parts) == 1:
        return next(iter(parts.values()))
    groups: Dict[Tuple[int, int], Dict[Region, torch.Tensor]] = {}
    for region, t in parts.items():
        groups.setdefault(region[dim], {})[region] = t
    ordered = [_assemble(groups[k], ndim, dim + 1) for k in sorted(groups)]
    return ordered[0] if len(ordered) == 1 else torch.cat(ordered, dim=dim)


def place_tensor(x: torch.Tensor, mesh: RenderMesh, spec) -> MeshTensor:
    """``x`` copied over ``mesh`` as ``spec`` lays it out: a
    :class:`MeshTensor` whose pieces never alias ``x``, one copy per
    distinct device and slice."""
    copies: Dict[tuple, torch.Tensor] = {}
    pieces = {}
    for pos, region in spec_regions(mesh, spec, x.shape, mesh.positions).items():
        dev = mesh.grid[pos[0]][pos[1]]
        key = (region, dev)
        if key not in copies:
            copies[key] = x[_slices(region)].to(device=dev, copy=True).contiguous()
        pieces[pos] = copies[key]
    return MeshTensor(x.shape, x.dtype, mesh, spec, pieces)


def mesh_zeros(shape, dtype, mesh: RenderMesh, spec, rows_only: bool = False) -> MeshTensor:
    """A zero MeshTensor, each piece made on its own device (no global
    tensor is ever built; on ``meta``, shapes only). ``rows_only``: held by
    each data row's lead device only (a decode cache)."""
    copies: Dict[tuple, torch.Tensor] = {}
    pieces = {}
    positions = [(r, 0) for r in range(mesh.rows)] if rows_only else mesh.positions
    for pos, region in spec_regions(mesh, spec, shape, positions).items():
        dev = mesh.grid[pos[0]][pos[1]]
        key = (region, dev)
        if key not in copies:
            copies[key] = torch.zeros([hi - lo for lo, hi in region], dtype=dtype, device=dev)
        pieces[pos] = copies[key]
    return MeshTensor(shape, dtype, mesh, spec, pieces)


def row_tensor(mesh: RenderMesh, spec, rows: Iterable[torch.Tensor]) -> MeshTensor:
    """A MeshTensor held by each data row's lead device: row ``r``'s tensor
    is its slice under ``spec`` (data axes only), as a row's activations,
    step outputs and decode cache are held."""
    rows = list(rows)
    parts = _parts(spec, rows[0].dim())
    shape = list(rows[0].shape)
    for d, entry in enumerate(parts):
        if entry is not None:
            shape[d] *= math.prod(mesh.shape[a] for a in _axes_of(mesh, entry))
    return MeshTensor(shape, rows[0].dtype, mesh, spec,
                      {(r, 0): t for r, t in enumerate(rows)})


def gather(tree, device=None):
    """The inverse of :func:`place` on a tree of MeshTensors (nested dicts,
    lists, tuples, NamedTuples): each leaf's global tensor on ``device``."""
    return map_mesh(lambda m: m.gather(device), tree)


def map_mesh(fn, tree, *rest):
    """``tree`` with ``fn`` applied to every MeshTensor (or tensor) leaf of
    nested dicts, lists, tuples and NamedTuples; ``rest`` are trees of the
    same structure whose values at each leaf ``fn`` also takes."""
    if isinstance(tree, (MeshTensor, torch.Tensor)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_mesh(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_mesh(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


def position_bytes(tree) -> Dict[tuple, int]:
    """Bytes each mesh position holds over a tree of MeshTensors: what one
    physical card of such a mesh would hold."""
    total: Dict[tuple, int] = {}

    def add(m):
        for pos, n in m.position_bytes().items():
            total[pos] = total.get(pos, 0) + n

    map_mesh(add, tree)
    return total


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where an operand goes: a mesh and a spec (``NamedSharding``)."""

    mesh: RenderMesh
    spec: PartitionSpec

    @property
    def has_cuda(self) -> bool:
        return "cuda" in self.mesh.device_types


def place(tree, mesh: RenderMesh, spec: PartitionSpec):
    """Copy ``tree`` to the mesh as ``spec`` lays it out (see the module
    docstring). A tensor becomes a :class:`MeshTensor` under any spec
    (:func:`place_tensor`). A render operand returns a tuple: entry ``r``
    is the operand as data row ``r`` holds it (its lanes render against
    it). Under ``P('model')`` a ``ShardedScene`` whose shard count equals
    the model extent is split physically, shard ``d`` to column ``d``;
    with a model extent of 1 its shards stay logical on the lead device.
    Any other operand, or spec ``P()``, is replicated to each row's lead
    device."""
    if isinstance(tree, torch.Tensor):
        return place_tensor(tree, mesh, spec)

    from repro_torch.sharding.scene import ShardedScene

    copies: Dict[tuple, Any] = {}

    def to(key, x, device):
        k = (key, device)
        if k not in copies:
            copies[k] = tree_map(lambda t: t.to(device), x)
        return copies[k]

    rows = []
    physical = tuple(spec) == ("model",) and isinstance(tree, ShardedScene)
    if physical and mesh.columns not in (1, tree.num_shards):
        raise ValueError(
            f"a scene of {tree.num_shards} shards cannot lay over a model axis "
            f"of {mesh.columns}"
        )
    for r in range(mesh.rows):
        if physical and mesh.columns == tree.num_shards > 1:
            parts = tuple(to(("shard", d), tree.shard(d), mesh.grid[r][d])
                          for d in range(tree.num_shards))
            rows.append(ShardedScene(shards=parts, num_real=tree.num_real))
        else:
            rows.append(to("whole", tree, mesh.lead(r)))
    return tuple(rows)


# --------------------------------------------------------------------------
# collective traffic
# --------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter")

# The open record_collectives() logs, innermost last. A module-level stack,
# not a context variable: on a card autograd runs the backward (and a remat
# recompute) on a thread of its own, which must record too.
_LOGS: list = []


@contextlib.contextmanager
def record_collectives():
    """Within the block, the mesh steps add to the dict this yields ((kind,
    position) -> bytes, the kinds of :data:`COLLECTIVE_KINDS`) what each
    mesh position receives from the others, counted by position and not by
    device: a virtual or ``meta`` mesh copies nothing, and counts what a
    mesh of distinct cards would carry. A gather to a position receives the
    regions it does not hold (all-gather), its backward sends their
    gradients back (reduce-scatter); each position holding a replica of a
    gradient region takes the region's sum (all-reduce); ZeRO-1's refresh
    receives the state slices other positions updated (all-gather).
    Scalars (the loss, the norm) are not counted. :func:`per_device`
    reduces the log to one card's bytes."""
    log: Dict[tuple, int] = {}
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def collecting() -> bool:
    return bool(_LOGS)


def add_collective(kind: str, pos, nbytes: int, log: Optional[dict] = None) -> None:
    """Add ``nbytes`` of ``kind`` received at position ``pos`` to ``log``
    (by default the innermost open one, if any)."""
    if log is None:
        if not _LOGS:
            return
        log = _LOGS[-1]
    if nbytes:
        log[(kind, pos)] = log.get((kind, pos), 0) + int(nbytes)


def per_device(log) -> Dict[str, float]:
    """Collective bytes by kind at the position of ``log`` that receives
    the most in all (the first such in row-major order): what one card of
    the mesh carries. Keys of ``log`` that are not (kind, position) pairs
    are ignored."""
    totals: Dict[tuple, float] = {}
    for key, n in log.items():
        if isinstance(key, tuple):
            totals[key[1]] = totals.get(key[1], 0) + n
    top = max(sorted(totals), key=totals.get, default=None)
    return {k: log.get((k, top), 0) for k in COLLECTIVE_KINDS}


def region_bytes(region: Region, dtype: torch.dtype) -> int:
    return math.prod(hi - lo for lo, hi in region) * dtype.itemsize


def held_elsewhere(m: MeshTensor, pos) -> int:
    """Bytes of the regions of ``m`` that position ``pos`` does not hold:
    what a gather of ``m`` to ``pos`` receives."""
    own = m.region(pos) if pos in m.pieces else None
    regions = {m.region(p) for p in m.pieces}
    return sum(region_bytes(r, m.dtype) for r in regions if r != own)


class _ReduceScatterCount(torch.autograd.Function):
    """The identity; its backward adds ``nbytes`` of reduce-scatter at
    ``pos`` to the log that was open at the forward (the gradient of a
    gather going back to the shards it came from)."""

    @staticmethod
    def forward(ctx, x, log, pos, nbytes):
        ctx.log, ctx.pos, ctx.nbytes = log, pos, nbytes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        add_collective("reduce-scatter", ctx.pos, ctx.nbytes, ctx.log)
        return g, None, None, None


def gather_at(m: MeshTensor, pos, device=None, whole: Optional[torch.Tensor] = None):
    """``m.gather(device)`` for mesh position ``pos`` (``whole``: that
    gather made already, shared by positions on one device), counted inside
    :func:`record_collectives`: the regions ``pos`` does not hold as an
    all-gather at ``pos``, and where the result takes a gradient, the same
    bytes as a reduce-scatter when the backward reaches it (once per
    forward gather, however often a remat recompute gathers again)."""
    out = m.gather(device) if whole is None else whole
    nbytes = held_elsewhere(m, pos) if _LOGS else 0
    if nbytes:
        add_collective("all-gather", pos, nbytes)
        if out.requires_grad:
            out = _ReduceScatterCount.apply(out, _LOGS[-1], pos, nbytes)
    return out
