"""Step functions for train / prefill / decode, on one device or over a
mesh (mirror of ``repro.launch.steps``).

``make_train_step`` keeps the JAX step's order: the loss and its gradient,
clipping by the global norm, then AdamW (weight decay 0.01) or Adafactor on
a linear-warmup cosine schedule. Where the JAX step is jitted with its
parameters and optimizer state donated, the port's step updates them in
place under ``torch.no_grad()``, leaf by leaf (a slice of a leaf at a time),
and the clipped gradient overwrites the gradient: it never holds a second
copy of the parameters or the state.

**Over a mesh** (a ``('data', 'model')`` :class:`RenderMesh` from
``launch/mesh.py::make_host_mesh``, or a ``('pod', 'data', 'model')`` one
from ``make_production_mesh``, whose data rows are pod x data; one process
drives every device, and a device may be listed more than once) the steps
take trees of
``MeshTensor`` (``sharding/policies.py``): the parameters placed under
:func:`param_pspecs` (:func:`place_params`), the optimizer state under
:func:`zero1_axis` (:func:`init_opt_state`), the decode cache held by each
data row's lead device (:func:`mesh_cache`). Batches are global tensors,
split over the data rows as ``sharding/policies.py::batch_specs`` lays them
out.

* Each data row computes its slice of the batch on its lead device. The
  port realizes no tensor-parallel compute over ``'model'``: the
  ``constrain`` hook returns its tensor unchanged there, and
  :func:`make_unit_constrain` gathers one unit's shards (over ``'model'``,
  and over the data axes under FSDP) onto the row's device inside the unit
  loop, under remat recomputed in the backward. Its backward sends each
  slice of a unit's gradient back to the shard it came from, summed over
  the rows: the one-process reduce-scatter of JAX's ``_fsdp_reshard``.
  Non-unit leaves (embedding, head, final norm) are gathered once a step.
* The loss is JAX's function of the whole batch: the rows' masked
  cross-entropy sums and mask counts are added before the division, and
  the MoE load-balance loss is built from every row's expert counts and
  router probabilities (``models/moe.py::global_load_balance_loss``). One
  backward runs through every row.
* Replicas of a parameter slice on distinct devices add their gradients
  (the all-reduce) before the norm, which counts each element once.
* ZeRO-1 (AdamW): each state shard updates its slice of the parameter on
  its own device; replicas of the parameter on other devices then copy the
  slices they did not update (the all-gather). Adafactor gathers each leaf
  (a unit slice of a stacked one) whole, so its factored row and column
  statistics are the whole leaf's, and writes the results back to every
  shard.
* ``make_decode_step``'s ``weight_gather`` is accepted for the JAX
  signature and ignored: a mesh decode step always gathers each unit's
  weights onto the row's device, which is what JAX's ``weight_gather=True``
  does and its default ``False`` avoids (the port has no tensor-parallel
  compute to keep the weights sharded for). ``cache_seq`` (and any
  ``'model'`` entry of the cache spec) is not realized: each row's cache
  lives whole on its lead device, where its decode runs.

* Inside ``sharding/policies.py::record_collectives`` the steps count,
  where each of these copies is made, the bytes it brings to each mesh
  position from the others, by collective kind (the dry run's stand-in for
  XLA's collectives).

``optim/compression.py::compressed_psum`` all-reduces over a
``torch.distributed`` process group; a one-process mesh has none (its
reductions are copies between devices and adds), and neither package calls
it from a step.

``abstract_{params,opt_state,batch,cache}`` give a cell's inputs as
MeshTensor trees of zeros on the mesh's devices (the ``meta``
device in a dry run), and :func:`jit_for_cell` the step and its inputs for
one (arch x shape) cell: nothing is jitted or compiled (``launch/dryrun.py``
runs the step on ``meta``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.launch.mesh import RenderMesh
from repro_torch.launch.shapes import ShapeCell
from repro_torch.models import build_cache_spec, build_param_spec, decode_step, forward
from repro_torch.models import loss_fn, loss_parts
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _unbind_units
from repro_torch.models.moe import global_load_balance_loss, record_router_stats
from repro_torch.models.spec import (
    abstract_from_spec,
    is_leaf,
    partition_from_spec,
    spec_bytes,
    torch_dtype,
)
from repro_torch.optim import (
    adafactor_update_,
    adamw_update_,
    clip_by_global_norm_,
    linear_warmup_cosine,
)
from repro_torch.optim.adafactor import AdafactorState, FactoredLeaf, leaf_update, stacked
from repro_torch.optim.adamw import AdamWState, adamw_piece_, adamw_scalars
from repro_torch.optim.grad_utils import add_squares
from repro_torch.sharding.policies import (
    MeshTensor,
    P,
    PartitionSpec,
    _slices,
    activation_rules,
    add_collective,
    batch_specs,
    collecting,
    data_only,
    gather_at,
    make_constrain,
    map_mesh,
    mesh_zeros,
    param_rules,
    place_tensor,
    region_bytes,
    row_tensor,
)
from repro_torch.utils import tree_flatten, tree_map

ADAFACTOR_THRESHOLD = 50_000_000_000  # >=50B params -> factored optimizer


def pick_optimizer(cfg: ModelConfig) -> str:
    return "adafactor" if cfg.param_count() >= ADAFACTOR_THRESHOLD else "adamw"


# --------------------------------------------------------------------------
# sharding helpers
# --------------------------------------------------------------------------

def _dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


FSDP_THRESHOLD_BYTES = 2 << 30  # per-device weight bytes above which weights
                                # are also sharded over the data axes (FSDP)


def use_fsdp(cfg: ModelConfig, mesh) -> bool:
    """FSDP decision: tensor parallelism alone must leave < 2 GiB of weights
    a device, else the weights are sharded over the data axes too.
    ``cfg.force_fsdp`` pins the decision."""
    if cfg.force_fsdp is not None:
        return cfg.force_fsdp
    per_dev = spec_bytes(build_param_spec(cfg)) / mesh.shape["model"]
    return per_dev > FSDP_THRESHOLD_BYTES


def _zip_leaves(fn, spec, *trees):
    """``fn(leaf, *values)`` over a LeafSpec tree and trees of its shape
    (PartitionSpecs are tuples, so they are leaves here)."""
    if is_leaf(spec):
        return fn(spec, *trees)
    return {k: _zip_leaves(fn, spec[k], *(t[k] for t in trees)) for k in spec}


def param_pspecs(cfg: ModelConfig, mesh, fsdp: Optional[bool] = None):
    """The parameters' PartitionSpecs: the rules of ``param_rules``, and
    under FSDP each leaf's first free dimension over the data axes too."""
    spec = build_param_spec(cfg)
    base = partition_from_spec(spec, param_rules(cfg, mesh))
    if fsdp is None:
        fsdp = use_fsdp(cfg, mesh)
    if not fsdp:
        return base
    return _zip_leaves(lambda l, ps: zero1_axis(l, ps, mesh), spec, base)


def zero1_axis(leaf, pspec, mesh) -> PartitionSpec:
    """ZeRO-1: additionally shard optimizer state over the data axes on the
    first free (unsharded, divisible) dimension of each leaf (anything with
    a ``shape``)."""
    dp = _dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    parts = list(pspec) + [None] * (len(leaf.shape) - len(pspec))
    # Already data-sharded (e.g. FSDP params feeding optimizer states): keep.
    flat = []
    for pp in parts:
        flat.extend(pp if isinstance(pp, tuple) else (pp,))
    if any(a in flat for a in dp):
        return P(*parts)
    for i, (dim, cur) in enumerate(zip(leaf.shape, parts)):
        if cur is None and dim % dp_size == 0 and dim >= dp_size:
            parts[i] = dp
            return P(*parts)
    return P(*parts)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


class UnitConstrain:
    """``unit_constrain(unit_params, row=0)``: one unit's weights gathered
    whole onto data row ``row``'s lead device, differentiably (each slice's
    gradient goes back to the shard it came from). ``compute`` and
    ``storage`` hold the JAX package's per-unit specs of each leaf (its
    ``drop_lead`` of the base and the stored specs); the port computes on
    the gathered weights whatever they say."""

    def __init__(self, mesh, compute, storage):
        self.mesh = mesh
        self.compute = compute
        self.storage = storage

    def __call__(self, unit_params, row: int = 0):
        dev = self.mesh.lead(row)
        return map_mesh(lambda m: gather_at(m, (row, 0), dev) if isinstance(m, MeshTensor) else m,
                        unit_params)

    def row(self, r: int):
        return functools.partial(self, row=r)


def make_unit_constrain(cfg: ModelConfig, mesh) -> UnitConstrain:
    """The per-unit gather FSDP runs inside the unit loop (see
    :class:`UnitConstrain`)."""
    spec = build_param_spec(cfg)
    base = partition_from_spec(spec, param_rules(cfg, mesh))["units"]
    stored = param_pspecs(cfg, mesh)["units"]
    drop_lead = lambda ps: P(*list(ps)[1:])  # noqa: E731  (axis 0: the unit axis)
    return UnitConstrain(mesh, _map_specs(drop_lead, base), _map_specs(drop_lead, stored))


def _check_mesh(mesh) -> RenderMesh:
    if not isinstance(mesh, RenderMesh) or mesh.axis_names not in (
            ("data", "model"), ("pod", "data", "model")):
        raise ValueError("the LM steps run over a ('data', 'model') or ('pod', 'data', "
                         f"'model') RenderMesh, not {mesh!r}")
    return mesh


def place_params(cfg: ModelConfig, mesh: RenderMesh, params):
    """``params`` (a tree of tensors) copied over ``mesh`` under
    :func:`param_pspecs` (FSDP as :func:`use_fsdp` decides): a tree of
    MeshTensors."""
    specs = param_pspecs(cfg, mesh)
    return _zip_leaves(lambda _, x, s: place_tensor(x, mesh, s),
                       build_param_spec(cfg), params, specs)


def _opt_leaf_specs(pm: MeshTensor, optimizer: str, mesh):
    """The state specs of one parameter: ZeRO-1's for AdamW's moments; for
    Adafactor, JAX's factored specs (rows, columns, and the full spec of an
    unfactored leaf)."""
    if optimizer == "adamw":
        return zero1_axis(pm, pm.spec, mesh)
    parts = list(pm.spec) + [None] * (len(pm.shape) - len(pm.spec))
    if len(pm.shape) >= 2:
        return FactoredLeaf(vr=P(*parts[:-1]), vc=P(*(parts[:-2] + parts[-1:])), v=P(None))
    return FactoredLeaf(vr=P(None), vc=P(None), v=P(*parts))


def init_opt_state(params, optimizer: str):
    """The zeroed optimizer state of placed ``params``, each shard made on
    its own device: AdamW's float32 moments under :func:`zero1_axis` of the
    parameter's spec (ZeRO-1), or Adafactor's factored statistics under the
    JAX package's specs."""
    def adam(pm):
        return mesh_zeros(pm.shape, torch.float32, pm.mesh, _opt_leaf_specs(pm, "adamw", pm.mesh))

    if optimizer == "adamw":
        return AdamWState(mu=map_mesh(adam, params), nu=map_mesh(adam, params))

    def fac(pm):
        specs = _opt_leaf_specs(pm, optimizer, pm.mesh)
        shapes = ((pm.shape[:-1], pm.shape[:-2] + pm.shape[-1:], (1,)) if len(pm.shape) >= 2
                  else ((1,), (1,), pm.shape))
        return FactoredLeaf(*(mesh_zeros(s, torch.float32, pm.mesh, sp)
                              for s, sp in zip(shapes, specs)))

    return AdafactorState(stats=map_mesh(fac, params))


def mesh_cache(cfg: ModelConfig, mesh: RenderMesh, batch: int, max_seq: int,
               batch_shardable: bool = True):
    """The zeroed decode cache over ``mesh``: each data row's lead device
    holds its rows of the batch (the whole batch when it does not split),
    whole along the other axes (``data_only`` of JAX's cache spec)."""
    rules = activation_rules(cfg, _check_mesh(mesh))
    if not batch_shardable:
        rules = dict(rules, batch=None, cache_batch=None)
    cspec = build_cache_spec(cfg, batch, max_seq)
    specs = partition_from_spec(cspec, rules)
    return _zip_leaves(
        lambda l, s: mesh_zeros(l.shape, torch_dtype(l.dtype), mesh, data_only(s),
                                rows_only=True), cspec, specs)


def _leaves(tree) -> list:
    out = []
    map_mesh(out.append, tree)
    return out


def _split_rows(mesh: RenderMesh, x, shardable: bool = True) -> list:
    """Each data row's part of a batch tensor (a global tensor, or a
    MeshTensor held by the rows), on the row's lead device."""
    if isinstance(x, MeshTensor):
        if all((r, 0) in x.pieces for r in range(mesh.rows)) and x.mesh == mesh:
            return [x.pieces[(r, 0)].to(mesh.lead(r)) for r in range(mesh.rows)]
        x = x.gather(mesh.lead(0))
    if not shardable:
        return [x.to(mesh.lead(r)) for r in range(mesh.rows)]
    if x.shape[0] % mesh.rows:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {mesh.rows} data rows")
    n = x.shape[0] // mesh.rows
    return [x[r * n:(r + 1) * n].to(mesh.lead(r)) for r in range(mesh.rows)]


def _row_batches(mesh: RenderMesh, batch, shardable: bool = True) -> list:
    parts = {k: _split_rows(mesh, v, shardable) for k, v in batch.items()}
    return [{k: v[r] for k, v in parts.items()} for r in range(mesh.rows)]


def _row_params(params, mesh: RenderMesh, r: int, shared: dict):
    """Row ``r``'s view of the parameters: every leaf outside the unit
    stack gathered onto its lead device, the units left as MeshTensors for
    the unit loop's gather. ``shared`` (a dict kept over one step) gives
    rows on one lead device one gather, and the units one unbinding: the
    rows' gradients then add into one buffer per unit and stack once."""
    dev = mesh.lead(r)
    if dev not in shared:
        shared[dev] = {k: v if k == "units" else map_mesh(lambda m: m.gather(dev), v)
                       for k, v in params.items()}
        if "units" not in shared:
            shared["units"] = _unbind_units(params["units"], _n_units(params["units"]))
        shared[dev]["units"] = shared["units"]
    if not collecting():
        return shared[dev]
    # each row receives its gather, shared on one device or not
    return {k: w if k == "units" else map_mesh(
                lambda m, g: gather_at(m, (r, 0), whole=g), params[k], w)
            for k, w in shared[dev].items()}


def _n_units(units) -> int:
    return _leaves(units)[0].shape[0]


def _distinct_tensors(tree) -> list:
    seen, out = set(), []
    for m in _leaves(tree):
        for _, _, t in m.distinct():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _with_pieces(m: MeshTensor, by_id) -> MeshTensor:
    return MeshTensor(m.shape, m.dtype, m.mesh, m.spec,
                      {pos: by_id[id(t)] for pos, t in m.pieces.items()})


@torch.no_grad()
def _all_reduce_replicas(grads) -> None:
    """Replicas of a slice each take the sum of their gradients (in
    position order, so every replica on a distinct device holds the same
    bits): an all-reduce of the slice at each position holding it."""
    for m in _leaves(grads):
        for region, ps in m.holders().items():
            if len(ps) < 2:
                continue
            for pos in ps:
                add_collective("all-reduce", pos, region_bytes(region, m.dtype))
            reps = list({id(m.pieces[p]): m.pieces[p] for p in ps}.values())
            if len(reps) > 1:
                total = reps[0].clone()
                for t in reps[1:]:
                    total += t.to(total.device)
                for t in reps:
                    t.copy_(total)


@torch.no_grad()
def _clip_(grads, max_norm: float, lead) -> torch.Tensor:
    """Global-norm clipping over the mesh: each slice counted once (one
    replica of each region), the sum on the mesh's lead device."""
    total = torch.zeros((), dtype=torch.float32, device=lead)
    for m in _leaves(grads):
        for reps in m.replicas().values():
            part = add_squares(torch.zeros((), dtype=torch.float32, device=reps[0].device), reps[0])
            total = total + part.to(lead)
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for t in _distinct_tensors(grads):
        t.mul_(scale.to(device=t.device, dtype=t.dtype))
    return norm


def _inside(inner, outer) -> bool:
    return all(o0 <= i0 and i1 <= o1 for (i0, i1), (o0, o1) in zip(inner, outer))


@torch.no_grad()
def _adamw_zero1_(params, grads, state: AdamWState, step, lr, weight_decay: float) -> None:
    """AdamW over ZeRO-1 state: each distinct state shard updates its slice
    of the parameter piece at its position (on that piece's device); then
    each replica of a parameter slice copies in the state slices another
    replica updated (the all-gather, at each position receiving a slice
    it did not update)."""
    scalars = {}

    def on(dev):
        if dev not in scalars:
            scalars[dev] = adamw_scalars(step, lr, dev)
        return scalars[dev]

    for pm, gm, mm, vm in zip(_leaves(params), _leaves(grads), _leaves(state.mu),
                              _leaves(state.nu), strict=True):
        done, updated, owner = set(), set(), {}
        for pos in pm.mesh.positions:
            m = mm.pieces[pos]
            if id(m) in done:
                continue
            done.add(id(m))
            p, preg, sreg = pm.pieces[pos], pm.region(pos), mm.region(pos)
            if not _inside(sreg, preg):
                raise ValueError(f"state slice {sreg} is outside its parameter slice {preg}")
            sl = _slices(sreg, preg)
            adamw_piece_(p[sl], gm.pieces[pos][sl], m, vm.pieces[pos], on(p.device),
                         weight_decay=weight_decay)
            updated.add((id(p), sreg))
            owner.setdefault(sreg, (p, preg))
        for pos in pm.mesh.positions:
            p, preg, own = pm.pieces[pos], pm.region(pos), mm.region(pos)
            for sreg, (src, src_reg) in owner.items():
                if not _inside(sreg, preg):
                    continue
                if sreg != own:
                    add_collective("all-gather", pos, region_bytes(sreg, pm.dtype))
                if (id(p), sreg) not in updated:
                    p[_slices(sreg, preg)].copy_(src[_slices(sreg, src_reg)])
                    updated.add((id(p), sreg))


@torch.no_grad()
def _scatter_(m: MeshTensor, full: torch.Tensor, src_pos) -> None:
    """Write the global tensor ``full``, made at position ``src_pos``, into
    every distinct piece of ``m``: each other position receives its region
    (an all-gather there)."""
    done = set()
    for pos, t in m.pieces.items():
        region = m.region(pos)
        if pos != src_pos:
            add_collective("all-gather", pos, region_bytes(region, m.dtype))
        if id(t) in done:
            continue
        done.add(id(t))
        src = full[_slices(region)]
        if src.data_ptr() != t.data_ptr():
            t.copy_(src)


@torch.no_grad()
def _adafactor_whole_(params, grads, state: AdafactorState, step, lr) -> None:
    """Adafactor over a mesh: each leaf (each unit slice of a stacked leaf)
    gathered whole on its first shard's device, updated with the one-device
    arithmetic (``optim/adafactor.py::leaf_update``), and written back to
    every shard of the parameter and of its statistics."""
    def one(pm, gm, s: FactoredLeaf):
        first, _, lead = pm.distinct()[0]
        dev = lead.device
        whole = FactoredLeaf(*(gather_at(x, first, dev) for x in s))
        new_p, new_s = leaf_update(gather_at(pm, first, dev), gather_at(gm, first, dev), whole,
                                   step, lr=lr)
        _scatter_(pm, new_p, first)
        for mt, old, new in zip(s, whole, new_s):
            if new is not old:
                _scatter_(mt, new, first)

    for pm, gm, s in zip(_leaves(params), _leaves(grads), _leaves_factored(state.stats),
                         strict=True):
        if not stacked(pm.shape):
            one(pm, gm, s)
            continue
        units = zip(pm.unbind(0), gm.unbind(0), s.vr.unbind(0), s.vc.unbind(0))
        for p_i, g_i, vr_i, vc_i in units:
            one(p_i, g_i, FactoredLeaf(vr=vr_i, vc=vc_i, v=s.v))


def _leaves_factored(stats) -> list:
    out = []

    def walk(t):
        if isinstance(t, FactoredLeaf):
            out.append(t)
        else:
            for k in t:
                walk(t[k])

    walk(stats)
    return out


# --------------------------------------------------------------------------
# step functions
# --------------------------------------------------------------------------

def make_train_step(
    cfg: ModelConfig,
    mesh=None,
    optimizer: Optional[str] = None,
    lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    clip_norm: float = 1.0,
):
    """(train_step, optimizer name). ``train_step(params, opt_state, batch,
    step)`` returns (params, opt_state, {'loss', 'ce', 'aux', 'grad_norm'})
    with the parameters and state updated in place (the same objects) and
    the metrics as float32 scalar tensors on the parameters' device (over a
    mesh, the mesh's lead device; ``grad_norm`` before clipping). Over a
    mesh the parameters and state are MeshTensor trees (module
    docstring)."""
    optimizer = optimizer or pick_optimizer(cfg)
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    schedule = linear_warmup_cosine(lr, warmup, total_steps)
    if mesh is not None:
        return _mesh_train_step(cfg, _check_mesh(mesh), optimizer, schedule, clip_norm), optimizer

    def train_step(params, opt_state, batch, step):
        leaves = tree_flatten(params)[0]
        before = [p.requires_grad for p in leaves]
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss, metrics = loss_fn(cfg, params, batch)
                flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p, r in zip(leaves, before):
                p.requires_grad_(r)
        # A leaf the loss does not reach (an audio encoder's token table) gets
        # a zero gradient, as jax.grad gives it.
        by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, flat)}
        del flat
        grads = tree_map(lambda p: by_id[id(p)], params)
        gnorm = clip_by_global_norm_(grads, clip_norm)
        if optimizer == "adamw":
            adamw_update_(params, grads, opt_state, step, lr=schedule, weight_decay=0.01)
        else:
            adafactor_update_(params, grads, opt_state, step, lr=schedule)
        out_metrics = {
            "loss": loss.detach(),
            "ce": metrics["ce"].detach(),
            "aux": metrics["aux"].detach(),
            "grad_norm": gnorm,
        }
        return params, opt_state, out_metrics

    return train_step, optimizer


def _mesh_train_step(cfg: ModelConfig, mesh: RenderMesh, optimizer: str, schedule, clip_norm):
    constrain = make_constrain(cfg, mesh)
    uc = make_unit_constrain(cfg, mesh)
    lead = mesh.lead(0)

    def train_step(params, opt_state, batch, step):
        rows = _row_batches(mesh, batch)
        pieces = _distinct_tensors(params)
        before = [p.requires_grad for p in pieces]
        try:
            with torch.enable_grad():
                for p in pieces:
                    p.requires_grad_(True)
                nll = count = None
                stats, shared = [], {}
                for r, row_batch in enumerate(rows):
                    with record_router_stats() as sink:
                        n_r, c_r, _ = loss_parts(cfg, _row_params(params, mesh, r, shared),
                                                 row_batch, constrain, uc.row(r))
                    nll = n_r.to(lead) if nll is None else nll + n_r.to(lead)
                    count = c_r.to(lead) if count is None else count + c_r.to(lead)
                    stats.append(sink)
                ce = nll / torch.clamp(count, min=1.0)
                aux = global_load_balance_loss(stats, cfg.n_experts, lead)
                loss = ce + cfg.router_aux_weight * aux
                flat = torch.autograd.grad(loss, pieces, allow_unused=True)
        finally:
            for p, r in zip(pieces, before):
                p.requires_grad_(r)
        by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(pieces, flat)}
        del flat
        grads = map_mesh(lambda m: _with_pieces(m, by_id), params)
        del by_id
        _all_reduce_replicas(grads)
        gnorm = _clip_(grads, clip_norm, lead)
        if optimizer == "adamw":
            _adamw_zero1_(params, grads, opt_state, step, schedule, weight_decay=0.01)
        else:
            _adafactor_whole_(params, grads, opt_state, step, schedule)
        return params, opt_state, {"loss": loss.detach(), "ce": ce.detach(),
                                   "aux": aux.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch)``: the next-token logits (B, V) of the
    last position (the full frame-level logits for an encoder); over a mesh
    a MeshTensor held by the data rows."""
    if mesh is None:
        def prefill_step(params, batch):
            logits, _aux = forward(cfg, params, batch)
            if cfg.family == "encoder":
                return logits          # full frame-level logits (504-way)
            return logits[:, -1, :]    # TTFT: next-token logits only

        return prefill_step

    mesh = _check_mesh(mesh)
    constrain = make_constrain(cfg, mesh)
    uc = make_unit_constrain(cfg, mesh)
    dp = _dp_axes(mesh)

    def mesh_prefill_step(params, batch):
        outs, shared = [], {}
        for r, row_batch in enumerate(_row_batches(mesh, batch)):
            logits, _aux = forward(cfg, _row_params(params, mesh, r, shared), row_batch,
                                   constrain, uc.row(r))
            outs.append(logits if cfg.family == "encoder" else logits[:, -1, :])
        spec = P(dp, None, None) if cfg.family == "encoder" else P(dp, None)
        return row_tensor(mesh, spec, outs)

    return mesh_prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, batch_shardable: bool = True,
                     weight_gather: bool = False):
    """``serve_step(params, cache, tokens, pos)`` -> (next tokens, cache),
    the cache updated in place (the JAX step donates it). Over a mesh the
    cache comes from :func:`mesh_cache` with the same ``batch_shardable``,
    and the next tokens are a MeshTensor held by the data rows; a row whose
    cache is another row's (an unsplit batch on one device) is computed
    once. ``weight_gather`` is ignored (module docstring): over a mesh each
    unit's weights are gathered to the row's device on every token."""
    if mesh is None:
        def serve_step(params, cache, tokens, pos):
            next_tokens, _logits, cache = decode_step(cfg, params, cache, tokens, pos)
            return next_tokens, cache

        return serve_step

    mesh = _check_mesh(mesh)
    constrain = make_constrain(cfg, mesh, batch_shardable=batch_shardable)
    uc = make_unit_constrain(cfg, mesh)
    spec = P(_dp_axes(mesh)) if batch_shardable else P(None)

    def mesh_serve_step(params, cache, tokens, pos):
        toks = _split_rows(mesh, tokens, batch_shardable)
        outs, computed, shared = [], {}, {}
        for r in range(mesh.rows):
            row_cache = map_mesh(lambda m: m.pieces[(r, 0)], cache)
            key = id(_leaves(row_cache)[0])
            if key in computed:
                outs.append(outs[computed[key]])
                continue
            computed[key] = r
            nxt, _logits, _ = decode_step(cfg, _row_params(params, mesh, r, shared), row_cache,
                                          toks[r], pos, constrain, uc.row(r))
            outs.append(nxt)
        return row_tensor(mesh, spec, outs), cache

    return mesh_serve_step


# --------------------------------------------------------------------------
# a cell's inputs, and its step
# --------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, mesh: RenderMesh):
    """The parameters as :func:`place_params` lays them out, from
    ``abstract_from_spec``'s shapes and dtypes: a tree of MeshTensors under
    :func:`param_pspecs`, each piece made (zeros) on its position's device."""
    spec = build_param_spec(cfg)
    return _zip_leaves(lambda _, a, s: mesh_zeros(a.shape, a.dtype, mesh, s),
                       spec, abstract_from_spec(spec), param_pspecs(cfg, mesh))


def abstract_opt_state(cfg: ModelConfig, mesh: RenderMesh, optimizer: str, zero1: bool = True):
    """:func:`init_opt_state` of :func:`abstract_params`: AdamW's float32
    moments under ZeRO-1, or Adafactor's factored statistics, under the JAX
    package's specs. ``zero1`` keeps the JAX signature; ZeRO-1 is the
    port's only layout of AdamW's state, as it is in every JAX step, so
    ``False`` is refused."""
    if not zero1:
        raise ValueError("the port lays AdamW's state out under ZeRO-1 only")
    return init_opt_state(abstract_params(cfg, mesh), optimizer)


def abstract_batch(cfg: ModelConfig, shape: ShapeCell, mesh: RenderMesh):
    """A cell's global batch as MeshTensors under ``batch_specs`` (the batch
    axis over the data axes). Token ids and labels are int64, the index
    dtype torch gathers with, where the JAX package's are int32; patch
    embeddings and frames are bfloat16, as there."""
    B, S = shape.global_batch, shape.seq_len
    specs = batch_specs(cfg, mesh)
    act = torch.bfloat16
    if cfg.frontend == "vision_stub":
        s_text = S - cfg.n_frontend_tokens
        shapes = {"tokens": ((B, s_text), torch.int64), "labels": ((B, s_text), torch.int64),
                  "patch_embeds": ((B, cfg.n_frontend_tokens, cfg.d_model), act)}
    elif cfg.frontend == "audio_stub":
        shapes = {"frames": ((B, S, cfg.d_model), act), "labels": ((B, S), torch.int64)}
    else:
        shapes = {"tokens": ((B, S), torch.int64), "labels": ((B, S), torch.int64)}
    return {k: mesh_zeros(shp, dt, mesh, specs[k]) for k, (shp, dt) in shapes.items()}


def _batch_shardable(shape: ShapeCell, mesh) -> bool:
    """Whether the cell's batch splits over the mesh's data axes."""
    dp_size = 1
    for a in _dp_axes(mesh):
        dp_size *= mesh.shape[a]
    return shape.global_batch % dp_size == 0


def abstract_cache(cfg: ModelConfig, shape: ShapeCell, mesh: RenderMesh):
    """The decode cache of a cell as :func:`mesh_cache` lays it out: JAX's
    cache specs (the batch replicated where it does not split,
    :func:`_batch_shardable`) with their ``'model'`` entries dropped, each
    data row's part held whole by its lead device."""
    return mesh_cache(cfg, mesh, shape.global_batch, shape.seq_len,
                      _batch_shardable(shape, mesh))


def jit_for_cell(cfg: ModelConfig, shape: ShapeCell, mesh: RenderMesh,
                 optimizer: Optional[str] = None):
    """(step_fn, kwargs) for one (arch x shape) cell, as the JAX package's
    function returns them: ``step_fn(**kwargs)`` runs the cell's step over
    ``mesh`` on the ``abstract_*`` inputs (zeros on the mesh's
    devices; on ``meta`` the step computes shapes only). Nothing is jitted,
    compiled or donated, where JAX's returns a jitted function: the name is
    kept so that a reader finds the counterpart, and the steps update their
    state in place. Train: :func:`pick_optimizer`'s state under ZeRO-1 and
    the step number 0; prefill: the batch without labels; decode: tokens,
    position 0 and the cache, the batch replicated where it does not split
    over the data axes."""
    if shape.kind == "train":
        optimizer = optimizer or pick_optimizer(cfg)
        step_fn, _ = make_train_step(cfg, mesh, optimizer=optimizer)
        return step_fn, dict(params=abstract_params(cfg, mesh),
                             opt_state=abstract_opt_state(cfg, mesh, optimizer),
                             batch=abstract_batch(cfg, shape, mesh), step=0)
    if shape.kind == "prefill":
        batch = abstract_batch(cfg, shape, mesh)
        batch.pop("labels", None)
        return make_prefill_step(cfg, mesh), dict(params=abstract_params(cfg, mesh), batch=batch)
    if shape.kind == "decode":
        shardable = _batch_shardable(shape, mesh)
        tokens = mesh_zeros((shape.global_batch,), torch.int64, mesh,
                            P(_dp_axes(mesh)) if shardable else P(None))
        return make_decode_step(cfg, mesh, batch_shardable=shardable), dict(
            params=abstract_params(cfg, mesh), cache=abstract_cache(cfg, shape, mesh),
            tokens=tokens, pos=0)
    raise ValueError(shape.kind)


def abstract_inputs_for_cell(cfg: ModelConfig, shape: ShapeCell, mesh: RenderMesh,
                             optimizer: Optional[str] = None):
    """Back-compat shim: (step_fn, kwargs), as :func:`jit_for_cell`."""
    return jit_for_cell(cfg, shape, mesh, optimizer)
