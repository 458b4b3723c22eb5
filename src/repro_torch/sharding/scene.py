"""Canonical padded/sharded layout of the Gaussian axis (mirror of
``repro.sharding.scene``, DESIGN.md §10).

``ShardedScene`` is the layout every scene-sharded entry point agrees on:
the Gaussian axis is padded up to a multiple of the shard count and reshaped
to a leading ``(D, N_pad // D)`` shard axis, gaussian-contiguous (shard ``d``
holds global gaussians ``[d * shard_size, (d + 1) * shard_size)``).
Contiguity is load-bearing: the stable cross-shard merge
(``core/grouping.py::merge_bin_tables``) rebuilds the replicated
(depth, insertion-order) tie-break from shard-major concatenation order,
which equals global gaussian order only for this layout.

Padding rows are real (finite, NaN-free) gaussians that projection culls:
opacity logit ``PAD_OPACITY`` puts their alpha far below the 1/255
visibility cutoff, so ``Projected.valid`` is False and every counter sees
exactly the unpadded scene.

On one device the shard axis is logical: the shards are rows of one tensor
(the stacked form). Placed over a mesh's ``'model'`` axis
(``sharding/policies.py::place``) the shards are physical: one
``GaussianScene`` per shard, each on its own device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.core.gaussians import SCENE_FIELDS, GaussianScene
from repro_torch.utils import cdiv

# Opacity logit for padding rows: sigmoid(-30) ~ 9e-14 << 1/255, so padded
# gaussians fail the visible_alpha cull and never reach identification.
PAD_OPACITY = -30.0

# Per-field padding fill. Everything but opacity pads with zeros (a zero
# quaternion normalizes to the identity rotation under the norm guard; zero
# scales and means are finite): the opacity logit alone guarantees the cull.
_PAD_FILL = {"opacity": PAD_OPACITY}


@dataclasses.dataclass
class ShardedScene:
    """A GaussianScene in the canonical padded/sharded layout.

    ``shards`` holds either the ordinary scene tensors with a leading
    ``(D, Ns)`` shard axis (the stacked form, on one device), or a tuple of
    D ``(Ns, ...)`` scenes, each on its own device (the physical form);
    ``num_real`` is the unpadded gaussian count. Built by
    :func:`shard_scene` or :func:`shard_scene_host`, and placed physically
    by ``sharding/policies.py::place``.
    """

    shards: Union[GaussianScene, Tuple[GaussianScene, ...]]
    num_real: int           # gaussians before padding

    @property
    def physical(self) -> bool:
        """Whether the shards are separate scenes (one per device)."""
        return isinstance(self.shards, tuple)

    @property
    def num_shards(self) -> int:
        if self.physical:
            return len(self.shards)
        return self.shards.means3d.shape[0]

    @property
    def shard_size(self) -> int:
        if self.physical:
            return self.shards[0].means3d.shape[0]
        return self.shards.means3d.shape[1]

    @property
    def num_gaussians(self) -> int:
        """Unpadded count (mirrors GaussianScene.num_gaussians)."""
        return self.num_real

    @property
    def padded_size(self) -> int:
        return self.num_shards * self.shard_size

    @property
    def device(self) -> torch.device:
        """The device of shard 0 (the lead device of a physical layout)."""
        return self.shard(0).device

    def shard(self, d: int) -> GaussianScene:
        """Shard ``d`` as a plain ``(Ns, ...)`` scene (views, no copy)."""
        if self.physical:
            return self.shards[d]
        return GaussianScene(**{f: getattr(self.shards, f)[d] for f in SCENE_FIELDS})

    def stacked(self) -> GaussianScene:
        """The stacked ``(D, Ns, ...)`` form, on shard 0's device."""
        if not self.physical:
            return self.shards
        dev = self.device
        return GaussianScene(**{
            f: torch.stack([getattr(s, f).to(dev) for s in self.shards]) for f in SCENE_FIELDS
        })

    def to(self, device) -> "ShardedScene":
        """The stacked form on ``device``."""
        return ShardedScene(shards=self.stacked().to(device), num_real=self.num_real)


SceneLike = Union[GaussianScene, ShardedScene]


def _shard(scene: GaussianScene, num_shards: int, fetch) -> ShardedScene:
    """Pad every field of ``fetch(scene tensor)`` to ``D * Ns`` rows and
    reshape it to ``(D, Ns, ...)``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    n = scene.num_gaussians
    if n < 1:
        raise ValueError("cannot shard an empty scene")
    size = cdiv(n, num_shards)
    pad = size * num_shards - n

    def prep(name: str) -> torch.Tensor:
        x = fetch(getattr(scene, name))
        if pad:
            fill = torch.full((pad,) + tuple(x.shape[1:]), _PAD_FILL.get(name, 0.0),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, fill], dim=0)
        return x.reshape(num_shards, size, *x.shape[1:])

    return ShardedScene(shards=GaussianScene(**{f: prep(f) for f in SCENE_FIELDS}),
                        num_real=n)


def shard_scene(scene: GaussianScene, num_shards: int) -> ShardedScene:
    """Pad + reshape a scene into the canonical gaussian-contiguous layout,
    on the scene's device. ``render()`` calls it when handed a plain scene
    with ``cfg.scene_shards > 1``; autograd flows through it."""
    return _shard(scene, num_shards, lambda x: x)


def shard_scene_host(scene: GaussianScene, num_shards: int) -> ShardedScene:
    """:func:`shard_scene` built as CPU tensors: the staging step of the
    engine handle's scene-layout cache (``serving/sharded.py``). The layout
    is bitwise the one :func:`shard_scene` builds (pad and reshape are pure
    layout); ``.to(device)`` moves it to the card."""
    return _shard(scene, num_shards, lambda x: x.detach().cpu())


def scene_flat(scene: ShardedScene) -> GaussianScene:
    """The padded flat ``(D * Ns, ...)`` view of a sharded scene.

    ``scene_flat(shard_scene(s, d))`` equals ``s`` on the first
    ``s.num_gaussians`` rows bitwise; the tail is cull-guaranteed padding.
    """
    stacked = scene.stacked()
    return GaussianScene(**{f: getattr(stacked, f).flatten(0, 1) for f in SCENE_FIELDS})


def unshard_scene(scene: ShardedScene) -> GaussianScene:
    """Invert :func:`shard_scene`: flatten and drop the padding rows."""
    flat = scene_flat(scene)
    return GaussianScene(**{f: getattr(flat, f)[: scene.num_real] for f in SCENE_FIELDS})
