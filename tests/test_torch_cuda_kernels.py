"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card. Every test here is marked ``cuda`` and skips without one.

The module imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Inputs come from the port's own frontend on a seeded scene. Tolerances:
the bitmask kernel is bit-exact; the raster kernels blend sequentially
where the plain versions take a per-chunk cumprod, so images agree to 1e-5
and counters exactly at these sizes; the kernel backend matches the
reference backend the same way.
"""
import dataclasses
import functools
import math

import pytest
import torch

from repro_torch.core import camera, pipeline
from repro_torch.core.bitmask import generate_bitmasks
from repro_torch.core.gaussians import random_scene
from repro_torch.core.grouping import GridSpec
from repro_torch.kernels import build, ops
from repro_torch.kernels.bitmask_gen import bitmask_kernel, bitmask_plain
from repro_torch.kernels.layout import LANE, pack_features
from repro_torch.kernels.raster_tile import (
    raster_group_fused_kernel,
    raster_group_fused_plain,
    raster_tile_kernel,
    raster_tile_plain,
)
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

W, H = 256, 192
CFG = pipeline.RenderConfig(group_capacity=512, tile_capacity=256, span=4, chunk=32)


@functools.lru_cache(maxsize=None)
def _case(gf=4):
    """CPU frontend output of a seeded 3,000-gaussian scene."""
    scene = random_scene(3000, extent=3.0, generator=torch.Generator().manual_seed(4))
    cam = camera.make_camera((0.0, 1.2, 5.0), (0, 0, 0), W, H)
    cfg = dataclasses.replace(CFG, group=16 * gf)
    front = pipeline.render_frontend(scene, cam, cfg)
    grid = GridSpec(W, H, 16, 16 * gf, span=4)
    table = front.table
    feat = pack_features(front.proj, table.gauss_idx, table.entry_valid,
                         multiple=math.lcm(LANE, cfg.chunk))
    masks = generate_bitmasks(front.proj, table, grid, "ellipse").masks
    masks = torch.nn.functional.pad(masks, (0, feat.shape[-1] - masks.shape[1]))
    return scene, cam, grid, front, feat, masks


@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse"])
@pytest.mark.parametrize("gf", [2, 4])
def test_bitmask_kernel_bit_exact(cuda_device, method, gf):
    _, _, grid, _, feat, _ = _case(gf)
    args = (ops.group_origins(grid), ops.tiles_in_image(grid))
    want = bitmask_plain(feat, *args, 16, gf, method)
    before = build.LAUNCHES["bitmask_gen"]
    got = bitmask_kernel(feat.to(cuda_device), *(a.to(cuda_device) for a in args), 16, gf,
                         method)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bitmask_gen"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert bool(want.any())


@pytest.mark.parametrize(
    "gf,tile_capacity,early_exit,chunk",
    [(4, None, True, 32), (4, 7, True, 32), (2, None, False, 128), (4, 256, True, 128)],
)
def test_fused_raster_kernel_vs_plain(cuda_device, gf, tile_capacity, early_exit, chunk):
    _, _, grid, _, feat, masks = _case(gf)
    origins = ops.group_origins(grid)
    kw = dict(chunk=chunk, early_exit=early_exit, tile_capacity=tile_capacity)
    want, want_c = raster_group_fused_plain(feat, masks, origins, 16, gf, **kw)
    before = build.LAUNCHES["raster_group_fused"]
    got, got_c = raster_group_fused_kernel(
        feat.to(cuda_device), masks.to(cuda_device), origins.to(cuda_device), 16, gf, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["raster_group_fused"] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got_c.cpu(), want_c)


@pytest.mark.parametrize("tile,early_exit", [(16, True), (16, False), (32, True), (64, True)])
def test_tile_raster_kernel_vs_plain(cuda_device, tile, early_exit):
    """tile 32 and 64 run 4 and 16 pixels per thread (group_baseline's
    groups-as-tiles case)."""
    _, _, _, _, feat, _ = _case()
    feat = feat[:12]
    origins = torch.stack([torch.arange(12) % 4, torch.arange(12) // 4], -1).float() * tile
    want, want_c = raster_tile_plain(feat, origins, tile, chunk=32, early_exit=early_exit)
    got, got_c = raster_tile_kernel(feat.to(cuda_device), origins.to(cuda_device), tile,
                                    chunk=32, early_exit=early_exit)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got_c.cpu(), want_c)


def test_kernels_refuse_bad_inputs(cuda_device):
    _, _, grid, _, feat, masks = _case()
    f = feat.to(cuda_device)
    origins = ops.group_origins(grid, cuda_device)
    with pytest.raises(ValueError):
        raster_group_fused_kernel(f[:, :, :100], masks[:, :100].to(cuda_device), origins,
                                  16, 4, chunk=32)   # K not a multiple of chunk
    with pytest.raises(ValueError):
        raster_tile_kernel(f.transpose(1, 2).contiguous().transpose(1, 2), origins, 16)
    with pytest.raises(ValueError):
        bitmask_kernel(f, origins, ops.tiles_in_image(grid, cuda_device), 16, 4,
                       "ellipse_opacity")


@pytest.mark.parametrize("mode", ["gstg", "tile_baseline", "group_baseline"])
def test_cuda_backend_matches_reference_on_the_card(cuda_device, mode):
    scene, cam, _, _, _, _ = _case()
    scene = scene.to(cuda_device)
    cfg = dataclasses.replace(CFG, mode=mode)
    ref = pipeline.render(scene, cam, cfg)
    build.reset_launches()
    got = pipeline.render(scene, cam, dataclasses.replace(cfg, backend="cuda"))
    torch.cuda.synchronize()
    kernels = ("bitmask_gen", "raster_group_fused") if mode == "gstg" else ("raster_tile",)
    assert all(build.LAUNCHES[k] == 1 for k in kernels), build.LAUNCHES
    torch.testing.assert_close(got.image, ref.image, atol=1e-5, rtol=1e-5)
    assert got.stats.as_dict() == ref.stats.as_dict()


def test_gstg_bitwise_equals_tile_baseline_on_the_card(cuda_device):
    """Losslessness through the CUDA kernels: masked-out entries multiply T
    by exactly 1, so the fused kernel reproduces the tile kernel bit for
    bit when no list is cut."""
    scene, cam, _, _, _, _ = _case()
    scene = scene.to(cuda_device)
    cfg = dataclasses.replace(CFG, backend="cuda")
    ours = pipeline.render(scene, cam, cfg)
    base = pipeline.render(scene, cam, dataclasses.replace(cfg, mode="tile_baseline"))
    for stats in (ours.stats.as_dict(), base.stats.as_dict()):
        assert stats["overflow"] == 0 and stats["span_overflow"] == 0
    assert torch.equal(ours.image, base.image)
