"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card. Every test here is marked ``cuda`` and skips without one.

The module imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Inputs come from the port's own frontend on a seeded scene, or from seeded
numpy for the sort and for the odd raster shapes. Tolerances: the bitmask
and bitonic kernels are bit-exact; the raster kernels blend sequentially
where the plain versions take a per-chunk cumprod, so images agree to 1e-5
and counters exactly at these sizes; the fused raster kernel gives the tile
kernel's rgb and counters bit for bit over the compacted lists of the same
table (all four rows without early exit); the kernel backend matches the
reference backend the same way; the engine handle's batch and futures
paths are bitwise equal to its single render. Against the dense oracles of
``kernels/ref.py`` (run on the host): BGM words bit for bit, images within
1e-4 with NaN in the same places (a kernel stops a tile whose pixels all
fall below T = 1e-4 and keeps its T, where the oracle multiplies on),
sorted keys equal (rows with NaN excepted: the network places NaN by its
own order) and each row's (key, payload) pairs equal as a multiset.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.core import camera, pipeline
from repro_torch.core.bitmask import GroupBitmasks, compact_tiles, generate_bitmasks
from repro_torch.core.gaussians import random_scene
from repro_torch.core.grouping import GridSpec
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.bitmask_gen import bitmask_kernel, bitmask_plain, edge_case_block
from repro_torch.kernels.bitonic_sort import (
    bitonic_sort_kernel,
    bitonic_sort_plain,
    edge_case_rows,
)
from repro_torch.kernels.layout import (
    F_CONIC_A,
    F_CONIC_C,
    F_OPACITY,
    F_VALID,
    LANE,
    pack_features,
)
from repro_torch.kernels.raster_tile import (
    TILE_WINDOW,
    edge_case_lists,
    raster_group_fused_kernel,
    raster_group_fused_plain,
    raster_tile_kernel,
    raster_tile_plain,
    tile_kernel_shape,
)
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

W, H = 256, 192
CFG = pipeline.RenderConfig(group_capacity=512, tile_capacity=256, span=4, chunk=32)


@functools.lru_cache(maxsize=None)
def _case(gf=4, tile=16, gaussians=3000, capacity=512, chunk=32):
    """CPU frontend output of a seeded scene (3,000 gaussians unless asked)."""
    scene = random_scene(gaussians, extent=3.0, generator=torch.Generator().manual_seed(4))
    cam = camera.make_camera((0.0, 1.2, 5.0), (0, 0, 0), W, H)
    cfg = dataclasses.replace(CFG, tile=tile, group=tile * gf, group_capacity=capacity,
                              chunk=chunk)
    front = pipeline.render_frontend(scene, cam, cfg)
    grid = GridSpec(W, H, tile, tile * gf, span=4)
    table = front.table
    feat = pack_features(front.proj, table.gauss_idx, table.entry_valid,
                         multiple=math.lcm(LANE, cfg.chunk))
    masks = generate_bitmasks(front.proj, table, grid, "ellipse").masks
    masks = torch.nn.functional.pad(masks, (0, feat.shape[-1] - masks.shape[1]))
    return scene, cam, grid, front, feat, masks


@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse"])
@pytest.mark.parametrize("gf", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_bitmask_kernel_bit_exact(cuda_device, tile, gf, method):
    """Every compiled instance (gf 1-5 x method) on scene lists at tiles of
    8, 16 and 32 px; at 32 px and gf 3-5 some member tiles lie outside the
    image."""
    _, _, grid, _, feat, _ = _case(gf, tile)
    args = (ops.group_origins(grid), ops.tiles_in_image(grid))
    want = bitmask_plain(feat, *args, tile, gf, method)
    before = build.LAUNCHES["bitmask_gen"]
    got = bitmask_kernel(feat.to(cuda_device), *(a.to(cuda_device) for a in args), tile, gf,
                         method)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bitmask_gen"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert bool(want.any())


@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse"])
@pytest.mark.parametrize("gf", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("tile", [8, 16])
def test_bitmask_kernel_edge_cases(cuda_device, tile, gf, method):
    """The package's edge-case block (means on and one ulp off tile lines,
    q = 9 exactly, degenerate and huge shapes, NaN and inf, subnormals,
    member tiles outside the image, origins up to 2**24 and below 0): every
    word bitwise the plain version's."""
    feat, origins, in_img = edge_case_block(gf, tile, torch.Generator().manual_seed(7))
    want = bitmask_plain(feat, origins, in_img, tile, gf, method)
    got = bitmask_kernel(feat.to(cuda_device), origins.to(cuda_device),
                         in_img.to(cuda_device), tile, gf, method)
    assert torch.equal(got.cpu(), want)
    assert bool(want.any()) and not bool(want.all())


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


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("tile_capacity", [None, 7])
@pytest.mark.parametrize("gf", [2, 4])
def test_fused_raster_kernel_bitwise_vs_tile_kernel(cuda_device, gf, tile_capacity, chunk,
                                                    early_exit):
    """The tile kernel over compact_tiles of the same table and masks is the
    fused kernel's oracle: rgb and counters bit for bit; the transmittance
    too without early exit (with it, each kernel stops at a chunk boundary
    of its own list, which only T shows)."""
    _, _, grid, front, feat, masks = _case(gf)
    table, dev = front.table, cuda_device
    cap = table.capacity if tile_capacity is None else tile_capacity
    ttable = compact_tiles(table, GroupBitmasks(masks[:, :table.capacity], None), grid, cap)
    tfeat = pack_features(front.proj, ttable.gauss_idx, ttable.entry_valid,
                          multiple=math.lcm(LANE, chunk))
    got, got_c = raster_group_fused_kernel(
        feat.to(dev), masks.to(dev), ops.group_origins(grid, dev), 16, gf, chunk=chunk,
        early_exit=early_exit, tile_capacity=tile_capacity)
    want, want_c = raster_tile_kernel(tfeat.to(dev), ops.tile_origins(grid, dev), 16,
                                      chunk=chunk, early_exit=early_exit)
    gtile, in_image = ops.member_tiles(grid, dev)
    rows = 3 if early_exit else 4
    mine, oracle = got[in_image][:, :rows], want[gtile[in_image].long()][:, :rows]
    assert torch.equal(_bits(mine), _bits(oracle))
    assert torch.equal(got_c[in_image], want_c[gtile[in_image].long()])
    outside = got[~in_image]
    assert (outside[:, :3] == 0).all() and (outside[:, 3] == 1).all()
    assert (got_c[~in_image] == 0).all()
    assert int(want_c[:, 1].sum()) > 0


@pytest.mark.parametrize("chunk", [32, 128])
def test_fused_raster_kernel_opaque_tiles_stop_where_plain_does(cuda_device, chunk):
    """Every opacity 0.99 and splats ten times wider, so member tiles die
    mid-list. The final transmittance is compared relatively (rtol 1e-4): a
    tile that stopped one chunk early or late would be off by the factors of
    the entries in between. (atol 1e-30 only admits the float32 subnormals
    that T reaches by then, where the cumprod and the sequential product
    keep different bits.)"""
    _, _, grid, _, feat, masks = _case(4)
    feat = feat.clone()
    feat[:, F_OPACITY] = torch.where(feat[:, F_VALID] > 0.5, 0.99, 0.0)
    feat[:, F_CONIC_A:F_CONIC_C + 1] *= 0.01
    origins = ops.group_origins(grid)
    want, want_c = raster_group_fused_plain(feat, masks, origins, 16, 4, chunk=chunk)
    got, got_c = raster_group_fused_kernel(feat.to(cuda_device), masks.to(cuda_device),
                                           origins.to(cuda_device), 16, 4, chunk=chunk)
    got = got.cpu()
    dead = (want[:, :, 3] <= 1e-4).all(-1)
    assert int(dead.sum()) > 0
    torch.testing.assert_close(got[:, :, :3], want[:, :, :3], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[:, :, 3], want[:, :, 3], atol=1e-30, rtol=1e-4)
    assert torch.equal(got_c.cpu(), want_c)


@pytest.mark.parametrize(
    "tile_px,gf,early_exit",
    [(32, 2, True), (64, 2, True), (8, 4, True), (4, 4, False), (6, 3, True), (16, 5, True),
     (16, 1, False)],
)
def test_fused_raster_kernel_odd_shapes_vs_plain(cuda_device, tile_px, gf, early_exit):
    """Shapes off the main path: tiles of 8 and 32 warps (32 and 64 px, a
    group split over 4 blocks at 64 px), one warp at 2 or 1 pixels a thread
    (8 px), tiles that leave part of a warp idle (4 and 6 px), 25 member
    tiles (two blocks) and one member tile. Seeded random masks over the
    _case features."""
    _, _, _, _, feat, _ = _case()
    G, K = 6, feat.shape[-1]
    feat = feat[:G].contiguous()
    rng = np.random.default_rng(tile_px * 100 + gf)
    masks = torch.from_numpy(rng.integers(0, 2 ** (gf * gf), (G, K), dtype=np.int64)
                             .astype(np.int32))
    origins = torch.tensor([[(g % 3) * 64 + 8.0, (g // 3) * 64 + 8.0] for g in range(G)])
    kw = dict(chunk=32, early_exit=early_exit, tile_capacity=None)
    want, want_c = raster_group_fused_plain(feat, masks, origins, tile_px, gf, **kw)
    got, got_c = raster_group_fused_kernel(feat.to(cuda_device), masks.to(cuda_device),
                                           origins.to(cuda_device), tile_px, gf, **kw)
    torch.cuda.synchronize()
    assert got.shape == (G, gf * gf, 4, tile_px * tile_px)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got_c.cpu(), want_c)
    assert int(want_c[..., 1].sum()) > 0


@pytest.mark.parametrize("early_exit", [True, False])
def test_raster_kernels_at_chunk_2048(cuda_device, early_exit):
    """chunk 2048 on lists of up to 2,444 entries (20,000 gaussians, group
    capacity 4096): the tile kernel stages a chunk in pieces of 1,024 and
    votes on early exit only at the chunk's start. Both kernels against
    their plain versions, the tile kernel also over the group lists as
    64-px tiles (lists that span several pieces), and the fused kernel
    against the tile kernel over the compacted lists, bit for bit. Against
    plain: T within 1e-4 relative, so a stop one piece early would show;
    rgb within 1e-4 and counter totals within 1e-5 relative, as chip_smoke
    holds the main frame, since on lists this long an entry can flip at
    the T_before > 1e-4 gate (moving its pixels by at most alpha * 1e-4)."""
    chunk, dev = 2048, cuda_device
    _, _, grid, front, feat, masks = _case(gaussians=20000, capacity=4096, chunk=chunk)
    assert int(front.table.lengths.max()) > 1024 and int(front.table.overflow) == 0
    f, m, origins = feat.to(dev), masks.to(dev), ops.group_origins(grid, dev)
    kw = dict(chunk=chunk, early_exit=early_exit)

    def check(got, want):
        (out, counts), (want_out, want_counts) = got, want
        torch.testing.assert_close(out[..., :3, :], want_out[..., :3, :], atol=1e-4, rtol=0)
        torch.testing.assert_close(out[..., 3, :], want_out[..., 3, :], atol=1e-30, rtol=1e-4)
        total = counts.reshape(-1, 2).sum(0).double()
        want_total = want_counts.reshape(-1, 2).sum(0).double()
        assert bool(((total - want_total).abs() <= 1e-5 * want_total).all())
        assert int(want_total[1]) > 0

    fused = raster_group_fused_kernel(f, m, origins, 16, 4, **kw)
    check(fused, raster_group_fused_plain(f, m, origins, 16, 4, **kw))
    check(raster_tile_kernel(f, origins, 64, **kw), raster_tile_plain(f, origins, 64, **kw))
    table = front.table
    ttable = compact_tiles(table, GroupBitmasks(masks[:, :table.capacity], None), grid,
                           table.capacity)
    tfeat = pack_features(front.proj, ttable.gauss_idx, ttable.entry_valid,
                          multiple=math.lcm(LANE, chunk)).to(dev)
    torigins = ops.tile_origins(grid, dev)
    tile = raster_tile_kernel(tfeat, torigins, 16, **kw)
    check(tile, raster_tile_plain(tfeat, torigins, 16, **kw))
    gtile, in_image = ops.member_tiles(grid, dev)
    rows = 3 if early_exit else 4
    mine, oracle = fused[0][in_image][:, :rows], tile[0][gtile[in_image].long()][:, :rows]
    assert torch.equal(_bits(mine), _bits(oracle))
    assert torch.equal(fused[1][in_image], tile[1][gtile[in_image].long()])


@pytest.mark.parametrize(
    "tile,early_exit,chunk",
    [
        pytest.param(16, True, 32, id="16-True"),
        pytest.param(16, False, 32, id="16-False"),
        pytest.param(32, True, 32, id="32-True"),
        pytest.param(64, True, 32, id="64-True"),
        pytest.param(16, True, 256, id="16-True-chunk256"),
        pytest.param(16, True, 2048, id="16-True-chunk2048"),
        pytest.param(16, False, 2048, id="16-False-chunk2048"),
        pytest.param(8, True, 32, id="8-True"),
        pytest.param(8, False, 32, id="8-False"),
    ],
)
def test_tile_raster_kernel_vs_plain(cuda_device, tile, early_exit, chunk):
    """tile 8 runs one warp at 2 pixels a thread, 16 two warps at 4, 32
    eight warps at 4 and 64 sixteen warps at 8 (group_baseline's
    groups-as-tiles case). Chunk 256 spans four windows; chunk 2048 runs on
    the 20,000-gaussian lists of up to 2,444 entries (K = 4096), where no
    window is a vote point."""
    if chunk == 2048:
        _, _, _, _, feat, _ = _case(gaussians=20000, capacity=4096, chunk=chunk)
    else:
        _, _, _, _, feat, _ = _case()
    feat = feat[:12]
    origins = torch.stack([torch.arange(12) % 4, torch.arange(12) // 4], -1).float() * tile
    want, want_c = raster_tile_plain(feat, origins, tile, chunk=chunk, early_exit=early_exit)
    got, got_c = raster_tile_kernel(feat.to(cuda_device), origins.to(cuda_device), tile,
                                    chunk=chunk, early_exit=early_exit)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got_c.cpu(), want_c)
    assert int(want_c[:, 1].sum()) > 0


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("chunk", [32, TILE_WINDOW, 2048])
@pytest.mark.parametrize("tile", [4, 6, 8, 12, 16, 32, 48, 64])
def test_tile_raster_kernel_edge_cases(cuda_device, tile, chunk, early_exit):
    """The package's edge_case_lists: lists that end at a window boundary
    and one entry past it, interior opacity <= 0 and NaN, an empty list,
    tiles that die inside a window and from their first chunk, at chunks
    below, at and past the window. Tiles 4, 6, 12 and 48 are not a whole
    number of warps x pixels a thread (1, 2, 4 and 8 pixels a thread with
    idle slots). rgb within 1e-5, T within 1e-4 relative (a stop one chunk
    early or late would show), NaN in the same places, counters equal."""
    feat, origins = edge_case_lists(tile, chunk, torch.Generator().manual_seed(3))
    want, want_c = raster_tile_plain(feat, origins, tile, chunk, early_exit)
    before = build.LAUNCHES["raster_tile"]
    got, got_c = raster_tile_kernel(feat.to(cuda_device), origins.to(cuda_device), tile,
                                    chunk, early_exit)
    torch.cuda.synchronize()
    assert build.LAUNCHES["raster_tile"] == before + 1
    got = got.cpu()
    torch.testing.assert_close(got[:, :3], want[:, :3], atol=1e-5, rtol=0, equal_nan=True)
    torch.testing.assert_close(got[:, 3], want[:, 3], atol=1e-30, rtol=1e-4, equal_nan=True)
    assert torch.equal(got_c.cpu(), want_c)


@pytest.mark.parametrize("tile,threads,npix,full", [
    (4, 32, 1, False), (6, 32, 2, False), (8, 32, 2, True), (12, 64, 4, False),
    (16, 64, 4, True), (32, 256, 4, True), (48, 512, 8, False), (64, 512, 8, True)])
def test_tile_kernel_shape(cuda_device, tile, threads, npix, full):
    """The launch the CUDA source picks: warps enough for 4 pixels a thread,
    at most 16, and its window is the one edge_case_lists places its seams
    by."""
    assert tile_kernel_shape(tile) == {"block_threads": threads, "pixels_per_thread": npix,
                                       "full": full, "window_entries": TILE_WINDOW}


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


def _sort_case(G, K, seed):
    """Seeded keys with many ties (drawn from a small set, ±0.0 among them),
    +inf padding at the end of each row, and a permuted index payload."""
    rng = np.random.default_rng(seed)
    pool = np.array([-2.5, -0.0, 0.0, 0.5, 1.0, 7.25, np.inf], np.float32)
    keys = pool[rng.integers(0, pool.size, (G, K))]
    live = rng.integers(0, K + 1, G)
    keys[np.arange(K)[None, :] >= live[:, None]] = np.inf
    payload = np.stack([rng.permutation(K) for _ in range(G)]).astype(np.float32)
    return torch.from_numpy(keys), torch.from_numpy(payload)


@pytest.mark.parametrize("G,K", [(5, 1), (5, 2), (6, 1024), (4, 8192), (3, 16384), (2, 65536)])
def test_bitonic_kernel_bitwise(cuda_device, G, K):
    """K = 65536 runs the global-memory passes for the stages wider than a
    block's shared-memory span."""
    keys, payload = _sort_case(G, K, seed=K)
    want_k, want_v = bitonic_sort_plain(keys, payload)
    before = build.LAUNCHES["bitonic_sort"]
    got_k, got_v = bitonic_sort_kernel(keys.to(cuda_device), payload.to(cuda_device))
    torch.cuda.synchronize()
    assert build.LAUNCHES["bitonic_sort"] == before + 1
    assert torch.equal(got_k.cpu().view(torch.int32), want_k.view(torch.int32))
    assert torch.equal(got_v.cpu().view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_k.cpu(), torch.sort(keys, dim=-1).values)


def test_bitonic_kernel_edge_cases(cuda_device):
    keys = torch.tensor([[3.0, -0.0, 0.0, float("inf"), 3.0, -1.0, 0.0, float("inf")]])
    payload = torch.arange(8, dtype=torch.float32)[None]
    want = bitonic_sort_plain(keys, payload)
    got = bitonic_sort_kernel(keys.to(cuda_device), payload.to(cuda_device))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
    empty = torch.empty((0, 64), device=cuda_device)
    out_k, out_v = bitonic_sort_kernel(empty, empty)
    assert out_k.shape == out_v.shape == (0, 64)


@pytest.mark.parametrize("K", [2**p for p in range(17)])
def test_bitonic_kernel_on_edge_case_rows(cuda_device, K):
    """The package's edge_case_rows (NaN, ±0.0, all +inf, all equal, sorted
    either way, live lengths 0, 1 and K) at every K from one lane to four
    blocks' spans: keys and payload bitwise equal to the plain network."""
    keys, payload = edge_case_rows(K, torch.Generator().manual_seed(K))
    want = bitonic_sort_plain(keys, payload)
    got = bitonic_sort_kernel(keys.to(cuda_device), payload.to(cuda_device))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


ORACLE_IMAGE_TOL = 1e-4


def _pairs(keys, payload):
    """Each row's (payload, key) bit patterns, sorted: the row as a multiset."""
    kb = keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    vb = payload.contiguous().view(torch.int32).to(torch.int64)
    return torch.sort((vb << 32) | kb, dim=-1).values


def test_kernels_hold_to_their_dense_oracles(cuda_device):
    """The four kernels on the card against kernels/ref.py on the host, on
    the seeded frame's tables and the package's edge-case builders."""
    _, _, grid, _, feat, masks = _case(gf=4)
    origins, in_img = ops.group_origins(grid), ops.tiles_in_image(grid)
    dev = cuda_device
    for method in ("aabb", "obb", "ellipse"):
        got = bitmask_kernel(feat.to(dev), origins.to(dev), in_img.to(dev), grid.tile, grid.gf,
                             method)
        assert torch.equal(got.cpu(), ref.ref_bitmask(feat, origins, in_img, grid.tile, grid.gf,
                                                      method)), method
        block = edge_case_block(3, 8, torch.Generator().manual_seed(7))
        got = bitmask_kernel(*(x.to(dev) for x in block), 8, 3, method)
        assert torch.equal(got.cpu(), ref.ref_bitmask(*block, 8, 3, method)), method

    def close(got, want):
        assert torch.equal(got.isnan(), want.isnan())
        assert float((got - want).abs().nan_to_num(0.0).max()) <= ORACLE_IMAGE_TOL

    out, _ = raster_group_fused_kernel(feat.to(dev), masks.to(dev), origins.to(dev), grid.tile,
                                       grid.gf, chunk=32)
    close(out.cpu(), ref.ref_raster_group_fused(feat, masks, origins, grid.tile, grid.gf))
    for tile_px, chunk in ((8, 32), (16, TILE_WINDOW), (12, 2048)):
        f_e, o_e = edge_case_lists(tile_px, chunk, torch.Generator().manual_seed(3))
        out, _ = raster_tile_kernel(f_e.to(dev), o_e.to(dev), tile_px, chunk)
        close(out.cpu(), ref.ref_raster_tiles(f_e, o_e, tile_px))
        ones = torch.ones(f_e.shape[0], f_e.shape[2], dtype=torch.int32)
        out, _ = raster_group_fused_kernel(f_e.to(dev), ones.to(dev), o_e.to(dev), tile_px, 1,
                                           chunk)
        close(out.cpu(), ref.ref_raster_group_fused(f_e, ones, o_e, tile_px, 1))
    for keys, payload in (_sort_case(4, 8192, seed=1), edge_case_rows(1024, torch.Generator()
                                                                      .manual_seed(10))):
        got_k, got_v = (x.cpu() for x in bitonic_sort_kernel(keys.to(dev), payload.to(dev)))
        want_k, want_v = ref.ref_sort(keys, payload)
        clean = ~keys.isnan().any(-1)
        assert torch.equal(got_k[clean], want_k[clean])
        assert torch.equal(_pairs(got_k, got_v), _pairs(want_k, want_v))


def test_bitonic_kernel_refuses_bad_inputs(cuda_device):
    keys = torch.zeros((2, 100), device=cuda_device)
    with pytest.raises(ValueError, match="power-of-two"):
        bitonic_sort_kernel(keys, keys)
    keys = torch.zeros((2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        bitonic_sort_kernel(keys, keys.to(torch.int32))
    with pytest.raises(ValueError, match="float32"):
        bitonic_sort_kernel(keys.double(), keys)


def test_engine_batch_and_submit_bitwise_on_the_card(cuda_device):
    """render_batch lanes and submit() results equal render(cam_i) bit for
    bit on the cuda backend; four submits go out as one dispatch."""
    scene, _, _, _, _, _ = _case()
    cams = camera.orbit_cameras(4, 5.0, W, H)
    cfg = dataclasses.replace(CFG, backend="cuda")
    with engine.open(scene, cfg, device=cuda_device, max_batch=4, max_wait=60.0) as r:
        singles = [r.render(c) for c in cams]
        batch = r.render_batch(cams, pad_to=4)
        futs = [r.submit(c) for c in cams]
        results = [f.result(timeout=60) for f in futs]
        stats = r.stats()
    for i, one in enumerate(singles):
        assert torch.equal(batch.image[i], one.image)
        assert torch.equal(results[i].image, one.image.cpu())
        for name, value in one.stats.as_dict().items():
            assert int(getattr(batch.stats, name)[i]) == value
            assert int(getattr(results[i].stats, name)) == value
    assert (stats["submitted"], stats["completed"], stats["batches"]) == (4, 4, 1)


@pytest.mark.parametrize("shards", [3, 7])
@pytest.mark.parametrize("mode", ["gstg", "tile_baseline"])
def test_scene_sharded_render_bitwise_on_the_card(cuda_device, mode, shards):
    """D logical shards on the cuda backend (3,000 gaussians: 3 shards of
    1,000, or 7 of 429 with 3 padding rows) render bitwise like one, through
    render and a handle committed on a host-staged layout; the sharded gstg
    frame launches the BGM and the fused RM once each, tile_baseline the
    tile RM once."""
    from repro_torch.sharding import shard_scene_host

    scene, cam, _, _, _, _ = _case()
    cfg = dataclasses.replace(CFG, mode=mode, backend="cuda")
    scene = scene.to(cuda_device)
    one = pipeline.render(scene, cam, cfg)
    build.reset_launches()
    sharded = pipeline.render(scene, cam, dataclasses.replace(cfg, scene_shards=shards))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    with engine.open(shard_scene_host(scene, shards).to(cuda_device), cfg,
                     device=cuda_device) as r:
        committed = r.render(cam)
        assert r.scene_shards == shards and r.stats()["feature_gather"] == "index"
    for got in (sharded, committed):
        assert torch.equal(got.image, one.image)
        assert got.stats.as_dict() == one.stats.as_dict()
    kernels = ("bitmask_gen", "raster_group_fused") if mode == "gstg" else ("raster_tile",)
    assert all(launches[k] == 1 for k in kernels), launches


@pytest.mark.parametrize("shards", [1, 3])
def test_timed_render_bitwise_on_the_card(cuda_device, shards):
    """RenderConfig(timing=True) on the cuda backend: image and every counter
    bitwise the untimed render's at D = 1 and 3, through render and a
    handle; all seven stage spans (merge too when sharded) nest under the
    umbrella and validate; the timed frame launches the BGM and the fused RM
    once each."""
    from repro_torch.obs import Tracer, get_tracer, set_tracer, validate_chrome_trace

    scene, cam, _, _, _, _ = _case()
    scene = scene.to(cuda_device)
    cfg = dataclasses.replace(CFG, backend="cuda", scene_shards=shards)
    timed = dataclasses.replace(cfg, timing=True)
    want = pipeline.render(scene, cam, cfg)
    prev = set_tracer(Tracer(enabled=False))
    try:
        build.reset_launches()
        outs = [pipeline.render(scene, cam, timed)]
        launches = dict(build.LAUNCHES)
        with engine.open(scene, timed, device=cuda_device) as r:
            outs.append(r.render(cam))
        tracer = get_tracer()
        names = {e.name for e in tracer.events() if e.category == "stage"}
        errs = validate_chrome_trace(tracer.chrome_trace())
    finally:
        set_tracer(prev)
    for got in outs:
        assert torch.equal(got.image, want.image)
        assert got.stats.as_dict() == want.stats.as_dict()
    stages = {"stage/project", "stage/identify", "stage/bin", "stage/bitmask",
              "stage/compact", "stage/rasterize", "stage/render"}
    assert names == stages | ({"stage/merge"} if shards > 1 else set())
    assert errs == []
    assert launches["bitmask_gen"] == 1 and launches["raster_group_fused"] == 1, launches


def test_server_with_eviction_bitwise_on_the_card(cuda_device):
    """A RenderServer on the card over two scenes whose budget holds one:
    every image bitwise the handle's render of its camera, at least one
    eviction, and every image bitwise an unbudgeted server's; each gstg
    lane (padded lanes too) launches the BGM and the fused RM once."""
    from repro_torch.serving import RenderRequest, RenderServer

    scene, _, _, _, _, _ = _case()
    other = random_scene(2000, extent=3.0, generator=torch.Generator().manual_seed(5))
    scenes = {"a": scene.to(cuda_device), "b": other.to(cuda_device)}
    cfg = dataclasses.replace(CFG, backend="cuda")
    cams = camera.orbit_cameras(3, 5.0, W, H)

    def load():
        return [(0.0, RenderRequest(i, "ab"[i % 2], cams[i % 3], cfg)) for i in range(6)]

    with engine.open(scenes["a"], cfg, device=cuda_device) as probe:
        st = probe.stats()
        budget = 1.5 * (st["scene_mb_per_device"] + st["feature_mb_per_device"])
    build.reset_launches()
    with RenderServer(scenes, device=cuda_device, max_batch=2, max_wait=0.0,
                      device_budget_mb=budget) as server:
        got = server.run(load(), realtime=False)     # host copies: synchronized
        launches = dict(build.LAUNCHES)
        summary = server.stats.summary()
        assert server.residency.stats()["evictions"] >= 1
    with RenderServer(scenes, device=cuda_device, max_batch=2, max_wait=0.0) as plain:
        want = plain.run(load(), realtime=False)
        assert plain.residency.stats()["evictions"] == 0
    lanes = summary["completed"] + summary["padded"]
    assert launches["bitmask_gen"] == lanes and launches["raster_group_fused"] == lanes
    for _, req in load():
        with engine.open(scenes[req.scene_id], cfg, device=cuda_device) as h:
            one = h.render(req.camera).image.cpu()
        assert torch.equal(got[req.request_id].image, one), req.request_id
        assert torch.equal(want[req.request_id].image, one), req.request_id


def test_auto_tile_params_bitwise_like_the_fixed_winner_on_the_card(
        cuda_device, tmp_path, monkeypatch):
    """engine.open(tile_params='auto') on the card tunes on the card (the
    cache signature names the card) and renders bitwise, image and
    counters, like an open with the winner's triple fixed; the search
    verified the winner against the base config, bitwise when only the
    group or capacity moved (the kernels blend sequentially)."""
    from repro_torch.autotune import autotune_signature, cache as at_cache

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    at_cache._clear()
    scene, cam, _, _, _, _ = _case()
    cfg = dataclasses.replace(CFG, backend="cuda")
    opts = dict(tiles=(8, 16), group_factors=(2, 4), capacities=(512,), top_k=3,
                warmup=1, reps=2, verify=True)
    try:
        with engine.open(scene, cfg, device=cuda_device, tile_params="auto",
                         autotune_opts=opts) as ra:
            auto = ra.render(cam)
            tuned = ra.tile_params
            sig = autotune_signature(scene, W, H, ra.cfg, cuda_device)
            assert at_cache.lookup(sig) is not None
        with engine.open(scene, cfg, device=cuda_device, tile_params=tuned) as rf:
            fixed = rf.render(cam)
    finally:
        at_cache._clear()
    assert sig[-1] == ("cuda", torch.cuda.get_device_name(cuda_device))
    assert torch.equal(auto.image, fixed.image)
    assert auto.stats.as_dict() == fixed.stats.as_dict()


def test_gateway_failover_bitwise_on_the_card(cuda_device):
    """Two InprocWorkers on the card behind a RenderGateway, dispatches held
    until all 8 requests are routed, w0 killed as its first dispatch
    returns: every request completes, the retried ones on w1, each image
    bitwise a direct handle's render_batch lane padded as a worker pads;
    the BGM and the fused RM launch once per rendered lane."""
    import time

    from repro_torch.gateway import InprocWorker, RenderGateway
    from repro_torch.serving import RenderRequest

    scene, _, _, _, _, _ = _case()
    other = random_scene(2000, extent=3.0, generator=torch.Generator().manual_seed(5))
    scenes = {"a": scene.to(cuda_device), "b": other.to(cuda_device)}
    cfg = dataclasses.replace(CFG, backend="cuda")
    cams = camera.orbit_cameras(4, 5.0, W, H)
    workers = [InprocWorker(f"w{i}", scenes, device=cuda_device, max_batch=2)
               for i in range(2)]
    for i, w in enumerate(workers):
        for sid in "ab":
            w.dispatch([RenderRequest(-1 - 2 * i - "ab".index(sid), sid, cams[0], cfg)])
    batches = [w.server.stats.summary()["batches"] for w in workers]
    gw = None

    class Held:
        def __init__(self, worker, die):
            self.worker, self.die = worker, die

        def __getattr__(self, name):
            return getattr(self.worker, name)

        def dispatch(self, requests):
            deadline = time.monotonic() + 60
            while gw.counts["routed"] < 8 and time.monotonic() < deadline:
                time.sleep(0.001)
            out = self.worker.dispatch(requests)
            if self.die:
                self.worker.kill()
            return out

    load = [(0.0, RenderRequest(i, "ab"[i % 2], cams[i % 4], cfg)) for i in range(8)]
    build.reset_launches()
    gw = RenderGateway([Held(workers[0], True), Held(workers[1], False)],
                       retry_backoff_s=0.005)
    res = gw.run(load)
    launches = dict(build.LAUNCHES)
    gw.close()
    assert sorted(res) == list(range(8)) and not gw.failed, gw.failed
    assert gw.counts["failovers"] == 1
    retried = [r for r in res.values() if r.attempts > 1]
    assert retried and all(r.worker_id == "w1" for r in retried)
    lanes = 2 * sum(w.server.stats.summary()["batches"] - b for w, b in zip(workers, batches))
    assert launches["bitmask_gen"] == lanes and launches["raster_group_fused"] == lanes
    for _, req in load:
        with engine.open(scenes[req.scene_id], cfg, device=cuda_device) as h:
            one = h.render_batch([req.camera], pad_to=2).image[0].cpu()
        assert torch.equal(res[req.request_id].image, one), req.request_id


def test_kernels_launch_on_a_card_that_is_not_current(cuda_device):
    """Every wrapper launches under its operand's device: with card 0
    current, the BGM, the fused and tile raster kernels and the bitonic sort
    on card 1 run there and give card 0's results bit for bit. Needs two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a tensor on a card that is not current")
    _, _, grid, _, feat, masks = _case()
    keys, payload = _sort_case(4, 8192, seed=3)

    def run(dev):
        f, m = feat.to(dev), masks.to(dev)
        o, i = ops.group_origins(grid, dev), ops.tiles_in_image(grid, dev)
        out = [bitmask_kernel(f, o, i, grid.tile, grid.gf, "ellipse")]
        out += raster_group_fused_kernel(f, m, o, grid.tile, grid.gf, chunk=32)
        out += raster_tile_kernel(f, o, grid.group, chunk=32)    # group lists as 64-px tiles
        out += bitonic_sort_kernel(keys.to(dev), payload.to(dev))
        torch.cuda.synchronize(dev)
        return out

    with torch.cuda.device(0):
        want = run(torch.device("cuda", 0))
        got = run(torch.device("cuda", 1))
    for g, w in zip(got, want):
        assert g.device == torch.device("cuda", 1)
        assert torch.equal(g.cpu().view(torch.int32), w.cpu().view(torch.int32))


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2), (1, 4)])
def test_virtual_mesh_render_bitwise_on_the_card(cuda_device, data, model):
    """A mesh that lists the card four times renders a batch bitwise like
    one card, image and counters; a model axis commits the psum gather and
    each lane launches the BGM and the fused RM once."""
    from repro_torch.launch.mesh import make_render_mesh

    scene, _, _, _, _, _ = _case()
    cams = camera.orbit_cameras(4, 5.0, W, H)
    cfg = dataclasses.replace(CFG, backend="cuda")
    with engine.open(scene, cfg, device=cuda_device) as one:
        want = one.render_batch(cams)
    mesh = make_render_mesh([cuda_device] * 4, scene_shards=model)
    with engine.open(scene, cfg, mesh=mesh, scene_shards=model) as r:
        build.reset_launches()
        got = r.render_batch(cams)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        assert r.stats()["feature_gather"] == ("psum" if model > 1 else "flat")
    assert torch.equal(got.image, want.image)
    for f in dataclasses.fields(got.stats):
        assert torch.equal(getattr(got.stats, f.name), getattr(want.stats, f.name)), f.name
    assert launches["bitmask_gen"] == launches["raster_group_fused"] == len(cams)
