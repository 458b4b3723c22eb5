"""Port parity: the plain rasterizer and the plain versions of both raster
kernels against the JAX rasterizer and the Pallas kernels in interpret mode
(atol 3e-6, rtol 1e-5: the JAX package's own cross-backend tolerance), with
identical counters. The CUDA kernels against the plain versions are in
test_torch_cuda_kernels.py."""
import functools
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import make_camera, random_scene
from repro.core.bitmask import compact_tiles, generate_bitmasks
from repro.core.grouping import GridSpec as JGridSpec, bin_pairs, identify
from repro.core.projection import project as jproject
from repro.core.raster import rasterize as jrasterize
from repro.kernels import ops as jops
from repro.kernels.layout import pack_features as jpack
from repro.kernels.raster_tile import raster_group_fused_kernel as pallas_fused
from repro.kernels.raster_tile import raster_tile_kernel as pallas_tile
from repro_torch.core.grouping import GridSpec
from repro_torch.core.raster import rasterize
from repro_torch.kernels import build, ops
from repro_torch.kernels.layout import F_CONIC_A, F_CONIC_C, F_OPACITY, F_VALID
from repro_torch.kernels.raster_tile import (
    TILE_WINDOW,
    edge_case_lists,
    raster_group_fused_kernel,
    raster_tile_kernel,
    raster_tile_plain,
    raster_tile_walk,
)
from torch_parity import n, proj_to_torch, t, table_to_torch

W = H = 96
TOL = dict(atol=3e-6, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _tables(seed=1, gf=4, tcap=128):
    scene = random_scene(jax.random.key(seed), 400, extent=3.0)
    proj = jproject(scene, make_camera((0, 1.0, 4.5), (0, 0, 0), W, H))
    jgrid = JGridSpec(W, H, 16, 16 * gf, span=4)
    gtable = bin_pairs(identify(proj, jgrid, "group", "ellipse"), jgrid.num_groups, 256)
    masks = generate_bitmasks(proj, gtable, jgrid, "ellipse")
    ttable = compact_tiles(gtable, masks, jgrid, tcap)
    return proj, jgrid, GridSpec(W, H, 16, 16 * gf, span=4), gtable, masks, ttable


@pytest.mark.parametrize("early_exit", [True, False])
def test_rasterize_matches_reference(early_exit):
    proj, jgrid, grid, _, _, ttable = _tables()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = jrasterize(proj, ttable, jgrid, bg, chunk=32, early_exit=early_exit)
    got = rasterize(proj_to_torch(proj), table_to_torch(ttable), grid, t(bg), chunk=32,
                    early_exit=early_exit)
    np.testing.assert_allclose(n(got.image), np.asarray(want.image), **TOL)
    assert int(got.alpha_ops) == int(np.asarray(want.alpha_ops))
    assert int(got.blend_ops) == int(np.asarray(want.blend_ops))
    np.testing.assert_array_equal(n(got.processed), np.asarray(want.processed))


def test_first_parallel_exp_after_import_is_exact():
    """Importing the port's raster module makes MKL's vector math library
    choose its kernels on one thread, before any parallel call
    (``core/raster.py::settle_cpu_exp``): a process's first parallel exp
    (as in the plain rasterizer) then matches the same exp on one thread bit
    for bit. Without that, a first parallel call sometimes computed whole
    thread blocks with a less accurate kernel, which is what made
    test_rasterize_matches_reference fail now and then. Only the first
    parallel call of a process can race, so this starts 40 fresh processes,
    8 at a time: at the rate seen without the fix (17 of 200 processes) it
    catches a missing warm-up with probability 1 - 0.915**40, about 97%. On
    a torch build without MKL it holds trivially."""
    code = textwrap.dedent("""
        import numpy as np
        import repro_torch.core.raster  # noqa: F401
        import torch
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.uniform(-4.5, 0.0, 36 * 256 * 32).astype(np.float32))
        first = torch.exp(x)
        torch.set_num_threads(1)
        print(int((first.view(torch.int32) != torch.exp(x).view(torch.int32)).sum()))
    """)
    src = str(Path(sys.modules["repro_torch"].__file__).resolve().parents[1])  # .../src
    env = {**os.environ, "PYTHONPATH": src}
    outs = []
    for _ in range(5):
        procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                  env=env, text=True) for _ in range(8)]
        outs += [(p.communicate(timeout=300)[0].strip(), p.returncode) for p in procs]
    assert outs == [("0", 0)] * 40


def _with_opacity(feat, variant):
    """The packed group block with its opacity row rewritten: "opaque" sets
    every valid entry to 0.99 and widens every splat tenfold (conic / 100),
    so member tiles die mid-list; "zero_opacity" sets every third entry to 0
    and every fifth to -0.25, so entries with opacity <= 0 are streamed (and
    take FIFO slots) but never blended."""
    feat = np.array(feat)
    op, valid = feat[:, F_OPACITY], feat[:, F_VALID] > 0.5
    k = np.arange(feat.shape[-1])
    if variant == "opaque":
        op = np.where(valid, np.float32(0.99), np.float32(0.0))
        feat[:, F_CONIC_A:F_CONIC_C + 1] *= np.float32(0.01)
    elif variant == "zero_opacity":
        op = np.where(k % 3 == 0, np.float32(0.0), np.where(k % 5 == 0, np.float32(-0.25), op))
    feat[:, F_OPACITY] = op
    return feat


@pytest.mark.parametrize(
    "gf,tile_capacity,chunk,variant",
    [
        pytest.param(4, None, 128, None, id="4-None"),
        pytest.param(2, None, 128, None, id="2-None"),
        pytest.param(4, 9, 128, None, id="4-9"),  # the virtual FIFO clamp
        pytest.param(1, None, 128, None, id="gf1"),  # one member tile a group
        # chunk = K: one early-exit test, at the start
        pytest.param(4, None, 256, None, id="chunk_is_K"),
        pytest.param(4, None, 32, "opaque", id="opaque"),  # member tiles die mid-list
        # opacity <= 0 entries are streamed and count toward kept
        pytest.param(4, 9, 32, "zero_opacity", id="zero_opacity_clamped"),
    ],
)
def test_plain_fused_raster_vs_pallas(gf, tile_capacity, chunk, variant):
    proj, jgrid, grid, gtable, masks, _ = _tables(gf=gf)
    feat = _with_opacity(jpack(proj, gtable.gauss_idx, gtable.entry_valid), variant)
    assert feat.shape[-1] % chunk == 0
    origins = jops.group_origins(jgrid)
    want, want_c = pallas_fused(feat, masks.masks, origins, 16, gf, chunk=chunk,
                                interpret=True, tile_capacity=tile_capacity,
                                with_stats=True)
    got, got_c = raster_group_fused_kernel(
        t(feat), t(np.asarray(masks.masks).view(np.int32)), ops.group_origins(grid), 16, gf,
        chunk=chunk, tile_capacity=tile_capacity,
    )
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(n(got_c), np.asarray(want_c))
    if variant == "opaque":
        assert (n(got)[:, :, 3] <= 1e-4).all(-1).any()  # some member tiles died


@pytest.mark.parametrize("early_exit", [True, False])
def test_plain_tile_raster_vs_pallas(early_exit):
    proj, jgrid, grid, _, _, ttable = _tables()
    feat = jpack(proj, ttable.gauss_idx, ttable.entry_valid)
    origins = jops.tile_origins(jgrid)
    want, want_c = pallas_tile(feat, origins, 16, chunk=64, interpret=True,
                               early_exit=early_exit, with_stats=True)
    got, got_c = raster_tile_kernel(t(feat), ops.tile_origins(grid), 16, chunk=64,
                                    early_exit=early_exit)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(n(got_c), np.asarray(want_c))
    np.testing.assert_array_equal(n(ops.tile_origins(grid)), np.asarray(origins))


def test_plain_tile_raster_empty_tiles():
    """Tiles with no entries give rgb 0 and transmittance 1."""
    feat = np.zeros((3, 16, 128), np.float32)
    out, counts = raster_tile_plain(t(feat), t(np.zeros((3, 2), np.float32)), 16, chunk=64)
    assert (n(out)[:, :3] == 0).all() and (n(out)[:, 3] == 1).all()
    assert (n(counts) == 0).all()


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("chunk", [32, TILE_WINDOW, 2048])
def test_plain_tile_raster_vs_pallas_on_edge_case_lists(chunk, early_exit):
    """The package's edge_case_lists (lists ending at and one past a window
    boundary, interior opacity <= 0 and NaN, an empty list, tiles that die
    inside a window or from their first chunk) through the plain version and
    the Pallas kernel in interpret mode: images at TOL with NaN in the same
    places, counters equal."""
    feat, origins = edge_case_lists(16, chunk, torch.Generator().manual_seed(3))
    want, want_c = pallas_tile(n(feat), n(origins), 16, chunk=chunk, interpret=True,
                               early_exit=early_exit, with_stats=True)
    got, got_c = raster_tile_kernel(feat, origins, 16, chunk=chunk, early_exit=early_exit)
    np.testing.assert_allclose(n(got), np.asarray(want), equal_nan=True, **TOL)
    np.testing.assert_array_equal(n(got_c), np.asarray(want_c))
    T = n(got)[:, 3]
    assert (T[0] == 1).all() and (n(got_c)[0] == 0).all()            # the empty list
    assert np.isnan(T[6]).any() and not np.isnan(T[6]).all()       # NaN in a few pixels
    assert (n(got_c)[1:6, 1] > 0).all() and (T[1:4] > 1e-4).any(-1).all()  # alive to the end
    if early_exit and chunk < feat.shape[-1]:
        assert (T[7:9] <= 1e-4).all()  # stopped after the tile died


def test_tile_window_matches_the_kernel_source():
    """edge_case_lists places its seams by TILE_WINDOW: it must be the
    window the CUDA source stages."""
    src = (build.CSRC / "raster_tile.cu").read_text()
    assert re.search(r"constexpr int TILE_WIN = (\d+);", src).group(1) == str(TILE_WINDOW)


@pytest.mark.parametrize("chunk", [32, TILE_WINDOW, 2048])
def test_tile_walk_is_what_early_exit_needs(chunk):
    """raster_tile_walk on edge_case_lists: each list read in full up to its
    last live entry or the boundary where it stops (list 7 dies at entry W +
    8, list 8 in its first chunk), the rest of the stop only for opacity;
    and the output depends on nothing past what it counts."""
    W = TILE_WINDOW
    feat, origins = edge_case_lists(16, chunk, torch.Generator().manual_seed(3))
    K = feat.shape[-1]
    full, rest = raster_tile_walk(feat, origins, 16, chunk)
    stop7 = min(-(-(W + 9) // chunk) * chunk, K)
    want = [0, W, W + 1, 2 * W, K, 3 * W + 5, 3 * W, min(stop7, 3 * W), min(chunk, 3 * W)]
    assert full.tolist() == want
    assert (full + rest).tolist() == [K] * 7 + [stop7, chunk]
    cut = feat.clone()
    cut[torch.arange(K) >= full[:, None, None].expand_as(cut)] = 0.0
    got, got_c = raster_tile_plain(cut, origins, 16, chunk)
    want_out, want_c = raster_tile_plain(feat, origins, 16, chunk)
    torch.testing.assert_close(got, want_out, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got_c, want_c)
