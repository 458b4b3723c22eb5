"""Port parity: BGM and compaction (repro_torch vs repro), and the plain BGM
against the Pallas kernel in interpret mode, on scenes and on the package's
edge-case block."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_camera, random_scene
from repro.core import bitmask as jbitmask
from repro.core.grouping import GridSpec as JGridSpec, bin_pairs, identify
from repro.core.projection import project as jproject
from repro.core.stages import mask_tile_lengths as jmask_tile_lengths
from repro.kernels import ops as jops, ref as kref
from repro.kernels.bitmask_gen import bitmask_kernel as pallas_bitmask
from repro.kernels.layout import pack_features as jpack
from repro_torch.core import bitmask
from repro_torch.core.grouping import GridSpec
from repro_torch.core.stages import mask_tile_lengths
from repro_torch.kernels import ops
from repro_torch.kernels.bitmask_gen import bitmask_kernel, bitmask_plain, edge_case_block
from repro_torch.kernels.layout import pack_features
from torch_parity import n, proj_to_torch, t, table_to_torch

W = H = 96


@functools.lru_cache(maxsize=None)
def _setup(method, gf, seed=0):
    # The JAX kernel tests' shapes: >1 group on each axis, K > one block.
    scene = random_scene(jax.random.key(seed), 400, extent=3.0)
    proj = jproject(scene, make_camera((0, 1.0, 4.5), (0, 0, 0), W, H))
    jgrid = JGridSpec(W, H, 16, 16 * gf, span=4)
    gtable = bin_pairs(identify(proj, jgrid, "group", method), jgrid.num_groups, 256)
    return proj, jgrid, GridSpec(W, H, 16, 16 * gf, span=4), gtable


def _unsigned(masks):
    return n(masks).view(np.uint32)


@pytest.fixture(scope="module")
def ellipse_case():
    return _setup("ellipse", 4, seed=3)


@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse"])
def test_generate_bitmasks_matches_reference(method):
    proj, jgrid, grid, gtable = _setup(method, 4, seed=3)
    want = jbitmask.generate_bitmasks(proj, gtable, jgrid, method)
    got = bitmask.generate_bitmasks(proj_to_torch(proj), table_to_torch(gtable), grid, method)
    np.testing.assert_array_equal(_unsigned(got.masks), np.asarray(want.masks))
    assert int(got.n_bit_tests) == int(np.asarray(want.n_bit_tests))
    assert np.asarray(want.masks).any()


@pytest.mark.parametrize("tile_capacity", [256, 12])
def test_compact_tiles_matches_reference(ellipse_case, tile_capacity):
    """Identical tile tables, including the FIFO clamp (capacity 12)."""
    proj, jgrid, grid, gtable = ellipse_case
    jmasks = jbitmask.generate_bitmasks(proj, gtable, jgrid, "ellipse")
    masks = bitmask.GroupBitmasks(masks=t(np.asarray(jmasks.masks).view(np.int32)),
                                  n_bit_tests=None)
    ttable = table_to_torch(gtable)
    want = jbitmask.compact_tiles(gtable, jmasks, jgrid, tile_capacity)
    got = bitmask.compact_tiles(ttable, masks, grid, tile_capacity)
    np.testing.assert_array_equal(n(got.gauss_idx), np.asarray(want.gauss_idx))
    np.testing.assert_array_equal(n(got.entry_valid), np.asarray(want.entry_valid))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))
    assert int(got.overflow) == int(np.asarray(want.overflow))
    assert (int(got.overflow) > 0) == (tile_capacity == 12)
    np.testing.assert_array_equal(
        n(mask_tile_lengths(ttable, masks, grid)),
        np.asarray(jmask_tile_lengths(gtable, jmasks, jgrid)),
    )


def test_pack_features_matches_reference(ellipse_case):
    proj, _, _, gtable = ellipse_case
    want = jpack(proj, gtable.gauss_idx, gtable.entry_valid, multiple=128)
    got = pack_features(proj_to_torch(proj), t(gtable.gauss_idx), t(gtable.entry_valid),
                        multiple=128)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse"])
@pytest.mark.parametrize("gf", [2, 4])
def test_plain_bgm_bit_exact_vs_pallas(method, gf):
    """The plain BGM (what the CUDA kernel is held to on the card) is
    bit-exact against the Pallas kernel in interpret mode and its oracle."""
    proj, jgrid, grid, gtable = _setup(method, gf)
    feat = jpack(proj, gtable.gauss_idx, gtable.entry_valid)
    origins, in_img = jops.group_origins(jgrid), jops.tiles_in_image(jgrid)
    want = np.asarray(pallas_bitmask(feat, origins, in_img, 16, gf, method=method,
                                     interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(kref.ref_bitmask(feat, origins, in_img, 16, gf, method)))
    got = bitmask_kernel(t(feat), ops.group_origins(grid), ops.tiles_in_image(grid), 16, gf,
                         method)
    np.testing.assert_array_equal(_unsigned(got), want)
    np.testing.assert_array_equal(n(ops.group_origins(grid)), np.asarray(origins))
    np.testing.assert_array_equal(n(ops.tiles_in_image(grid)), np.asarray(in_img))


def test_bgm_rejects_methods_it_does_not_run(ellipse_case):
    proj, _, grid, gtable = ellipse_case
    feat = pack_features(proj_to_torch(proj), t(gtable.gauss_idx), t(gtable.entry_valid))
    with pytest.raises(ValueError):
        bitmask_kernel(feat, ops.group_origins(grid), ops.tiles_in_image(grid), 16, 4,
                       "ellipse_opacity")


@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse"])
@pytest.mark.parametrize("tile_px", [8, 16])
@pytest.mark.parametrize("gf", [1, 2, 3, 4, 5])
def test_plain_bgm_vs_pallas_on_edge_case_block(gf, tile_px, method):
    """The plain BGM against the Pallas kernel in interpret mode on the
    block as built. One known difference, of the reference's XLA
    environment on the CPU, and the words that differ are exactly its own:
    XLA reads float32 subnormals as zero where torch and the card keep
    them. The block's 16 subnormal means (group 0) then sit on a tile line
    instead of one ulp outside it, which flips their aabb and ellipse
    words; obb reads the mean only through mean - centre, which rounds the
    subnormal away, so no obb word changes."""
    feat, origins, in_img = edge_case_block(gf, tile_px, torch.Generator().manual_seed(7))
    want = np.asarray(pallas_bitmask(jnp.asarray(n(feat)), jnp.asarray(n(origins)),
                                     jnp.asarray(n(in_img)), tile_px, gf, method=method,
                                     interpret=True))
    got = _unsigned(bitmask_plain(feat, origins, in_img, tile_px, gf, method))
    tiny = torch.finfo(torch.float32).smallest_normal
    subnormal = n(((feat != 0) & (feat.abs() < tiny)).any(1))
    assert subnormal.sum() == 16 and not subnormal[1:].any()
    flips = subnormal if method in ("aabb", "ellipse") else np.zeros_like(subnormal)
    np.testing.assert_array_equal(got != want, flips)
