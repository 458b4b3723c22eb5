"""Port parity: identification and binning (repro_torch.core.grouping vs
repro.core.grouping), fed the reference's projected features."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import make_camera, random_scene
from repro.core import grouping as jgrouping
from repro.core.projection import project as jproject
from repro_torch.core import grouping
from torch_parity import n, pairs_to_torch, proj_to_torch, t

W = H = 96


@pytest.fixture(scope="module")
def ref_proj():
    scene = random_scene(jax.random.key(21), 400, extent=3.0)
    return jproject(scene, make_camera((0.0, 1.0, 4.5), (0, 0, 0), W, H))


def _assert_pairs_equal(got, want):
    for f in dataclasses.fields(grouping.PairSet):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        if g.ndim == 0:
            assert int(g) == w.item(), f.name
        else:
            np.testing.assert_array_equal(n(g), w, err_msg=f.name)


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(n(got.gauss_idx), np.asarray(want.gauss_idx))
    np.testing.assert_array_equal(n(got.entry_valid), np.asarray(want.entry_valid))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))
    assert int(got.overflow) == int(np.asarray(want.overflow))


@pytest.mark.parametrize(
    "level,method",
    [("group", "ellipse"), ("group", "aabb"), ("group", "obb"),
     ("group", "ellipse_opacity"), ("tile", "ellipse")],
)
def test_identify_matches_reference(ref_proj, level, method):
    jgrid = jgrouping.GridSpec(W, H, 16, 32, span=3)
    grid = grouping.GridSpec(W, H, 16, 32, span=3)
    want = jgrouping.identify(ref_proj, jgrid, level, method)
    got = grouping.identify(proj_to_torch(ref_proj), grid, level, method)
    _assert_pairs_equal(got, want)
    assert int(got.n_pairs) > 0


@pytest.mark.parametrize("capacity", [128, 8])
def test_bin_pairs_matches_reference(ref_proj, capacity):
    """Identical tables, including the overflow clamp (capacity 8)."""
    jgrid = jgrouping.GridSpec(W, H, 16, 32, span=3)
    pairs = jgrouping.identify(ref_proj, jgrid, "group", "ellipse")
    want = jgrouping.bin_pairs(pairs, jgrid.num_groups, capacity)
    got = grouping.bin_pairs(pairs_to_torch(pairs), jgrid.num_groups, capacity)
    _assert_tables_equal(got, want)
    assert (int(got.overflow) > 0) == (capacity == 8)


def test_bin_pairs_depth_ties_keep_insertion_order():
    """Equal depths sort by pair index (the 3D-GS tie-break losslessness
    rests on): a synthetic pair set full of ties, invalid pairs and +inf."""
    rng = np.random.default_rng(3)
    P, num_bins = 600, 7
    depth = rng.integers(0, 5, P).astype(np.float32)        # many exact ties
    valid = rng.random(P) < 0.8
    bin_id = np.where(valid, rng.integers(0, num_bins, P), num_bins).astype(np.int32)
    depth = np.where(valid, depth, np.inf).astype(np.float32)
    gauss = rng.permutation(P).astype(np.int32)
    zero = jnp.zeros((), jnp.int32)
    pairs = jgrouping.PairSet(
        bin_id=jnp.asarray(bin_id), gauss_idx=jnp.asarray(gauss), depth=jnp.asarray(depth),
        valid=jnp.asarray(valid), n_candidate_tests=zero, n_pairs=zero, n_span_overflow=zero,
    )
    want = jgrouping.bin_pairs(pairs, num_bins, 96)
    got = grouping.bin_pairs(pairs_to_torch(pairs), num_bins, 96)
    _assert_tables_equal(got, want)


def test_sort_op_count_and_tile_maps():
    lengths = np.array([0, 1, 2, 3, 4, 5, 17, 1000, 4097, 5009], np.int32)
    want = jgrouping.sort_op_count(jnp.asarray(lengths))
    assert int(grouping.sort_op_count(t(lengths))) == int(np.asarray(want))

    jgrid = jgrouping.GridSpec(96, 80, 16, 64, span=4)   # partial edge groups
    grid = grouping.GridSpec(96, 80, 16, 64, span=4)
    assert (grid.num_groups, grid.num_tiles, grid.gf) == (
        jgrid.num_groups, jgrid.num_tiles, jgrid.gf)
    g = np.arange(grid.num_groups, dtype=np.int32)[:, None]
    s = np.arange(grid.tiles_per_group, dtype=np.int32)[None, :]
    for got, want in zip(
        grouping.tile_rect_in_group(grid, t(g), t(s)),
        jgrouping.tile_rect_in_group(jgrid, jnp.asarray(g), jnp.asarray(s)),
    ):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(
        n(grouping.group_tile_to_global_tile(grid, t(g), t(s))),
        np.asarray(jgrouping.group_tile_to_global_tile(jgrid, jnp.asarray(g), jnp.asarray(s))),
    )
    with pytest.raises(ValueError):
        grouping.GridSpec(96, 96, 16, 40)
