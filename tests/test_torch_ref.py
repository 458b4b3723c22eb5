"""The port's dense kernel oracles (``kernels/ref.py``) against the JAX
package's, and against the port's plain versions, on the same seeded numpy
inputs. Tolerances: raster images at atol 3e-6, rtol 1e-5 (the JAX
package's own between its kernel and this oracle,
``tests/test_kernels_raster.py``); bitmask words and sorts exactly (the
bitonic network leaves ties unordered: against it, keys exactly and each
row's (key, payload) pairs as a multiset).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.bitmask_gen import bitmask_plain
from repro_torch.kernels.bitonic_sort import bitonic_sort_plain
from repro_torch.kernels.layout import (
    F_CONIC_A,
    F_CONIC_B,
    F_CONIC_C,
    F_EIGVAL_1,
    F_EIGVAL_2,
    F_EIGVEC_X,
    F_EIGVEC_Y,
    F_MEAN_X,
    F_MEAN_Y,
    F_OPACITY,
    F_RADIUS,
    F_RGB_R,
    F_VALID,
    NUM_FEATURES,
)
from repro_torch.kernels.raster_tile import raster_group_fused_plain, raster_tile_plain

RASTER_TOL = dict(atol=3e-6, rtol=1e-5)
# JAX's oracles jitted (eager vmap compiles op by op, seconds a call)
JREF_TILES = jax.jit(jref.ref_raster_tiles, static_argnums=2)
JREF_FUSED = jax.jit(jref.ref_raster_group_fused, static_argnums=(3, 4))
JREF_BITMASK = jax.jit(jref.ref_bitmask, static_argnums=(3, 4, 5))


def entries(rng, n_lists, K, origins, span, live):
    """(n_lists, 16, K) float32 features: splats around each list's area
    (``span`` pixels from its origin) from random covariances, opacity
    0.02-0.5, the first ``live[i]`` entries of list i valid and the rest
    zero (opacity 0, as the pack writes invalid entries)."""
    feat = np.zeros((n_lists, NUM_FEATURES, K), np.float32)
    for i, n in enumerate(live):
        ox, oy = origins[i]
        s1, s2 = rng.uniform(1.0, 0.3 * span, (2, n))
        th = rng.uniform(0, np.pi, n)
        c, s = np.cos(th), np.sin(th)
        a, b, d = c * c * s1 * s1 + s * s * s2 * s2, c * s * (s1 * s1 - s2 * s2), \
            s * s * s1 * s1 + c * c * s2 * s2
        det = a * d - b * b
        tr = (a + d) / 2
        disc = np.sqrt(np.maximum(tr * tr - det, 0))
        f = feat[i]
        f[F_MEAN_X, :n] = ox + rng.uniform(-0.25, 1.25, n) * span
        f[F_MEAN_Y, :n] = oy + rng.uniform(-0.25, 1.25, n) * span
        f[F_CONIC_A, :n], f[F_CONIC_B, :n], f[F_CONIC_C, :n] = d / det, -b / det, a / det
        f[F_OPACITY, :n] = rng.uniform(0.02, 0.5, n)
        f[F_RGB_R:F_RGB_R + 3, :n] = rng.uniform(0, 1, (3, n))
        f[F_RADIUS, :n] = np.ceil(3 * np.sqrt(tr + disc))
        f[F_EIGVEC_X, :n], f[F_EIGVEC_Y, :n] = c, s
        f[F_EIGVAL_1, :n], f[F_EIGVAL_2, :n] = s1 * s1, s2 * s2
        f[F_VALID, :n] = 1.0
    return feat


def test_raster_tiles_match_jax_and_plain():
    rng = np.random.default_rng(0)
    tile, K = 16, 96
    origins = np.array([[0, 0], [16, 0], [32, 48], [-16, 8]], np.float32)
    feat = entries(rng, 4, K, origins, tile, [0, 5, 64, 96])
    got = ref.ref_raster_tiles(torch.from_numpy(feat), torch.from_numpy(origins), tile)
    want = np.asarray(JREF_TILES(jnp.asarray(feat), jnp.asarray(origins), tile))
    assert got.shape == want.shape == (4, 4, tile * tile)
    np.testing.assert_allclose(got.numpy(), want, **RASTER_TOL)
    plain, _ = raster_tile_plain(torch.from_numpy(feat), torch.from_numpy(origins), tile,
                                 chunk=32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **RASTER_TOL)


@pytest.mark.parametrize("gf", [2, 4])
def test_raster_group_fused_matches_jax_and_plain(gf):
    rng = np.random.default_rng(gf)
    tile, K = 8, 64
    origins = np.array([[0, 0], [tile * gf, 0], [0, tile * gf]], np.float32)
    feat = entries(rng, 3, K, origins, tile * gf, [64, 30, 0])
    words = rng.integers(0, 2**32, (3, K), dtype=np.uint64) & ((1 << gf * gf) - 1)
    masks = words.astype(np.uint32).view(np.int32)
    got = ref.ref_raster_group_fused(torch.from_numpy(feat), torch.from_numpy(masks),
                                     torch.from_numpy(origins), tile, gf)
    want = np.asarray(JREF_FUSED(jnp.asarray(feat), jnp.asarray(masks), jnp.asarray(origins),
                                 tile, gf))
    assert got.shape == want.shape == (3, gf * gf, 4, tile * tile)
    np.testing.assert_allclose(got.numpy(), want, **RASTER_TOL)
    plain, _ = raster_group_fused_plain(torch.from_numpy(feat), torch.from_numpy(masks),
                                        torch.from_numpy(origins), tile, gf, chunk=32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **RASTER_TOL)


@pytest.mark.parametrize("gf", [2, 4, 5])
@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse"])
def test_bitmask_matches_jax_and_plain(method, gf):
    """gf 5 sets bits past 16 and, with 25 member tiles, words past 2**24."""
    rng = np.random.default_rng(7)
    tile, K = 16, 128
    span = tile * gf
    origins = np.array([[0, 0], [span, 0], [2 * span, span]], np.float32)
    feat = entries(rng, 3, K, origins, span, [128, 70, 3])
    feat[1, F_VALID, 10:20] = 0.25   # valid below 0.5: no bits
    in_img = np.ones((3, gf * gf), bool)
    in_img[2, ::3] = False
    args = [torch.from_numpy(x) for x in (feat, origins, in_img)]
    got = ref.ref_bitmask(*args, tile, gf, method)
    want = np.asarray(JREF_BITMASK(*(jnp.asarray(x) for x in (feat, origins, in_img)),
                                   tile, gf, method))
    assert got.dtype == torch.int32 and got.shape == (3, K)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(got, bitmask_plain(*args, tile, gf, method))
    assert int((got != 0).sum()) > 0


@pytest.mark.parametrize("K", [8, 1024])
def test_sort_matches_jax_and_plain(K):
    rng = np.random.default_rng(K)
    pool = np.array([-2.5, -0.0, 0.0, 0.5, 1.0, 7.25, np.inf], np.float32)
    keys = pool[rng.integers(0, pool.size, (5, K))]
    keys[3] = rng.standard_normal(K).astype(np.float32)
    keys[4, K // 2:] = np.inf
    payload = np.stack([rng.permutation(K) for _ in range(5)]).astype(np.float32)
    got_k, got_v = ref.ref_sort(torch.from_numpy(keys), torch.from_numpy(payload))
    want_k, want_v = jref.ref_sort(jnp.asarray(keys), jnp.asarray(payload))
    np.testing.assert_array_equal(got_k.numpy().view(np.int32), np.asarray(want_k).view(np.int32))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    net_k, net_v = bitonic_sort_plain(torch.from_numpy(keys), torch.from_numpy(payload))
    assert torch.equal(net_k, got_k)
    pairs = lambda k, v: sorted(zip(v.tolist(), k.tolist()))  # noqa: E731
    for r in range(5):
        assert pairs(net_k[r], net_v[r]) == pairs(got_k[r], got_v[r])
