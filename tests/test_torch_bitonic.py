"""The port's GSM bitonic sort against the JAX package's Pallas kernel in
interpret mode: keys and payload bitwise equal (the network is
deterministic, so ties, ±0.0, NaN and +inf padding land in one fixed
order), on seeded rows and on the package's ``edge_case_rows``, and the
int32 entry point ``sort_groups_bitonic`` against its JAX twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_sort import bitonic_sort_kernel as jax_bitonic
from repro.kernels.ops import sort_groups_bitonic as jax_sort_groups
from repro_torch.kernels import build, ops
from repro_torch.kernels.bitonic_sort import (
    bitonic_sort_kernel,
    bitonic_sort_plain,
    edge_case_rows,
)
from torch_parity import n, t

POOL = np.array([-2.5, -0.0, 0.0, 0.5, 1.0, 7.25, np.inf], np.float32)


def _case(G, K, seed, ties):
    """Seeded keys: drawn from a small pool (many ties, ±0.0) or uniform,
    each row padded with +inf past a random live length; payload a
    permutation of the slot indices."""
    rng = np.random.default_rng(seed)
    if ties:
        keys = POOL[rng.integers(0, POOL.size, (G, K))]
    else:
        keys = rng.uniform(-1.0, 1.0, (G, K)).astype(np.float32)
    live = rng.integers(0, K + 1, G)
    keys[np.arange(K)[None, :] >= live[:, None]] = np.inf
    payload = np.stack([rng.permutation(K) for _ in range(G)]).astype(np.float32)
    return keys, payload


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "uniform"])
@pytest.mark.parametrize("K", [2, 64, 256, 1024])
def test_plain_matches_pallas_bitwise(K, ties):
    keys, payload = _case(6, K, seed=K + ties, ties=ties)
    want_k, want_v = jax_bitonic(jnp.asarray(keys), jnp.asarray(payload), interpret=True)
    got_k, got_v = bitonic_sort_plain(t(keys), t(payload))
    np.testing.assert_array_equal(_bits(n(got_k)), _bits(want_k))
    np.testing.assert_array_equal(_bits(n(got_v)), _bits(want_v))
    # Sorted, and the payload a permutation that carries each key along.
    np.testing.assert_array_equal(n(got_k), np.sort(keys, axis=1))
    for g in range(keys.shape[0]):
        idx = n(got_v)[g].astype(np.int64)
        assert sorted(idx.tolist()) == list(range(K))


@pytest.mark.parametrize("K", [2**p for p in range(11)])
def test_plain_matches_pallas_on_edge_case_rows(K):
    """edge_case_rows (NaN, ±0.0, all +inf, all equal, sorted either way,
    live lengths 0, 1 and K) through the plain network and the Pallas kernel
    in interpret mode: keys and payload bitwise equal. Up to K = 1024 here;
    the cuda tests and chip_smoke take the kernel on to 65,536."""
    keys, payload = edge_case_rows(K, torch.Generator().manual_seed(K))
    want_k, want_v = jax_bitonic(jnp.asarray(n(keys)), jnp.asarray(n(payload)), interpret=True)
    got_k, got_v = bitonic_sort_plain(keys, payload)
    np.testing.assert_array_equal(_bits(n(got_k)), _bits(want_k))
    np.testing.assert_array_equal(_bits(n(got_v)), _bits(want_v))
    # The NaN-free rows come out sorted; the payload stays a permutation.
    clean = ~keys.isnan().any(1)
    assert torch.equal(got_k[clean], torch.sort(keys[clean], dim=1).values)
    assert torch.equal(torch.sort(got_v, dim=1).values,
                       torch.arange(K, dtype=torch.float32).expand(10, K))


def test_signed_zeros_keep_the_network_order():
    keys = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, np.inf, -1.0, 0.0]], np.float32)
    payload = np.arange(8, dtype=np.float32)[None]
    want_k, want_v = jax_bitonic(jnp.asarray(keys), jnp.asarray(payload), interpret=True)
    got_k, got_v = bitonic_sort_plain(t(keys), t(payload))
    np.testing.assert_array_equal(_bits(n(got_k)), _bits(want_k))
    np.testing.assert_array_equal(_bits(n(got_v)), _bits(want_v))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_groups_bitonic_matches_jax(seed):
    keys, payload = _case(4, 128, seed=seed, ties=True)
    idx = payload.astype(np.int32)
    want_k, want_v = jax_sort_groups(jnp.asarray(keys), jnp.asarray(idx), interpret=True)
    got_k, got_v = ops.sort_groups_bitonic(t(keys), t(idx))
    assert got_v.dtype == torch.int32
    np.testing.assert_array_equal(_bits(n(got_k)), _bits(want_k))
    np.testing.assert_array_equal(n(got_v), np.asarray(want_v))


def test_sort_groups_bitonic_int_payload():
    """The JAX package's own case (tests/test_kernels_sort.py)."""
    keys = torch.tensor([[3.0, 1.0, 2.0, float("inf")]])
    payload = torch.tensor([[10, 11, 12, 13]], dtype=torch.int32)
    _, v = ops.sort_groups_bitonic(keys, payload)
    assert v[0, :3].tolist() == [11, 12, 10]


@pytest.mark.parametrize("K", [3, 100, 0])
def test_rejects_non_power_of_two(K):
    with pytest.raises(ValueError, match="power-of-two"):
        bitonic_sort_plain(torch.ones((1, K)), torch.ones((1, K)))
    with pytest.raises(ValueError, match="power-of-two"):
        bitonic_sort_kernel(torch.ones((1, K)), torch.ones((1, K)))


def test_rejects_wrong_dtype_and_shape():
    with pytest.raises(ValueError, match="float32"):
        bitonic_sort_kernel(torch.ones((1, 8)), torch.ones((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        bitonic_sort_kernel(torch.ones((1, 8)), torch.ones((2, 8)))
    with pytest.raises(ValueError, match="int32"):
        ops.sort_groups_bitonic(torch.ones((1, 8)), torch.ones((1, 8)))


def test_kernel_wrapper_on_cpu_runs_the_plain_version():
    keys, payload = _case(3, 256, seed=9, ties=True)
    before = build.LAUNCHES["bitonic_sort"]
    got = bitonic_sort_kernel(t(keys), t(payload))
    want = bitonic_sort_plain(t(keys), t(payload))
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert build.LAUNCHES["bitonic_sort"] == before   # no kernel ran
