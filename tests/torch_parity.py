"""Shared helpers of the port's parity tests (tests/test_torch_*.py): carry
the JAX package's arrays into the port as numpy, and back."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.grouping import BinTable, PairSet
from repro_torch.core.projection import Projected


def t(x) -> torch.Tensor:
    """JAX/numpy array -> CPU tensor (copied)."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """Tensor -> numpy."""
    return x.detach().cpu().numpy()


def proj_to_torch(proj) -> Projected:
    return Projected(**{f.name: t(getattr(proj, f.name)) for f in dataclasses.fields(Projected)})


def table_to_torch(table) -> BinTable:
    return BinTable(
        gauss_idx=t(table.gauss_idx),
        entry_valid=t(table.entry_valid),
        lengths=t(table.lengths),
        overflow=torch.tensor(int(np.asarray(table.overflow))),
    )


def pairs_to_torch(pairs) -> PairSet:
    counters = ("n_candidate_tests", "n_pairs", "n_span_overflow")
    return PairSet(**{
        f.name: torch.tensor(int(np.asarray(getattr(pairs, f.name))))
        if f.name in counters else t(getattr(pairs, f.name))
        for f in dataclasses.fields(PairSet)
    })


def assert_counters_equal(port: dict, ref_stats) -> None:
    """Port counters (ints) == JAX counters (int32 or float32 below 2**24)."""
    for name, value in port.items():
        want = np.asarray(getattr(ref_stats, name)).item()
        assert want < 2**24, f"{name}={want} is past float32's exact range"
        assert value == want, f"{name}: port {value} != reference {want}"


@pytest.fixture()
def cuda_device():
    """The CUDA device, or a skip: the test runs a hand-written kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")
