"""Group Sorting Module (GSM, paper Fig 10): bitonic-sort CUDA kernel wrapper
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro.kernels.bitonic_sort.bitonic_sort_kernel``:
per row, an ascending sort of float32 keys that carries a 32-bit payload.
K is a power of two and invalid slots hold +inf so they sink to the end.
The network is not stable, but it is deterministic: ties, ``±0.0`` and the
+inf padding come out in one fixed order, and the payload follows its key
word for word. ``bitonic_sort_plain`` runs the TPU kernel's network stage
for stage (``_bitonic_network``), so both agree bitwise with it.

The CUDA source is ``csrc/bitonic_sort.cu``: one block per row (per chunk
of ``SPAN`` slots for longer rows), the chunk held in registers, E slots a
thread. A stage runs in registers, through warp shuffles, or, for the
distances that span warps, in registers again after a round trip through
shared memory that swaps those index bits into the registers
(``block_shape`` reads the launch from the built library). Rows longer
than the span add global-memory passes for the wide stages.
``bitonic_sort_kernel`` launches it for CUDA tensors and runs
``bitonic_sort_plain`` for CPU tensors; it never falls back from one to
the other. ``edge_case_rows`` gives the rows that reach each of the
kernel's code paths.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_P, _I = build.P, build.I
_SIGNATURES = {
    # keys, vals, keys_out, vals_out, G, K, stream
    "bitonic_sort_launch": [_P, _P, _P, _P, _I, _I, _P],
    # K, shape[4]
    "bitonic_block_shape": [_I, _P],
}
_MAX_ROWS = 65535  # the launch grid's y extent


def bitonic_sort_plain(
    keys: torch.Tensor, payload: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch GSM: the TPU kernel's network in its order. For
    k = 2, 4, ..., K and j = k/2, ..., 1, slot i with bit j clear meets
    slot i + j; the pair sorts ascending where ``i & k == 0`` and swaps when
    ``asc ? lo > hi : lo < hi``."""
    G, K = _check_shape(keys, payload)
    idx = torch.arange(K, device=keys.device)
    k = 2
    while k <= K:
        asc_all = (idx & k) == 0
        j = k // 2
        while j >= 1:
            kr = keys.reshape(G, K // (2 * j), 2, j)
            vr = payload.reshape(G, K // (2 * j), 2, j)
            asc = asc_all.reshape(K // (2 * j), 2, j)[:, 0, :]
            lo_k, hi_k = kr[:, :, 0, :], kr[:, :, 1, :]
            lo_v, hi_v = vr[:, :, 0, :], vr[:, :, 1, :]
            swap = torch.where(asc, lo_k > hi_k, lo_k < hi_k)
            keys = torch.stack(
                [torch.where(swap, hi_k, lo_k), torch.where(swap, lo_k, hi_k)], dim=2
            ).reshape(G, K)
            payload = torch.stack(
                [torch.where(swap, hi_v, lo_v), torch.where(swap, lo_v, hi_v)], dim=2
            ).reshape(G, K)
            j //= 2
        k *= 2
    return keys, payload


def bitonic_sort_kernel(
    keys: torch.Tensor,     # (num_groups, K) float32, +inf padding
    payload: torch.Tensor,  # (num_groups, K) float32 (cast your ints)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, permuted payload), both (num_groups, K): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    G, K = _check_shape(keys, payload)
    if keys.device.type == "cpu":
        return bitonic_sort_plain(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"bitonic_sort_kernel: unsupported device {keys.device}")
    if payload.device != keys.device:
        raise ValueError("bitonic_sort_kernel: keys and payload on different devices")
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError("bitonic_sort_kernel: keys and payload must be contiguous")
    if G > _MAX_ROWS:
        raise ValueError(f"bitonic_sort_kernel: {G} rows exceed {_MAX_ROWS}")
    keys_out = torch.empty_like(keys)
    vals_out = torch.empty_like(payload)
    if G == 0:
        return keys_out, vals_out
    lib = build.load("bitonic_sort", _SIGNATURES)
    status = lib.bitonic_sort_launch(
        keys.data_ptr(), payload.data_ptr(), keys_out.data_ptr(), vals_out.data_ptr(),
        G, K, build.stream_of(keys),
    )
    build.check_status(lib, status, "bitonic_sort")
    build.count_launch("bitonic_sort")
    return keys_out, vals_out


def block_shape(K: int) -> dict:
    """The block kernel's launch for rows of ``K`` as the CUDA source
    decides it: threads a block, slots a thread holds in registers, slots a
    block sorts (the row, or ``SPAN`` of it) and bytes of dynamic shared
    memory. Builds the kernel on first use."""
    lib = build.load("bitonic_sort", _SIGNATURES)
    shape = (ctypes.c_int32 * 4)()
    build.check_status(lib, lib.bitonic_block_shape(K, ctypes.addressof(shape)),
                       "bitonic_block_shape")
    return {"block_threads": shape[0], "slots_per_thread": shape[1], "block_span": shape[2],
            "dynamic_smem_bytes": shape[3]}


def edge_case_rows(K: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ten seeded rows of ``K`` slots that put the network's edge cases to a
    sort: CPU tensors keys (10, K) float32 and payload (10, K) float32 (a
    permutation of the slot indices per row). By row:

      0. uniform keys in [-1, 1) with about one in eight NaN;
      1. signed zeros, with a few +-1 among them;
      2. all +inf (a live length of 0);
      3. all equal;
      4. sorted ascending, with ties;
      5. sorted descending, with ties;
      6. a live length of 1: one key, then +inf padding;
      7. keys from a small pool (ties, +-0.0, +-inf, NaN), padded with +inf
         past a random live length;
      8. uniform keys, padded with +inf past half the row;
      9. -inf, NaN and +inf only.

    Every row but 2, 6, 7 and 8 is live to its end (a live length of K). Taken
    over K = 1, 2, 4, ..., 65536 the rows reach every code path of the CUDA
    kernel: one lane, one warp, one block, the register, shuffle and
    shared-memory stages, and the global-memory passes past ``SPAN``."""
    f32 = torch.float32
    inf, nan = float("inf"), float("nan")

    def rand(n):
        return torch.rand(n, generator=generator, dtype=torch.float64)

    def pick(values, n):
        idx = torch.randint(len(values), (n,), generator=generator)
        return torch.tensor(values, dtype=f32)[idx]

    pool = [-2.5, -0.0, 0.0, 0.5, 1.0, 7.25, -inf, inf, nan]
    ties = pick([-1.0, 0.0, 0.25, 3.0], K)
    keys = torch.empty((10, K), dtype=f32)
    keys[0] = torch.where(rand(K) < 0.125, nan, rand(K) * 2 - 1).to(f32)
    keys[1] = torch.where(rand(K) < 0.9, pick([-0.0, 0.0], K), pick([-1.0, 1.0], K))
    keys[2] = inf
    keys[3] = 0.5
    keys[4] = torch.sort(ties).values
    keys[5] = torch.sort(ties, descending=True).values
    keys[6] = inf
    keys[6, 0] = float(rand(1)[0]) * 2 - 1
    live = int(torch.randint(K + 1, (1,), generator=generator))
    keys[7] = torch.where(torch.arange(K) < live, pick(pool, K), inf)
    keys[8] = torch.where(torch.arange(K) < K // 2, (rand(K) * 2 - 1).to(f32), inf)
    keys[9] = pick([-inf, nan, inf], K)
    payload = torch.stack([torch.randperm(K, generator=generator) for _ in range(10)])
    return keys, payload.to(f32)


def _check_shape(keys: torch.Tensor, payload: torch.Tensor) -> Tuple[int, int]:
    if keys.dim() != 2 or payload.shape != keys.shape:
        raise ValueError(
            f"bitonic sort takes (G, K) keys and payload of one shape, got "
            f"{tuple(keys.shape)} and {tuple(payload.shape)}"
        )
    if keys.dtype != torch.float32 or payload.dtype != torch.float32:
        raise ValueError(
            f"bitonic sort takes float32 keys and payload, got {keys.dtype} "
            f"and {payload.dtype}"
        )
    G, K = keys.shape
    if K < 1 or K & (K - 1):
        raise ValueError("bitonic sort requires power-of-two capacity")
    return G, K
