"""Group Sorting Module (GSM, paper Fig 10): bitonic-sort CUDA kernel wrapper
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro.kernels.bitonic_sort.bitonic_sort_kernel``:
per row, an ascending sort of float32 keys that carries a 32-bit payload.
K is a power of two and invalid slots hold +inf so they sink to the end.
The network is not stable, but it is deterministic: ties, ``±0.0`` and the
+inf padding come out in one fixed order, and the payload follows its key
word for word. ``bitonic_sort_plain`` runs the TPU kernel's network stage
for stage (``_bitonic_network``), so both agree bitwise with it.

The CUDA source is ``csrc/bitonic_sort.cu``: one block per row, the row in
shared memory, every stage there; rows longer than the shared-memory span
add global-memory passes for the wide stages. ``bitonic_sort_kernel``
launches it for CUDA tensors and runs ``bitonic_sort_plain`` for CPU
tensors; it never falls back from one to the other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

_P, _I = build.P, build.I
_SIGNATURES = {
    # keys, vals, keys_out, vals_out, G, K, stream
    "bitonic_sort_launch": [_P, _P, _P, _P, _I, _I, _P],
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
