"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/``
at the repository root (listed in ``.gitignore``), keyed by a hash of the
source and the flags, and loaded with ``ctypes``. Pointers go in as
``data_ptr()`` and the stream as ``torch.cuda.current_stream().cuda_stream``;
every C entry point returns ``cudaGetLastError()``, which
:func:`check_status` turns into an exception.

Nothing is built at import time: the first wrapper call on a CUDA tensor
builds (or finds) its library. :func:`build` starts one ``nvcc`` per missing
source, all at once.

Every source is compiled with ``--fmad=false``: a contracted ``a*b+c`` can
flip a boundary hit sitting exactly on q = 9 or on a rect edge, and the
bitmask kernel is checked bit for bit against its plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("bitmask_gen", "raster_tile")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel, and nowhere else. Read and reset by whoever drives a path.
LAUNCHES: Dict[str, int] = {
    "bitmask_gen": 0,
    "raster_group_fused": 0,
    "raster_tile": 0,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def count_launch(kernel: str) -> None:
    with _lock:
        LAUNCHES[kernel] += 1


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source and
    the flags, so an edited source never loads a stale library."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc`` per
    source, all started together. Returns the seconds each build took (0 for
    a library already built). Raises with the compiler's output on failure;
    the ``ptxas`` report (registers, shared memory, spills) of a build that
    succeeds is kept beside its library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        Path(f"{out}.log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


# Argument kinds of the C entry points: pointers (and the stream) go as
# c_void_p, sizes and flags as c_int.
P, I = ctypes.c_void_p, ctypes.c_int


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``signatures`` (entry point -> argtypes; every one returns a CUDA status
    as int) declared."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.gstg_error_string.argtypes = [ctypes.c_int]
    lib.gstg_error_string.restype = ctypes.c_char_p
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    with _lock:
        return _libs.setdefault(name, lib)


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronise would not report it)."""
    if status != 0:
        msg = lib.gstg_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the int the C entry
    points take."""
    return torch.cuda.current_stream(t.device).cuda_stream
