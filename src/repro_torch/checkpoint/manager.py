"""Checkpointing: atomic, integrity-checked, async, retention-managed (mirror
of ``repro.checkpoint.manager``).

Format (the JAX package's): one .npz (a zstd-compressed stream when
``zstandard`` is installed) per checkpoint holding the flat leaves plus a
JSON manifest (step, tree structure, per-leaf sha256, extra). Writes go to a
temp name + fsync + rename (atomic on POSIX), so a preempted writer never
corrupts the latest-good checkpoint. An async writer thread overlaps
serialization with the next training steps.

Leaves are flattened in jax's order — dict keys sorted, lists and tuples
(named ones too) in order, a dataclass such as ``GaussianScene`` by its
fields in declaration order (as ``register_dataclass`` flattens the JAX
package's), None an empty subtree — so a checkpoint written by either
package restores leaf for leaf in the other (``utils/misc.py::tree_flatten``,
re-exported here). :func:`tree_unflatten` puts restored leaves back into a
tree of the saved structure.

A bfloat16 leaf is written as the JAX manager writes one (its bits as
2-byte voids, ``|V2``) and restored as bfloat16. Restore validates hashes
and returns CPU tensors, or tensors on ``device=`` when it is given (the
port's stand-in for the JAX package's ``sharding_tree``): that is how
elastic re-scaling (``ft/elastic.py``) resumes on other devices.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.utils.misc import tree_flatten, tree_unflatten  # noqa: F401  (re-exported)

try:  # optional: checkpoints are written uncompressed when unavailable
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

# zstd frame magic number — lets restore() auto-detect how a file was written
# regardless of which environment wrote it.
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array the JAX manager writes for it. numpy has
    no bfloat16: the JAX manager's ``ml_dtypes.bfloat16`` array is saved
    as 2-byte voids, so a bf16 tensor is written as its bits viewed as
    ``|V2`` (the same bytes, so the same sha256)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2").copy()
        return leaf.numpy().copy()
    return np.array(leaf)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A restored array as a CPU tensor. In the trees of both packages a
    2-byte void leaf can only be bf16 (float16 saves as ``<f2``, the
    float8 types are 1 byte): it becomes a bfloat16 tensor of the same
    bits. Any other void width is refused."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"checkpoint leaf of dtype {arr.dtype.str} ({arr.dtype.itemsize}-byte "
                            "void) has no torch dtype; only 2-byte voids (bfloat16) restore")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointInfo:
    step: int
    path: str
    manifest: Dict[str, Any]


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep: int = 3,
        async_write: bool = True,
    ):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ---------- public API ----------

    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None):
        """Snapshot ``tree`` at ``step``. Host-copies immediately (so training
        can mutate buffers), then writes sync or async."""
        leaves, treedef = tree_flatten(tree)
        host_leaves = [_host(x) for x in leaves]
        payload = (step, host_leaves, treedef, extra or {})
        if self.async_write:
            self._q.put(payload)
        else:
            self._write(payload)

    def wait(self):
        """Block until pending async writes are on disk."""
        if self.async_write:
            self._q.join()
        if self._errors:
            raise RuntimeError(f"checkpoint writer failed: {self._errors[0]}")

    def latest(self) -> Optional[CheckpointInfo]:
        steps = self.all_steps()
        return self._info(steps[-1]) if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                out.append(int(f[5:-4]))
        return sorted(out)

    def restore(self, step: Optional[int] = None, device=None):
        """Load (leaves, manifest): the leaves as CPU tensors in the saved
        order, or on ``device`` when it is given."""
        if step is None:
            info = self.latest()
            if info is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
            step = info.step
        path = self._path(step)
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] == _ZSTD_MAGIC:
            if zstandard is None:
                raise ImportError(
                    f"checkpoint {path} is zstd-compressed but the 'zstandard' "
                    "package is not installed"
                )
            raw = zstandard.ZstdDecompressor().decompress(raw)
        buf = io.BytesIO(raw)
        npz = np.load(buf, allow_pickle=False)
        manifest = json.loads(str(npz["__manifest__"]))
        leaves = []
        for i in range(manifest["n_leaves"]):
            arr = npz[f"leaf_{i}"]
            digest = hashlib.sha256(arr.tobytes()).hexdigest()
            if digest != manifest["hashes"][i]:
                raise IOError(
                    f"checkpoint {path} leaf {i} hash mismatch — corrupt file"
                )
            leaf = _tensor(arr)
            leaves.append(leaf if device is None else leaf.to(device))
        return leaves, manifest

    # ---------- internals ----------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.npz")

    def _info(self, step: int) -> CheckpointInfo:
        return CheckpointInfo(step=step, path=self._path(step), manifest={})

    def _drain(self):
        while True:
            payload = self._q.get()
            try:
                self._write(payload)
            except BaseException as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, payload):
        step, leaves, treedef_str, extra = payload
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": treedef_str,
            "hashes": [hashlib.sha256(a.tobytes()).hexdigest() for a in leaves],
            "time": time.time(),
            "extra": extra,
        }
        buf = io.BytesIO()
        arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
        arrays["__manifest__"] = np.asarray(json.dumps(manifest))
        np.savez(buf, **arrays)
        comp = buf.getvalue()
        if zstandard is not None:
            comp = zstandard.ZstdCompressor(level=3).compress(comp)
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(comp)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
