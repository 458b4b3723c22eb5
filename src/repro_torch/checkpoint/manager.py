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
package restores leaf for leaf in the other. :func:`tree_unflatten` puts
restored leaves back into a tree of the saved structure.

Restore validates hashes and returns CPU tensors, or tensors on
``device=`` when it is given (the port's stand-in for the JAX package's
``sharding_tree``): that is how elastic re-scaling (``ft/elastic.py``)
resumes on other devices.
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
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

try:  # optional: checkpoints are written uncompressed when unavailable
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

# zstd frame magic number — lets restore() auto-detect how a file was written
# regardless of which environment wrote it.
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _children(tree) -> Optional[Tuple[list, Any]]:
    """(children in jax's order, a rebuild function), or None for a leaf."""
    if tree is None:
        return [], lambda xs: None
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda xs: type(tree)(zip(keys, xs))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):       # NamedTuple
        return list(tree), lambda xs: type(tree)(*xs)
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda xs: type(tree)(xs)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return ([getattr(tree, n) for n in names],
                lambda xs: dataclasses.replace(tree, **dict(zip(names, xs))))
    return None


def tree_flatten(tree) -> Tuple[list, str]:
    """The leaves of ``tree`` in jax's order, and a description of its
    structure (the manifest's ``treedef``)."""
    leaves: list = []

    def walk(node) -> str:
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            return "*"
        if node is None:
            return "None"
        parts = [walk(c) for c in kids[0]]
        if isinstance(node, Mapping):
            parts = [f"{k!r}: {p}" for k, p in zip(sorted(node), parts)]
            return "{" + ", ".join(parts) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(parts) + "]"
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return "(" + ", ".join(parts) + ")"
        return f"{type(node).__name__}(" + ", ".join(parts) + ")"

    desc = walk(tree)
    return leaves, f"PyTreeDef({desc})"


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in jax's order)."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        children, rebuild = kids
        return rebuild([build(c) for c in children])

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


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
            leaf = torch.from_numpy(arr)
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
