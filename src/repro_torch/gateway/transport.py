"""Line-JSON subprocess transport: the out-of-process worker form (mirror of
``repro.gateway.transport``).

The gateway side (:class:`SubprocessWorker`, this module — pure Python, no
torch at import) spawns ``python -m repro_torch.gateway.worker_main`` and
speaks a one-line-JSON request/response protocol over the child's
stdin/stdout:

  parent -> child   {"op": "ping|commit|dispatch|shutdown", "id": n, ...}
  child  -> parent  {"id": n, "ok": true, ...}          (same order, 1:1)

The child owns its own torch runtime (its own CUDA context on the card the
parent names) and a ``RenderServer``; the first line it emits is a
``{"ready": true}`` banner after scenes are built. Cameras ship with
pose/translation as base64 raw bytes (dtype+shape alongside) so the child
reconstructs BITWISE-identical ``Camera`` values — the parity invariant
must survive the wire. Images come back the same way. The wire format is
the JAX package's: an array encoded by either package decodes bit for bit
in the other.

A reply line is large at the paper's frame: one 1952x1088 float32 image is
25,485,312 bytes, 33,980,416 base64 characters. :meth:`SubprocessWorker._read_line`
therefore scans each byte for the newline once and joins the line once,
linear in the line's length (the JAX package re-scans and re-copies its
whole buffer after every pipe read, quadratic in it).

Failure model: any transport fault — EOF (the child died, e.g. our
``kill()``'s SIGKILL), a read timeout, a broken pipe, a protocol error, or
an ``ok: false`` reply — raises :class:`WorkerDied` and the worker is done
(the gateway never routes to it again; ``shutdown()`` reaps the process).
That maps exactly onto the all-or-nothing dispatch contract: a child that
died mid-batch completed none of it.
"""
from __future__ import annotations

import base64
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.gateway.errors import WorkerDied

__all__ = ["SubprocessWorker", "WireResult", "encode_array", "decode_array"]


def encode_array(arr) -> dict:
    """numpy array or CPU tensor -> JSON-safe {b64, dtype, shape} (bitwise
    round-trip; the dtype is numpy's name, as the JAX package writes it)."""
    import numpy as np

    torch = sys.modules.get("torch")      # a tensor exists only if torch is loaded
    if torch is not None and isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(arr)
    return {
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
    }


def decode_array(doc: dict):
    """{b64, dtype, shape} -> a writable numpy array, bit for bit."""
    import numpy as np

    return np.frombuffer(
        bytearray(base64.b64decode(doc["b64"])), dtype=np.dtype(doc["dtype"])
    ).reshape(doc["shape"])


def encode_camera(cam) -> dict:
    # fx/fy/cx/cy/znear/zfar are Python floats: JSON round-trips them
    # exactly (repr-based); only the arrays need the byte-exact path.
    return {
        "R": encode_array(cam.R),
        "t": encode_array(cam.t),
        "fx": float(cam.fx), "fy": float(cam.fy),
        "cx": float(cam.cx), "cy": float(cam.cy),
        "width": int(cam.width), "height": int(cam.height),
        "znear": float(cam.znear), "zfar": float(cam.zfar),
    }


def encode_request(req) -> dict:
    # cfg intentionally does NOT ship: the child renders every request under
    # its OWN RenderConfig (built from the same CLI flags as the parent's),
    # which is what keeps one render signature per child.
    return {
        "request_id": req.request_id,
        "scene_id": req.scene_id,
        "stream_id": req.stream_id,
        "camera": encode_camera(req.camera),
    }


@dataclass
class WireResult:
    """A completed request as decoded off the wire (duck-types the serving
    tier's ``RequestResult`` where the gateway cares: ``.image``, a CPU
    tensor)."""

    request_id: int
    image: Any
    latency_s: float
    batch_size: int


class SubprocessWorker:
    """A fleet member living in a child process.

    ``argv`` is the full child command line (the CLI composes it around
    ``repro_torch.gateway.worker_main``); ``scene_ids`` mirrors what the
    child was told to host. The parent keeps the committed-scene set from
    the child's replies, so affinity routing never pays an RPC.
    ``startup_s`` is spawn to ready banner; ``wire`` records, per
    dispatch, the round trip, the child's largest reported ``latency_s``,
    the reply line's bytes, and where the round trip went: waiting for the
    reply's first byte (the child renders and encodes), the line's
    transfer through the pipe, parsing it, decoding its images.
    """

    def __init__(
        self,
        worker_id: str,
        scene_ids: Sequence[str],
        argv: Sequence[str],
        *,
        max_batch: int = 8,
        read_timeout_s: float = 120.0,
        ready_timeout_s: float = 300.0,
        env: Optional[Dict[str, str]] = None,
    ):
        self.worker_id = worker_id
        self.scene_ids = frozenset(scene_ids)
        self.max_batch = max_batch
        self.read_timeout_s = read_timeout_s
        self._lock = threading.Lock()      # serializes the req/resp pairing
        self._seq = 0
        self._partial: List[bytes] = []    # the current line's bytes so far
        self._lines: deque = deque()       # complete lines not yet consumed
        self._committed: set = set()
        self._resident: Optional[set] = None   # None until first report
        self._killed = False
        self._line_start = self._sent = 0.0
        self.last_line: dict = {}
        self.wire: List[dict] = []
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            list(argv),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=None,                   # child logs inherit our stderr
            env=env,
            bufsize=0,
        )
        banner = self._read_line(ready_timeout_s)
        if not banner.get("ready"):
            self._reap()
            raise WorkerDied(
                f"worker {worker_id} failed to start: {banner!r}"
            )
        self.startup_s = time.perf_counter() - t0
        self.devices = int(banner.get("devices", 1))

    # -- wire ----------------------------------------------------------------

    def _read_line(self, timeout_s: float) -> dict:
        """One JSON line off the child's stdout, or WorkerDied on
        EOF/timeout/garbage. select-based so a hung child can't hang us.
        Each pipe read is split at its own newlines, and a line's pieces are
        joined once when its newline arrives: linear in the line's length.
        ``last_line`` keeps the line's bytes, the times its first byte and
        its newline arrived, and the seconds its parse took."""
        fd = self.proc.stdout.fileno()
        deadline = time.monotonic() + timeout_s
        while not self._lines:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._reap()
                raise WorkerDied(
                    f"worker {self.worker_id} unresponsive for {timeout_s}s"
                )
            ready, _, _ = select.select([fd], [], [], min(remaining, 0.5))
            if not ready:
                continue
            chunk = os.read(fd, 1 << 20)
            now = time.perf_counter()
            if not chunk:                  # EOF: the child is gone
                self._reap()
                raise WorkerDied(
                    f"worker {self.worker_id} exited "
                    f"(code {self.proc.poll()})"
                )
            if not self._partial:          # this read starts a line
                self._line_start = now
            *done, rest = chunk.split(b"\n")
            if done:
                self._lines.append(
                    (b"".join(self._partial + [done[0]]), self._line_start, now))
                self._lines.extend((part, now, now) for part in done[1:])
                self._partial = []
                self._line_start = now
            if rest:
                self._partial.append(rest)
        line, first_byte, newline = self._lines.popleft()
        t = time.perf_counter()
        try:
            rep = json.loads(line)
        except ValueError as e:
            self._reap()
            raise WorkerDied(
                f"worker {self.worker_id} wrote a non-protocol line: "
                f"{line[:200]!r}"
            ) from e
        self.last_line = {"bytes": len(line), "first_byte": first_byte,
                          "newline": newline, "parse_s": time.perf_counter() - t}
        return rep

    def _rpc(self, msg: dict, timeout_s: Optional[float] = None) -> dict:
        with self._lock:
            if not self.alive():
                raise WorkerDied(f"worker {self.worker_id} is dead")
            self._seq += 1
            msg = dict(msg, id=self._seq)
            try:
                self.proc.stdin.write(
                    (json.dumps(msg) + "\n").encode("ascii")
                )
                self.proc.stdin.flush()
                self._sent = time.perf_counter()
            except (BrokenPipeError, OSError) as e:
                self._reap()
                raise WorkerDied(
                    f"worker {self.worker_id} pipe broke: {e}"
                ) from e
            rep = self._read_line(
                self.read_timeout_s if timeout_s is None else timeout_s
            )
            if rep.get("id") != self._seq or not rep.get("ok"):
                err = rep.get("error", f"bad reply {rep!r}")
                self._reap()
                raise WorkerDied(f"worker {self.worker_id}: {err}")
            if "committed" in rep:
                self._committed = set(rep["committed"])
            if "resident" in rep:
                self._resident = set(rep["resident"])
            return rep

    # -- worker contract -----------------------------------------------------

    def alive(self) -> bool:
        return not self._killed and self.proc.poll() is None

    def ping(self) -> None:
        self._rpc({"op": "ping"}, timeout_s=min(self.read_timeout_s, 10.0))

    def committed_scene_ids(self) -> set:
        return set(self._committed)

    def resident_scene_ids(self) -> set:
        """Scenes the child last reported device-resident (DESIGN.md §17).
        Replies carry the set alongside ``committed``; before any report
        fall back to the committed set so residency routing degrades to
        plain affinity."""
        if self._resident is None:
            return set(self._committed)
        return set(self._resident)

    def commit(self, scene_id: str, cfg=None) -> None:
        """Pre-commit ``scene_id`` in the child (the child applies its own
        config — ``cfg`` is accepted for contract parity and ignored)."""
        self._rpc({"op": "commit", "scene_id": scene_id})

    def dispatch(self, requests: List[Any]) -> Dict[int, WireResult]:
        import torch

        t0 = time.perf_counter()
        rep = self._rpc({
            "op": "dispatch",
            "requests": [encode_request(r) for r in requests],
        })
        line = self.last_line
        t_decode = time.perf_counter()
        out: Dict[int, WireResult] = {}
        for res in rep.get("results", []):
            out[res["request_id"]] = WireResult(
                request_id=res["request_id"],
                image=torch.from_numpy(decode_array(res["image"])),
                latency_s=float(res.get("latency_s", 0.0)),
                batch_size=int(res.get("batch_size", 1)),
            )
        missing = [r.request_id for r in requests if r.request_id not in out]
        if missing:
            self._reap()
            raise WorkerDied(
                f"worker {self.worker_id} lost requests {missing}"
            )
        t1 = time.perf_counter()
        self.wire.append({
            "requests": len(requests),
            "round_trip_s": t1 - t0,
            "child_latency_s": max(r.latency_s for r in out.values()),
            "line_bytes": line["bytes"],
            "reply_wait_s": line["first_byte"] - self._sent,
            "transfer_s": line["newline"] - line["first_byte"],
            "parse_s": line["parse_s"],
            "decode_s": t1 - t_decode,
        })
        return out

    def kill(self) -> None:
        """SIGKILL — a real node loss, no goodbye. The in-flight dispatch
        (if any) sees EOF and raises; failover takes it from there."""
        self._killed = True
        try:
            self.proc.send_signal(signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass

    def shutdown(self) -> None:
        if self.proc.poll() is None and not self._killed:
            try:
                self._rpc({"op": "shutdown"}, timeout_s=10.0)
            except WorkerDied:
                pass
        self._reap()

    def _reap(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        for pipe in (self.proc.stdin, self.proc.stdout):
            try:
                pipe.close()
            except OSError:
                pass

    def __repr__(self) -> str:
        state = "alive" if self.alive() else "dead"
        return (
            f"<SubprocessWorker {self.worker_id} pid={self.proc.pid} {state} "
            f"scenes={sorted(self.scene_ids)}>"
        )


def worker_argv(
    worker_id: str,
    scene_specs: Sequence[str],
    *,
    device: Optional[str] = None,
    python: Optional[str] = None,
    extra: Sequence[str] = (),
) -> List[str]:
    """The child command line for ``repro_torch.gateway.worker_main``.

    ``scene_specs`` are scene ids, or ``sid:global_index`` pairs as the JAX
    package writes them; the port seeds each synthetic scene from the crc32
    of its name, so a worker hosting any subset of the fleet's scenes
    builds each one bit-identically to a single-server run (the parity
    invariant), and the index is parsed but keys nothing.
    """
    argv = [
        python or sys.executable, "-m", "repro_torch.gateway.worker_main",
        "--worker-id", worker_id,
        "--scenes", ",".join(scene_specs),
    ]
    if device:
        argv += ["--device", str(device)]
    argv += list(extra)
    return argv
