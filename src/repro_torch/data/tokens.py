"""Deterministic, seekable synthetic token pipeline (a copy of
``repro.data.tokens``: numpy only, so the port keeps its own).

Every batch is a pure function of (seed, step) — restart at step k reproduces
the exact stream with no cursor files (the checkpoint only stores the step).
Generation uses a counter-based hash (splitmix64) so any (step, position) can
be materialized independently: this is what makes elastic resharding trivial
— a host can produce any slice of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
        """Rows [lo, hi) of the global batch at ``step`` (for sharded hosts)."""
        hi = self.global_batch if hi is None else hi
        rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        ctr = (
            np.uint64(self.seed) * np.uint64(0x1000003)
            + np.uint64(step) * np.uint64(0x100000001B3)
            + rows * np.uint64(self.seq_len + 1)
            + cols
        )
        h = _splitmix64(ctr)
        return (h % np.uint64(self.vocab)).astype(np.int32)


def make_batch(
    stream: TokenStream,
    step: int,
    frontend: str = "text",
    n_frontend_tokens: int = 0,
    d_model: int = 0,
) -> Dict[str, np.ndarray]:
    """Model-ready batch: inputs + next-token labels (+ frontend stubs)."""
    full = stream.batch_at(step)                 # (B, S+1)
    tokens, labels = full[:, :-1], full[:, 1:]
    B, S = tokens.shape
    if frontend == "vision_stub":
        s_text = S - n_frontend_tokens
        rng = np.random.default_rng(stream.seed * 7919 + step)
        return {
            "tokens": tokens[:, :s_text],
            "labels": labels[:, :s_text],
            "patch_embeds": rng.standard_normal(
                (B, n_frontend_tokens, d_model), dtype=np.float32
            )
            * 0.02,
        }
    if frontend == "audio_stub":
        rng = np.random.default_rng(stream.seed * 104729 + step)
        return {
            "frames": rng.standard_normal((B, S, d_model), dtype=np.float32)
            * 0.02,
            "labels": labels % 504,
        }
    return {"tokens": tokens, "labels": labels}
