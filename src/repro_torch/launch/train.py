"""LM training loop: data pipeline -> train step -> checkpoints (mirror of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch smollm-360m --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --full-config --arch granite-3-2b \\
      --steps 10 --batch 2 --seq 4096

Runs a smoke config (or, with ``--full-config``, the full one) on one
device. Checkpoints every ``ckpt_every`` steps go through the port's
``CheckpointManager`` (the JAX package's file format: a bf16 leaf as its
bits); on restart the latest checkpoint restores (params, optimizer state,
step) and the counter-based ``TokenStream`` regenerates the exact batch
sequence. A ``HeartbeatMonitor`` records each step's latency (one host
here).

Differences from the JAX package's ``train``: ``--device`` (CUDA unless the
caller names another; there is no fallback) and ``--seed``; the weights
come from a ``torch.Generator`` seeded with ``seed``, so they are not the
JAX package's values. The JAX package's ``train`` cannot resume a run
whose parameters are bf16 (``jnp.asarray`` refuses the restored 2-byte
voids); this one restores them as bf16.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenStream, make_batch
from repro_torch.ft import HeartbeatMonitor
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_param_spec
from repro_torch.models.spec import init_from_spec
from repro_torch.optim import adafactor_init, adamw_init
from repro_torch.utils import resolve_device, tree_unflatten


def device_batch(np_batch, device) -> dict:
    """A ``make_batch`` batch as tensors on ``device`` (token ids as int64,
    the index dtype torch gathers with)."""
    out = {}
    for k, v in np_batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if v.dtype.kind == "i" else t).to(device)
    return out


def train(
    arch: str,
    steps: int = 100,
    batch: int = 4,
    seq: int = 128,
    lr: float = 3e-3,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    smoke: bool = True,
    seed: int = 0,
    log_every: int = 10,
    device=None,
):
    """Train ``arch`` for ``steps`` steps (resuming from the latest
    checkpoint in ``ckpt_dir``). Returns (params, history): one entry a
    logged step with its metrics as floats and ``s_per_step``."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    step_fn, optname = make_train_step(cfg, None, lr=lr, total_steps=steps)

    params = init_from_spec(build_param_spec(cfg),
                            torch.Generator(device=dev).manual_seed(seed), dev)
    opt_state = adamw_init(params) if optname == "adamw" else adafactor_init(params)
    stream = TokenStream(cfg.vocab, batch, seq, seed=seed)

    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        if mgr.all_steps():
            leaves, manifest = mgr.restore(device=dev)
            restored = tree_unflatten({"params": params, "opt": opt_state}, leaves)
            params, opt_state = restored["params"], restored["opt"]
            start = manifest["step"]
            print(f"resumed from step {start}")

    monitor = HeartbeatMonitor(n_hosts=1)
    history = []
    for i in range(start, steps):
        t0 = time.time()
        np_batch = make_batch(stream, i, cfg.frontend, cfg.n_frontend_tokens, cfg.d_model)
        params, opt_state, metrics = step_fn(params, opt_state, device_batch(np_batch, dev), i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        monitor.report(0, i, dt, now_s=time.time())
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m, "s_per_step": dt})
            print(
                f"step {i:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"gnorm={m['grad_norm']:.3f} ({dt:.2f}s)"
            )
        if mgr and (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.wait()
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    train(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        smoke=not args.full_config,
        seed=args.seed,
        device=args.device,
    )


if __name__ == "__main__":
    main()
