"""Batched greedy LM serving: prefill (teacher-forced decode) + decode
(mirror of ``repro.launch.serve``).

Serves a (smoke or full) LM with a batch of requests: fills the KV cache by
stepping the prompt tokens, then greedily decodes continuations.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch granite-3-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --full-config --batch 8 \\
      --prompt-len 64 --gen-len 64

Differences from the JAX package's CLI: ``--device`` (CUDA unless the
caller names another; there is no fallback) and ``--seed``. The weights and
prompts come from ``torch.Generator``s seeded with ``--seed``, so they are
not the JAX package's values. The generated tokens stay on the device until
the loop ends, where the JAX loop copies each one to the host.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_param_spec, decode_step, init_cache
from repro_torch.models.spec import init_from_spec
from repro_torch.utils import resolve_device


def generate(cfg, params, prompts: torch.Tensor, gen_len: int, on_step=None):
    """The serve loop: ``prompts`` (B, prompt_len) stepped through
    ``decode_step`` to fill the cache, then greedy steps. Returns the
    generated tokens (B, gen_len) (one token when ``gen_len`` is 0, as the
    JAX loop gives). ``on_step(phase, pos, logits, next_tokens)``, where
    given, is called after every step with phase 'prefill' or 'decode'."""
    batch, prompt_len = prompts.shape
    if prompt_len < 1 or gen_len < 0:
        raise ValueError(f"need prompt_len >= 1 and gen_len >= 0, got {prompt_len}, {gen_len}")
    max_seq = prompt_len + gen_len
    cache = init_cache(cfg, batch, max_seq, prompts.device)
    for pos in range(prompt_len):  # prefill by teacher-forced stepping
        nxt, logits, cache = decode_step(cfg, params, cache, prompts[:, pos], pos)
        if on_step is not None:
            on_step("prefill", pos, logits, nxt)
    generated = [nxt]
    for pos in range(prompt_len, max_seq - 1):
        nxt, logits, cache = decode_step(cfg, params, cache, generated[-1], pos)
        if on_step is not None:
            on_step("decode", pos, logits, nxt)
        generated.append(nxt)
    return torch.stack(generated, dim=1)


def serve(
    arch: str,
    batch: int = 4,
    prompt_len: int = 16,
    gen_len: int = 16,
    smoke: bool = True,
    seed: int = 0,
    device=None,
):
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.family == "encoder":
        raise SystemExit(f"{arch} is encoder-only: no decode serving")
    params = init_from_spec(build_param_spec(cfg),
                            torch.Generator(device=dev).manual_seed(seed), dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed))
    t0 = time.time()
    gen = generate(cfg, params, prompts, gen_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tput = batch * gen.shape[1] / dt
    print(
        f"{arch}: served batch={batch} prompt={prompt_len} gen={gen.shape[1]} "
        f"in {dt:.2f}s ({tput:.1f} tok/s incl prefill steps)"
    )
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with torch.inference_mode():
        serve(
            args.arch,
            batch=args.batch,
            prompt_len=args.prompt_len,
            gen_len=args.gen_len,
            smoke=not args.full_config,
            seed=args.seed,
            device=args.device,
        )


if __name__ == "__main__":
    main()
