"""Serve a small LM with batched greedy decoding (the KV-cache decode path
of ``repro_torch.launch.serve``; mirror of the JAX package's
``examples/serve_lm.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch granite-3-2b]
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
import argparse

import torch

from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    with torch.inference_mode():
        gen = serve(
            args.arch,
            batch=args.batch,
            prompt_len=args.prompt_len,
            gen_len=args.gen_len,
            smoke=True,
            device=args.device,
        )
    print("sample continuation token ids:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
