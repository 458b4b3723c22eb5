"""Train a small LM for a few hundred steps on the synthetic token stream,
with async checkpointing + resume (the ``repro_torch.launch.train`` loop;
mirror of the JAX package's ``examples/train_lm.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--arch smollm-360m --steps 300]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 40

It runs the reduced (smoke) config and fails unless the loss falls.
"""
import argparse

from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="results/ckpt_lm_torch")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    _, history = train(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=100,
        smoke=True,
        device=args.device,
    )
    first, last = history[0], history[-1]
    print(
        f"\nloss {first['loss']:.4f} (step {first['step']}) -> "
        f"{last['loss']:.4f} (step {last['step']})"
    )
    if not last["loss"] < first["loss"]:
        raise SystemExit("training did not reduce loss")


if __name__ == "__main__":
    main()
