"""End-to-end training driver on the PyTorch port: a ~25M-param
gemma2-family model on the synthetic-LM pipeline for a few hundred steps
(pass --arch/--steps to scale).  Loss decreases; checkpoints + PerfTracker
online.

  PYTHONPATH=src python examples_torch/train_lm.py --steps 200
  PYTHONPATH=src python examples_torch/train_lm.py --steps 20 --device cpu

The run is on the card unless ``--device cpu`` is given; without a card
and without that flag it raises.
"""
import argparse
import tempfile
from pathlib import Path

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = reduced(ARCHS[args.arch], layers=args.layers,
                  d_model=args.d_model, vocab=args.vocab)
    n = cfg.param_counts()["total"]
    print(f"arch={cfg.name} (reduced) params~{n/1e6:.1f}M "
          f"batch={args.batch}x{args.seq}")
    trainer = Trainer(
        cfg,
        DataConfig(batch=args.batch, seq_len=args.seq),
        OptConfig(lr_peak=args.lr, warmup_steps=max(10, args.steps // 20),
                  total_steps=args.steps),
        TrainConfig(steps=args.steps, log_every=max(1, args.steps // 20),
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.steps // 4,
                    perftracker=True),
        device=args.device,
    )
    trainer.run()
    first = trainer.history[0]["loss"]
    last = trainer.history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    print(f"checkpoints: {trainer.ckpt.steps()} in {args.ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
