"""Batched serving example on the PyTorch port: greedy/temperature decode
with KV caches on a small model; reports tokens/s.

  PYTHONPATH=src python examples_torch/serve_lm.py --arch deepseek-v2-lite-16b
  PYTHONPATH=src python examples_torch/serve_lm.py --device cpu

The model serves on the card unless ``--device cpu`` is given; without a
card and without that flag it raises.
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.models.transformer import Transformer, param_leaves
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-34b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = reduced(ARCHS[args.arch], d_model=128, layers=4, vocab=512)
    model = Transformer(cfg)
    params = model.init(0, device=args.device)
    n = sum(t.numel() for _, t in param_leaves(params))
    print(f"serving {cfg.name} (reduced, {n/1e6:.1f}M params) "
          f"batch={args.batch}")

    engine = Engine(cfg, params, ServeConfig(
        batch=args.batch, max_len=args.prompt_len + args.new_tokens,
        temperature=args.temperature), device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"generated {out.shape} in {dt:.2f}s ({tps:.1f} tok/s)")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {out[b, :args.prompt_len].tolist()} => "
              f"{out[b, args.prompt_len:].tolist()}")
    return out


if __name__ == "__main__":
    main()
