#!/usr/bin/env python3
"""Shows whether ``chip_smoke.py``'s decode checks can fail: it runs a
check once as the port decodes, then once under each of two decode faults
patched into ``Transformer.decode_step`` for the run, and prints each
run's line.

- ``--arch zamba2-7b`` (the default): ``[hybrid serve]``'s f32 check
  (``f32_decode_vs_forward``: zamba2-7b at full width and depth, f32
  parameters and activations);
- ``--arch gemma2-2b``: ``[serve engine]``'s two checks, the bf16 one
  (``engine_vs_forward``: gemma2-2b at full width and depth, the decode
  logits within ``LOGIT_CONTROL_FACTOR`` times their distance from a
  control forward), which a decode fault does not fail (it moves the
  control as much as the decode), and its f32 rerun
  (``f32_decode_vs_forward``), which must.

The faults:

- ``position``: from step 20 on, each step decodes at position + 1 (its
  rotary phase and its cache slot are one off);
- ``cache-swap``: from step 20 on, two attention applications next to
  each other (zamba2's shared block's 6th and 7th, gemma2's layers 6 and
  7) read and write each other's K/V caches.

Run from the repository root on a machine with one CUDA card:

    python3 tools/hybrid_decode_mutants.py [--arch gemma2-2b]

It prints the card's name and power limit first, and exits 1 unless the
unpatched decode passes and both faults fail the f32 check.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402  (puts src/ on the path)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=CS.ZAMBA,
                    choices=[CS.ZAMBA, "gemma2-2b"])
    args = ap.parse_args(argv)
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import pattern_summary as K
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.models.transformer import Transformer
    print(CS.gpu_line(), flush=True)
    _build.build_all([(K.SOURCE, "k1_pattern_summary"),
                      (K2.SOURCE, "k2_flash_attention"),
                      (K3.SOURCE, "k3_ssd_scan")])
    cfg = ARCHS[args.arch]
    orig = Transformer.decode_step
    # the first of the two swapped K/V caches: a hybrid model's list holds
    # its SSM caches first, then one per application of the shared block
    first = cfg.num_layers + 5 if cfg.family == "hybrid" else 6

    def position(self, p, cache, batch, pos):
        return orig(self, p, cache, batch, pos + 1 if pos >= 20 else pos)

    def cache_swap(self, p, cache, batch, pos):
        c = list(cache)
        if pos >= 20:
            c[first], c[first + 1] = c[first + 1], c[first]
        logits, _ = orig(self, p, c, batch, pos)
        return logits, cache

    checks = [("f32", lambda tag: CS.f32_decode_vs_forward(
        tag, cfg, K, K2, K3, CS.ENGINE_PROMPT, CS.ENGINE_NEW))]
    if cfg.family != "hybrid":
        checks.insert(0, ("bf16", lambda tag: CS.free_engine(
            CS.engine_vs_forward(tag, cfg, K, K2, K3, CS.ENGINE_PROMPT,
                                 CS.ENGINE_NEW))))
    ok = True
    for name, fn in (("none", orig), ("position", position),
                     ("cache-swap", cache_swap)):
        for check, run in checks:
            Transformer.decode_step = fn
            t = time.perf_counter()
            try:
                run(f"[{name}]")
                failed = False
            except AssertionError:
                failed = True
            finally:
                Transformer.decode_step = orig
            print(f"fault {name}: the {check} check "
                  f"{'failed' if failed else 'passed'} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
            if check == "f32" or name == "none":
                ok &= failed == (name != "none")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
