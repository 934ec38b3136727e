#!/usr/bin/env python3
"""Shows that ``chip_smoke.py``'s f32 decode check of ``[hybrid serve]``
(``f32_decode_vs_forward``: zamba2-7b at full width and depth, f32
parameters and activations) can fail: it runs the check once as the port
decodes, then once under each of two decode faults patched into
``Transformer.decode_step`` for the run, and prints each run's line.

- ``position``: from step 20 on, each step decodes at position + 1 (its
  rotary phase and its cache slot are one off);
- ``cache-swap``: from step 20 on, the shared attention block's 6th and
  7th applications read and write each other's K/V caches.

Run from the repository root on a machine with one CUDA card:

    python3 tools/hybrid_decode_mutants.py

It prints the card's name and power limit first, and exits 1 unless the
unpatched decode passes and both faults fail.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402  (puts src/ on the path)


def main() -> int:
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
    cfg = ARCHS[CS.ZAMBA]
    L, orig = cfg.num_layers, Transformer.decode_step

    def position(self, p, cache, batch, pos):
        return orig(self, p, cache, batch, pos + 1 if pos >= 20 else pos)

    def cache_swap(self, p, cache, batch, pos):
        c = list(cache)
        if pos >= 20:
            c[L + 5], c[L + 6] = c[L + 6], c[L + 5]
        logits, _ = orig(self, p, c, batch, pos)
        return logits, cache

    ok = True
    for name, fn in (("none", orig), ("position", position),
                     ("cache-swap", cache_swap)):
        Transformer.decode_step = fn
        t = time.perf_counter()
        try:
            CS.f32_decode_vs_forward(f"[{name}]", cfg, K, K2, K3,
                                     CS.ENGINE_PROMPT, CS.ENGINE_NEW)
            failed = False
        except AssertionError:
            failed = True
        finally:
            Transformer.decode_step = orig
        print(f"fault {name}: the check {'failed' if failed else 'passed'} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        ok &= failed == (name != "none")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
