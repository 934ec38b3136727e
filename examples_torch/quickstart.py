"""Quickstart on the PyTorch port: train a tiny LM with PerfTracker
attached, inject a storage fault mid-run, watch the online diagnosis fire
(paper case C2P1, live).

  PYTHONPATH=src python examples_torch/quickstart.py
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The trainer and the diagnosis run on the card unless ``--device cpu`` is
given; without a card and without that flag it raises.  ``--steps`` and
``--fault-step`` shorten the run (defaults: the reference's 120 and 60).
"""
import argparse

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--fault-step", type=int, default=60)
    args = ap.parse_args(argv)

    cfg = reduced(ARCHS["gemma2-2b"], d_model=64, vocab=256)
    trainer = Trainer(
        cfg,
        DataConfig(batch=4, seq_len=32),
        OptConfig(lr_peak=5e-3, warmup_steps=5, total_steps=args.steps),
        TrainConfig(steps=args.steps, log_every=20, perftracker=True,
                    pt_window_s=0.3),
        device=args.device,
    )
    trainer.pt.service.detector.cfg.n_recent = 10

    # inject the fault: data loading becomes 20x slower
    orig_next = trainer.loader.next

    def degrading_next():
        if trainer.loader.step == args.fault_step:
            print(">>> injecting slow-storage fault (case C2P1)")
            trainer.loader.source.data.delay_s = 0.05
        return orig_next()

    trainer._next, _ = trainer.pt.wrap(degrading_next, lambda: None)
    trainer.run()

    res = trainer.pt.flush()
    if res is None and trainer.pt.results:
        res = trainer.pt.results[-1]
    if res is None:
        # re-armed detector fires once per incident; the window it opened
        # may already have been consumed by mitigation — show that one
        res = trainer.last_diagnosis
    print()
    if trainer.pt.service.detector.triggers:
        t = trainer.pt.service.detector.triggers[0]
        print(f"degradation detected: {t.reason} ({t.detail})")
    if res is not None:
        print(res.report())
    else:
        print("no diagnosis window completed (try more steps)")
    return res


if __name__ == "__main__":
    main()
