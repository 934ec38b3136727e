"""Training launcher (port of the reference's ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --steps 100 --ckpt-dir /tmp/ckpt --device cpu

The reference's flags, with the same meanings.  ``--mesh single|multi``
builds the 256/512-rank production mesh (``launch.mesh``) over a process
group that ``torchrun`` starts (``torchrun --nproc-per-node ... -m
repro_torch.launch.train --mesh single``), and raises at any other world
size.  ``--grad-compress`` is parsed and not wired to the step, as in the
reference.  The reference's TPU XLA flags (``TPU_XLA_FLAGS``) and its
placeholder host devices for ``--mesh`` have no counterpart on the card
and are left out.

Two flags are the port's own: ``--device`` (default: the card; the run
raises without one unless ``--device cpu`` is given) and ``--layers N``,
which cuts the model's depth to N layers at full width (after
``--reduced``, if given).  ``main(argv)`` takes an argument list, so
scripts and tests can call it.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--no-perftracker", action="store_true")
    ap.add_argument("--inject-slow-dataloader", type=float, default=0.0,
                    help="seconds of injected storage latency per batch "
                         "after step N/2 (reproduces case C2P1 online)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    return ap.parse_args(argv)


def _mesh_ctx(kind: str, device):
    """The production mesh's ``DistCtx`` over the process group that
    ``torchrun`` describes in the environment."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import DistCtx
    from repro_torch.launch.mesh import make_production_mesh
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(f"--mesh {kind} runs under torchrun (256 "
                               f"ranks single, 512 multi): no WORLD_SIZE "
                               f"in the environment")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        import torch
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    mesh = make_production_mesh(multi_pod=(kind == "multi"),
                                device_type=device.type)
    return DistCtx.from_mesh(mesh)


def main(argv=None):
    """Run the CLI on ``argv`` (None: ``sys.argv``); returns the trainer
    (closed) and its final PerfTracker result, if any."""
    args = parse_args(argv)

    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.core.service import resolve_device
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import TrainConfig, Trainer

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = cfg.with_overrides(num_layers=args.layers)

    dist = _mesh_ctx(args.mesh, device) if args.mesh != "none" else None

    data = DataConfig(batch=args.batch, seq_len=args.seq)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, remat=args.remat,
                     perftracker=not args.no_perftracker)
    opt = OptConfig(lr_peak=args.lr, warmup_steps=max(10, args.steps // 20),
                    total_steps=args.steps)
    trainer = Trainer(cfg, data, opt, tc, dist=dist, device=device)

    if args.inject_slow_dataloader:
        half = args.steps // 2
        orig_next = trainer.loader.next

        def degrading_next():
            if trainer.loader.step >= half:
                trainer.loader.source.data.delay_s = \
                    args.inject_slow_dataloader
            return orig_next()
        trainer.loader.next = degrading_next
        if trainer.pt:
            trainer._next, _ = trainer.pt.wrap(degrading_next, lambda: None)

    trainer.run()
    res = None
    if trainer.pt:
        res = trainer.pt.flush()
        if res is not None:
            print(res.report())
    return trainer, res


if __name__ == "__main__":
    main()
