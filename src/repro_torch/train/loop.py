"""Training loop with PerfTracker attached (port of the reference's
``repro/train/loop.py``).

``train_iteration`` is the fully-instrumented single step the
``TrainerWorkload`` (``repro_torch.train.workload``) drives: every phase of
a real step — ``dataloader.next`` / ``train.step`` (forward + backward,
ended by a device synchronize on the gradients) / ``optimizer.step`` /
``ckpt.save`` — is recorded as a Tracer event, and the forward + backward
span is split into ``xla.gemm`` / ``xla.other`` depth-2 sub-events by the
step's cost (``launch.step_cost``), under the reference's names: the
host sees no per-op boundaries inside the fenced span, so the split is
the cost model's attribution (DESIGN.md §11).  With ``ckpt_dir`` the
trainer saves every ``ckpt_every`` steps (async), resumes from the latest
valid step, and a ``ROLLBACK_TO_CHECKPOINT`` plan restores it.

Device policy: the trainer runs on ``device`` (``None`` means ``"cuda"``)
and raises without a CUDA device unless the caller passes ``"cpu"``.

With ``dist`` (a ``dist.sharding.DistCtx``) the parameters are placed by
``params_shardings`` (ZeRO-3 over the data-parallel mesh dims), the
optimizer state follows them (always fully sharded), and each batch is
placed by ``batch_shardings`` in ``dataloader.next``.
"""
from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import Checkpointer, CheckpointError
from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import Kind
from repro_torch.core.mitigation import Action, plan_mitigations
from repro_torch.core.service import resolve_device
from repro_torch.data.pipeline import DataConfig, DataLoader, SyntheticLM
from repro_torch.instrument.hooks import PerfTracker, PerfTrackerConfig
from repro_torch.instrument.tracer import sync
from repro_torch.launch.step_cost import count_step
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW, OptConfig
from repro_torch.train.step import make_split_train_step, make_train_step


#: roofline that splits the fenced step between the "xla.gemm" and
#: "xla.other" sub-events (the reference's constants: they set only the
#: split ratio, identical across same-program workers, not a speed)
_ROOFLINE_FLOPS_S = 5e10
_ROOFLINE_BYTES_S = 2e10


def gemm_fraction(cost) -> Optional[float]:
    """The share of the step the ``xla.gemm`` sub-event takes: FLOPs over
    ``_ROOFLINE_FLOPS_S`` against bytes over ``_ROOFLINE_BYTES_S``,
    clamped to [0.05, 0.95]; None for a step that costs nothing."""
    t_gemm = cost.flops / _ROOFLINE_FLOPS_S
    t_other = cost.bytes / _ROOFLINE_BYTES_S
    if t_gemm + t_other <= 0.0:
        return None
    return min(0.95, max(0.05, t_gemm / (t_gemm + t_other)))


@contextmanager
def _noop_phase(name, kind=None, depth=1, fence=None, resource=""):
    yield


@dataclass
class StepBundle:
    """The split step's two halves, shareable across same-shape trainers,
    and the ``xla.gemm`` share of the fenced step (None when the step's
    cost could not be counted)."""
    grad_step: Callable
    opt_step: Callable
    gemm_frac: Optional[float] = None
    cost: Optional[object] = None        # launch.step_cost.Cost


@dataclass
class TrainConfig:
    steps: int = 50
    log_every: int = 10
    ckpt_every: int = 0              # 0 = off
    ckpt_dir: str = ""
    remat: str = "none"
    folded: bool = False
    perftracker: bool = True
    pt_window_s: float = 1.0
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 opt_cfg: OptConfig, tc: TrainConfig, dist=None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.data_cfg, self.tc = cfg, data, tc
        self.dist = dist if dist is not None and dist.mesh is not None \
            else None
        self.model = Transformer(cfg, dist=self.dist, remat=tc.remat,
                                 folded=tc.folded)
        self.opt = AdamW(opt_cfg)
        self.source = SyntheticLM(cfg, data)
        self.loader = DataLoader(self.source)
        self._fused_step = make_train_step(self.model, self.opt)
        self.pt: Optional[PerfTracker] = None
        if tc.perftracker:
            self.pt = PerfTracker(PerfTrackerConfig(
                window_s=tc.pt_window_s,
                family="moe" if cfg.is_moe else "dense"),
                device=self.device)
            self._next, self._opt_anchor = self.pt.wrap(
                self.loader.next, lambda: None)
        else:
            self._next, self._opt_anchor = self.loader.next, lambda: None
        self.ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None
        self.history: list = []
        self.mitigations: list = []
        self.last_diagnosis = None       # most recent consumed PT result
        # split-step bundle for the instrumented train_iteration path
        # (built lazily; assignable so an in-process fleet shares one)
        self.bundle: Optional[StepBundle] = None
        # the step phases read the cpu stream only when the step runs on
        # the CPU; on the card they name the device stream, which no
        # sampler records, and keep beta-only patterns (as the reference)
        self._step_resource = "cpu" if self.device.type == "cpu" else ""
        self._iter = 0
        # live fault-injection hooks (repro_torch.train.workload perturbs
        # the REAL loop for end-to-end diagnosis scenarios); all off
        self.data_burn_s = 0.0           # CPU spin inside dataloader.next
        self.step_pad_s = 0.0            # stall inside train.step
        self.gc_pause_s = 0.0            # gc.collect + stall, every
        self.gc_every = 1                # gc_every iterations

    # ------------------------------------------------------------------
    def init_state(self, resume: bool = True):
        """Fresh parameters (seed ``tc.seed``) on the trainer's device and
        their optimizer state, or with ``resume`` the latest valid
        checkpoint of ``ckpt_dir`` restored into them; returns
        ``(params, opt_state, start_step)``."""
        params = self.model.init(self.tc.seed, device=self.device)
        if self.dist is not None:
            params = self.dist.place(params,
                                     self.dist.params_shardings(params))
        opt_state = self.opt.init(params)   # placed like the parameters
        start = 0
        if self.ckpt and resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                (params, opt_state), meta = self._restore(latest, params,
                                                          opt_state)
                start = meta["step"]
        return params, opt_state, start

    def _restore(self, step, params, opt_state):
        shardings = None
        if self.dist is not None:
            # every leaf needs a real placement: scalar opt state rides the
            # mesh replicated
            ps = self.dist.params_shardings(params)
            shardings = self.dist.named(
                {"params": ps, "opt": self.opt.state_shardings(
                    ps, self.dist.replicated())})
        tree, meta = self.ckpt.restore(step, {"params": params,
                                              "opt": opt_state},
                                       shardings=shardings)
        return (tree["params"], tree["opt"]), meta

    def _batch(self, batch_np):
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in batch_np.items()}
        if self.dist is not None:
            batch = self.dist.place(batch, self.dist.batch_shardings(batch))
        return batch

    # ------------------------------------------------------------------
    def ensure_bundle(self, params, batch) -> StepBundle:
        """Build (or return) the split-step bundle.  Building it counts the
        cost of one ``grad_step(params, batch)`` (``launch.step_cost``) to
        set ``gemm_frac``, as the reference reads its compiled module's:
        one extra forward and backward per bundle, run before any timed
        span.  ``gemm_frac`` stays None only where the count raises."""
        if self.bundle is None:
            grad_fn, opt_fn = make_split_train_step(self.model, self.opt)
            gemm_frac, cost = None, None
            try:
                cost = count_step(grad_fn, params, batch)
                gemm_frac = gemm_fraction(cost)
            except Exception:
                gemm_frac = None          # attribution is best-effort
            self.bundle = StepBundle(grad_step=grad_fn, opt_step=opt_fn,
                                     gemm_frac=gemm_frac, cost=cost)
        return self.bundle

    def train_iteration(self, params, opt_state, tracer=None):
        """One fully-instrumented iteration of the REAL loop.

        Every phase is a genuine host-visible span: ``dataloader.next``
        (PYTHON, including the copy of the batch to the device),
        ``train.step`` (forward + backward, ended by a device synchronize
        on the gradients, split into ``xla.gemm`` / ``xla.other`` depth-2
        sub-events by the step's cost), ``optimizer.step`` (fenced on the new params),
        and ``ckpt.save`` when a checkpoint interval hits.
        ``tracer`` may be None or inactive — the loop then runs unobserved.
        Returns ``(params, opt_state, metrics)``; the optimizer updates the
        given ``params`` and ``opt_state`` in place."""
        ph = tracer.phase if tracer is not None else _noop_phase
        with ph("dataloader.next", Kind.PYTHON):
            batch = self._batch(self.loader.next())
            if self.data_burn_s > 0.0:    # injected fault: CPU-burning loader
                deadline = time.perf_counter() + self.data_burn_s
                x = 1.0
                while time.perf_counter() < deadline:
                    x = x * 1.0000001 + 1.0
        bundle = self.ensure_bundle(params, batch)
        res = self._step_resource
        t0 = time.perf_counter()
        grads, metrics = bundle.grad_step(params, batch)
        if self.step_pad_s > 0.0:         # injected fault: slow device step
            time.sleep(self.step_pad_s)
        sync(grads)
        t1 = time.perf_counter()
        if tracer is not None and tracer.active:
            tracer.add_event("train.step", Kind.GPU, t0, t1, depth=1,
                             resource=res)
            if bundle.gemm_frac is not None:
                cut = t0 + (t1 - t0) * bundle.gemm_frac
                tracer.add_event("xla.gemm", Kind.GPU, t0, cut, depth=2,
                                 resource=res)
                tracer.add_event("xla.other", Kind.GPU, cut, t1, depth=2,
                                 resource=res)
        with ph("optimizer.step", Kind.GPU, resource=res,
                fence=lambda: new_params):
            new_params, new_opt, opt_metrics = bundle.opt_step(
                grads, opt_state, params)
        del grads
        self._iter += 1
        if self.ckpt and self.tc.ckpt_every \
                and self._iter % self.tc.ckpt_every == 0:
            with ph("ckpt.save", Kind.PYTHON):
                self.ckpt.save(self._iter, {"params": new_params,
                                            "opt": new_opt})
        if self.gc_pause_s > 0.0 and self._iter % max(1, self.gc_every) == 0:
            # injected fault: unsynchronized gc stall (C2P3 stand-in)
            with ph("runtime.gc", Kind.PYTHON):
                gc.collect()
                time.sleep(self.gc_pause_s)
        m = dict(metrics)
        m.update(opt_metrics)
        return new_params, new_opt, m

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None):
        params, opt_state, start = self.init_state()
        n = steps or self.tc.steps
        tracer = self.pt.tracer if self.pt else None
        for step in range(start, start + n):
            batch = self._batch(self._next())
            if tracer:
                with tracer.phase("train.step", Kind.GPU, depth=1,
                                  fence=lambda: metrics["loss"]):
                    params, opt_state, metrics = self._fused_step(
                        params, opt_state, batch)
            else:
                params, opt_state, metrics = self._fused_step(
                    params, opt_state, batch)
            self._opt_anchor()
            if (step + 1) % self.tc.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                self.history.append({"step": step + 1, **m})
                print(f"step {step+1:5d} loss {m['loss']:.4f} "
                      f"nll {m['nll']:.4f} gnorm {m['grad_norm']:.3f} "
                      f"lr {m['lr']:.2e}", flush=True)
            if self.ckpt and self.tc.ckpt_every \
                    and (step + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(step + 1, {"params": params,
                                          "opt": opt_state})
            params, opt_state = self._maybe_mitigate(params, opt_state,
                                                     step + 1)
        if self.ckpt:
            self.ckpt.save(start + n, {"params": params, "opt": opt_state},
                           async_=False)
        self.loader.close()
        return params, opt_state

    # ------------------------------------------------------------------
    def _maybe_mitigate(self, params, opt_state, step: int):
        """PerfTracker output drives fault tolerance (DESIGN.md §4).
        Returns the (possibly rolled-back) live state."""
        if not self.pt or not self.pt.results:
            return params, opt_state
        res = self.pt.results.pop()
        self.last_diagnosis = res
        for p in plan_mitigations(res.diagnoses, fleet_size=1):
            if p.action == Action.NONE:
                continue
            self.mitigations.append((step, p))
            print(f"[perftracker] step {step}: "
                  f"{res.trigger.reason if res.trigger else '?'} -> "
                  f"{p.action.value}: {p.detail}", flush=True)
            # both actions begin with an immediate checkpoint: replace
            # re-meshes from it, checkpoint_now protects against the
            # widespread-hardware abnormality getting worse
            if p.action in (Action.REPLACE_HOSTS, Action.CHECKPOINT_NOW) \
                    and self.ckpt:
                self.ckpt.save(step, {"params": params, "opt": opt_state})
            # rollback is REAL (DESIGN.md §14): restore the latest valid
            # on-disk step into the live loop; with nothing usable on
            # disk the state is honestly left as-is (no faked cure)
            if p.action == Action.ROLLBACK_TO_CHECKPOINT and self.ckpt:
                latest = self.ckpt.latest_step()
                if latest is not None:
                    try:
                        (params, opt_state), meta = self._restore(
                            latest, params, opt_state)
                        self._iter = meta["step"]
                        print(f"[perftracker] rolled back to step "
                              f"{meta['step']}", flush=True)
                    except CheckpointError as e:
                        print(f"[perftracker] rollback failed: {e}",
                              flush=True)
        return params, opt_state
