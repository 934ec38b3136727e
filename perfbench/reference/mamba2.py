"""Plain reference of a mamba2 language model's training step: its loss,
its gradients and AdamW's update, in float32 with TF32 off.

It follows the published Mamba2 block (Dao and Gu, arXiv:2405.21060) at
the configuration's sizes, its residual stream in float32 as the published
model keeps it, and imports nothing of the program:

    h = rmsnorm(x) * ln;  z, xs, B, C, dt = h W_z, h W_x, h W_B, h W_C, h W_dt
    xs, B, C = silu(causal_conv(.) + bias)  (depthwise, width d_conv)
    dt = softplus(dt + dt_bias);  A = -exp(A_log)
    state_t = exp(dt_t A) state_{t-1} + dt_t B_t x_t^T;  y_t = C_t state_t
    y = (y + D x) * silu(z);  out = (rmsnorm(y) * gate_norm) W_out;  x += out

then the final RMS norm, logits against the tied token table, and the mean
next-token cross-entropy over the real vocabulary.  The scan is the SSD's
chunked form (the paper's minimal listing), every decay masked before its
exponential.  The step runs in blocks so that it fits beside nothing else
on the card: the forward keeps only each layer's input, and the backward
recomputes one layer at a time.

``precision="fp8"`` is the control: every matrix product's operands (and
the scan's x, B and C) rounded to float8 e4m3 with a per-tensor scale in
the forward, the rest as above.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: Tensor) -> Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale; the gradient
    passes straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


class Model:
    """The configuration's sizes and the step's precision."""

    def __init__(self, cfg: Dict, precision: str = "float32"):
        self.d = int(cfg["d_model"])
        self.L = int(cfg["num_layers"])
        self.di = int(cfg["expand"]) * self.d
        self.P = int(cfg["head_dim"])
        self.N = int(cfg["d_state"])
        self.G = int(cfg["n_groups"])
        self.H = self.di // self.P
        self.W = int(cfg["d_conv"])
        self.Q = int(cfg["chunk_size"])
        self.eps = float(cfg["norm_eps"])
        self.V = int(cfg["vocab_size"])
        self.q = fp8 if precision == "fp8" else (lambda t: t)
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)

    def rms(self, x: Tensor, scale: Tensor) -> Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * scale

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.q(a) @ self.q(b)

    def conv(self, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        """Depthwise causal convolution: out_t = sum_k w_k x_{t-W+1+k}."""
        S = x.shape[1]
        xp = F.pad(x, (0, 0, self.W - 1, 0))
        return sum(xp[:, k:k + S] * w[:, k] for k in range(self.W)) + b

    def ssd(self, x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
            Cm: Tensor) -> Tensor:
        """y of the scan: x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n)."""
        b, s, h, p = x.shape
        Q = min(self.Q, s)
        c = s // Q
        rep = h // Bm.shape[2]
        Bh = Bm.repeat_interleave(rep, dim=2).reshape(b, c, Q, h, -1)
        Ch = Cm.repeat_interleave(rep, dim=2).reshape(b, c, Q, h, -1)
        X = (x * dt[..., None]).reshape(b, c, Q, h, p)
        a = (dt * A).reshape(b, c, Q, h).permute(0, 3, 1, 2)   # b h c Q
        cum = a.cumsum(-1)
        tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        Lm = torch.exp(torch.where(tril, cum[..., :, None]
                                   - cum[..., None, :], -math.inf))
        # within a chunk
        y = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, Lm, X)
        # each chunk's state, then the states carried across chunks
        decay = torch.exp(cum[..., -1:] - cum)                 # b h c Q
        st = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X)
        last = cum[..., -1]                                     # b h c
        carry = [torch.zeros_like(st[:, 0])]
        for k in range(c - 1):
            carry.append(carry[-1] * torch.exp(last[:, :, k])[..., None,
                                                               None]
                         + st[:, k])
        prev = torch.stack(carry, dim=1)                        # b c h p n
        y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, prev,
                             torch.exp(cum))
        return y.reshape(b, s, h, p)

    def layer(self, p: Dict[str, Tensor], x: Tensor) -> Tensor:
        b, s, _ = x.shape
        h = self.rms(x, p["ln/scale"])
        z = self.mm(h, p["mamba/w_z"])
        xs = self.mm(h, p["mamba/w_x"])
        Bm = self.mm(h, p["mamba/w_B"])
        Cm = self.mm(h, p["mamba/w_C"])
        dt = self.mm(h, p["mamba/w_dt"])
        xs = F.silu(self.conv(xs, p["mamba/conv_x_w"], p["mamba/conv_x_b"]))
        Bm = F.silu(self.conv(Bm, p["mamba/conv_B_w"], p["mamba/conv_B_b"]))
        Cm = F.silu(self.conv(Cm, p["mamba/conv_C_w"], p["mamba/conv_C_b"]))
        xs = xs.reshape(b, s, self.H, self.P)
        dt = F.softplus(dt + p["mamba/dt_bias"])
        A = -torch.exp(p["mamba/A_log"])
        y = self.ssd(self.q(xs), dt, A,
                     self.q(Bm.reshape(b, s, self.G, self.N)),
                     self.q(Cm.reshape(b, s, self.G, self.N)))
        y = y + xs * p["mamba/D"][:, None]
        y = y.reshape(b, s, self.di) * F.silu(z)
        y = self.rms(y, p["mamba/gate_norm"])
        return x + self.mm(y, p["mamba/out_proj"])

    def head_loss(self, w: Dict[str, Tensor], x: Tensor,
                  labels: Tensor) -> Tensor:
        x = self.rms(x, w["final_norm/scale"])
        logits = self.mm(x, w["embed/table"].t())
        logits[..., self.V:] = -math.inf
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long())


def block_params(w: Dict[str, Tensor], i: int) -> Dict[str, Tensor]:
    pre = f"blocks/{i}/"
    return {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}


def loss_and_grads(model: Model, w: Dict[str, Tensor], tokens: Tensor,
                   labels: Tensor) -> Tuple[float, Dict[str, Tensor]]:
    """The loss and every parameter's gradient, a layer at a time."""
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    table = w["embed/table"]
    with torch.no_grad():
        xs: List[Tensor] = [table[tokens.long()]]
        for i in range(model.L):
            xs.append(model.layer(block_params(w, i), xs[-1]))
    top = {k: w[k].detach().requires_grad_(True)
           for k in ("final_norm/scale", "embed/table")}
    x = xs[-1].detach().requires_grad_(True)
    loss = model.head_loss(top, x, labels)
    gtop = torch.autograd.grad(loss, [x, *top.values()])
    dx = gtop[0]
    for k, g in zip(top, gtop[1:]):
        grads[k] += g
    for i in reversed(range(model.L)):
        p = {k: v.detach().requires_grad_(True)
             for k, v in block_params(w, i).items()}
        xin = xs[i].detach().requires_grad_(True)
        out = model.layer(p, xin)
        g = torch.autograd.grad(out, [xin, *p.values()], dx)
        dx = g[0]
        for k, gk in zip(p, g[1:]):
            grads[f"blocks/{i}/{k}"] += gk
        xs[i + 1] = None
    grads["embed/table"].index_add_(0, tokens.reshape(-1).long(),
                                    dx.reshape(-1, dx.shape[-1]))
    return float(loss.detach()), grads


class AdamW:
    """The configuration's AdamW: warmup then cosine, global-norm clipping,
    bias-corrected moments, decoupled weight decay on every leaf whose path
    holds none of ``no_decay``."""

    def __init__(self, opt: Dict, params: Dict[str, Tensor]):
        self.c = opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def lr(self, t: int) -> float:
        c = self.c
        warm = c["warmup_steps"]
        if t < warm:
            return c["lr_peak"] * t / max(1.0, warm)
        prog = min(1.0, max(0.0, (t - warm) / max(1.0, c["total_steps"]
                                                  - warm)))
        r = c["min_lr_ratio"]
        return c["lr_peak"] * (r + (1 - r) * 0.5 * (1 + math.cos(
            math.pi * prog)))

    @torch.no_grad()
    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]
             ) -> None:
        """Updates ``params`` in place; clips ``grads`` in place, so that
        they are the gradients as the update takes them."""
        c = self.c
        self.t += 1
        t, lr = self.t, self.lr(self.t)
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        scale = min(1.0, c["clip_norm"] / max(norm, 1e-12))
        for k, w in params.items():
            g = grads[k].mul_(scale)
            self.m[k].mul_(c["b1"]).add_((1 - c["b1"]) * g)
            self.v[k].mul_(c["b2"]).add_((1 - c["b2"]) * g.square())
            delta = (self.m[k] / (1 - c["b1"] ** t)) / (
                torch.sqrt(self.v[k] / (1 - c["b2"] ** t)) + c["eps"])
            if not any(tok in k for tok in c["no_decay"]):
                delta += c["weight_decay"] * w
            w.sub_(lr * delta)



def leaf_norms(tree: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def follow(cfg: Dict, opt: Dict, init: Dict[str, Tensor],
           batches: List[Tuple[Tensor, Tensor]], precision: str = "float32",
           scale_grads: Dict[str, float] | None = None) -> Dict[str, object]:
    """The first ``len(batches)`` training steps from the weights ``init``
    (left as they are): each step's loss, each leaf's norm of the first
    clipped gradient, and each leaf's norm of its change over all steps.
    ``scale_grads`` multiplies the named leaves' gradients where they are
    produced (a planted fault, for the control script)."""
    no_tf32()
    model = Model(cfg, precision)
    weights = {k: v.float().clone() for k, v in init.items()}
    optim = AdamW(opt, weights)
    losses, grad1 = [], {}
    for i, (tok, lab) in enumerate(batches):
        loss, grads = loss_and_grads(model, weights, tok, lab)
        for k, f in (scale_grads or {}).items():
            grads[k].mul_(f)
        losses.append(loss)
        optim.step(weights, grads)
        if i == 0:
            grad1 = leaf_norms(grads)
        del grads
    change = {k: float((weights[k] - init[k].float()).double().norm())
              for k in weights}
    return {"losses": losses, "grad1": grad1, "change": change}
