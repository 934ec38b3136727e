"""Plain reference of a published Zamba2 language model's training step
(Zamba2-7B, arXiv:2411.15242; the shared block of Zamba, arXiv:2405.16712
fig. 2, eq. 6): its loss, its gradients and AdamW's update, in float32
with TF32 off, at the configuration's sizes.  It imports nothing of the
program, and takes the Mamba2 pieces (RMS norm, causal conv, the SSD scan,
the tied head's loss) and AdamW from ``perfbench.reference.mamba2``.

With x a layer's input and e the token embedding, a mamba layer is
``x + mixer(rms(x))`` and a hybrid layer (``layers_block_type``
"hybrid"), the j-th, uses shared block ``j % num_mem_blocks``, its own
rank-r adapter (A, B) and its own linear W::

    c = rms(concat(x, e))                      (2 d columns)
    q, k, v = c Wq, c Wk, c Wv                 (heads of hd = 2 d / heads)
    q, k = rope(q), rope(k)                    (all hd dims, theta)
    a = softmax(q k^T (hd/2)^-0.5, causal) v Wo
    h = rms(a);  [g, u] = h W_gu + (h A) B;  m = (gelu(g) u) W_down
    x <- x + mixer(rms(x + m W))

The mixer is ``transformers``' ``Zamba2MambaMixer`` (4.57.6): in-projections
z, x, B, C, dt, depthwise causal convolutions of x, B and C with biases and
silu, ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD scan,
``y + D x``, then the gated norm per group of ``d_inner / n_groups``
columns (``Zamba2RMSNormGated``: ``rms_g(y silu(z)) * w``) and the out
projection.  GELU is the exact (erf) one.  Departures, each from
``transformers``' CPU path, which the published CUDA path does not take:
dt is not clamped at ``time_step_min`` (``time_step_limit`` is null, and
the CUDA path clamps nothing), and the residual stream stays float32.
The step runs in blocks so that it fits beside nothing else on the card:
the forward keeps only each layer's input and the embedding, and the
backward recomputes one layer (a hybrid layer with its shared block) at a
time.  The attention runs a few heads at a time.

``precision="fp8"`` is the control: every matrix product's operands
(the scan's x, B and C, and q, k, v and the probabilities) rounded to
float8 e4m3 with a per-tensor scale in the forward.  ``fault`` plants one
of ``FAULTS`` (the control script's and the tests' planted faults):
``swap_blocks`` applies shared block ``(j + 1) % num_mem_blocks``,
``no_embed`` concatenates zeros in place of e, ``no_adapter`` drops the
adapters, ``row_norm`` takes the gated norm over the whole row.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import mamba2 as refm

Tensor = torch.Tensor
FAULTS = ("swap_blocks", "no_embed", "no_adapter", "row_norm")
#: heads of one attention product (a few, so the scores stay small)
HEAD_CHUNK = 8


class Model(refm.Model):
    """The configuration's sizes, the step's precision and a planted
    fault (module docstring)."""

    def __init__(self, cfg: Dict, precision: str = "float32",
                 fault: Optional[str] = None):
        super().__init__(cfg, precision)
        if fault is not None and fault not in FAULTS:
            raise ValueError(fault)
        self.fault = fault
        self.heads = int(cfg["num_attention_heads"])
        self.kv = int(cfg["num_key_value_heads"])
        self.hd = 2 * self.d // self.heads
        self.ff = int(cfg["intermediate_size"])
        self.nb = int(cfg["num_mem_blocks"])
        self.theta = float(cfg["rope_theta"])
        self.ids = tuple(i for i, t in enumerate(
            cfg["layers_block_type"][:self.L]) if t == "hybrid")
        self.norm_groups = 1 if fault == "row_norm" else self.G

    # -- the mamba layer --------------------------------------------------------
    def gated_norm(self, y: Tensor, scale: Tensor) -> Tensor:
        g = y.reshape(*y.shape[:-1], self.norm_groups, -1)
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.eps)
        return g.reshape(y.shape) * scale

    def mixer(self, p: Dict[str, Tensor], h: Tensor) -> Tensor:
        """The Mamba2 mixer on the normed input h."""
        b, s, _ = h.shape
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
        y = self.gated_norm(y.reshape(b, s, self.di) * F.silu(z),
                            p["mamba/gate_norm"])
        return self.mm(y, p["mamba/out_proj"])

    def mamba_layer(self, p: Dict[str, Tensor], x: Tensor) -> Tensor:
        return x + self.mixer(p, self.rms(x, p["ln/scale"]))

    # -- the shared block ---------------------------------------------------------
    def rope(self, x: Tensor) -> Tensor:
        """Rotary embedding over all hd dims of x (b, s, heads, hd), the
        halves rotated together (``transformers``' ``rotate_half``)."""
        s, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / self.theta ** (torch.arange(0, hd, 2, device=x.device,
                                                dtype=torch.float32) / hd)
        ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
            * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        """Causal softmax attention (b, s, heads, hd), scale (hd/2)^-0.5,
        ``HEAD_CHUNK`` heads at a time."""
        s = q.shape[1]
        rep = self.heads // self.kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scale = (self.hd / 2) ** -0.5
        outs = []
        for h0 in range(0, self.heads, HEAD_CHUNK):
            sl = slice(h0, h0 + HEAD_CHUNK)
            sc = torch.einsum("bthd,bshd->bhts", self.q(q[:, :, sl]),
                              self.q(k[:, :, sl])) * scale
            pr = torch.softmax(sc.masked_fill(~mask, -math.inf), dim=-1)
            outs.append(torch.einsum("bhts,bshd->bthd", self.q(pr),
                                     self.q(v[:, :, sl])))
        return torch.cat(outs, dim=2)

    def shared(self, sp: Dict[str, Tensor], x: Tensor, e: Tensor,
               lp: Dict[str, Tensor]) -> Tensor:
        """The shared block's output m (module docstring), with hybrid
        layer ``lp``'s adapter."""
        b, s, d = x.shape
        if self.fault == "no_embed":
            e = torch.zeros_like(e)
        c = self.rms(torch.cat([x, e], dim=-1), sp["ln1/scale"])
        qkv = [self.mm(c, sp[f"attn/{w}"].reshape(2 * d, -1)).reshape(
            b, s, -1, self.hd) for w in ("wq", "wk", "wv")]
        o = self.attention(self.rope(qkv[0]), self.rope(qkv[1]), qkv[2])
        a = self.mm(o.reshape(b, s, -1), sp["attn/wo"].reshape(-1, d))
        h = self.rms(a, sp["ln2/scale"])
        gu = self.mm(h, sp["mlp/wi"].reshape(d, -1))
        if self.fault != "no_adapter":
            gu = gu + self.mm(self.mm(h, lp["adapter/a"]),
                              lp["adapter/b"].reshape(-1, 2 * self.ff))
        g, u = gu[..., :self.ff], gu[..., self.ff:]
        return self.mm(F.gelu(g) * u, sp["mlp/wo"])

    def hybrid_layer(self, lp: Dict[str, Tensor], sp: Dict[str, Tensor],
                     x: Tensor, e: Tensor) -> Tensor:
        t = self.mm(self.shared(sp, x, e, lp), lp["linear"])
        return x + self.mixer(lp, self.rms(x + t, lp["ln/scale"]))

    def block_of(self, i: int) -> int:
        """The shared block hybrid layer ``i`` applies."""
        j = self.ids.index(i) + (self.fault == "swap_blocks")
        return j % self.nb


def sub(w: Dict[str, Tensor], pre: str) -> Dict[str, Tensor]:
    return {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}


def loss_and_grads(model: Model, w: Dict[str, Tensor], tokens: Tensor,
                   labels: Tensor) -> Tuple[float, Dict[str, Tensor]]:
    """The loss and every parameter's gradient, a layer at a time."""
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    table = w["embed/table"]

    def run(i, x, e, p, sp):
        return model.hybrid_layer(p, sp, x, e) if i in model.ids \
            else model.mamba_layer(p, x)

    with torch.no_grad():
        e = table[tokens.long()]
        xs: List[Optional[Tensor]] = [e]
        for i in range(model.L):
            xs.append(run(i, xs[-1], e, sub(w, f"blocks/{i}/"),
                          sub(w, f"shared/{model.block_of(i)}/")
                          if i in model.ids else None))
    top = {k: w[k].detach().requires_grad_(True)
           for k in ("final_norm/scale", "embed/table")}
    x = xs[-1].detach().requires_grad_(True)
    loss = model.head_loss(top, x, labels)
    gtop = torch.autograd.grad(loss, [x, *top.values()])
    dx, de = gtop[0], torch.zeros_like(e)
    for k, g in zip(top, gtop[1:]):
        grads[k] += g
    for i in reversed(range(model.L)):
        pre = f"blocks/{i}/"
        p = {k: v.detach().requires_grad_(True)
             for k, v in sub(w, pre).items()}
        sp, spre = {}, ""
        if i in model.ids:
            spre = f"shared/{model.block_of(i)}/"
            sp = {k: v.detach().requires_grad_(True)
                  for k, v in sub(w, spre).items()}
        xin = xs[i].detach().requires_grad_(True)
        ein = e.detach().requires_grad_(True)
        out = run(i, xin, ein, p, sp)
        names = [pre + k for k in p] + [spre + k for k in sp]
        g = torch.autograd.grad(out, [xin, ein, *p.values(), *sp.values()],
                                dx, allow_unused=True)
        dx = g[0]
        if g[1] is not None:
            de += g[1]
        for name, gk in zip(names, g[2:]):
            if gk is not None:
                grads[name] += gk
        xs[i + 1] = None
    grads["embed/table"].index_add_(0, tokens.reshape(-1).long(),
                                    (dx + de).reshape(-1, dx.shape[-1]))
    return float(loss.detach()), grads


def follow(cfg: Dict, opt: Dict, init: Dict[str, Tensor],
           batches: List[Tuple[Tensor, Tensor]], precision: str = "float32",
           scale_grads: Optional[Dict[str, float]] = None,
           fault: Optional[str] = None) -> Dict[str, object]:
    """The first ``len(batches)`` training steps from the weights ``init``
    (left as they are), as ``perfbench.reference.mamba2.follow`` gives
    them: each step's loss, each leaf's norm of the first clipped
    gradient, and each leaf's norm of its change over all steps."""
    refm.no_tf32()
    model = Model(cfg, precision, fault)
    weights = {k: v.float().clone() for k, v in init.items()}
    optim = refm.AdamW(opt, weights)
    losses, grad1 = [], {}
    for i, (tok, lab) in enumerate(batches):
        loss, grads = loss_and_grads(model, weights, tok, lab)
        for k, f in (scale_grads or {}).items():
            grads[k].mul_(f)
        losses.append(loss)
        optim.step(weights, grads)
        if i == 0:
            grad1 = refm.leaf_norms(grads)
        del grads
    change = {k: float((weights[k] - init[k].float()).double().norm())
              for k in weights}
    return {"losses": losses, "grad1": grad1, "change": change}
