"""Plain reference of a granite-4.0-h language model's training step
(``transformers``' ``GraniteMoeHybridForCausalLM``, 4.57.6): its loss, its
gradients and AdamW's update, in float32 with TF32 off, at the
configuration's sizes and with its share of the experts.  It imports
nothing of the program, and takes the RMS norm, the causal conv, the SSD
scan and AdamW from ``perfbench.reference.mamba2``.

With x a layer's input and r the residual multiplier, every layer is::

    x <- x + r mixer(rms(x))
    h = rms(x);  x <- x + r (moe(h) + shared(h))

where the mixer is the layer's kind in ``layer_types``: Mamba2
(``GraniteMoeHybridMambaLayer``: in-projections z, x, B, C, dt, depthwise
causal convolutions of x, B and C with biases and silu, ``dt =
softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD scan, ``y + D x``,
the gated norm per group of ``d_inner / n_groups`` columns, gate before
norm, and the out projection) or attention (GQA, no position encoding,
scale ``attention_multiplier``, causal).  The MoE
(``GraniteMoeHybridMoE``) takes the top k of the router's logits over all
``num_local_experts_published`` experts and a softmax over those k, and
adds, for each expert held here (``experts_start`` on, ``num_local_experts``
of them), ``gate * (silu(g) u) W_out`` with ``[g, u] = h W_in`` for every
token routed to it: nothing is dropped.  The shared expert is a SwiGLU of
width ``shared_intermediate_size``.  The embedding is multiplied by
``embedding_multiplier``, and the tied head's logits are divided by
``logits_scaling`` before the mean next-token cross-entropy.  The loss adds
the router's balance term, ``E sum_e f_e p_e`` times
``router_aux_loss_coef``, over all experts and layers (``f_e`` the share
of the top-k choices, ``p_e`` the mean router probability), as the
program's ``aux_loss_from_stats``.

Departures, each from ``transformers``' CPU path: the residual stream
stays float32, and the gate is not cast to the activations' type.  The
step runs in blocks so that it fits beside nothing else on the card: the
forward keeps only each layer's input, the backward recomputes one layer
at a time, the attention runs ``HEAD_CHUNK`` heads at a time under
``torch.utils.checkpoint``, and the head ``HEAD_ROWS`` tokens at a time.

``precision="fp8"`` is the control: every matrix product's operands (the
scan's x, B and C, and q, k, v and the probabilities) rounded to float8
e4m3 with a per-tensor scale in the forward.  ``fault`` plants one of
``FAULTS``: ``softmax_first`` (the gate as the top k of the softmax over
all experts), ``rope`` (rotary embedding on q and k), ``no_ffn_scale`` (the
FFN's branch added unscaled), ``no_shared`` (the shared expert dropped),
``capacity`` (each held expert keeps its first ``ceil(1.25 T k / E)``
tokens, rounded up to 8, and drops the rest).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import mamba2 as refm

Tensor = torch.Tensor
FAULTS = ("softmax_first", "rope", "no_ffn_scale", "no_shared", "capacity")
#: heads of one attention product, recomputed in the backward
HEAD_CHUNK = 4
#: tokens of one block of the head's logits
HEAD_ROWS = 2048


def layer_kinds(cfg: Dict) -> Tuple[str, ...]:
    """The kinds of the ``num_layers`` layers held."""
    return tuple(cfg["layer_types"][:int(cfg["num_layers"])])


class Model(refm.Model):
    """The configuration's sizes, the step's precision and a planted
    fault (module docstring)."""

    def __init__(self, cfg: Dict, precision: str = "float32",
                 fault: Optional[str] = None):
        super().__init__(cfg, precision)
        if fault is not None and fault not in FAULTS:
            raise ValueError(fault)
        self.fault = fault
        self.kinds = layer_kinds(cfg)
        self.heads = int(cfg["num_attention_heads"])
        self.kv = int(cfg["num_key_value_heads"])
        self.hd = self.d // self.heads
        self.scale = float(cfg["attention_multiplier"])
        self.theta = float(cfg["rope_theta"])
        self.ff = int(cfg["intermediate_size"])
        self.E = int(cfg["num_local_experts_published"])
        self.e0 = int(cfg["experts_start"])
        self.held = int(cfg["num_local_experts"])
        self.k = int(cfg["num_experts_per_tok"])
        self.r = float(cfg["residual_multiplier"])
        self.emb = float(cfg["embedding_multiplier"])
        self.logit_div = float(cfg["logits_scaling"])
        self.aux_w = float(cfg["router_aux_loss_coef"])

    # -- the mixers ---------------------------------------------------------------
    def mamba(self, p: Dict[str, Tensor], h: Tensor) -> Tensor:
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
        g = (y.reshape(b, s, self.di) * F.silu(z)).reshape(b, s, self.G, -1)
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.eps)
        return self.mm(g.reshape(b, s, self.di) * p["mamba/gate_norm"],
                       p["mamba/out_proj"])

    def rope(self, x: Tensor) -> Tensor:
        """Rotary embedding over all hd dims (the ``rope`` fault only)."""
        s, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / self.theta ** (torch.arange(0, hd, 2, device=x.device,
                                                dtype=torch.float32) / hd)
        ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
            * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def heads_attn(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        """Causal softmax attention of a few heads, (b, s, heads, hd)."""
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = torch.einsum("bthd,bshd->bhts", self.q(q), self.q(k)) \
            * self.scale
        pr = torch.softmax(sc.masked_fill(~mask, -math.inf), dim=-1)
        return torch.einsum("bhts,bshd->bthd", self.q(pr), self.q(v))

    def attention(self, p: Dict[str, Tensor], h: Tensor) -> Tensor:
        b, s, d = h.shape
        q, k, v = [self.mm(h, p[f"attn/{w}"].reshape(d, -1)).reshape(
            b, s, -1, self.hd) for w in ("wq", "wk", "wv")]
        if self.fault == "rope":
            q, k = self.rope(q), self.rope(k)
        rep = self.heads // self.kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        outs = []
        for h0 in range(0, self.heads, HEAD_CHUNK):
            sl = slice(h0, h0 + HEAD_CHUNK)
            outs.append(checkpoint(self.heads_attn, q[:, :, sl], k[:, :, sl],
                                   v[:, :, sl], use_reentrant=False))
        o = torch.cat(outs, dim=2).reshape(b, s, -1)
        return self.mm(o, p["attn/wo"].reshape(-1, d))

    # -- the FFN block ------------------------------------------------------------
    def capacity(self, T: int) -> int:
        c = math.ceil(T * self.k / self.E * 1.25)
        return max(8, -(-c // 8) * 8)

    def swiglu(self, x: Tensor, wi: Tensor, wo: Tensor) -> Tensor:
        gu = self.mm(x, wi.reshape(x.shape[-1], -1))
        ff = gu.shape[-1] // 2
        return self.mm(F.silu(gu[..., :ff]) * gu[..., ff:], wo)

    def ffn(self, p: Dict[str, Tensor], h: Tensor
            ) -> Tuple[Tensor, Tensor, Tensor]:
        """moe(h) + shared(h), the top-k choices counted over all experts,
        and the router's probabilities summed over the tokens."""
        shape = h.shape
        x = h.reshape(-1, shape[-1])
        logits = self.mm(x, p["moe/router"])
        probs = torch.softmax(logits, dim=-1)
        if self.fault == "softmax_first":
            gates, idx = probs.topk(self.k, dim=-1)
        else:
            top, idx = logits.topk(self.k, dim=-1)
            gates = torch.softmax(top, dim=-1)
        cap = self.capacity(x.shape[0]) if self.fault == "capacity" else None
        y = torch.zeros_like(x)
        for e in range(self.held):
            t, j = (idx == self.e0 + e).nonzero(as_tuple=True)
            if cap is not None:
                t, j = t[:cap], j[:cap]
            out = self.swiglu(x[t], p["moe/wi"][e], p["moe/wo"][e])
            y = y.index_add(0, t, out * gates[t, j, None])
        if self.fault != "no_shared":
            y = y + self.swiglu(x, p["moe/shared/wi"], p["moe/shared/wo"])
        counts = torch.bincount(idx.reshape(-1), minlength=self.E).float()
        return y.reshape(shape), counts, probs.sum(dim=0)

    def layer(self, p: Dict[str, Tensor], x: Tensor, kind: str
              ) -> Tuple[Tensor, Tensor, Tensor]:
        """The layer's output, its top-k counts and probability sums."""
        h = self.rms(x, p["ln1/scale"])
        a = self.mamba(p, h) if kind == "mamba" else self.attention(p, h)
        x = x + self.r * a
        m, counts, psum = self.ffn(p, self.rms(x, p["ln2/scale"]))
        r = 1.0 if self.fault == "no_ffn_scale" else self.r
        return x + r * m, counts, psum

    # -- the head -----------------------------------------------------------------
    def head_grads(self, w: Dict[str, Tensor], x: Tensor, labels: Tensor
                   ) -> Tuple[float, Tensor, Dict[str, Tensor]]:
        """The mean cross-entropy of ``rms(x) E^T / logits_scaling``, its
        gradient by x and by the final norm and the table, ``HEAD_ROWS``
        tokens at a time."""
        d = x.shape[-1]
        xf, lab = x.reshape(-1, d), labels.reshape(-1).long()
        n = lab.numel()
        top = {k: w[k].detach().requires_grad_(True)
               for k in ("final_norm/scale", "embed/table")}
        gtop = {k: torch.zeros_like(v) for k, v in top.items()}
        dx = torch.zeros_like(xf)
        total = 0.0
        for a in range(0, n, HEAD_ROWS):
            xc = xf[a:a + HEAD_ROWS].detach().requires_grad_(True)
            logits = self.mm(self.rms(xc, top["final_norm/scale"]),
                             top["embed/table"].t()) / self.logit_div
            logits[..., self.V:] = -math.inf
            loss = F.cross_entropy(logits, lab[a:a + HEAD_ROWS],
                                   reduction="sum") / n
            g = torch.autograd.grad(loss, [xc, *top.values()])
            dx[a:a + HEAD_ROWS] = g[0]
            for k, gk in zip(top, g[1:]):
                gtop[k] += gk
            total += float(loss.detach())
        return total, dx.reshape(x.shape), gtop


def sub(w: Dict[str, Tensor], pre: str) -> Dict[str, Tensor]:
    return {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}


def loss_and_grads(model: Model, w: Dict[str, Tensor], tokens: Tensor,
                   labels: Tensor) -> Tuple[float, Dict[str, Tensor]]:
    """The loss and every parameter's gradient, a layer at a time; the
    balance term's counts are those of the whole forward (they carry no
    gradient), so each layer's backward adds its probabilities' part."""
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    table = w["embed/table"]
    L = len(model.kinds)
    with torch.no_grad():
        xs: List[Optional[Tensor]] = [table[tokens.long()] * model.emb]
        counts = torch.zeros(model.E, device=table.device)
        psum = torch.zeros(model.E, device=table.device)
        for i, kind in enumerate(model.kinds):
            x, c, ps = model.layer(sub(w, f"blocks/{i}/"), xs[-1], kind)
            xs.append(x)
            counts += c
            psum += ps
    T = tokens.numel() * L
    coef = model.E * model.aux_w / (T * T * model.k)
    nll, dx, gtop = model.head_grads(w, xs[-1], labels)
    for k, g in gtop.items():
        grads[k] += g
    for i in reversed(range(L)):
        pre = f"blocks/{i}/"
        p = {k: v.detach().requires_grad_(True)
             for k, v in sub(w, pre).items()}
        xin = xs[i].detach().requires_grad_(True)
        out, _, ps = model.layer(p, xin, model.kinds[i])
        aux = coef * (counts * ps).sum()
        g = torch.autograd.grad([out, aux], [xin, *p.values()],
                                [dx, torch.ones_like(aux)],
                                allow_unused=True)
        dx = g[0]
        for k, gk in zip(p, g[1:]):
            if gk is not None:      # a leaf a planted fault leaves unused
                grads[pre + k] += gk
        xs[i + 1] = None
    grads["embed/table"].index_add_(0, tokens.reshape(-1).long(),
                                    model.emb * dx.reshape(-1, dx.shape[-1]))
    return nll + float(coef * (counts * psum).sum()), grads


def follow(cfg: Dict, opt: Dict, init: Dict[str, Tensor],
           batches: List[Tuple[Tensor, Tensor]], precision: str = "float32",
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
        losses.append(loss)
        optim.step(weights, grads)
        if i == 0:
            grad1 = refm.leaf_norms(grads)
        del grads
    change = {k: float((weights[k] - init[k].float()).double().norm())
              for k in weights}
    return {"losses": losses, "grad1": grad1, "change": change}
