"""Blocked online-softmax attention core with a flash-style backward (port
of the reference's ``repro/models/attention_core.py``).

``blocked_attention`` is a ``torch.autograd.Function``.  Its forward is
K2 (``repro_torch.kernels.flash_attention``): the kernel on a CUDA tensor,
its plain torch version on a CPU tensor, so both devices compute one
function.  It saves only ``(q, k, v, out, lse)``, as the reference's ``_fwd``
does.  Its backward is ``_backward``, the reference's blocked recomputation
in plain torch: the reference has no backward kernel either, only XLA code.

Shapes follow the reference: q ``(B, Sq, H, D)``, k ``(B, Skv, KV, D)`` and
v ``(B, Skv, KV, Dv)``, the output ``(B, Sq, H, Dv)`` (Dv differs from D in
MLA: 192 and 128 at deepseek-v2's widths, which K2 takes); this port keeps
``lse`` as ``(B, Sq, H)`` (the reference's ``(B, Sq, KV, G)`` flattened, head
``h = kv * G + g``).  The blocks of ``AttnSpec`` tile the backward (K2
tiles the forward itself); its loop skips (q, kv) block pairs that the
causal mask or the window empties wholly, where the reference computes them
and adds zeros.

A step count (``launch.step_cost``) counts the forward as K2's custom op,
by the FLOP formula ``kernels.flash_attention`` gives it, whichever path
runs inside.

``AttnSpec.folded`` (balanced causal folding) is accepted and runs the
unfolded path.  On the TPU the fold pairs q blocks (i, NQ-1-i) so that
every step of the kernel's grid does the same work; here it would only
reorder block updates.  K2's forward on the card already skips the tiles
the causal mask empties, and the backward's loop (``_live``) visits
exactly the block pairs the mask keeps, so the work is the same either
way and the function is the reference's folded one.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention

Tensor = torch.Tensor
NEG_INF = -1.0e30

class AttnSpec(NamedTuple):
    causal: bool = True
    window: int = 0          # 0 = full
    softcap: float = 0.0
    scale: float = 0.0       # 0 -> 1/sqrt(D)
    q_block: int = 512
    kv_block: int = 512
    folded: bool = False     # balanced causal folding


def _mask(qpos: Tensor, kpos: Tensor, spec: AttnSpec, kv_len) -> Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if spec.causal:
        m &= qpos[:, None] >= kpos[None, :]
    if spec.window:
        m &= (qpos[:, None] - kpos[None, :]) < spec.window
    if kv_len is not None:
        m &= kpos[None, :] < kv_len
    return m


def _live(spec: AttnSpec, q_lo: int, q_hi: int, k_lo: int, k_hi: int
          ) -> bool:
    """Whether the block of q positions [q_lo, q_hi] and kv positions
    [k_lo, k_hi] holds an unmasked pair."""
    if spec.causal and k_lo > q_hi:
        return False
    if spec.window and q_lo - k_hi >= spec.window:
        return False
    return True


def _blocks(q: Tensor, k: Tensor, spec: AttnSpec):
    Sq, Skv = q.shape[1], k.shape[1]
    BQ, BK = min(spec.q_block, Sq), min(spec.kv_block, Skv)
    if Sq % BQ or Skv % BK:
        raise ValueError(f"sequence lengths {Sq}, {Skv} are not multiples "
                         f"of the blocks {BQ}, {BK}")
    return BQ, BK, Sq // BQ, Skv // BK


def _backward(q, k, v, out, lse, dout, spec: AttnSpec, q_offset: int = 0,
              kv_len=None):
    """Plain blocked backward: recomputes each block's probabilities from
    ``lse``; returns (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    BQ, BK, NQ, NK = _blocks(q, k, spec)
    scale = spec.scale or 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, D).float()
    kf, vf = k.float(), v.float()
    dog = dout.reshape(B, Sq, KV, G, Dv).float()
    lseg = lse.reshape(B, Sq, KV, G)
    delta = (dout.float() * out.float()).sum(dim=-1).reshape(B, Sq, KV, G)
    dq = torch.zeros((B, Sq, KV, G, D), device=dev)
    dk = torch.zeros((B, Skv, KV, D), device=dev)
    dv = torch.zeros((B, Skv, KV, Dv), device=dev)
    for j in range(NK):
        ks, ke = j * BK, (j + 1) * BK
        kpos = ks + torch.arange(BK, device=dev)
        kb, vb = kf[:, ks:ke], vf[:, ks:ke]
        for i in range(NQ):
            qs, qe = i * BQ, (i + 1) * BQ
            if not _live(spec, q_offset + qs, q_offset + qe - 1, ks, ke - 1):
                continue
            qpos = q_offset + qs + torch.arange(BQ, device=dev)
            mask = _mask(qpos, kpos, spec, kv_len)[None, :, None, None, :]
            qb = qg[:, qs:qe]
            t = torch.einsum("btkgd,bskd->btkgs", qb, kb) * scale
            z = torch.tanh(t / spec.softcap) * spec.softcap \
                if spec.softcap else t
            z = torch.where(mask, z, NEG_INF)
            p = torch.where(mask, torch.exp(z - lseg[:, qs:qe, ..., None]),
                            0.0)
            dob = dog[:, qs:qe]
            dp = torch.einsum("btkgd,bskd->btkgs", dob, vb)
            dz = p * (dp - delta[:, qs:qe, ..., None])
            if spec.softcap:
                dz = dz * (1.0 - torch.tanh(t / spec.softcap).square())
            dz = dz * scale
            dv[:, ks:ke] += torch.einsum("btkgs,btkgd->bskd", p, dob)
            dk[:, ks:ke] += torch.einsum("btkgs,btkgd->bskd", dz, qb)
            dq[:, qs:qe] += torch.einsum("btkgs,bskd->btkgd", dz, kb)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _BlockedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, spec: AttnSpec, q_offset: int,
                kv_len: Optional[int]):
        out, lse = flash_attention(
            q, k, v, causal=spec.causal, window=spec.window,
            softcap=spec.softcap, scale=spec.scale, q_offset=q_offset,
            kv_len=kv_len, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec, ctx.q_offset, ctx.kv_len = spec, q_offset, kv_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, ctx.spec,
                               ctx.q_offset, ctx.kv_len)
        return dq, dk, dv, None, None, None


def blocked_attention(q: Tensor, k: Tensor, v: Tensor, spec: AttnSpec,
                      q_offset: int = 0, kv_len=None) -> Tensor:
    """Attention output ``(B, Sq, H, Dv)`` in q's dtype (module docstring)."""
    return _BlockedAttention.apply(q, k, v, spec, q_offset, kv_len)
