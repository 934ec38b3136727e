"""Mamba2 (SSD, state-space duality) block in PyTorch (port of the
reference's ``repro/models/ssm.py``).

Chunked SSD: an intra-chunk product quadratic in the chunk length and a
state recurrence across chunks.  ``apply_mamba2`` runs it through K3
(``repro_torch.kernels.ssd_scan``) by default: the kernel on a CUDA tensor,
its plain version on a CPU tensor.  ``ssd_chunked`` is the reference's own
chunked path (its bf16 cast of the scores and its final state), kept for the
tests and as ``apply_mamba2``'s other ``impl``.

Every exponential of a decay difference is masked before it is taken
(``exp(where(t >= s, cum_t - cum_s, -inf))``).  The reference takes the
exponential over the whole chunk and masks it afterwards (``ssm.py:107-108``):
the forward values are the same, but at mamba2's widths (chunk 256, A down to
-16, dt up to 0.1) the upper triangle overflows and its gradient is
``0 * inf = NaN``.  Here the gradients stay finite.

Projections stay separate (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``), as in
the reference.  Shapes: x ``(B, S, d_model)``; heads ``(B, S, H, P)`` with
``P = ssm_head_dim``, state ``N = ssm_state``, groups ``G`` (B and C are
shared per group; head h reads group ``h // (H/G)``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rms_norm as K4
from repro_torch.kernels.ssd_scan import masked_decay, ssd_scan
from repro_torch.models import layers as L

Tensor = torch.Tensor


def init_mamba2(gen: torch.Generator, cfg, dtype=torch.float32, device=None
                ) -> Dict[str, Tensor]:
    """One block's parameters.  ``A_log``, ``D`` and ``dt_bias`` are f32
    whatever ``dtype`` is, as in the reference."""
    d = cfg.d_model
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    H, W = cfg.ssm_heads, cfg.conv_width
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias: softplus^-1(dt) for dt ~ U[1e-3, 1e-1] on a log scale
    u = torch.rand(H, generator=gen, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a = 1.0 + 15.0 * torch.rand(H, generator=gen, **f32)

    def conv(ch):
        w = torch.randn((ch, W), generator=gen, **f32)
        return (w / math.sqrt(W)).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    return {
        "w_z": L.dense_init(gen, (d, di), dtype, device=device),
        "w_x": L.dense_init(gen, (d, di), dtype, device=device),
        "w_B": L.dense_init(gen, (d, G * N), dtype, device=device),
        "w_C": L.dense_init(gen, (d, G * N), dtype, device=device),
        "w_dt": L.dense_init(gen, (d, H), dtype, device=device),
        "conv_x_w": conv(di),
        "conv_x_b": zeros(di),
        "conv_B_w": conv(G * N),
        "conv_B_b": zeros(G * N),
        "conv_C_w": conv(G * N),
        "conv_C_b": zeros(G * N),
        "A_log": torch.log(a),
        "D": torch.ones(H, **f32),
        "dt_bias": dt_bias,
        "gate_norm": torch.ones(di, dtype=dtype, device=device),
        "out_proj": L.dense_init(gen, (di, d), dtype, device=device),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (C, W).  W shifted float32
    multiply-adds: no convolution library call, so nothing runs in TF32."""
    W, S = w.shape[-1], x.shape[1]
    xp = F.pad(x.float(), (0, 0, W - 1, 0))
    wf = w.float()
    out = xp[:, :S] * wf[:, 0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * wf[:, k]
    return (out + b.float()).to(x.dtype)


def _conv_region(dist, x):
    """``_causal_conv`` on local shards: the batch over the data-parallel
    dims, the sequence and channels whole (DTensor would pad a sequence it
    may have sharded for the product; not every PyTorch can plan that
    redistribution), the weights gathered, their gradients partial sums
    over the data-parallel dims."""
    from repro_torch.dist.compat import shard_map
    from repro_torch.dist.sharding import P
    dpe = dist.batch_entry(x)
    xspec = P(dpe, None, None)
    wgrad = dist.dp_partial(dpe is not None)
    return shard_map(_causal_conv, mesh=dist.mesh,
                     in_specs=(xspec, P(None, None), P(None)),
                     in_grad_specs=(xspec, wgrad, wgrad), out_specs=xspec)


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                chunk: int) -> Tuple[Tensor, Tensor]:
    """The reference's chunked SSD scan.  x: (B,S,H,P); dt: (B,S,H)
    post-softplus; A: (H,) negative; Bm/Cm: (B,S,G,N).  Returns
    (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) f32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    rep = H // G
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum((dtq * A).float(), dim=1)             # (B,Q,H)
        # intra-chunk (quadratic in Q)
        CB = torch.einsum("btgn,bsgn->bgts", Cq.float(), Bq.float())
        CB = CB.repeat_interleave(rep, dim=1)                    # (B,H,Q,Q)
        Lmat = masked_decay(cum.transpose(1, 2)) \
            * dtq.transpose(1, 2)[:, :, None]
        scores = (CB * Lmat).to(xq.dtype)                        # (B,H,t,s)
        y_intra = torch.einsum("bhts,bshp->bthp", scores.float(),
                               xq.float())
        # inter-chunk: the state left by the previous chunks
        Ch = Cq.float().repeat_interleave(rep, dim=2)             # (B,Q,H,N)
        y_inter = torch.einsum("bthn,bhnp->bthp", Ch, state) \
            * torch.exp(cum)[..., None]
        # state update
        decay_end = torch.exp(cum[:, -1:, :] - cum) * dtq        # (B,Q,H)
        Bh = Bq.float().repeat_interleave(rep, dim=2)             # (B,Q,H,N)
        ds = torch.einsum("bqhn,bqhp,bqh->bhnp", Bh, xq.float(), decay_end)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + ds
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), state


def ssd_k3(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
           chunk: int) -> Tuple[Tensor, None]:
    """K3 under ``ssd_chunked``'s signature; the kernel returns no final
    state."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk), None


def _scan_region(impl, dist, chunk: int):
    """``impl`` under ``dist``: a local-shard region with batch over the
    data-parallel dims (DTensor has no sharding rule for K3).  A's
    gradient is a partial sum on each data shard."""
    from torch.distributed.tensor import Partial

    from repro_torch.dist.compat import shard_map
    from repro_torch.dist.sharding import P
    dpe = dist._dp_entry() if dist.dp_size > 1 else None
    x4 = P(dpe, None, None, None)
    specs = (x4, P(dpe, None, None), P(None), x4, x4)
    a_grad = tuple(Partial() if a in dist.dp_axes else pl for a, pl in
                   zip(dist.axis_names, dist.placements(P(None))))
    return shard_map(lambda *t: impl(*t, chunk)[0], mesh=dist.mesh,
                     in_specs=specs,
                     in_grad_specs=specs[:2] + (a_grad,) + specs[3:],
                     out_specs=x4)


def apply_mamba2(p, x: Tensor, cfg, impl=ssd_k3, dist=None) -> Tensor:
    """Full Mamba2 block (train/prefill).  Under ``dist`` the scan runs in a
    local-shard region (``_scan_region``); the tail is ``gated_norm``."""
    N, G, H = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    P = cfg.ssm_head_dim
    Bsz, S, _ = x.shape
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt_raw = x @ p["w_dt"]
    conv = _conv_region(dist, x) if dist is not None \
        and dist.mesh is not None else _causal_conv
    xs = F.silu(conv(xs, p["conv_x_w"], p["conv_x_b"]))
    Bm = F.silu(conv(Bm, p["conv_B_w"], p["conv_B_b"]))
    Cm = F.silu(conv(Cm, p["conv_C_w"], p["conv_C_b"]))
    xs = L.reshape(xs, (Bsz, S, H, P))
    Bm = L.reshape(Bm, (Bsz, S, G, N))
    Cm = L.reshape(Cm, (Bsz, S, G, N))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if dist is not None and dist.mesh is not None:
        y = _scan_region(impl, dist, cfg.ssm_chunk)(xs, dt, A, Bm, Cm)
    else:
        y, _ = impl(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = gated_norm(y, xs, p["D"], z, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def gated_norm(y: Tensor, xs: Tensor, D: Tensor, z: Tensor, scale: Tensor,
               eps: float) -> Tensor:
    """``apply_mamba2``'s tail from the scan's output y and xs ``(B, S, H,
    P)`` to ``out_proj``'s input: the skip through D, the gate silu(z) and
    the RMS norm, in z's shape ``(B, S, H P)``.  K4's gated variant on a
    tensor K4 takes (``K4.takes``), its composed ops (``K4.gate``, then
    ``apply_norm``) on any other."""
    if K4.takes(y):
        return K4.rms_norm.gated(y, xs, D, z, scale, eps)
    u, s = K4.gate(y, xs, D, z)
    return L.apply_norm({"scale": scale}, L.reshape(u, z.shape) * s, "rms",
                        eps)


# ---------------------------------------------------------------------------
# Decode (single-token recurrent step)
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device=None
                   ) -> Dict[str, Tensor]:
    """Conv windows in ``dtype``, the state in f32."""
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    W = cfg.conv_width
    kw = dict(dtype=dtype, device=device)
    return {
        "conv_x": torch.zeros((batch, W - 1, di), **kw),
        "conv_B": torch.zeros((batch, W - 1, G * N), **kw),
        "conv_C": torch.zeros((batch, W - 1, G * N), **kw),
        "state": torch.zeros((batch, cfg.ssm_heads, N, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }


def _conv_step(window_prev: Tensor, x_new: Tensor, w: Tensor, b: Tensor):
    """window_prev: (B, W-1, C); x_new: (B, C).  Returns (out (B,C),
    window)."""
    window = torch.cat([window_prev, x_new[:, None, :]], dim=1)
    out = torch.einsum("bwc,cw->bc", window.float(), w.float())
    return (out + b.float()).to(x_new.dtype), window[:, 1:, :]


def mamba2_decode(p, x: Tensor, cfg, cache, dist=None):
    """x: (B, 1, d).  Returns (y (B,1,d), new_cache).  Under ``dist`` the
    block's small weights are gathered and its activations keep the batch
    over the data-parallel dims and the rest whole, so that no product of
    the recurrence folds a sharded head dim (``dist.sharding``)."""
    di, N, G, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    P = cfg.ssm_head_dim
    B = x.shape[0]
    x0 = x[:, 0]
    z = x0 @ p["w_z"]
    xs = x0 @ p["w_x"]
    Bm = x0 @ p["w_B"]
    Cm = x0 @ p["w_C"]
    dt_raw = x0 @ p["w_dt"]
    if dist is not None and dist.mesh is not None:
        z, xs, Bm, Cm, dt_raw = (dist.constrain_act(t)
                                 for t in (z, xs, Bm, Cm, dt_raw))
        p = {k: v if k.startswith("w_") or k == "out_proj"
             else dist.gather(v) for k, v in p.items()}
        cache = {k: dist.constrain_act(v) for k, v in cache.items()}
    xs, conv_x = _conv_step(cache["conv_x"], xs, p["conv_x_w"], p["conv_x_b"])
    Bm, conv_B = _conv_step(cache["conv_B"], Bm, p["conv_B_w"], p["conv_B_b"])
    Cm, conv_C = _conv_step(cache["conv_C"], Cm, p["conv_C_w"], p["conv_C_b"])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    xs = L.reshape(xs, (B, H, P))
    rep = H // G
    Bh = L.reshape(Bm, (B, G, N)).repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = L.reshape(Cm, (B, G, N)).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])             # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                      # (B,H)
    state = (cache["state"] * a[..., None, None]
             + torch.einsum("bhn,bhp,bh->bhnp", Bh.float(), xs.float(), dt))
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), state)
    y = y + xs.float() * p["D"][:, None]
    y = L.reshape(y, (B, di)).to(x.dtype)
    y = y * F.silu(z)
    y = L.apply_norm({"scale": p["gate_norm"]}, y, "rms", cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None]
    new_cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "state": state}
    return out, new_cache
