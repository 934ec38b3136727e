"""K3: the Mamba2 SSD chunked scan on the card.

``ssd_scan(x, dt, A, Bm, Cm, chunk)`` computes, over x ``(B, S, H, P)``,
dt ``(B, S, H)`` (post-softplus), A ``(H,)`` (negative) and Bm/Cm
``(B, S, G, N)`` (head h reads group ``h // (H/G)``), in chunks of
``Q = min(chunk, S)`` with an ``(N, P)`` state carried across chunks and
zero at the start:

    cum   = cumsum(dt * A)                              per chunk
    y     = (C B^T * L) x + (C state) * exp(cum)        L[t, s] = exp(cum_t
                                                        - cum_s) dt_s, t >= s
    state = exp(cum[-1]) state + (B * w)^T x            w = exp(cum[-1] - cum) dt

f32 inside, y in x's dtype, no final state: the function of the JAX
reference's Pallas TPU kernel ``repro/kernels/ssd_scan.py::_kernel``, which
the kernels in ``csrc/ssd_scan.cu`` replace.  ``ssd_scan`` is a
``torch.autograd.Function``: its forward is a kernel on a CUDA tensor and
``ssd_scan_reference``, the plain torch version, on a CPU tensor, so both
devices compute one function; both run behind the custom op
``repro_torch::ssd_scan_fwd``, whose fake implementation serves tensors
without storage (a dry run's) after the checks a call on their device
makes before it reads data.  The reference has no backward kernel, so the
backward recomputes the plain version under autograd and returns the
gradients of x, dt, A, Bm and Cm.  The plain version masks every decay
difference before its exponential, so its gradients stay finite where the
upper triangle would overflow.  ``launch.step_cost`` counts the op by
``ssd_flops`` (``common.OP_FLOPS``), whichever path runs inside it.

Which kernel runs is one fixed rule, ``variant_for(dtype, P, N, Q)``,
decided before any launch:

* bfloat16 x/Bm/Cm with P in (64, 128) and N and Q multiples of 64 up to
  256 (mamba2-2.7b's layer, zamba2-7b's SSM layer) run ``"wgmma"``: four
  device kernels in one stream (``ssd_fwd_state``, ``ssd_fwd_pass``,
  ``ssd_fwd_cb``, ``ssd_fwd_scan``) that compute every product in parallel
  over (batch, head, chunk) on tensor-core tiles fed by TMA and run only an
  elementwise pass in chunk order; C B^T is computed once per group.  The
  wrapper allocates their f32 scratch (``wgmma_scratch``).  x, Bm and Cm
  must suit TMA (``common.tma_strides`` raises ``ValueError``).
* everything else, f32 at any shape among it, runs ``"simt"``: one kernel
  (``ssd_fwd``) of fp32 FMAs on the CUDA cores that carries each block's
  state slice through the chunks (``p_split_for``).  f32 must meet the
  reference's 2e-5, which tensor cores (TF32 for f32 inputs) cannot.

A failed launch of either variant raises; nothing retries on the other or
on the plain version.  ``launches`` counts calls of K3, one per layer
forward however many device kernels it runs, and ``launches_by_variant``
each variant's.

Bound on an H100 (``bound_ms``): the larger of the bytes (x, dt, Bm, Cm
read once, y written once, at 3.35 TB/s) and the operations the function
needs (``ssd_flops``) at the H100's peak for x's type: 989 TFLOP/s for bf16
on the tensor cores, 67 TFLOP/s for fp32.  No single PyTorch call computes
the SSD scan, so it has no library yardstick.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, HBM_BYTES_PER_S, I, LL,
                                        OP_FLOPS, P, PEAK_FLOPS, Kernel,
                                        tma_layout, tma_strides)

SOURCE = _build.CSRC / "ssd_scan.cu"
VARIANTS = ("wgmma", "simt")

#: widths of the P slice one block of the SIMT kernel owns (``dispatch`` in
#: the source)
P_SPLITS = (16, 32, 64)
#: the wgmma variant's tile: P, N and Q are multiples of it
WGMMA_TILE = 64
#: the longest chunk the kernel's shared-memory plan takes
MAX_CHUNK = 1024


def ssd_flops(x: torch.Tensor, Bm: torch.Tensor, chunk: int) -> float:
    """The FLOPs the function needs: C B^T once per (batch, group, chunk)
    and its product with x per (batch, head, chunk), each over the
    ``Q(Q+1)/2`` pairs t >= s the mask keeps; ``4QNP`` per (batch, head,
    chunk) for C times the state and the state update."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    pairs = Q * (Q + 1) // 2
    nc = S // Q
    return float(B * G * nc * 2 * pairs * N
                 + B * H * nc * (2 * pairs * P + 4 * Q * N * P))


def bound_ms(x, dt, Bm, Cm, chunk: int) -> Tuple[float, str]:
    """Least time an H100 could take for this call, and what bounds it:
    ``max(FLOPs / peak, bytes / 3.35 TB/s)`` (module docstring)."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, Bm, Cm)) \
        + x.numel() * x.element_size()
    t_ops = ssd_flops(x, Bm, chunk) / PEAK_FLOPS[x.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def masked_decay(cum: torch.Tensor) -> torch.Tensor:
    """``exp(cum_t - cum_s)`` for t >= s and 0 above the diagonal, masked
    before the exponential so that no difference overflows and the gradient
    holds no ``0 * inf``.  cum: (..., Q); returns (..., Q, Q) as (t, s)."""
    Q = cum.shape[-1]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    rel = cum[..., :, None] - cum[..., None, :]
    return torch.exp(torch.where(tril, rel, -math.inf))


def ssd_scan_reference(x, dt, A, Bm, Cm, chunk: int = 128) -> torch.Tensor:
    """Plain torch version of K3 (module docstring): every chunk at once for
    the intra-chunk product, a loop over chunks for the state.  Computes in
    f32 (f64 for f64 inputs) and returns y in x's dtype."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct).reshape(B, nc, Q, G, rep, P)
    dtf = dt.to(ct).reshape(B, nc, Q, G, rep)
    Bf = Bm.to(ct).reshape(B, nc, Q, G, N)
    Cf = Cm.to(ct).reshape(B, nc, Q, G, N)
    cum = torch.cumsum(dtf * A.to(ct).reshape(G, rep), dim=2)
    # intra-chunk: (C B^T) masked by the decay, exp only where t >= s
    CB = torch.einsum("bctgn,bcsgn->bcgts", Cf, Bf)            # (B,c,G,Q,Q)
    Lmat = masked_decay(cum.permute(0, 1, 3, 4, 2)) \
        * dtf.permute(0, 1, 3, 4, 2)[..., None, :]             # (B,c,G,r,t,s)
    y = torch.einsum("bcgrts,bcsgrp->bctgrp", CB[:, :, :, None] * Lmat, xf)
    # the state each chunk leaves, then the state each chunk starts from
    w = torch.exp(cum[:, :, -1:] - cum) * dtf                  # (B,c,Q,G,r)
    ds = torch.einsum("bcqgn,bcqgrp,bcqgr->bcgrnp", Bf, xf, w)
    decay = torch.exp(cum[:, :, -1])                           # (B,c,G,r)
    state = torch.zeros((B, G, rep, N, P), dtype=ct, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * decay[:, c, ..., None, None] + ds[:, c]
    prev = torch.stack(starts, dim=1)                          # (B,c,G,r,N,P)
    y = y + torch.einsum("bctgn,bcgrnp->bctgrp", Cf, prev) \
        * torch.exp(cum)[..., None]
    return y.reshape(B, S, H, P).to(x.dtype).contiguous()


def ssd_oracle(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Naive sequential state-space recurrence in float64 (a copy of the
    reference's ``kernels/ref.py::ssd_oracle``, for the tests).  Returns y
    in x's dtype; differentiable."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f64 = torch.float64
    xf, dtf, Af = x.to(f64), dt.to(f64), A.to(f64)
    Bf = Bm.to(f64).repeat_interleave(rep, dim=2)              # (B,S,H,N)
    Cf = Cm.to(f64).repeat_interleave(rep, dim=2)
    state = torch.zeros((B, H, N, P), dtype=f64, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af)                          # (B,H)
        state = state * a[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhnp", Bf[:, t], xf[:, t], dtf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def variant_for(dtype: torch.dtype, P: int, N: int, Q: int) -> str:
    """The kernel that runs x/Bm/Cm of ``dtype`` with head dim ``P``, state
    ``N`` and chunk ``Q``: ``"wgmma"`` for bfloat16 with P in (64, 128) and
    N and Q multiples of 64 up to 256, else ``"simt"`` (module docstring).
    Raises ``TypeError`` on a type K3 does not take."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"K3 takes float32 or bfloat16, got {dtype}")
    tile = WGMMA_TILE
    fits = (P in (tile, 2 * tile) and 0 < N <= 4 * tile and N % tile == 0
            and 0 < Q <= 4 * tile and Q % tile == 0)
    return "wgmma" if dtype == torch.bfloat16 and fits else "simt"


def p_split_for(P: int) -> int:
    """The P slice one block of the SIMT variant owns: the widest of
    ``P_SPLITS`` dividing P.  At mamba2-2.7b's batch-1 layer that is all 64
    columns, 80 blocks for 132 SMs: on an H100 80GB HBM3 at 700 W that
    kernel took 2.19 ms there, against 2.52 ms with two slices of 32 (160
    blocks) and 3.35 ms with four (PERF.md, K3): recomputing C B^T for each
    slice costs more than the idle SMs."""
    fits = [s for s in P_SPLITS if P % s == 0]
    if not fits:
        raise ValueError(f"K3 takes head dims that are multiples of 16, "
                         f"got {P}")
    return max(fits)


def wgmma_scratch(B: int, S: int, H: int, P: int, G: int, N: int, Q: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wgmma variant's f32 scratch, views of one ``torch.empty``
    buffer: ``cum`` (B, H, S), the chunk states ``(B, H, S/Q, N, P)`` (each
    chunk's contribution, then the state it starts from) and C B^T ``(B, G,
    S/Q, T (T + 1) / 2, 64 * 64)``, one 64 x 64 tile per (t, s) tile pair at
    or below the diagonal, T = Q / 64."""
    nc, nt = S // Q, Q // WGMMA_TILE
    shapes = ((B, H, S), (B, H, nc, N, P),
              (B, G, nc, nt * (nt + 1) // 2, WGMMA_TILE * WGMMA_TILE))
    sizes = [math.prod(s) for s in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return tuple(part.view(shape) for part, shape
                 in zip(buf.split(sizes), shapes))


class SSDScan(Kernel):
    """The K3 wrapper.  ``launches`` counts calls that launched K3 and
    ``launches_by_variant`` those of each variant (plain integers, never
    incremented on the CPU path).  Calling it runs the autograd function;
    ``run`` is the forward alone."""

    NAME, SOURCE = "K3", SOURCE
    SIGNATURES = {
        "k3_ssd_scan": ([P] * 6 + [I] * 7 + [LL] * 12 + [I, I, P], I),
        "k3_ssd_scan_wgmma": ([P] * 9 + [I] * 7 + [LL] * 12 + [P], I),
        "k3_smem_bytes": ([I, I, I], LL),
        "k3_wgmma_smem_bytes": ([I, I, ctypes.POINTER(LL)], None)}
    COUNTS = {"variant": VARIANTS}

    def smem_bytes(self, N: int, Q: int, P: int) -> int:
        """Dynamic shared memory of one block of the SIMT kernel, in bytes,
        at head dim P."""
        return int(self.library().k3_smem_bytes(N, Q, p_split_for(P)))

    def wgmma_smem_bytes(self, N: int, Q: int) -> Tuple[int, int, int]:
        """Dynamic shared memory of one block of the wgmma variant's
        ``ssd_fwd_state``, ``ssd_fwd_cb`` and ``ssd_fwd_scan``, in bytes."""
        out = (LL * 3)()
        self.library().k3_wgmma_smem_bytes(N, Q, out)
        return tuple(int(v) for v in out)

    def run(self, x, dt, A, Bm, Cm, chunk: int = 128) -> torch.Tensor:
        """y: a kernel on a CUDA tensor, the plain version on a CPU one
        (through the custom op ``repro_torch::ssd_scan_fwd``)."""
        return torch.ops.repro_torch.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk)

    def _run(self, x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
        """The op on tensors with storage."""
        B, S, H, P, G, N, Q = scan_shapes(x, dt, A, Bm, Cm, chunk)
        if x.device.type == "cpu":
            return ssd_scan_reference(x, dt, A, Bm, Cm, chunk)
        variant = card_variant(x, dt, A, Bm, Cm, Q)
        if variant == "wgmma":
            strides = [s for t in (x, Bm, Cm) for s in tma_strides(t)]
        else:
            strides = [s for t in (x, Bm, Cm) for s in t.stride()[:3]]
        dt = dt.contiguous()
        A = A.contiguous()
        y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
        lib = self.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if variant == "wgmma":
                scratch = wgmma_scratch(B, S, H, P, G, N, Q, x.device)
                code = lib.k3_ssd_scan_wgmma(
                    x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), y.data_ptr(),
                    *(t.data_ptr() for t in scratch), B, S, H, P, G, N, Q,
                    *strides, *y.stride()[:3], stream)
            else:
                code = lib.k3_ssd_scan(
                    x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), y.data_ptr(), B, S, H, P, G, N, Q,
                    *strides, *y.stride()[:3], p_split_for(P),
                    DTYPE_CODES[x.dtype], stream)
        self.launched(code, lambda: f"({variant}) launch on x "
                      f"{tuple(x.shape)} Bm {tuple(Bm.shape)} {x.dtype} "
                      f"chunk {Q}", variant)
        return y

    def __call__(self, x, dt, A, Bm, Cm, chunk: int = 128) -> torch.Tensor:
        return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)


def scan_shapes(x, dt, A, Bm, Cm, chunk: int) -> Tuple[int, ...]:
    """``(B, S, H, P, G, N, Q)`` of a call; raises ``ValueError`` unless
    the operands form an SSD scan whose length the chunk divides."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 \
            or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("K3 takes x (B,S,H,P), dt (B,S,H), A (H,), "
                         "Bm/Cm (B,S,G,N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (B, S, H) or A.shape != (H,) or Cm.shape != Bm.shape \
            or Bm.shape[:2] != (B, S) or G == 0 or H % G:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do "
                         "not form an SSD scan")
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    return B, S, H, P, G, N, Q


def card_variant(x, dt, A, Bm, Cm, Q: int) -> str:
    """What a launch on the card checks before it reads any data: one CUDA
    device, the types K3 takes, the chunk and head dim of the variant that
    runs (``variant_for``) and contiguous last dims.  Returns the variant;
    raises ``ValueError`` or ``TypeError``."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (dt, A, Bm, Cm)):
        raise ValueError(f"K3 runs on one CUDA device, got x on "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"K3 takes float32 or bfloat16 x/Bm/Cm of one "
                        f"type, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"K3 takes float32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    P, N = x.shape[3], Bm.shape[3]
    variant = variant_for(x.dtype, P, N, Q)
    if variant == "simt":
        if Q > MAX_CHUNK:
            raise ValueError(f"K3 takes chunks up to {MAX_CHUNK}, got "
                             f"{Q}")
        p_split_for(P)
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("K3 takes x, Bm, Cm whose last dim is "
                         "contiguous")
    return variant


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def _ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                  ) -> torch.Tensor:
    return ssd_scan._run(x, dt, A, Bm, Cm, chunk)


@_ssd_scan_fwd.register_fake
def _ssd_scan_fwd_fake(x, dt, A, Bm, Cm, chunk):
    """The op on tensors with no storage (a dry run's ``FakeTensorMode``):
    y's shape, type and device, after the checks a call on the same device
    makes before it reads data (the kernel's TMA layout but not its base
    address)."""
    Q = scan_shapes(x, dt, A, Bm, Cm, chunk)[-1]
    if x.device.type != "cpu" \
            and card_variant(x, dt, A, Bm, Cm, Q) == "wgmma":
        for t in (x, Bm, Cm):
            tma_layout(t)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


OP_FLOPS["ssd_scan_fwd"] = ("ssd_scan", lambda x, dt, A, Bm, Cm, chunk:
                            ssd_flops(x, Bm, chunk))


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ssd_scan.run(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssd_scan_reference(*inputs, ctx.chunk)
            grads = torch.autograd.grad(y, inputs, dy)
        return (*grads, None)


ssd_scan = SSDScan()
