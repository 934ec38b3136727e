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
devices compute one function.  The reference has no backward kernel, so the
backward recomputes the plain version under autograd and returns the
gradients of x, dt, A, Bm and Cm.  The plain version masks every decay
difference before its exponential, so its gradients stay finite where the
upper triangle would overflow.  While ``launch.step_cost`` counts a step,
the forward counts as K3 by ``ssd_flops``, whichever path runs it.

Which kernel runs is one fixed rule, ``variant_for(dtype, P, N, Q)``,
decided before any launch:

* bfloat16 x/Bm/Cm with P in (64, 128) and N and Q multiples of 64 up to
  256 (mamba2-2.7b's layer, zamba2-7b's SSM layer) run ``"wgmma"``: four
  device kernels in one stream (``ssd_fwd_state``, ``ssd_fwd_pass``,
  ``ssd_fwd_cb``, ``ssd_fwd_scan``) that compute every product in parallel
  over (batch, head, chunk) on tensor-core tiles fed by TMA and run only an
  elementwise pass in chunk order; C B^T is computed once per group.  The
  wrapper allocates their f32 scratch (``wgmma_scratch``).  x, Bm and Cm
  must suit TMA (``flash_attention.tma_strides`` raises ``ValueError``).
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
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import tma_strides
from repro_torch.launch.step_cost import kernel_call

SOURCE = _build.CSRC / "ssd_scan.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("wgmma", "simt")

#: widths of the P slice one block of the SIMT kernel owns (``dispatch`` in
#: the source)
P_SPLITS = (16, 32, 64)
#: the wgmma variant's tile: P, N and Q are multiples of it
WGMMA_TILE = 64
#: the longest chunk the kernel's shared-memory plan takes
MAX_CHUNK = 1024

#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, fp32 on
#: the CUDA cores, device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


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


def build() -> Path:
    """Compile the CUDA source (both variants) unless built already;
    returns the library (``repro_torch.kernels._build``)."""
    return _build.build(SOURCE, "k3_ssd_scan")


class SSDScan:
    """The K3 wrapper.  ``launches`` counts calls that launched K3 and
    ``launches_by_variant`` those of each variant (plain integers, never
    incremented on the CPU path).  Calling it runs the autograd function;
    ``run`` is the forward alone."""

    def __init__(self):
        self.reset_counts()
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_variant = dict.fromkeys(VARIANTS, 0)

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernels' shared library."""
        if self._lib is None:
            lib = ctypes.CDLL(str(build()))
            ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
            lib.k3_ssd_scan.argtypes = (
                [p] * 6 + [i] * 7 + [ll] * 12 + [i, i, p])
            lib.k3_ssd_scan.restype = ctypes.c_int
            lib.k3_ssd_scan_wgmma.argtypes = (
                [p] * 9 + [i] * 7 + [ll] * 12 + [p])
            lib.k3_ssd_scan_wgmma.restype = ctypes.c_int
            lib.k3_smem_bytes.argtypes = [i, i, i]
            lib.k3_smem_bytes.restype = ll
            lib.k3_wgmma_smem_bytes.argtypes = [i, i,
                                                ctypes.POINTER(ll)]
            lib.k3_wgmma_smem_bytes.restype = None
            lib.k3_error_string.argtypes = [i]
            lib.k3_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def smem_bytes(self, N: int, Q: int, P: int) -> int:
        """Dynamic shared memory of one block of the SIMT kernel, in bytes,
        at head dim P."""
        return int(self.library().k3_smem_bytes(N, Q, p_split_for(P)))

    def wgmma_smem_bytes(self, N: int, Q: int) -> Tuple[int, int, int]:
        """Dynamic shared memory of one block of the wgmma variant's
        ``ssd_fwd_state``, ``ssd_fwd_cb`` and ``ssd_fwd_scan``, in bytes."""
        out = (ctypes.c_longlong * 3)()
        self.library().k3_wgmma_smem_bytes(N, Q, out)
        return tuple(int(v) for v in out)

    def run(self, x, dt, A, Bm, Cm, chunk: int = 128) -> torch.Tensor:
        """y: a kernel on a CUDA tensor, the plain version on a CPU one."""
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
        if x.device.type == "cpu":
            return ssd_scan_reference(x, dt, A, Bm, Cm, chunk)
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
        variant = variant_for(x.dtype, P, N, Q)
        if variant == "simt":
            if Q > MAX_CHUNK:
                raise ValueError(f"K3 takes chunks up to {MAX_CHUNK}, got "
                                 f"{Q}")
            ps = p_split_for(P)
        if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
            raise ValueError("K3 takes x, Bm, Cm whose last dim is "
                             "contiguous")
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
                    *strides, *y.stride()[:3], ps, DTYPE_CODES[x.dtype],
                    stream)
        if code != 0:
            msg = lib.k3_error_string(code).decode()
            raise RuntimeError(f"K3 ({variant}) launch on x "
                               f"{tuple(x.shape)} Bm {tuple(Bm.shape)} "
                               f"{x.dtype} chunk {Q} failed: error {code} "
                               f"({msg})")
        self.launches += 1
        self.launches_by_variant[variant] += 1
        return y

    def __call__(self, x, dt, A, Bm, Cm, chunk: int = 128) -> torch.Tensor:
        return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return kernel_call("ssd_scan",
                           lambda: ssd_scan.run(x, dt, A, Bm, Cm, chunk),
                           lambda: ssd_flops(x, Bm, chunk),
                           (x, dt, A, Bm, Cm))

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssd_scan_reference(*inputs, ctx.chunk)
            grads = torch.autograd.grad(y, inputs, dy)
        return (*grads, None)


ssd_scan = SSDScan()
