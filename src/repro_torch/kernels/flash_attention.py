"""K2: flash attention forward on the card.

``flash_attention(q, k, v, ...)`` computes softmax attention over
q ``(B, Sq, H, D)``, k ``(B, Skv, KV, D)`` and v ``(B, Skv, KV, Dv)`` in the
JAX layout: GQA (kv head ``h // (H/KV)``), causal masking, a sliding window
(``qpos - kpos < window``), a tanh logit softcap and a scale (``1/sqrt(D)``
when 0).  It returns the output ``(B, Sq, H, Dv)`` in q's dtype and, with
``return_lse``, the fp32 log-sum-exp ``(B, Sq, H)`` of every row, which the
attention backward needs.  On a CUDA tensor it launches a hand-written
kernel in ``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs
``flash_attention_reference``, the plain torch version of the same function.

Which kernel runs is one fixed rule, ``variant_for(dtype, D, Dv)``, decided
before any launch:

* bfloat16 with D = Dv in (64, 112, 128, 256), every head dim of the
  repo's GQA models (112: zamba2-7b's shared attention block, run on the
  tiles of 128 with TMA filling columns 112-127 with zeros and the
  epilogue storing 112), and (D, Dv) = (192, 128), deepseek-v2's MLA after
  its per-head K and V are materialized (128 nope + 64 rope dims for q and
  k, 128 for v), runs ``"wgmma"``: tensor-core tiles (``wgmma``) fed by TMA
  loads, a
  producer warpgroup and two consumer warpgroups of 64 q rows per block
  (two q heads of one kv head per block when H/KV is even, so they share
  every K and V tile; else 128 rows of one head).  Its operands must suit
  TMA: a 16-byte-aligned base and 16-byte-multiple strides
  (``tma_strides`` checks them and raises ``ValueError``).
* float32 at any D = Dv, and bfloat16 with D = Dv in (16, 32), run
  ``"simt"``: fp32 FMAs on the CUDA cores.  float32 must meet the
  reference's 2e-5, which the tensor cores (TF32 for fp32 inputs, about 3
  digits) cannot; D 16 and 32 occur only in the reduced test
  configurations.

Any other (dtype, D, Dv) raises ``ValueError`` naming it, f32 at (192, 128)
included (no path on the card runs MLA in f32).  A failed launch of either
variant raises; nothing retries on the other or on the plain version.
``launches`` counts every launch and ``launches_by_variant`` each
variant's.

The kernels replace the JAX reference's Pallas TPU kernel
``repro/kernels/flash_attention.py::_kernel``.  The bound on an H100 is
operations (``bound_ms``): 2 (D + Dv) FLOPs per unmasked (q, k) pair and
head at the dense tensor-core rate of the input type, against the bytes of
q, k, v, the output and lse at 3.35 TB/s.  The library call that computes
the same function is ``torch.nn.attention.flex_attention`` under
``torch.compile`` with a tanh ``score_mod`` and a causal/window block mask;
with softcap 0, ``torch.nn.functional.scaled_dot_product_attention`` with
the same mask is another (at MLA's head dims, with ``is_causal``).
``chip_smoke.py`` times them beside the kernel; the port calls neither.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
NEG_INF = -1.0e30

#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: bf16 head dims of the wgmma variant (``flash_fwd_wgmma`` in the source;
#: 112 on the tiles of 128)
WGMMA_HEAD_DIMS = (64, 112, 128, 256)
#: the one (D, Dv) pair with D != Dv, bf16 on the wgmma variant: MLA's
#: materialized attention (deepseek-v2: 128 nope + 64 rope, v 128)
MLA_HEAD_DIMS = (192, 128)
VARIANTS = ("wgmma", "simt")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, fp32 on
#: the CUDA cores, device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def unmasked_pairs(Sq: int, Skv: int, causal: bool, window: int,
                   q_offset: int = 0, kv_len: Optional[int] = None) -> int:
    """Number of (q, k) position pairs the mask keeps."""
    kv_len = Skv if kv_len is None else kv_len
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(kv_len - 1, qpos) if causal else \
        np.full(Sq, kv_len - 1, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq,
                                                                  np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def bound_ms(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
             window: int = 0, q_offset: int = 0,
             kv_len: Optional[int] = None,
             Dv: Optional[int] = None) -> Tuple[float, str]:
    """Least time an H100 could take for this call, and what bounds it:
    ``max(FLOPs / peak, bytes / 3.35 TB/s)`` with 2 (D + Dv) FLOPs per
    unmasked pair and head (Q K^T and P V), and q, k, v, out and lse each
    moved once.  ``Dv`` is v's head dim (D when None)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dv = D if Dv is None else Dv
    flops = 2.0 * (D + Dv) * B * H * unmasked_pairs(
        Sq, Skv, causal, window, q_offset, kv_len)
    size = q.element_size()
    nbytes = (B * Sq * H * (D + Dv) + B * Skv * KV * (D + Dv)) * size \
        + B * Sq * H * 4
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def variant_for(dtype: torch.dtype, D: int, Dv: Optional[int] = None
                ) -> str:
    """The kernel that runs q/k of ``dtype`` with head dim ``D`` and v with
    head dim ``Dv`` (D when None): ``"wgmma"`` for bfloat16 at D = Dv in
    ``WGMMA_HEAD_DIMS`` or at ``MLA_HEAD_DIMS``, else ``"simt"`` (module
    docstring).  Raises on a type or head dims K2 does not take."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"K2 takes float32 or bfloat16, got {dtype}")
    if Dv is not None and Dv != D:
        if dtype == torch.bfloat16 and (D, Dv) == MLA_HEAD_DIMS:
            return "wgmma"
        raise ValueError(f"K2 takes head dims (D, Dv) = {MLA_HEAD_DIMS} "
                         f"with D != Dv, in bfloat16 only; got ({D}, {Dv}) "
                         f"in {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"K2 takes head dims D = Dv in {HEAD_DIMS} or (D, "
                         f"Dv) = {MLA_HEAD_DIMS}; got ({D}, {D})")
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS \
        else "simt"


def tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, seq, head) strides, in elements, by which the wgmma
    variant's TMA descriptors read a ``(B, S, heads, D)`` operand: its own,
    except that a dimension of size 1 gets the stride of a dense layout
    (its stride is never used, and TMA takes none that is not a multiple of
    16 bytes).  Raises ``ValueError`` unless the head dim is contiguous,
    the base is 16-byte aligned and every other stride is a positive
    multiple of 16 bytes below 2^40."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError("TMA reads (B, S, heads, D) with D contiguous")
    size = t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte-aligned base, got address "
                         f"{t.data_ptr():#x}")
    strides = [0, 0, 0]
    inner, extent = 1, t.shape[3]
    for dim in (2, 1, 0):
        st = t.stride(dim) if t.shape[dim] > 1 else inner * extent
        if st <= 0 or (st * size) % 16 or st * size >= 1 << 40:
            raise ValueError(f"TMA needs strides that are positive "
                             f"multiples of 16 bytes, got stride {st} "
                             f"elements of {size} bytes in dim {dim}")
        strides[dim] = st
        inner, extent = st, t.shape[dim]
    return strides[0], strides[1], strides[2]


def build() -> Path:
    """Compile the CUDA source unless built already; returns the library
    (``repro_torch.kernels._build``)."""
    return _build.build(SOURCE, "k2_flash_attention")


def _mask(Sq: int, Skv: int, causal: bool, window: int, q_offset: int,
          kv_len: Optional[int], device) -> torch.Tensor:
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = torch.arange(Skv, device=device)
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= (qpos[:, None] - kpos[None, :]) < window
    if kv_len is not None:
        m &= kpos[None, :] < kv_len
    return m


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              scale: float = 0.0, q_offset: int = 0,
                              kv_len: Optional[int] = None):
    """Plain torch version of K2: unblocked softmax attention in fp32 with
    the reference's masking (the function of the reference's
    ``kernels/ref.py::attention_oracle``).  Returns ``(out in q's dtype,
    lse (B, Sq, H) fp32)``.  A row the mask empties wholly gives zeros and
    ``lse = -1e30``, as the kernel does (the oracle would average it)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("btkgd,bskd->btkgs", qg, k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(Sq, Skv, causal, window, q_offset, kv_len,
                 q.device)[None, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    lsum = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("btkgs,bskd->btkgd", p, v.float()) / lsum
    lse = (m + torch.log(lsum))[..., 0]
    # contiguous, as the kernel writes them: what a backward does with
    # them (a reshape copies or not) then does not depend on the device
    return (out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype).contiguous(),
            lse.reshape(B, Sq, H).contiguous())


class FlashAttention:
    """The K2 wrapper.  ``launches`` counts kernel launches and
    ``launches_by_variant`` those of each variant (plain integers, never
    incremented on the CPU path)."""

    def __init__(self):
        self.reset_counts()
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_variant = dict.fromkeys(VARIANTS, 0)

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel's shared library."""
        if self._lib is None:
            lib = ctypes.CDLL(str(build()))
            ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
            lib.k2_flash_attention.argtypes = (
                [p] * 5 + [i] * 6 + [ll] * 12
                + [i, i, ctypes.c_float, ctypes.c_float, i, i, i, p])
            lib.k2_flash_attention.restype = ctypes.c_int
            lib.k2_flash_attention_wgmma.argtypes = (
                [p] * 5 + [i] * 7 + [ll] * 12
                + [i, i, ctypes.c_float, ctypes.c_float, i, i, p])
            lib.k2_flash_attention_wgmma.restype = ctypes.c_int
            lib.k2_smem_bytes.argtypes = [i, i, i]
            lib.k2_smem_bytes.restype = ll
            lib.k2_error_string.argtypes = [i]
            lib.k2_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def smem_bytes(self, dtype: torch.dtype, D: int,
                   Dv: Optional[int] = None) -> int:
        """Dynamic shared memory of one block of the kernel that runs
        (dtype, D, Dv), in bytes."""
        return int(self.library().k2_smem_bytes(
            DTYPE_CODES[dtype], D, D if Dv is None else Dv))

    def __call__(self, q, k, v, *, causal: bool = True, window: int = 0,
                 softcap: float = 0.0, scale: float = 0.0,
                 q_offset: int = 0, kv_len: Optional[int] = None,
                 return_lse: bool = False):
        if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
            raise ValueError("q, k, v must be (B, S, heads, D)")
        B, Sq, H, D = q.shape
        Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
        if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D \
                or KV == 0 or H % KV:
            raise ValueError(f"shapes q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                             "form GQA attention")
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                  q_offset=q_offset, kv_len=kv_len)
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, **kw)
            return (out, lse) if return_lse else out
        if q.device.type != "cuda" or k.device != q.device \
                or v.device != q.device:
            raise ValueError(f"K2 runs on one CUDA device, got {q.device}, "
                             f"{k.device}, {v.device}")
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"K2 takes q/k/v of one type, got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
        variant = variant_for(q.dtype, D, Dv)
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("K2 takes tensors whose head dim is contiguous")
        if variant == "wgmma":
            strides = [s for t in (q, k, v) for s in tma_strides(t)]
        else:
            strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
        kv_len = Skv if kv_len is None else min(int(kv_len), Skv)
        lib = self.library()
        head = [D, Dv] if variant == "wgmma" else [D]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, Sq, Skv, H, KV, *head, *strides,
                *out.stride()[:3], int(causal), int(window), float(softcap),
                float(scale or 1.0 / math.sqrt(D)), int(q_offset), kv_len]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            if variant == "wgmma":
                code = lib.k2_flash_attention_wgmma(*args, stream)
            else:
                code = lib.k2_flash_attention(*args, DTYPE_CODES[q.dtype],
                                              stream)
        if code != 0:
            msg = lib.k2_error_string(code).decode()
            raise RuntimeError(f"K2 ({variant}) launch on q {tuple(q.shape)} "
                               f"k {tuple(k.shape)} v {tuple(v.shape)} "
                               f"{q.dtype} failed: error "
                               f"{code} ({msg})")
        self.launches += 1
        self.launches_by_variant[variant] += 1
        return (out, lse) if return_lse else out


flash_attention = FlashAttention()
