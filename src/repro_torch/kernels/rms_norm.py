"""K4: the RMS norm on the card, plain and with mamba2's skip and gate.

Two variants of one kernel (``csrc/rms_norm.cu``):

* ``"plain"``, ``rms_norm(x, scale, eps)``: ``models.layers.apply_norm``'s
  RMS norm over the last dim, ``T((x * rstd) * scale)`` with ``rstd =
  rsqrt(mean(x^2) + eps)`` in f32 and T the type of x;
* ``"gated"``, ``rms_norm.gated(y, xs, D, z, scale, eps)``: the tail of
  ``models.ssm.apply_mamba2`` from K3's output to ``out_proj``'s input, y
  and xs ``(..., H, P)``, D ``(H,)`` f32, z ``(..., H P)``::

      u = T(y + xs D),  v = T(u * T(silu(z))),  out = rms_norm(v, scale)

  with ``groups`` > 1 the norm is taken per group of ``H P / groups``
  columns (Zamba2's ``Zamba2RMSNormGated``, a group per SSM group): one
  rstd a row and group, ``rstd (..., groups)``; ``groups`` = 1 is the
  norm over the whole row, ``rstd (...)``, the same kernel and bits as
  before groups existed.

Each is a ``torch.autograd.Function`` that saves only what it was given
(the plain one x and the scale; the gated one y, xs, D, z and the scale)
and one f32 rstd a row (and group), where the composed ops keep f32 copies of every
row (the f32 input and ``x * rstd``, and ``silu``'s input).  The backward
is a kernel too: it recomputes the row from the saved inputs and returns
every gradient in f32 arithmetic, rounded once; its column sums (the
scale's, D's) are deterministic (per-block partials in an f32 scratch the
wrapper allocates, then a pass in a fixed order).  Both directions run
behind custom ops (``repro_torch::rms_norm_fwd`` / ``_bwd``) whose fake
implementations serve a dry run's tensors.  ``launch.step_cost.count_step``
counts each op as the one op it is: no FLOPs, the bytes of its tensor
arguments and results.

Who takes it is one rule, ``takes(x)`` (``common.takes``): a tensor on a
CUDA device that is not a DTensor.  ``models.layers.apply_norm`` and
``models.ssm.gated_norm`` run the composed ops for every other tensor, and
those ops are the plain versions below (``rms_norm_reference``, ``gate``),
so the CPU computes exactly what it computed before (every CPU test
against the JAX package sees the same arithmetic), and so does a mesh
(DTensor has no sharding rule for these ops; its norms sit up to one bf16
step from K4's).  On the card a tensor K4 does not take (another type, a
layout whose rows share no stride, a row wider than its shared memory)
raises; nothing falls back.
The functions and their custom ops run on CPU tensors too, through the
plain versions (``rms_norm_reference``, ``gated_rms_norm_reference`` and
their backward formulas), for the tests.

Replaces no TPU kernel: the JAX reference leaves its norms to XLA.  K4 was
added to keep the norms' f32 copies out of device memory (about 178 MB a
mamba2-2.7b layer saved for the backward).  Bound on an H100: bytes
(``bound_ms``, ``common.bound_ms``): its inputs read once and its outputs
written once at 3.35 TB/s.  ``launches`` counts calls that launched K4 (a
forward or a backward), ``launches_by_variant`` each variant's and
``launches_by_direction`` each direction's; none on the CPU path.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, common
from repro_torch.kernels.common import (DTYPE_CODES, F32, I, LL, P, Kernel,
                                        Layouts, on, ptr, unwatched)

Tensor = torch.Tensor

SOURCE = _build.CSRC / "rms_norm.cu"
VARIANTS = ("plain", "gated")
DIRECTIONS = ("forward", "backward")

#: the kernel's shared memory: a row (and the gated backward's second row
#: of column sums) in f32 plus one float a warp, within the 227 KB a block
#: can use (``kMaxSmem``, ``kWarps`` in the source)
MAX_SMEM_BYTES = 232448
WARPS = 8
#: an access of 16 bytes a thread
VECTOR_BYTES = 16

#: who the models route to K4, and the bound of a call
takes, bound_ms = common.takes, common.bound_ms


def max_width(backward: bool, gated: bool) -> int:
    """The widest row a direction takes (its shared memory)."""
    rows = 2 if backward and gated else 1
    return (MAX_SMEM_BYTES // 4 - WARPS) // rows


def _ct(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# -- the plain versions --------------------------------------------------------

def rms_norm_reference(x: Tensor, scale: Tensor, eps: float
                       ) -> Tuple[Tensor, Tensor]:
    """The plain forward as composed ops, in f32 (f64 for f64): what
    ``models.layers.apply_norm`` runs (on x in f32) for every tensor K4
    does not take, and K4's plain version.  Returns (out in x's type, rstd
    ``x.shape[:-1]`` in the compute type)."""
    ct = _ct(x.dtype)
    xf = x.to(ct)
    var = xf.square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    out = xf * r * scale.to(ct)
    return out.to(x.dtype), r[..., 0]


def gate(y: Tensor, xs: Tensor, D: Tensor, z: Tensor
         ) -> Tuple[Tensor, Tensor]:
    """The gated variant's prologue as composed ops: (u, silu(z)), ``u =
    T(y + f32(xs) D)`` in y's shape and T z's type (the activations').
    ``models.ssm.gated_norm`` runs it for every tensor K4 does not take."""
    return (y + xs.float() * D[:, None]).to(z.dtype), F.silu(z)


def _grouped(t: Tensor, groups: int, reshape=torch.reshape) -> Tensor:
    """``t (..., n)`` as ``(..., groups, n / groups)``."""
    return reshape(t, (*t.shape[:-1], groups, t.shape[-1] // groups))


def gated_rms_norm_reference(y: Tensor, xs: Tensor, D: Tensor, z: Tensor,
                             scale: Tensor, eps: float, groups: int = 1,
                             reshape=torch.reshape) -> Tuple[Tensor, Tensor]:
    """Plain version of the gated forward: ``gate``, then the RMS norm of
    ``u * silu(z)``, per group of columns with ``groups`` > 1; what
    ``models.ssm.gated_norm`` runs for every tensor K4 does not take (with
    ``reshape`` the one a mesh's DTensors need).  Returns (out in y's type,
    z's shape; rstd ``z.shape[:-1]``, or with groups ``z.shape[:-1] +
    (groups,)``)."""
    u, s = gate(y, xs, D, z)
    v = reshape(u, tuple(z.shape)) * s
    if groups == 1:
        return rms_norm_reference(v, scale, eps)
    out, r = rms_norm_reference(_grouped(v, groups, reshape),
                                _grouped(scale, groups, reshape), eps)
    return reshape(out, tuple(z.shape)), r


def _norm_backward(g: Tensor, v: Tensor, scale: Tensor, rstd: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """(dv, dscale) of ``out = v rstd scale`` in v's (compute) type; the
    norm is over v's last dim, which the scale's last dim matches (a
    grouped norm passes ``(..., groups, n / groups)`` and its scale as
    ``(groups, n / groups)``)."""
    r = rstd.to(v.dtype)[..., None]
    vh = v * r
    gw = g * scale.to(v.dtype)
    c = (gw * vh).mean(dim=-1, keepdim=True)
    dv = r * (gw - vh * c)
    return dv, (g * vh).reshape(-1, *scale.shape).sum(0)


def rms_norm_backward_reference(g: Tensor, x: Tensor, scale: Tensor,
                                rstd: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of the plain backward (the formula in
    ``csrc/rms_norm.cu``), in f32 (f64 for f64): (dx in x's type, dscale
    in the scale's)."""
    ct = _ct(x.dtype)
    dx, dw = _norm_backward(g.to(ct), x.to(ct), scale, rstd)
    return dx.to(x.dtype), dw.to(scale.dtype)


def gated_rms_norm_backward_reference(g: Tensor, y: Tensor, xs: Tensor,
                                      D: Tensor, z: Tensor, scale: Tensor,
                                      rstd: Tensor, groups: int = 1
                                      ) -> List[Tensor]:
    """Plain version of the gated backward: [dy, dxs, dD, dz, dscale], dy
    and dxs in y's shape and type, dz in z's, dD in D's type and dscale
    in the scale's; f32 arithmetic (f64 for f64) on the forward's rounded
    u, silu(z) and v, with xs taken in f32 as ``gate`` takes it."""
    ct = _ct(y.dtype)
    u, s = gate(y, xs, D, z)
    u = u.reshape(z.shape)
    v = (u * s).to(ct)
    u, s, zf = u.to(ct), s.to(ct), z.to(ct)
    if groups == 1:
        dv, dw = _norm_backward(g.to(ct), v, scale, rstd)
    else:
        dv, dw = _norm_backward(_grouped(g.to(ct), groups),
                                _grouped(v, groups), _grouped(scale, groups),
                                rstd)
        dv, dw = dv.reshape(z.shape), dw.reshape(scale.shape)
    du = dv * s
    sig = torch.sigmoid(zf)
    dz = dv * u * sig * (1 + zf * (1 - sig))
    du = du.reshape(y.shape)
    Dc = D.to(ct)[:, None]
    dD = (du * xs.float()).reshape(-1, *D.shape, y.shape[-1]).sum((0, 2))
    return [du.to(y.dtype), (du * Dc).float().to(y.dtype), dD.to(D.dtype),
            dz.to(z.dtype), dw.to(scale.dtype)]


# -- shapes and what a launch checks ------------------------------------------

def row_stride(t: Tensor, row_dims: int = 1) -> int:
    """The stride between consecutive rows of ``t``, whose last
    ``row_dims`` dims form a row: the row contiguous and the leading dims
    one run of rows.  Raises ``ValueError`` for a layout whose rows share
    no stride."""
    shape, strides = t.shape, t.stride()
    row = [(s, st) for s, st in zip(shape[-row_dims:], strides[-row_dims:])
           if s > 1]
    want = 1
    for s, st in reversed(row):
        if st != want:
            raise ValueError(f"K4 takes rows that are contiguous, got shape "
                             f"{tuple(shape)} strides {strides}")
        want *= s
    lead = [(s, st) for s, st in zip(shape[:-row_dims], strides[:-row_dims])
            if s > 1]
    if not lead:
        return math.prod(shape[-row_dims:])
    for (_, st), (s_in, st_in) in zip(lead[:-1], lead[1:]):
        if st != st_in * s_in:
            raise ValueError(f"K4 takes leading dims that form one run of "
                             f"rows, got shape {tuple(shape)} strides "
                             f"{strides}")
    return lead[-1][1]


def norm_shapes(x: Tensor, scale: Tensor, xs: Optional[Tensor],
                D: Optional[Tensor], z: Optional[Tensor], groups: int = 1
                ) -> Tuple[Tuple[int, ...], int, int]:
    """(the output's shape, n, H) of a call (H 0 for the plain variant);
    raises ``ValueError`` unless the operands form one (``groups`` > 1
    only in the gated variant, dividing n)."""
    if (xs is None) != (D is None) or (xs is None) != (z is None):
        raise ValueError("K4's gated variant takes xs, D and z together")
    if groups < 1 or (groups > 1 and xs is None):
        raise ValueError(f"K4 takes groups >= 1, and > 1 only in the gated "
                         f"variant; got {groups}")
    if xs is None:
        n = x.shape[-1]
        if x.dim() < 1 or scale.shape != (n,):
            raise ValueError(f"K4 takes x (..., n) and a scale (n,), got "
                             f"{tuple(x.shape)}, {tuple(scale.shape)}")
        return tuple(x.shape), n, 0
    if x.dim() < 2 or D.dim() != 1:
        raise ValueError("K4's gated variant takes y, xs (..., H, P), D "
                         "(H,) and z (..., H P)")
    H, P = x.shape[-2], x.shape[-1]
    n = H * P
    if xs.shape != x.shape or D.shape != (H,) \
            or tuple(z.shape) != tuple(x.shape[:-2]) + (n,) \
            or scale.shape != (n,):
        raise ValueError(f"shapes y {tuple(x.shape)}, xs {tuple(xs.shape)}, "
                         f"D {tuple(D.shape)}, z {tuple(z.shape)}, scale "
                         f"{tuple(scale.shape)} do not form a gated norm")
    if n % groups:
        raise ValueError(f"K4 takes groups that divide the row: {groups} "
                         f"groups of {n} columns")
    return tuple(z.shape), n, H


def rstd_shape(shape: Tuple[int, ...], groups: int) -> Tuple[int, ...]:
    """The rstd of a call whose output has ``shape``: one a row, or one a
    row and group."""
    return tuple(shape[:-1]) + ((groups,) if groups > 1 else ())


def card_checks(x, scale, xs, D, z, backward: bool, groups: int = 1
                ) -> Tuple[Tuple[int, ...], int, int, Tuple[int, int, int]]:
    """What a launch on the card checks before it reads any data: one CUDA
    device, the types K4 takes, rows with one stride each, a contiguous
    scale and D, and a width its shared memory holds.  Returns (the
    output's shape, n, H, the row strides); raises ``ValueError`` or
    ``TypeError``."""
    shape, n, H = norm_shapes(x, scale, xs, D, z, groups)
    acts = [t for t in (x, xs, z) if t is not None]
    others = [t for t in (scale, D) if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in acts + others):
        raise ValueError(f"K4 runs on one CUDA device, got x on "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES or any(t.dtype != x.dtype for t in acts):
        raise TypeError(f"K4 takes float32 or bfloat16 activations of one "
                        f"type, got {[t.dtype for t in acts]}")
    if scale.dtype not in DTYPE_CODES:
        raise TypeError(f"K4 takes a float32 or bfloat16 scale, got "
                        f"{scale.dtype}")
    if D is not None and D.dtype != torch.float32:
        raise TypeError(f"K4 takes a float32 D, got {D.dtype}")
    if math.prod(shape[:-1]) == 0:
        raise ValueError("K4 takes at least one row")
    wide = max_width(backward, xs is not None)
    if n > wide:
        raise ValueError(f"K4 takes rows up to {wide} wide, got {n}")
    if any(t.dim() == 1 and t.numel() > 1 and t.stride(0) != 1
           for t in others):
        raise ValueError("K4 takes a contiguous scale and D")
    return shape, n, H, row_strides(x, xs, z)


def row_strides(x: Tensor, xs: Optional[Tensor], z: Optional[Tensor]
                ) -> Tuple[int, int, int]:
    """The row strides of x (y), xs and z (0 for the plain variant's
    absent ones): y and xs hold a row in their last two dims."""
    if xs is None:
        return row_stride(x), 0, 0
    return row_stride(x, 2), row_stride(xs, 2), row_stride(z)


def _vec(tensors: Sequence[Tensor], strides: Sequence[int],
         dtype: torch.dtype, *widths: int) -> int:
    """The kernel's vector: 16 bytes of the activation type when every
    row start is 16-byte aligned and the vector divides each of ``widths``
    (the gated variant's head and norm group, n for the plain one), else
    one element."""
    v = VECTOR_BYTES * 8 // torch.finfo(dtype).bits
    aligned = all(w % v == 0 for w in widths) \
        and all(s % v == 0 for s in strides) and all(
            t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)
    return v if aligned else 1


class RMSNorm(Kernel):
    """The K4 wrapper.  Calling it runs the plain variant's autograd
    function, ``gated`` the gated one's; ``forward`` and ``backward`` are
    the two directions alone (the custom ops).  ``launches``,
    ``launches_by_variant`` and ``launches_by_direction`` are plain
    integers, never incremented on the CPU path."""

    NAME, SOURCE = "K4", SOURCE
    SIGNATURES = {
        "k4_rms_fwd": ([P] * 7 + [LL, I, I, I, LL, LL, LL, F32] + [I] * 4
                       + [P], I),
        "k4_rms_bwd": ([P] * 13 + [LL, I, I, I, LL, LL, LL] + [I] * 4 + [P],
                       I),
        "k4_scratch_floats": ([LL, I, I], LL)}
    COUNTS = {"variant": VARIANTS, "direction": DIRECTIONS}

    def __init__(self):
        super().__init__()
        self._layouts = Layouts()

    def __call__(self, x: Tensor, scale: Tensor, eps: float) -> Tensor:
        return _RMSNorm.apply(x, scale, eps)

    def gated(self, y: Tensor, xs: Tensor, D: Tensor, z: Tensor,
              scale: Tensor, eps: float, groups: int = 1) -> Tensor:
        return _GatedRMSNorm.apply(y, xs, D, z, scale, eps, groups)

    def forward(self, x, scale, eps: float, xs=None, D=None, z=None,
                groups: int = 1) -> Tuple[Tensor, Tensor]:
        """(out, rstd): the kernel on CUDA tensors, the plain version on CPU
        ones, through the custom op ``repro_torch::rms_norm_fwd`` wherever
        the dispatcher has a reader (``common.unwatched``)."""
        if unwatched((x, scale, xs, D, z)):
            return self._forward(x, scale, eps, xs, D, z, groups)
        return torch.ops.repro_torch.rms_norm_fwd(x, scale, eps, xs, D, z,
                                                  groups)

    def backward(self, g, x, scale, rstd, xs=None, D=None, z=None,
                 groups: int = 1) -> List[Tensor]:
        """[dx, dscale], or gated [dy, dxs, dD, dz, dscale]
        (``repro_torch::rms_norm_bwd``, likewise)."""
        if unwatched((g, x, scale, rstd, xs, D, z)):
            return self._backward(g, x, scale, rstd, xs, D, z, groups)
        return torch.ops.repro_torch.rms_norm_bwd(g, x, scale, rstd, xs, D,
                                                  z, groups)

    def checked(self, x, scale, xs, D, z, backward: bool, groups: int = 1):
        """``card_checks`` of the operands, made once a layout (their
        shapes, strides, types and devices, the direction and the
        groups)."""
        return self._layouts(card_checks, (x, scale, xs, D, z), backward,
                             groups)

    def _forward(self, x, scale, eps, xs, D, z, groups: int = 1
                 ) -> Tuple[Tensor, Tensor]:
        """The forward op on tensors with storage."""
        if x.device.type == "cpu":
            norm_shapes(x, scale, xs, D, z, groups)
            if xs is None:
                return rms_norm_reference(x, scale, eps)
            return gated_rms_norm_reference(x, xs, D, z, scale, eps, groups)
        shape, n, H, (sx, sxs, sz) = self.checked(x, scale, xs, D, z,
                                                  backward=False,
                                                  groups=groups)
        gated = xs is not None
        acts = (x, xs, z) if gated else (x,)
        vec = _vec(acts + (scale,), (sx, sxs, sz), x.dtype,
                   *((n // H, n // groups) if H else (n,)))
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        rstd = torch.empty(rstd_shape(shape, groups), dtype=torch.float32,
                           device=x.device)
        lib = self.library()
        with on(x.device):
            code = lib.k4_rms_fwd(
                x.data_ptr(), ptr(xs), ptr(D), ptr(z), scale.data_ptr(),
                out.data_ptr(), rstd.data_ptr(), out.numel() // n, n, H,
                groups, sx, sxs, sz, eps, DTYPE_CODES[x.dtype],
                DTYPE_CODES[scale.dtype], vec, int(gated),
                torch.cuda.current_stream().cuda_stream)
        self.launched(code, lambda: f"({VARIANTS[gated]} forward) launch on "
                      f"{tuple(x.shape)} {x.dtype}", VARIANTS[gated],
                      "forward")
        return out, rstd

    def _backward(self, g, x, scale, rstd, xs, D, z, groups: int = 1
                  ) -> List[Tensor]:
        """The backward op on tensors with storage."""
        if x.device.type == "cpu":
            if xs is None:
                return list(rms_norm_backward_reference(g, x, scale, rstd))
            return gated_rms_norm_backward_reference(g, x, xs, D, z, scale,
                                                     rstd, groups)
        shape, n, H, (sx, sxs, sz) = self.checked(x, scale, xs, D, z,
                                                  backward=True,
                                                  groups=groups)
        backward_checks(g, rstd, shape, x.device, groups)
        g = g.contiguous()
        gated = xs is not None
        acts = (x, xs, z) if gated else (x,)
        vec = _vec(acts + (scale, g), (sx, sxs, sz), x.dtype,
                   *((n // H, n // groups) if H else (n,)))
        rows = g.numel() // n
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dscale = torch.empty_like(scale, memory_format=torch.contiguous_format)
        lib = self.library()
        part = torch.empty(lib.k4_scratch_floats(rows, n, int(gated)),
                           dtype=torch.float32, device=x.device)
        if gated:
            dxs = torch.empty(xs.shape, dtype=x.dtype, device=x.device)
            dD = torch.empty(D.shape, dtype=torch.float32, device=x.device)
            dz = torch.empty(z.shape, dtype=x.dtype, device=x.device)
        with on(x.device):
            code = lib.k4_rms_bwd(
                g.data_ptr(), x.data_ptr(), ptr(xs), ptr(D), ptr(z),
                scale.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                dxs.data_ptr() if gated else None,
                dz.data_ptr() if gated else None, dscale.data_ptr(),
                dD.data_ptr() if gated else None, part.data_ptr(), rows, n,
                H, groups, sx, sxs, sz, DTYPE_CODES[x.dtype],
                DTYPE_CODES[scale.dtype], vec, int(gated),
                torch.cuda.current_stream().cuda_stream)
        self.launched(code, lambda: f"({VARIANTS[gated]} backward) launch "
                      f"on {tuple(x.shape)} {x.dtype}", VARIANTS[gated],
                      "backward")
        return [dx, dxs, dD, dz, dscale] if gated else [dx, dscale]


def backward_checks(g: Tensor, rstd: Tensor, shape, device,
                    groups: int = 1) -> None:
    """The backward's own operands: the output's gradient and the
    forward's rstd, on the device, of the shapes the forward gave."""
    want = rstd_shape(shape, groups)
    if tuple(g.shape) != tuple(shape) or tuple(rstd.shape) != want:
        raise ValueError(f"K4's backward takes g {tuple(shape)} and rstd "
                         f"{want}, got {tuple(g.shape)}, "
                         f"{tuple(rstd.shape)}")
    if g.device != device or rstd.device != device:
        raise ValueError("K4's backward runs on the forward's device")
    if rstd.dtype != torch.float32 and device.type != "cpu":
        raise TypeError(f"K4 takes a float32 rstd, got {rstd.dtype}")


@torch.library.custom_op("repro_torch::rms_norm_fwd", mutates_args=())
def _rms_norm_fwd(x: Tensor, scale: Tensor, eps: float,
                  xs: Optional[Tensor], D: Optional[Tensor],
                  z: Optional[Tensor], groups: int = 1
                  ) -> Tuple[Tensor, Tensor]:
    return rms_norm._forward(x, scale, eps, xs, D, z, groups)


@_rms_norm_fwd.register_fake
def _rms_norm_fwd_fake(x, scale, eps, xs, D, z, groups=1):
    """The forward on tensors with no storage (a dry run's): out and rstd
    of the real call's shapes, types and device, after the checks a call on
    the same device makes before it reads data."""
    shape = norm_shapes(x, scale, xs, D, z, groups)[0]
    if x.device.type != "cpu":
        card_checks(x, scale, xs, D, z, backward=False, groups=groups)
    rt = torch.float32 if x.device.type != "cpu" else _ct(x.dtype)
    return (x.new_empty(shape),
            x.new_empty(rstd_shape(shape, groups), dtype=rt))


@torch.library.custom_op("repro_torch::rms_norm_bwd", mutates_args=())
def _rms_norm_bwd(g: Tensor, x: Tensor, scale: Tensor, rstd: Tensor,
                  xs: Optional[Tensor], D: Optional[Tensor],
                  z: Optional[Tensor], groups: int = 1) -> List[Tensor]:
    return rms_norm._backward(g, x, scale, rstd, xs, D, z, groups)


@_rms_norm_bwd.register_fake
def _rms_norm_bwd_fake(g, x, scale, rstd, xs, D, z, groups=1):
    """The backward on tensors with no storage: the gradients' shapes,
    types and device, after the checks a call on the same device makes."""
    shape = norm_shapes(x, scale, xs, D, z, groups)[0]
    if x.device.type != "cpu":
        card_checks(x, scale, xs, D, z, backward=True, groups=groups)
        backward_checks(g, rstd, shape, x.device, groups)
    grads = [x.new_empty(x.shape)]
    if xs is not None:
        grads += [x.new_empty(xs.shape), D.new_empty(D.shape),
                  x.new_empty(z.shape)]
    return grads + [scale.new_empty(scale.shape)]


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        out, rstd = rms_norm.forward(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rms_norm.backward(g, x, scale, rstd)
        return dx, dscale, None


class _GatedRMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, xs, D, z, scale, eps: float, groups: int = 1):
        out, rstd = rms_norm.forward(y, scale, eps, xs, D, z, groups)
        ctx.save_for_backward(y, xs, D, z, scale, rstd)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, g):
        y, xs, D, z, scale, rstd = ctx.saved_tensors
        grads = rms_norm.backward(g, y, scale, rstd, xs, D, z, ctx.groups)
        return (*grads, None, None)


rms_norm = RMSNorm()
