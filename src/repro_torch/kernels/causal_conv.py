"""K5: mamba2's depthwise causal conv and its SiLU on the card.

One kernel (``csrc/causal_conv.cu``), ``causal_conv_silu(x, w, b)``:
``silu(T(conv(x, w) + b))`` over x ``(B, S, C)``, the taps w ``(C, W)``
(W <= 4) and the bias b ``(C,)``, where ``conv`` is the depthwise causal
conv as ``models.ssm.apply_mamba2`` runs it for each of xs, B and C and T
is x's type.  Its plain version is the composed ops,
``F.silu(causal_conv_reference(x, w, b))``: W shifted f32 multiply-adds on
a padded f32 copy of x (``models.ssm._causal_conv`` is that function).

It is a ``torch.autograd.Function`` that saves only x, the taps and the
bias, where the composed ops keep the padded f32 copy of x (44 MB a
mamba2-2.7b layer) and SiLU's input.  The forward makes the composed ops'
roundings in their order, so it gives their bits; in bf16 it reads SiLU
from a table of its output for every bf16 value (``silu_table``, 128 KB a
device, made on the card by the same arithmetic).  The backward is a
kernel too: it recomputes the pre-activation from x, rounds ``dpre = g
silu'(pre)`` to x's type as autograd does, and returns dx summed in f32
and rounded once and the taps' and bias's gradients from per-block
partials summed in a fixed order (no atomics: the same bits run after
run).  Both directions run behind custom ops
(``repro_torch::causal_conv_silu_fwd`` / ``_bwd``) whose fake
implementations serve a dry run's tensors, and which
``launch.step_cost.count_step`` counts as the single ops they are (no
FLOPs, the bytes of their tensor arguments and results).

Who takes it is one rule, ``takes(x)`` (``common.takes``, K4's rule): a
tensor on a CUDA device that is not a DTensor (inside
``models.ssm._conv_region`` a mesh's local shards are plain tensors, so
they take it too).  Every other tensor runs the composed ops, so the CPU
computes what it computed before K5 and every CPU test against the JAX
package sees the same arithmetic.  A CUDA tensor the
kernel cannot take (another type, W > 4, channels not contiguous) raises;
nothing falls back.  The functions and their custom ops run on CPU tensors
too, through the plain versions (``causal_conv_silu_reference`` and
``causal_conv_silu_backward_reference``), for the tests.

Replaces no TPU kernel: the JAX reference leaves the conv to XLA.  K5 was
added to keep the conv's f32 copies out of device memory.  Bound on an
H100: bytes (``bound_ms``, ``common.bound_ms``), its inputs read once and
its outputs written once at 3.35 TB/s.  ``launches`` counts calls that
launched K5 (a forward or a backward), ``launches_by_direction`` each
direction's; none on the CPU path.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, common
from repro_torch.kernels.common import (DTYPE_CODES, I, LL, P, Kernel,
                                        Layouts, on, unwatched)

Tensor = torch.Tensor

SOURCE = _build.CSRC / "causal_conv.cu"
DIRECTIONS = ("forward", "backward")
#: the widest conv the kernel takes (``kMaxW``)
MAX_WIDTH = 4
#: the vector a thread loads, in bytes, by direction (``kFwdBytes``,
#: ``kBwdBytes``)
VECTOR_BYTES = {"forward": 8, "backward": 4}

#: who the models route to K5, and the bound of a call
takes, bound_ms = common.takes, common.bound_ms


def _ct(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# -- the plain versions --------------------------------------------------------

def causal_conv_reference(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv as composed ops.  x: (B, S, C); w: (C, W); b:
    (C,).  W shifted f32 multiply-adds (f64 for f64) on x padded with W - 1
    zero rows in front, then the bias, in x's type: no convolution library
    call, so nothing runs in TF32."""
    ct = _ct(x.dtype)
    W, S = w.shape[-1], x.shape[1]
    xp = F.pad(x.to(ct), (0, 0, W - 1, 0))
    wf = w.to(ct)
    out = xp[:, :S] * wf[:, 0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * wf[:, k]
    return (out + b.to(ct)).to(x.dtype)


def causal_conv_silu_reference(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """K5's plain forward: the composed ops the models run for every tensor
    K5 does not take."""
    return F.silu(causal_conv_reference(x, w, b))


def causal_conv_silu_backward_reference(g: Tensor, x: Tensor, w: Tensor,
                                        b: Tensor) -> List[Tensor]:
    """The plain backward (the formula in ``csrc/causal_conv.cu``): [dx in
    x's type, dw in w's, db in b's].  f32 arithmetic (f64 for f64) on the
    recomputed pre-activation in x's type; ``dpre = g sig (1 + pre (1 -
    sig))`` rounded to x's type, as autograd's SiLU backward rounds it."""
    ct = _ct(x.dtype)
    W, S = w.shape[-1], x.shape[1]
    pre = causal_conv_reference(x, w, b).to(ct)
    sig = 1 / (1 + torch.exp(-pre))
    dpre = (g.to(ct) * sig * (1 + pre * (1 - sig))).to(x.dtype).to(ct)
    wf = w.to(ct)
    # dx[s] = sum_k dpre[s + W - 1 - k] w[k], dpre 0 past the last row
    dp = F.pad(dpre, (0, 0, 0, W - 1))
    dx = dp[:, W - 1:W - 1 + S] * wf[:, 0]
    for k in range(1, W):
        dx = dx + dp[:, W - 1 - k:W - 1 - k + S] * wf[:, k]
    xp = F.pad(x.to(ct), (0, 0, W - 1, 0))
    dw = torch.stack([(dpre * xp[:, k:k + S]).sum((0, 1)) for k in range(W)],
                     dim=-1)
    return [dx.to(x.dtype), dw.to(w.dtype), dpre.sum((0, 1)).to(b.dtype)]


# -- shapes and what a launch checks ------------------------------------------

def conv_shapes(x: Tensor, w: Tensor, b: Tensor) -> Tuple[int, int, int, int]:
    """(B, S, C, W) of a call; raises ``ValueError`` unless x is (B, S, C),
    w (C, W) and b (C,)."""
    if x.dim() != 3 or w.dim() != 2 or b.dim() != 1 \
            or w.shape[0] != x.shape[2] or tuple(b.shape) != (x.shape[2],):
        raise ValueError(f"K5 takes x (B, S, C), w (C, W) and b (C,), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    return (*x.shape, w.shape[1])


def card_checks(x: Tensor, w: Tensor, b: Tensor) -> Tuple[int, int]:
    """What a launch on the card checks before it reads any data: one CUDA
    device, one type K5 takes, a conv no wider than ``MAX_WIDTH``,
    contiguous channels, taps and bias, and sizes the grid holds.  Returns
    x's (batch, row) strides in elements; raises ``ValueError`` or
    ``TypeError``."""
    B, S, C, W = conv_shapes(x, w, b)
    if x.device.type != "cuda" or w.device != x.device \
            or b.device != x.device:
        raise ValueError(f"K5 runs on one CUDA device, got x on {x.device}, "
                         f"w on {w.device}, b on {b.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise TypeError(f"K5 takes float32 or bfloat16 activations, taps and "
                        f"bias of one type, got {x.dtype}, {w.dtype}, "
                        f"{b.dtype}")
    if not 1 <= W <= MAX_WIDTH:
        raise ValueError(f"K5 takes convs of width 1 to {MAX_WIDTH}, got {W}")
    if min(B, S, C) < 1 or B > 65535:
        raise ValueError(f"K5 takes 1 to 65535 batches of at least one row "
                         f"and channel, got {tuple(x.shape)}")
    if C > 1 and x.stride(2) != 1:
        raise ValueError(f"K5 takes contiguous channels, got strides "
                         f"{x.stride()}")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("K5 takes contiguous taps and bias")
    # a dim of one holds no step: its stride is never read
    return x.stride(0) if B > 1 else 0, x.stride(1) if S > 1 else 0


def vector(direction: str, dtype: torch.dtype, C: int,
           tensors: Sequence[Tensor], strides: Sequence[int]) -> int:
    """The kernel's vector in elements: the direction's ``VECTOR_BYTES`` of
    the activation type when it divides C and every row stride and each
    tensor starts aligned to it, else one element."""
    nbytes = VECTOR_BYTES[direction]
    v = max(1, nbytes * 8 // torch.finfo(dtype).bits)
    aligned = C % v == 0 and all(s % v == 0 for s in strides) and all(
        t.data_ptr() % nbytes == 0 for t in tensors)
    return v if aligned else 1


class CausalConvSilu(Kernel):
    """The K5 wrapper.  Calling it runs the autograd function; ``forward``
    and ``backward`` are the two directions alone (the custom ops).
    ``launches`` and ``launches_by_direction`` are plain integers, never
    incremented on the CPU path."""

    NAME, SOURCE = "K5", SOURCE
    SIGNATURES = {
        "k5_conv_fwd": ([P] * 5 + [I] * 4 + [LL, LL] + [I] * 2 + [P], I),
        "k5_conv_bwd": ([P] * 8 + [I] * 4 + [LL, LL] + [I] * 2 + [P], I),
        "k5_silu_table": ([P] * 2, I),
        "k5_scratch_floats": ([I] * 6, LL)}
    COUNTS = {"direction": DIRECTIONS}

    def __init__(self):
        super().__init__()
        self._layouts = Layouts()
        #: SiLU's table by device (``silu_table``)
        self._tables: dict = {}

    def __call__(self, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        return _CausalConvSilu.apply(x, w, b)

    def forward(self, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        """The output: the kernel on CUDA tensors, the plain version on CPU
        ones, through the custom op ``repro_torch::causal_conv_silu_fwd``
        wherever the dispatcher has a reader (``common.unwatched``)."""
        if unwatched((x, w, b)):
            return self._forward(x, w, b)
        return torch.ops.repro_torch.causal_conv_silu_fwd(x, w, b)

    def backward(self, g: Tensor, x: Tensor, w: Tensor, b: Tensor
                 ) -> List[Tensor]:
        """[dx, dw, db] (``repro_torch::causal_conv_silu_bwd``, likewise)."""
        if unwatched((g, x, w, b)):
            return self._backward(g, x, w, b)
        return torch.ops.repro_torch.causal_conv_silu_bwd(g, x, w, b)

    def checked(self, x: Tensor, w: Tensor, b: Tensor) -> Tuple[int, int]:
        """``card_checks`` of the operands, made once a layout (their
        shapes, strides, types and devices)."""
        return self._layouts(card_checks, (x, w, b))

    def silu_table(self, x: Tensor) -> Optional[int]:
        """The address of SiLU's table for a forward on x: for bf16 x, SiLU's
        bf16 output for every bf16 value (``silu_table`` in the source; 128
        KB a device, made at the first bf16 call there and kept); none for
        f32 x."""
        if x.dtype != torch.bfloat16:
            return None
        table = self._tables.get(x.device)
        if table is None:
            table = torch.empty(1 << 16, dtype=torch.bfloat16,
                                device=x.device)
            with on(x.device):
                stream = torch.cuda.current_stream()
                self.check(self.library().k5_silu_table(
                    table.data_ptr(), stream.cuda_stream),
                    lambda: f"SiLU table on {x.device}")
                # made once: a call on any later stream reads it finished
                stream.synchronize()
            self._tables[x.device] = table
        return table.data_ptr()

    def _forward(self, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        """The forward op on tensors with storage."""
        if x.device.type == "cpu":
            conv_shapes(x, w, b)
            return causal_conv_silu_reference(x, w, b)
        sb, ss = self.checked(x, w, b)
        B, S, C, W = conv_shapes(x, w, b)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        vec = vector("forward", x.dtype, C, (x, out), (sb, ss))
        lib = self.library()
        silu = self.silu_table(x)
        with on(x.device):
            code = lib.k5_conv_fwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                silu, B, S, C, W, sb, ss, DTYPE_CODES[x.dtype], vec,
                torch.cuda.current_stream().cuda_stream)
        self.launched(code, lambda: f"(forward) launch on {tuple(x.shape)} "
                      f"{x.dtype}", "forward")
        return out

    def _backward(self, g: Tensor, x: Tensor, w: Tensor, b: Tensor
                  ) -> List[Tensor]:
        """The backward op on tensors with storage."""
        if x.device.type == "cpu":
            conv_shapes(x, w, b)
            return causal_conv_silu_backward_reference(g, x, w, b)
        sb, ss = self.checked(x, w, b)
        backward_checks(g, x)
        B, S, C, W = conv_shapes(x, w, b)
        g = g.contiguous()
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dw = torch.empty(w.shape, dtype=w.dtype, device=x.device)
        db = torch.empty(b.shape, dtype=b.dtype, device=x.device)
        vec = vector("backward", x.dtype, C, (x, g, dx), (sb, ss))
        lib = self.library()
        t = DTYPE_CODES[x.dtype]
        with on(x.device):
            floats = lib.k5_scratch_floats(B, S, C, W, t, vec)
            if floats <= 0:
                raise RuntimeError(f"K5's backward on {tuple(x.shape)} "
                                   f"{x.dtype}: no scratch size")
            part = torch.empty(floats, dtype=torch.float32, device=x.device)
            code = lib.k5_conv_bwd(
                g.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
                B, S, C, W, sb, ss, t, vec,
                torch.cuda.current_stream().cuda_stream)
        self.launched(code, lambda: f"(backward) launch on "
                      f"{tuple(x.shape)} {x.dtype}", "backward")
        return [dx, dw, db]


def backward_checks(g: Tensor, x: Tensor) -> None:
    """The backward's own operand: the output's gradient, of x's shape,
    type and device."""
    if tuple(g.shape) != tuple(x.shape) or g.dtype != x.dtype \
            or g.device != x.device:
        raise ValueError(f"K5's backward takes g of x's shape, type and "
                         f"device {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")


@torch.library.custom_op("repro_torch::causal_conv_silu_fwd", mutates_args=())
def _causal_conv_silu_fwd(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    return causal_conv_silu._forward(x, w, b)


@_causal_conv_silu_fwd.register_fake
def _causal_conv_silu_fwd_fake(x, w, b):
    """The forward on tensors with no storage (a dry run's): the output of
    the real call's shape, type and device, after the checks a call on the
    same device makes before it reads data."""
    conv_shapes(x, w, b)
    if x.device.type != "cpu":
        card_checks(x, w, b)
    return x.new_empty(x.shape)


@torch.library.custom_op("repro_torch::causal_conv_silu_bwd", mutates_args=())
def _causal_conv_silu_bwd(g: Tensor, x: Tensor, w: Tensor, b: Tensor
                          ) -> List[Tensor]:
    return causal_conv_silu._backward(g, x, w, b)


@_causal_conv_silu_bwd.register_fake
def _causal_conv_silu_bwd_fake(g, x, w, b):
    """The backward on tensors with no storage: the gradients' shapes,
    types and device, after the checks a call on the same device makes."""
    conv_shapes(x, w, b)
    if x.device.type != "cpu":
        card_checks(x, w, b)
        backward_checks(g, x)
    return [x.new_empty(x.shape), w.new_empty(w.shape),
            b.new_empty(b.shape)]


class _CausalConvSilu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b):
        out = causal_conv_silu.forward(x, w, b)
        ctx.save_for_backward(x, w, b)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        return tuple(causal_conv_silu.backward(g, x, w, b))


causal_conv_silu = CausalConvSilu()

