"""K6: the training loss head's softcap, log-sum-exp and cross-entropy on
the card.

One kernel (``csrc/cross_entropy.cu``), ``cross_entropy(h, labels,
vocab_size, softcap)``: the NLL of each row of the head's product ``h = x
E^T`` (``(..., V)``, in its type), its label's in ``labels`` (``(...)``,
label < 0 padding), over the first ``vocab_size`` columns of the logits
``softcap(f32(h))``.  Its plain version is the composed ops the models run
for the training loss (``models.layers.lm_logits`` then
``cross_entropy_sums``): ``logits_reference`` (the cast and the tanh
softcap) and ``rows_reference`` (the mask, ``logsumexp``, the label's
logit), which those functions call.  The mask of padded rows, the sum and
the division by the count stay with the callers
(``models.layers.masked_sums``, ``mean_nll``).

It is a ``torch.autograd.Function`` that saves h, one f32 lse a row and
the labels, where autograd of the composed ops keeps the masked f32
(rows x V) logits and its backward makes four more such f32 blocks (2.07
GB of mamba2-2.7b's training peak).  The backward is a kernel too: it
recomputes each logit from h and writes ``dnll (softmax - onehot)``, with
the softcap's ``1 - tanh^2`` and zeros in the padded columns, rounded once
to h's type, where autograd's cast back rounds it.  The matmul's backward
stays autograd's.  Both directions run behind custom ops
(``repro_torch::cross_entropy_fwd`` / ``_bwd``) whose fake implementations
serve a dry run's tensors, and which ``launch.step_cost.count_step``
counts as the single ops they are (no FLOPs, the bytes of their tensor
arguments and results).

Who takes it: ``models.transformer.Transformer._loss`` routes the loss to
K6 when the hidden state is a tensor ``takes`` (``common.takes``: on a
CUDA device, not a DTensor) and there is no mesh.  Every other tensor runs
the composed ops, so the CPU computes what it computed before K6 and every
CPU test against the JAX package sees the same arithmetic; a mesh keeps
its vocab-parallel composed loss (``transformer._vocab_parallel_sums``),
whose lse spans ranks.  A CUDA tensor the kernel cannot take (another
type, columns not contiguous) raises; nothing falls back.  The functions
and their custom ops run on CPU tensors too, through the plain versions
(``cross_entropy_reference`` and ``cross_entropy_backward_reference``,
which makes autograd's operations of the composed ops in their order, so
it gives their gradient bit for bit), for the tests.

Replaces no TPU kernel: the JAX reference leaves the loss to XLA.  K6 was
added to keep the loss's f32 (rows x V) blocks out of device memory.
Bound on an H100: bytes (``bound_ms``, ``common.bound_ms``), the forward
reading h once, the backward reading h and writing dh, at 3.35 TB/s.
``launches`` counts calls that launched K6 (a forward or a backward),
``launches_by_direction`` each direction's; none on the CPU path.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.common import DTYPE_CODES, F32, I, LL, P, Kernel, on

Tensor = torch.Tensor

SOURCE = _build.CSRC / "cross_entropy.cu"
DIRECTIONS = ("forward", "backward")
#: the vector a thread loads, in bytes (``kVecBytes``)
VECTOR_BYTES = 16
#: the fill of the padded vocabulary's columns, as the composed ops mask
#: them
MASKED = torch.finfo(torch.float32).min

#: who the models route to K6, and the bound of a call
takes, bound_ms = common.takes, common.bound_ms


# -- the plain versions --------------------------------------------------------

def logits_reference(h: Tensor, softcap: float) -> Tensor:
    """f32 logits from the head's product h: the cast, then the tanh
    softcap (the reference's order, its ``layers.py:133-137``)."""
    logits = h.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def _keep(logits: Tensor, vocab_size: int) -> Tensor:
    return torch.arange(logits.shape[-1], device=logits.device) < vocab_size


def rows_reference(logits: Tensor, labels: Tensor, vocab_size: int
                   ) -> Tuple[Tensor, Tensor]:
    """(lse, nll) of each row of f32 logits ``(..., V_padded)``: the
    columns from ``vocab_size`` on masked, ``logsumexp``, and the logit of
    the row's label (clamped to >= 0: a padding row's nll is masked by the
    caller)."""
    logits = torch.where(_keep(logits, vocab_size), logits, MASKED)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    return lse, lse - ll


def cross_entropy_reference(h: Tensor, labels: Tensor, vocab_size: int,
                            softcap: float) -> Tuple[Tensor, Tensor]:
    """K6's plain forward: (lse, nll) a row, by the composed ops."""
    return rows_reference(logits_reference(h, softcap), labels, vocab_size)


def cross_entropy_backward_reference(g: Tensor, h: Tensor, lse: Tensor,
                                     labels: Tensor, vocab_size: int,
                                     softcap: float) -> Tensor:
    """The plain backward (the formula in ``csrc/cross_entropy.cu``): dh in
    h's type from g, the nll's gradient, and the forward's lse.  It makes
    the operations autograd makes through the composed ops, in their order
    (logsumexp's ``g exp(l - lse)``, the gather's ``-g`` added, the mask,
    tanh's backward between the softcap's multiply and divide, the cast
    back), so on one device it gives their bits."""
    logits = h.float()
    t = None
    if softcap:
        t = torch.tanh(logits / softcap)
        logits = t * softcap
    keep = _keep(logits, vocab_size)
    logits = torch.where(keep, logits, MASKED)
    d = g[..., None] * (logits - lse[..., None]).exp()
    onehot = torch.zeros_like(d).scatter_(
        -1, labels.clamp(min=0).long()[..., None], -g[..., None])
    d = torch.where(keep, d + onehot, 0)
    if softcap:
        d = torch.ops.aten.tanh_backward(d * softcap, t) / softcap
    return d.to(h.dtype)


# -- shapes and what a launch checks ------------------------------------------

def rows_shape(h: Tensor, labels: Tensor, vocab_size: int) -> Tuple[int, int]:
    """(rows, V) of a call; raises ``ValueError`` unless h is (rows, V)
    with at least one row and column, labels (rows,) and vocab_size >= 1."""
    if h.dim() != 2 or tuple(labels.shape) != (h.shape[0],) \
            or min(h.shape) < 1 or vocab_size < 1:
        raise ValueError(f"K6 takes h (rows, V) with rows, V >= 1, labels "
                         f"(rows,) and a vocabulary of at least one token, "
                         f"got {tuple(h.shape)}, {tuple(labels.shape)}, "
                         f"{vocab_size}")
    return h.shape[0], h.shape[1]


def card_checks(h: Tensor, labels: Tensor, vocab_size: int
                ) -> Tuple[int, int]:
    """What a launch on the card checks before it reads any data: one CUDA
    device, a type K6 takes, integer labels, a contiguous h and sizes the
    grid holds.  Returns (rows, V); raises ``ValueError`` or
    ``TypeError``."""
    rows, V = rows_shape(h, labels, vocab_size)
    if h.device.type != "cuda" or labels.device != h.device:
        raise ValueError(f"K6 runs on one CUDA device, got h on {h.device}, "
                         f"labels on {labels.device}")
    if h.dtype not in DTYPE_CODES:
        raise TypeError(f"K6 takes a float32 or bfloat16 product, got "
                        f"{h.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"K6 takes int32 or int64 labels, got "
                        f"{labels.dtype}")
    if not h.is_contiguous():
        raise ValueError(f"K6 takes a contiguous product, got strides "
                         f"{h.stride()}")
    if rows >= 1 << 31 or V >= 1 << 31:
        raise ValueError(f"K6 takes fewer than 2^31 rows and columns, got "
                         f"{tuple(h.shape)}")
    return rows, V


def backward_checks(g: Tensor, lse: Tensor, h: Tensor) -> None:
    """The backward's own operands: the nll's gradient and the forward's
    lse, each (rows,) f32 on h's device."""
    for name, t in (("gradient", g), ("lse", lse)):
        if tuple(t.shape) != (h.shape[0],) or t.dtype != torch.float32 \
                or t.device != h.device:
            raise ValueError(f"K6's backward takes a float32 {name} of "
                             f"({h.shape[0]},) on {h.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


class CrossEntropy(Kernel):
    """The K6 wrapper.  Calling it runs the autograd function; ``forward``
    and ``backward`` are the two directions alone (the custom ops) on
    (rows, V) products.  ``launches`` and ``launches_by_direction`` are
    plain integers, never incremented on the CPU path."""

    NAME, SOURCE = "K6", SOURCE
    SIGNATURES = {
        "k6_ce_fwd": ([P] * 4 + [LL] + [I] * 3 + [F32, P], I),
        "k6_ce_bwd": ([P] * 5 + [LL] + [I] * 3 + [F32, I, P], I)}
    COUNTS = {"direction": DIRECTIONS}

    def __call__(self, h: Tensor, labels: Tensor, vocab_size: int,
                 softcap: float = 0.0) -> Tensor:
        """The nll of each row of h ``(..., V)``, of labels' shape
        ``(...)``, under autograd."""
        return _CrossEntropy.apply(h, labels, int(vocab_size),
                                   float(softcap))

    def forward(self, h: Tensor, labels: Tensor, vocab_size: int,
                softcap: float) -> Tuple[Tensor, Tensor]:
        """(lse, nll) a row: the kernel on CUDA tensors, the plain version
        on CPU ones, through the custom op
        ``repro_torch::cross_entropy_fwd``."""
        return tuple(torch.ops.repro_torch.cross_entropy_fwd(
            h, labels, vocab_size, softcap))

    def backward(self, g: Tensor, h: Tensor, lse: Tensor, labels: Tensor,
                 vocab_size: int, softcap: float) -> Tensor:
        """dh (``repro_torch::cross_entropy_bwd``, likewise)."""
        return torch.ops.repro_torch.cross_entropy_bwd(
            g, h, lse, labels, vocab_size, softcap)

    @staticmethod
    def _int32(labels: Tensor) -> Tensor:
        """The labels as the kernel reads them: contiguous int32."""
        return labels.to(torch.int32).contiguous()

    def _forward(self, h: Tensor, labels: Tensor, vocab_size: int,
                 softcap: float) -> Tuple[Tensor, Tensor]:
        """The forward op on tensors with storage."""
        if h.device.type == "cpu":
            rows_shape(h, labels, vocab_size)
            return cross_entropy_reference(h, labels, vocab_size, softcap)
        rows, V = card_checks(h, labels, vocab_size)
        lse = torch.empty(rows, dtype=torch.float32, device=h.device)
        nll = torch.empty(rows, dtype=torch.float32, device=h.device)
        lab = self._int32(labels)
        lib = self.library()
        with on(h.device):
            code = lib.k6_ce_fwd(
                h.data_ptr(), lab.data_ptr(), lse.data_ptr(), nll.data_ptr(),
                rows, V, min(vocab_size, V), DTYPE_CODES[h.dtype], softcap,
                torch.cuda.current_stream().cuda_stream)
        self.launched(code, lambda: f"(forward) launch on {tuple(h.shape)} "
                      f"{h.dtype}", "forward")
        return lse, nll

    def _backward(self, g: Tensor, h: Tensor, lse: Tensor, labels: Tensor,
                  vocab_size: int, softcap: float) -> Tensor:
        """The backward op on tensors with storage."""
        if h.device.type == "cpu":
            rows_shape(h, labels, vocab_size)
            return cross_entropy_backward_reference(g, h, lse, labels,
                                                    vocab_size, softcap)
        rows, V = card_checks(h, labels, vocab_size)
        backward_checks(g, lse, h)
        g, lse = g.contiguous(), lse.contiguous()
        dh = torch.empty_like(h, memory_format=torch.contiguous_format)
        vec = int((h.data_ptr() - dh.data_ptr()) % VECTOR_BYTES == 0)
        lab = self._int32(labels)
        lib = self.library()
        with on(h.device):
            code = lib.k6_ce_bwd(
                g.data_ptr(), h.data_ptr(), lse.data_ptr(), lab.data_ptr(),
                dh.data_ptr(), rows, V, min(vocab_size, V),
                DTYPE_CODES[h.dtype], softcap, vec,
                torch.cuda.current_stream().cuda_stream)
        self.launched(code, lambda: f"(backward) launch on "
                      f"{tuple(h.shape)} {h.dtype}", "backward")
        return dh


@torch.library.custom_op("repro_torch::cross_entropy_fwd", mutates_args=())
def _cross_entropy_fwd(h: Tensor, labels: Tensor, vocab_size: int,
                       softcap: float) -> Tuple[Tensor, Tensor]:
    return cross_entropy._forward(h, labels, vocab_size, softcap)


@_cross_entropy_fwd.register_fake
def _cross_entropy_fwd_fake(h, labels, vocab_size, softcap):
    """The forward on tensors with no storage (a dry run's): lse and nll of
    the real call's shape, type and device, after the checks a call on the
    same device makes before it reads data."""
    rows, _ = rows_shape(h, labels, vocab_size)
    if h.device.type != "cpu":
        card_checks(h, labels, vocab_size)
    return (h.new_empty(rows, dtype=torch.float32),
            h.new_empty(rows, dtype=torch.float32))


@torch.library.custom_op("repro_torch::cross_entropy_bwd", mutates_args=())
def _cross_entropy_bwd(g: Tensor, h: Tensor, lse: Tensor, labels: Tensor,
                       vocab_size: int, softcap: float) -> Tensor:
    return cross_entropy._backward(g, h, lse, labels, vocab_size, softcap)


@_cross_entropy_bwd.register_fake
def _cross_entropy_bwd_fake(g, h, lse, labels, vocab_size, softcap):
    """The backward on tensors with no storage: dh's shape, type and
    device, after the checks a call on the same device makes."""
    rows_shape(h, labels, vocab_size)
    if h.device.type != "cpu":
        card_checks(h, labels, vocab_size)
        backward_checks(g, lse, h)
    return torch.empty_like(h, memory_format=torch.contiguous_format)


class _CrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, labels, vocab_size, softcap):
        V = h.shape[-1]
        lse, nll = cross_entropy.forward(h.reshape(-1, V),
                                         labels.reshape(-1), vocab_size,
                                         softcap)
        ctx.save_for_backward(h, lse, labels)
        ctx.vocab_size, ctx.softcap = vocab_size, softcap
        return nll.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        h, lse, labels = ctx.saved_tensors
        V = h.shape[-1]
        dh = cross_entropy.backward(g.reshape(-1), h.reshape(-1, V), lse,
                                    labels.reshape(-1), ctx.vocab_size,
                                    ctx.softcap)
        return dh.reshape(h.shape), None, None, None


cross_entropy = CrossEntropy()
