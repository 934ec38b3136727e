"""K4 (``repro_torch.kernels.rms_norm``) on the CPU: its plain versions
against the composed ops they replace on the card, what its autograd
functions save, its custom ops' fake implementations, its count, and that
the CPU path of the models is the composed ops as before.

This file imports neither JAX nor the reference package.  The kernel
itself is held against these plain versions on the card by the ``gpu``
tests in ``tests/test_torch_kernels.py`` and by ``chip_smoke.py``.
"""
import contextlib
import math

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.kernels import rms_norm as K4
from repro_torch.kernels.rms_norm import (gated_rms_norm_backward_reference,
                                          gated_rms_norm_reference, rms_norm,
                                          rms_norm_backward_reference,
                                          rms_norm_reference)
from repro_torch.launch.step_cost import count_step
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import Transformer, apply_mamba_block

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

EPS = 1e-5
#: mamba2-2.7b's widths: d_model 2560 (the pre-norm), 80 heads of 64
#: (the gated norm over d_inner 5120)
D_MODEL, HEADS, HEAD_DIM = 2560, 80, 64


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _plain_inputs(seed, lead, n, dtype, grad=False):
    g = _gen(seed)
    x = torch.randn(*lead, n, generator=g).to(dtype)
    scale = (1 + 0.1 * torch.randn(n, generator=g)).to(dtype)
    dout = torch.randn(*lead, n, generator=g).to(dtype)
    return ([t.requires_grad_(grad) for t in (x, scale)], dout)


def _gated_inputs(seed, lead, H, P, dtype, grad=False, d_dtype=None):
    g = _gen(seed)
    y = torch.randn(*lead, H, P, generator=g).to(dtype)
    xs = torch.randn(*lead, H, P, generator=g).to(dtype)
    D = (1 + 0.5 * torch.randn(H, generator=g)).to(d_dtype or
                                                   torch.float32)
    z = (2 * torch.randn(*lead, H * P, generator=g)).to(dtype)
    scale = (1 + 0.1 * torch.randn(H * P, generator=g)).to(dtype)
    dout = torch.randn(*lead, H * P, generator=g).to(dtype)
    return ([t.requires_grad_(grad) for t in (y, xs, D, z, scale)], dout)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


# -- the plain versions against the composed ops -------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["plain", "gated"])
def test_plain_forward_is_the_composed_ops_bit_for_bit(variant, dtype):
    if variant == "plain":
        (x, scale), _ = _plain_inputs(0, (2, 4), D_MODEL, dtype)
        out, rstd = rms_norm_reference(x, scale, EPS)
        want = L.apply_norm({"scale": scale}, x, "rms", EPS)
        xf = x.float()
    else:
        ins, _ = _gated_inputs(1, (1, 4), HEADS, HEAD_DIM, dtype)
        out, rstd = gated_rms_norm_reference(*ins, EPS)
        want = S.gated_norm(*ins, EPS)
        xf = None
    assert out.dtype == dtype and torch.equal(out, want)
    assert rstd.dtype == torch.float32 and rstd.shape == out.shape[:-1]
    if xf is not None:
        assert torch.equal(rstd, torch.rsqrt(
            xf.square().mean(-1) + EPS))


def _autograd_and_twin(variant, ins, dout):
    """(autograd's gradients through the plain forward, the backward
    formula's)."""
    if variant == "plain":
        out, rstd = rms_norm_reference(*ins, EPS)
        twin = rms_norm_backward_reference(
            dout, *(t.detach() for t in ins), rstd.detach())
    else:
        out, rstd = gated_rms_norm_reference(*ins, EPS)
        twin = gated_rms_norm_backward_reference(
            dout, *(t.detach() for t in ins), rstd.detach())
    return torch.autograd.grad(out, ins, dout), twin


@pytest.mark.parametrize("variant", ["plain", "gated"])
def test_backward_formula_is_autograd_in_float64(variant):
    """In float64 nothing rounds to bf16: the formula is the exact
    derivative of the forward, to 1e-10 of each gradient's largest."""
    if variant == "plain":
        ins, dout = _plain_inputs(2, (3, 5), 96, torch.float64, grad=True)
    else:
        ins, dout = _gated_inputs(3, (2, 5), 6, 16, torch.float64,
                                  grad=True, d_dtype=torch.float64)
    auto, twin = _autograd_and_twin(variant, ins, dout)
    assert len(auto) == len(twin)
    for a, t, inp in zip(auto, twin, ins):
        assert t.dtype == inp.dtype and t.shape == inp.shape
        assert _rel(t, a) < 1e-10


@pytest.mark.parametrize("variant,n", [("plain", D_MODEL),
                                       ("gated", HEADS * HEAD_DIM)])
def test_backward_formula_in_bf16_at_mamba2_widths(variant, n):
    """bf16 at mamba2-2.7b's widths, 8 rows.  The plain norm's composed
    ops run their whole backward in f32 and round once, as the formula
    does: every gradient within 2^-7 of its largest (the two may round one
    value to neighbouring bf16 steps).  The gated tail's composed ops
    round to bf16 at u, silu(z) and v on the way back; the formula does
    not: within 2^-6 of autograd (two chains of up to three bf16 roundings
    each), and within 2^-7 of the float64 truth, where autograd's chain
    reaches 0.0074 on these draws."""
    for seed in range(3):
        if variant == "plain":
            ins, dout = _plain_inputs(seed, (8,), n, torch.bfloat16,
                                      grad=True)
        else:
            ins, dout = _gated_inputs(seed, (1, 8), HEADS, HEAD_DIM,
                                      torch.bfloat16, grad=True)
        auto, twin = _autograd_and_twin(variant, ins, dout)
        exact_ins = [t.detach().double().requires_grad_(True) for t in ins]
        exact, _ = _autograd_and_twin(variant, exact_ins, dout.double())
        for a, t, e, inp in zip(auto, twin, exact, ins):
            assert t.dtype == inp.dtype and t.shape == inp.shape
            limit = 2.0 ** -7 if variant == "plain" else 2.0 ** -6
            assert _rel(t, a) < limit, (seed, _rel(t, a))
            assert _rel(t, e) < 2.0 ** -7, (seed, _rel(t, e))


@pytest.mark.parametrize("variant", ["plain", "gated"])
def test_column_sums_give_the_same_bits_run_after_run(variant):
    if variant == "plain":
        (x, scale), dout = _plain_inputs(4, (64,), 512, torch.bfloat16)
        rstd = rms_norm_reference(x, scale, EPS)[1]
        runs = [rms_norm.backward(dout, x, scale, rstd) for _ in range(3)]
    else:
        ins, dout = _gated_inputs(5, (2, 32), 8, 64, torch.bfloat16)
        y, xs, D, z, scale = ins
        rstd = gated_rms_norm_reference(*ins, EPS)[1]
        runs = [rms_norm.backward(dout, y, scale, rstd, xs, D, z)
                for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# -- the autograd functions ------------------------------------------------------

def _saved(fn):
    """The tensors the autograd graph built by ``fn()`` saves."""
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = fn()
    return out, saved


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_functions_save_their_inputs_and_one_rstd_a_row():
    rows = 16
    (x, scale), dout = _plain_inputs(6, (2, 8), D_MODEL, torch.bfloat16,
                                     grad=True)
    out, saved = _saved(lambda: rms_norm(x, scale, EPS))
    assert [t.data_ptr() for t in saved[:2]] == [x.data_ptr(),
                                                 scale.data_ptr()]
    assert len(saved) == 3 and saved[2].dtype == torch.float32 \
        and saved[2].shape == (2, 8)
    assert _nbytes(*saved) == rows * D_MODEL * 2 + D_MODEL * 2 + 4 * rows
    # the composed ops keep f32 copies of the row
    _, composed = _saved(lambda: L.apply_norm({"scale": scale}, x, "rms",
                                              EPS))
    assert _nbytes(*composed) > 2 * rows * D_MODEL * 4
    dx, ds = torch.autograd.grad(out, (x, scale), dout)
    want = rms_norm_backward_reference(dout, x.detach(), scale.detach(),
                                       saved[2])
    assert torch.equal(dx, want[0]) and torch.equal(ds, want[1])

    ins, dout = _gated_inputs(7, (1, rows), HEADS, HEAD_DIM, torch.bfloat16,
                              grad=True)
    out, saved = _saved(lambda: rms_norm.gated(*ins, EPS))
    assert [t.data_ptr() for t in saved[:5]] == [t.data_ptr() for t in ins]
    assert len(saved) == 6 and saved[5].shape == (1, rows)
    n = HEADS * HEAD_DIM
    assert _nbytes(*saved) == (3 * rows * n * 2 + 4 * HEADS + n * 2
                               + 4 * rows)
    _, composed = _saved(lambda: S.gated_norm(*ins, EPS))
    assert _nbytes(*composed) > _nbytes(*saved) + 2 * rows * n * 4
    grads = torch.autograd.grad(out, ins, dout)
    want = gated_rms_norm_backward_reference(
        dout, *(t.detach() for t in ins), saved[5])
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def _mamba_block_before(p, x, cfg):
    """``apply_mamba_block`` as the port ran it before K4: the composed
    pre-norm, and ``apply_mamba2`` with its composed tail."""
    h = L.apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    m = p["mamba"]
    di, N, G, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    B, S_, _ = h.shape
    z = h @ m["w_z"]
    xs = F.silu(S._causal_conv(h @ m["w_x"], m["conv_x_w"], m["conv_x_b"]))
    Bm = F.silu(S._causal_conv(h @ m["w_B"], m["conv_B_w"], m["conv_B_b"]))
    Cm = F.silu(S._causal_conv(h @ m["w_C"], m["conv_C_w"], m["conv_C_b"]))
    xs = xs.reshape(B, S_, H, cfg.ssm_head_dim)
    dt = F.softplus((h @ m["w_dt"]).float() + m["dt_bias"])
    A = -torch.exp(m["A_log"])
    y, _ = S.ssd_k3(xs, dt, A, Bm.reshape(B, S_, G, N),
                    Cm.reshape(B, S_, G, N), cfg.ssm_chunk)
    y = y + xs.float() * m["D"][:, None]
    y = y.reshape(B, S_, di).to(h.dtype)
    y = y * F.silu(z)
    y = L.apply_norm({"scale": m["gate_norm"]}, y, "rms", cfg.norm_eps)
    return x + y @ m["out_proj"]


def test_cpu_tensors_keep_the_composed_ops_and_launch_nothing(monkeypatch):
    """On the CPU the models never reach K4: a reduced mamba2 block (bf16)
    gives the loss and gradients of the block as it ran before K4, bit for
    bit, and nothing counts a launch."""
    cfg = reduced(ARCHS["mamba2-2.7b"]).with_overrides(dtype="bfloat16",
                                                       param_dtype="bfloat16")
    bp = Transformer(cfg).init(0, device="cpu")["blocks"][0]
    x = torch.randn(2, 64, cfg.d_model, generator=_gen(8)).bfloat16()

    def loss_and_grads(block):
        p = {part: {k: v.detach().requires_grad_(True)
                    for k, v in bp[part].items()} for part in bp}
        leaves = [p[part][k] for part in sorted(p) for k in sorted(p[part])]
        loss = block(p, x).float().square().mean()
        return loss, torch.autograd.grad(loss, leaves)

    def no_k4(*a, **k):
        raise AssertionError("K4 reached on the CPU")
    monkeypatch.setattr(K4._RMSNorm, "apply", no_k4)
    monkeypatch.setattr(K4._GatedRMSNorm, "apply", no_k4)
    rms_norm.reset_counts()
    loss, grads = loss_and_grads(lambda p, x: apply_mamba_block(p, x, cfg))
    before, grads_before = loss_and_grads(
        lambda p, x: _mamba_block_before(p, x, cfg))
    assert rms_norm.launches == 0
    assert torch.equal(loss, before)
    assert len(grads) == len(grads_before) == 1 + len(bp["mamba"])
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_before))


# -- the wrapper's host path ------------------------------------------------------

def test_a_call_goes_through_the_op_only_where_the_dispatcher_is_read():
    """With no dispatch mode active and plain operands a call runs the op's
    body directly, with the op's results bit for bit; under a dispatch mode
    (the step count's, a fake mode's) both directions reach the mode as the
    custom ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))
    ins, dout = _gated_inputs(14, (1, 4), 4, 16, torch.bfloat16)
    y, xs, D, z, scale = ins
    assert K4.unwatched([y, scale, xs, D, z])
    out, rstd = rms_norm.forward(y, scale, EPS, xs, D, z)
    grads = rms_norm.backward(dout, y, scale, rstd, xs, D, z)
    want = torch.ops.repro_torch.rms_norm_fwd(y, scale, EPS, xs, D, z)
    assert torch.equal(out, want[0]) and torch.equal(rstd, want[1])
    want = torch.ops.repro_torch.rms_norm_bwd(dout, y, scale, rstd, xs, D, z)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    with Seen() as mode:
        assert not K4.unwatched([y])
        out2, rstd2 = rms_norm.forward(y, scale, EPS, xs, D, z)
        rms_norm.backward(dout, y, scale, rstd2, xs, D, z)
    assert "repro_torch.rms_norm_fwd" in mode.ops
    assert "repro_torch.rms_norm_bwd" in mode.ops
    assert torch.equal(out2, out)
    assert K4.unwatched([torch.nn.Parameter(scale)])


def test_the_card_checks_are_made_once_a_layout(monkeypatch):
    """``RMSNorm.checked`` keeps ``card_checks``' result by the operands'
    shapes, strides, types and devices: the same layout is checked once,
    another stride, type or direction anew."""
    made = []

    def card_checks(x, scale, xs, D, z, backward):
        made.append((tuple(x.shape), x.stride(), x.dtype, backward))
        return (tuple(x.shape), x.shape[-1], 0, (x.stride(-2), 0, 0))
    monkeypatch.setattr(K4, "card_checks", card_checks)
    w = K4.RMSNorm()
    base = torch.empty(4, 96)
    x, s = base[:, :64], torch.empty(64)
    for _ in range(3):
        assert w.checked(x, s, None, None, None, False) == (
            (4, 64), 64, 0, (96, 0, 0))
    w.checked(torch.empty(4, 64), s, None, None, None, False)
    w.checked(x.bfloat16(), s, None, None, None, False)
    w.checked(x, s, None, None, None, True)
    w.checked(base[:, 32:], s, None, None, None, False)  # same layout
    assert len(made) == 4


# -- the custom ops' fake implementations ---------------------------------------

def _fake(mode, tensors, device=None):
    with mode:
        return [None if t is None else torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype, device=device or t.device)
                for t in tensors]


@pytest.mark.parametrize("variant", ["plain", "gated"])
def test_fake_implementations_match_the_real_call(variant):
    if variant == "plain":
        (x, scale), dout = _plain_inputs(9, (2, 6), 64, torch.float32)
        args = [x, scale, None, None, None]
    else:
        (y, xs, D, z, scale), dout = _gated_inputs(10, (2, 6), 4, 16,
                                                   torch.float32)
        args = [y, scale, xs, D, z]
    x, scale, xs, D, z = args
    out, rstd = rms_norm.forward(x, scale, EPS, xs, D, z)
    grads = rms_norm.backward(dout, x, scale, rstd, xs, D, z)
    mode = FakeTensorMode()
    for device in (None, "cuda"):
        fx, fs, fxs, fD, fz, fdout = _fake(mode, [x, scale, xs, D, z, dout],
                                           device)
        with mode:
            fout, frstd = rms_norm.forward(fx, fs, EPS, fxs, fD, fz)
            fgrads = rms_norm.backward(fdout, fx, fs, frstd, fxs, fD, fz)
        for f, r in zip([fout, frstd] + list(fgrads),
                        [out, rstd] + list(grads)):
            assert tuple(f.shape) == tuple(r.shape) and f.dtype == r.dtype
            assert f.device.type == (device or "cpu")
    small = [t if t is None else t[:1] if t.dim() > 1 else t for t in args]
    torch.library.opcheck(torch.ops.repro_torch.rms_norm_fwd.default,
                          (small[0], small[1], EPS, *small[2:]),
                          test_utils=("test_schema", "test_faketensor"))
    r = rms_norm.forward(small[0], small[1], EPS, *small[2:])[1]
    torch.library.opcheck(torch.ops.repro_torch.rms_norm_bwd.default,
                          (dout[:1], small[0], small[1], r, *small[2:]),
                          test_utils=("test_schema", "test_faketensor"))


def test_fake_implementations_raise_the_card_checks():
    """The checks a launch makes before it reads data, on fake CUDA
    tensors (the forward alone, and tensors made whole: on a PyTorch built
    without CUDA, indexing a CUDA tensor or an error inside an autograd
    function on one turns into another error)."""
    bf = torch.bfloat16

    def cuda(shape, dtype=bf, strides=None):
        return torch.empty_strided(shape, strides or torch.empty(
            shape, device="meta").stride(), dtype=dtype, device="cuda")
    with FakeTensorMode():
        x, s = cuda((4, 64)), cuda((64,))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            rms_norm.forward(cuda((4, 64), torch.float16), s, EPS)
        with pytest.raises(TypeError, match="float32 or bfloat16 scale"):
            rms_norm.forward(x, cuda((64,), torch.float16), EPS)
        with pytest.raises(ValueError, match="scale"):
            rms_norm.forward(x, cuda((32,)), EPS)
        with pytest.raises(ValueError, match="contiguous"):
            rms_norm.forward(cuda((4, 32), strides=(64, 2)), cuda((32,)),
                             EPS)
        with pytest.raises(ValueError, match="one run of rows"):
            rms_norm.forward(cuda((2, 4, 64), strides=(64, 128, 1)), s, EPS)
        with pytest.raises(ValueError, match="contiguous scale"):
            rms_norm.forward(x, cuda((64,), strides=(2,)), EPS)
        wide = K4.max_width(False, False) + 1
        with pytest.raises(ValueError, match="rows up to"):
            rms_norm.forward(cuda((2, wide)), cuda((wide,)), EPS)
        y, z, g = cuda((1, 4, 8, 16)), cuda((1, 4, 128)), cuda((128,))
        D = cuda((8,), torch.float32)
        with pytest.raises(TypeError, match="float32 D"):
            rms_norm.forward(y, g, EPS, y, cuda((8,)), z)
        with pytest.raises(ValueError, match="gated norm"):
            rms_norm.forward(y, g, EPS, y, cuda((4,), torch.float32), z)
        with pytest.raises(ValueError, match="together"):
            rms_norm.forward(y, g, EPS, y, None, z)
        wide = K4.max_width(True, True) // 64 + 1
        yw, zw = cuda((1, 2, wide, 64)), cuda((1, 2, wide * 64))
        rms_norm.forward(yw, cuda((wide * 64,)), EPS, yw,
                         cuda((wide,), torch.float32), zw)
        rstd = cuda((1, 2), torch.float32)
        with pytest.raises(ValueError, match="rows up to"):
            rms_norm.backward(zw, yw, cuda((wide * 64,)), rstd, yw,
                              cuda((wide,), torch.float32), zw)
        with pytest.raises(ValueError, match="backward takes"):
            rms_norm.backward(cuda((4, 32)), x, s, cuda((4,),
                                                        torch.float32))
        out, rstd = rms_norm.forward(y, g, EPS, y, D, z)
        assert out.shape == z.shape and rstd.shape == (1, 4)


def test_models_route_to_k4_what_it_takes(monkeypatch):
    """A dry run's fake CUDA tensor takes K4 in ``apply_norm`` (the RMS
    norm, not the layernorm), through the fake implementation; a CPU
    tensor does not.  With the rule widened to CPU tensors, a mamba2 block
    runs the plain variant for its pre-norm and the gated one for its tail,
    and its output is the composed ops' bit for bit.  (Indexing, or
    autograd, on a fake CUDA tensor needs a PyTorch built with CUDA.)"""
    calls = []
    orig = K4.RMSNorm.forward

    def spy(self, x, scale, eps, xs=None, D=None, z=None):
        calls.append("gated" if xs is not None else "plain")
        return orig(self, x, scale, eps, xs, D, z)
    monkeypatch.setattr(K4.RMSNorm, "forward", spy)
    with FakeTensorMode():
        x = torch.empty((1, 64, 32), device="cuda", dtype=torch.bfloat16)
        p = {"scale": torch.empty(32, device="cuda", dtype=torch.bfloat16),
             "bias": torch.empty(32, device="cuda", dtype=torch.bfloat16)}
        assert K4.takes(x)
        out = L.apply_norm(p, x, "rms", EPS)
        L.apply_norm(p, x, "layer", EPS)
    assert out.shape == x.shape and out.device.type == "cuda"
    assert calls == ["plain"] and not K4.takes(torch.empty(3))

    cfg = reduced(ARCHS["mamba2-2.7b"]).with_overrides(dtype="bfloat16",
                                                       param_dtype="bfloat16")
    bp = Transformer(cfg).init(0, device="cpu")["blocks"][0]
    x = torch.randn(2, 64, cfg.d_model, generator=_gen(13)).bfloat16()
    want = apply_mamba_block(bp, x, cfg)
    monkeypatch.setattr(K4, "takes", lambda t: True)
    calls.clear()
    got = apply_mamba_block(bp, x, cfg)
    assert calls == ["plain", "gated"] and torch.equal(got, want)


# -- the count -------------------------------------------------------------------

def test_count_adds_no_flops_and_each_calls_bytes():
    (x, scale), dout = _plain_inputs(11, (4,), 64, torch.bfloat16,
                                     grad=True)
    out, rstd = rms_norm.forward(x.detach(), scale.detach(), EPS)
    dx, ds = rms_norm.backward(dout, x.detach(), scale.detach(), rstd)

    def step(a, b):
        y = rms_norm(x, scale, EPS)
        torch.autograd.grad(y, (x, scale), dout)
    c = count_step(step, None, None)
    assert c.flops == 0.0 and c.detail_flops == {}
    assert c.detail_bytes["rms_norm_fwd"] == _nbytes(x, scale, out, rstd)
    assert c.detail_bytes["rms_norm_bwd"] == _nbytes(dout, x, scale, rstd,
                                                     dx, ds)
    ins, dout = _gated_inputs(12, (1, 4), 4, 16, torch.bfloat16, grad=True)
    out, rstd = rms_norm.forward(ins[0], ins[4], EPS, *ins[1:4])
    grads = rms_norm.backward(dout, ins[0], ins[4], rstd, *ins[1:4])
    c = count_step(lambda a, b: torch.autograd.grad(
        rms_norm.gated(*ins, EPS), ins, dout), None, None)
    assert c.flops == 0.0 and c.detail_flops == {}
    assert c.detail_bytes["rms_norm_fwd"] == _nbytes(*ins, out, rstd)
    assert c.detail_bytes["rms_norm_bwd"] == _nbytes(dout, *ins, rstd,
                                                     *grads)


def test_mamba2_step_counts_k4_once_a_norm_and_the_dry_count_equals_it(
        monkeypatch):
    """With the models routed to K4 on the CPU too (as the card routes
    them), a reduced mamba2 step counts 2 L + 1 forward calls and as many
    backward ones, by formula, and the count under a ``FakeTensorMode``
    (the dry run's) equals it."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_train_step
    monkeypatch.setattr(K4, "takes", lambda t: type(t).__name__ != "DTensor")
    cfg = reduced(ARCHS["mamba2-2.7b"])
    model, opt = Transformer(cfg), AdamW(OptConfig())
    real = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, DataConfig(batch=2, seq_len=64)).batch_at(0).items()}

    def count(fake):
        with FakeTensorMode() if fake else contextlib.nullcontext():
            params = model.init(0, device="cpu")
            batch = {k: torch.empty(v.shape, dtype=v.dtype)
                     for k, v in real.items()} if fake else real
            state = opt.init(params)
            step = make_train_step(model, opt)
            return count_step(lambda p, b: step(p, state, b), params, batch)
    calls = []
    orig = K4.RMSNorm.forward

    def spy(self, x, scale, eps, xs=None, D=None, z=None):
        calls.append(xs is not None)
        return orig(self, x, scale, eps, xs, D, z)
    monkeypatch.setattr(K4.RMSNorm, "forward", spy)
    want = count(False)
    assert len(calls) == 2 * cfg.num_layers + 1
    assert sum(calls) == cfg.num_layers
    assert "rms_norm_fwd" not in want.detail_flops
    assert want.detail_bytes["rms_norm_bwd"] > 0
    dry = count(True)
    assert (dry.flops, dry.bytes) == (want.flops, want.bytes)
    assert dry.detail_bytes == want.detail_bytes


def test_bound_counts_each_byte_once():
    t = torch.empty((2048, 5120), dtype=torch.bfloat16)
    assert math.isclose(K4.bound_ms([t, t, t, t]),
                        4 * 2048 * 5120 * 2 / 3.35e12 * 1e3)
