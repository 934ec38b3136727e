"""K5 (``repro_torch.kernels.causal_conv``): its plain backward against
autograd of the composed ops it replaces on the card, what its autograd
function saves, its custom ops' fake implementations, its count, that the
CPU path of the models is the composed ops as before, and (marked ``gpu``)
the kernel against the composed ops on a CUDA device.

This file imports neither JAX nor the reference package, so it also runs
on the card's machine:  ``python -m pytest -q -m gpu tests/test_torch_conv.py``.
Without a CUDA device the ``gpu`` tests skip.
"""
import contextlib

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.kernels import causal_conv as K5
from repro_torch.kernels.causal_conv import (
    causal_conv_reference, causal_conv_silu,
    causal_conv_silu_backward_reference, causal_conv_silu_reference)
from repro_torch.launch.step_cost import count_step
from repro_torch.models import ssm as S
from repro_torch.models.transformer import Transformer, apply_mamba_block

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

W = 4
#: channels of the convs: mamba2-2.7b's xs (d_inner 5120) and B / C (one
#: group of 128), the published Zamba2-7B's xs (7168)
MAMBA2_XS, GROUP, ZAMBA2_XS = 5120, 128, 7168


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _inputs(seed, B, S_, C, dtype, grad=False, device="cpu"):
    """x, the taps (init's scale, 1/sqrt(W)), a bias and the output's
    gradient, from the seed."""
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device)
    ins = [r(B, S_, C).to(dtype), (r(C, W) / W ** 0.5).to(dtype),
           (0.1 * r(C)).to(dtype)]
    return [t.requires_grad_(grad) for t in ins], r(B, S_, C).to(dtype)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def _composed_grads(ins, dout):
    """Autograd's gradients through the composed ops (``models.ssm``'s
    CPU path)."""
    out = F.silu(S._causal_conv(*ins))
    return torch.autograd.grad(out, ins, dout)


# -- the plain versions against the composed ops -------------------------------

def test_plain_forward_is_the_models_composed_ops():
    ins, _ = _inputs(0, 2, 37, 24, torch.bfloat16)
    assert S._causal_conv is causal_conv_reference
    assert torch.equal(causal_conv_silu_reference(*ins),
                       F.silu(S._causal_conv(*ins)))
    assert torch.equal(S.conv_silu(*ins), F.silu(S._causal_conv(*ins)))


@pytest.mark.parametrize("B,S_", [(2, 2), (2, 37), (1, 64)],
                         ids=["S<W", "ragged", "S64"])
def test_backward_formula_is_autograd_in_float64(B, S_):
    """In float64 nothing rounds: the formula is the exact derivative of
    the forward, to 1e-12 of each gradient's largest, for S < W, a ragged
    S and a batch."""
    ins, dout = _inputs(1, B, S_, 24, torch.float64, grad=True)
    auto = _composed_grads(ins, dout)
    twin = causal_conv_silu_backward_reference(
        dout, *(t.detach() for t in ins))
    assert len(auto) == len(twin) == 3
    for a, t, inp in zip(auto, twin, ins):
        assert t.dtype == inp.dtype and t.shape == inp.shape
        assert _rel(t, a) < 1e-12


@pytest.mark.parametrize("C", [MAMBA2_XS, GROUP, ZAMBA2_XS])
@pytest.mark.parametrize("B,S_", [(1, 2), (2, 37), (1, 64)],
                         ids=["S<W", "ragged", "S64"])
def test_backward_formula_in_bf16_at_mamba2_and_zamba2_widths(C, B, S_):
    """bf16 at the models' conv widths.  Autograd rounds dpre to bf16 in
    SiLU's backward, as the formula does, and sums dx's four products and
    the taps' and bias's rows in f32 in another order: every gradient
    within 2^-8 of its largest (the two may round one value to
    neighbouring bf16 steps), and within 2^-7 of the float64 truth."""
    for seed in range(2):
        ins, dout = _inputs(seed, B, S_, C, torch.bfloat16, grad=True)
        auto = _composed_grads(ins, dout)
        twin = causal_conv_silu_backward_reference(
            dout, *(t.detach() for t in ins))
        exact_ins = [t.detach().double().requires_grad_(True) for t in ins]
        exact = _composed_grads(exact_ins, dout.double())
        for a, t, e, inp in zip(auto, twin, exact, ins):
            assert t.dtype == inp.dtype and t.shape == inp.shape
            assert _rel(t, a) < 2.0 ** -8, (seed, _rel(t, a))
            assert _rel(t, e) < 2.0 ** -7, (seed, _rel(t, e))


def test_sums_give_the_same_bits_run_after_run():
    ins, dout = _inputs(2, 2, 64, 256, torch.bfloat16)
    runs = [causal_conv_silu.backward(dout, *ins) for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# -- the autograd function -------------------------------------------------------

def _saved(fn):
    """The tensors the autograd graph built by ``fn()`` saves."""
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = fn()
    return out, saved


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_function_saves_its_inputs_alone():
    """x, the taps and the bias, by storage; the composed ops keep the
    padded f32 copy of x besides SiLU's input: (S + W - 1) C 4 bytes more
    than the function, and their gradients are the function's."""
    B, S_, C = 1, 64, MAMBA2_XS
    ins, dout = _inputs(3, B, S_, C, torch.bfloat16, grad=True)
    out, saved = _saved(lambda: causal_conv_silu(*ins))
    assert [t.data_ptr() for t in saved] == [t.data_ptr() for t in ins]
    assert _nbytes(*saved) == _nbytes(*ins)
    _, composed = _saved(lambda: F.silu(S._causal_conv(*ins)))
    assert _nbytes(*composed) - _nbytes(*saved) >= (S_ + W - 1) * C * 4
    grads = torch.autograd.grad(out, ins, dout)
    want = causal_conv_silu_backward_reference(
        dout, *(t.detach() for t in ins))
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def _parent_causal_conv(x, w, b):
    """``models.ssm._causal_conv`` as the port ran it before K5."""
    W_, S_ = w.shape[-1], x.shape[1]
    xp = F.pad(x.float(), (0, 0, W_ - 1, 0))
    wf = w.float()
    out = xp[:, :S_] * wf[:, 0]
    for k in range(1, W_):
        out = out + xp[:, k:k + S_] * wf[:, k]
    return (out + b.float()).to(x.dtype)


def _block_loss_and_grads(cfg, bp, x, block):
    p = {part: {k: v.detach().requires_grad_(True)
                for k, v in bp[part].items()} for part in bp}
    leaves = [p[part][k] for part in sorted(p) for k in sorted(p[part])]
    loss = block(p, x).float().square().mean()
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b-instruct"])
def test_apply_mamba2_on_the_cpu_gives_the_parents_bits(arch, monkeypatch):
    """On the CPU the models never reach K5: a reduced mamba2 block (bf16;
    the published Zamba2-7B's layout at G 2 too) gives the loss and
    gradients of the block with the conv as it ran before K5, bit for bit,
    and nothing counts a launch."""
    from repro_torch.configs.registry import get_arch
    cfg = reduced(get_arch(arch)).with_overrides(dtype="bfloat16",
                                                 param_dtype="bfloat16")
    bp = Transformer(cfg).init(0, device="cpu")["blocks"][0]
    bp = {k: bp[k] for k in ("ln", "mamba")}
    x = torch.randn(2, 64, cfg.d_model, generator=_gen(8)).bfloat16()

    def no_k5(*a, **k):
        raise AssertionError("K5 reached on the CPU")
    causal_conv_silu.reset_counts()
    monkeypatch.setattr(K5._CausalConvSilu, "apply", no_k5)
    loss, grads = _block_loss_and_grads(
        cfg, bp, x, lambda p, x: apply_mamba_block(p, x, cfg))
    monkeypatch.setattr(S, "_causal_conv", _parent_causal_conv)
    before, grads_before = _block_loss_and_grads(
        cfg, bp, x, lambda p, x: apply_mamba_block(p, x, cfg))
    assert causal_conv_silu.launches == 0
    assert torch.equal(loss, before)
    assert len(grads) == len(grads_before) == 1 + len(bp["mamba"])
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_before))


# -- the wrapper's host path ------------------------------------------------------

def test_a_call_goes_through_the_op_only_where_the_dispatcher_is_read():
    """With no dispatch mode active and plain operands a call runs the op's
    body directly, with the op's results bit for bit; under a dispatch mode
    both directions reach the mode as the custom ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))
    ins, dout = _inputs(4, 1, 9, 16, torch.bfloat16)
    out = causal_conv_silu.forward(*ins)
    grads = causal_conv_silu.backward(dout, *ins)
    assert torch.equal(out, torch.ops.repro_torch.causal_conv_silu_fwd(*ins))
    want = torch.ops.repro_torch.causal_conv_silu_bwd(dout, *ins)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    with Seen() as mode:
        out2 = causal_conv_silu.forward(*ins)
        causal_conv_silu.backward(dout, *ins)
    assert "repro_torch.causal_conv_silu_fwd" in mode.ops
    assert "repro_torch.causal_conv_silu_bwd" in mode.ops
    assert torch.equal(out2, out)


def test_the_card_checks_are_made_once_a_layout(monkeypatch):
    made = []

    def card_checks(x, w, b):
        made.append((tuple(x.shape), x.stride(), x.dtype))
        return x.stride(0), x.stride(1)
    monkeypatch.setattr(K5, "card_checks", card_checks)
    k = K5.CausalConvSilu()
    base = torch.empty(2, 8, 96)
    x, w, b = base[..., :64], torch.empty(64, W), torch.empty(64)
    for _ in range(3):
        assert k.checked(x, w, b) == (768, 96)
    k.checked(torch.empty(2, 8, 64), w, b)
    k.checked(x.bfloat16(), w, b)
    k.checked(base[..., 32:], w, b)          # the same layout
    assert len(made) == 3


def test_vector_follows_alignment_and_channels():
    """8 bytes a thread forward and 4 backward where C, the row strides and
    every start allow them, else one element."""
    x = torch.empty(2, 8, 64, dtype=torch.bfloat16)
    assert K5.vector("forward", x.dtype, 64, [x], [512, 64]) == 4
    assert K5.vector("backward", x.dtype, 64, [x], [512, 64]) == 2
    assert K5.vector("forward", torch.float32, 64, [x.float()],
                     [512, 64]) == 2
    assert K5.vector("backward", torch.float32, 64, [x.float()],
                     [512, 64]) == 1
    assert K5.vector("forward", x.dtype, 62, [x], [496, 62]) == 1
    assert K5.vector("backward", x.dtype, 62, [x], [496, 62]) == 2
    assert K5.vector("forward", x.dtype, 64, [x[..., 1:]], [512, 64]) == 1
    assert K5.vector("forward", x.dtype, 64, [x], [512, 66]) == 1


# -- the custom ops' fake implementations ---------------------------------------

def _fake(mode, tensors, device=None):
    with mode:
        return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device=device or t.device)
                for t in tensors]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations_match_the_real_call(dtype):
    ins, dout = _inputs(5, 2, 6, 16, dtype)
    out = causal_conv_silu.forward(*ins)
    grads = causal_conv_silu.backward(dout, *ins)
    mode = FakeTensorMode()
    for device in (None, "cuda"):
        fx, fw, fb, fg = _fake(mode, ins + [dout], device)
        with mode:
            fout = causal_conv_silu.forward(fx, fw, fb)
            fgrads = causal_conv_silu.backward(fg, fx, fw, fb)
        for f, r in zip([fout] + list(fgrads), [out] + list(grads)):
            assert tuple(f.shape) == tuple(r.shape) and f.dtype == r.dtype
            assert f.device.type == (device or "cpu")
    torch.library.opcheck(torch.ops.repro_torch.causal_conv_silu_fwd.default,
                          tuple(ins),
                          test_utils=("test_schema", "test_faketensor"))
    torch.library.opcheck(torch.ops.repro_torch.causal_conv_silu_bwd.default,
                          (dout, *ins),
                          test_utils=("test_schema", "test_faketensor"))


def test_fake_implementations_raise_the_card_checks():
    """The checks a launch makes before it reads data, on fake CUDA
    tensors."""
    bf = torch.bfloat16

    def cuda(shape, dtype=bf, strides=None):
        return torch.empty_strided(shape, strides or torch.empty(
            shape, device="meta").stride(), dtype=dtype, device="cuda")
    with FakeTensorMode():
        x, w, b = cuda((1, 16, 64)), cuda((64, W)), cuda((64,))
        with pytest.raises(TypeError, match="float32 or bfloat16 activ"):
            causal_conv_silu.forward(cuda((1, 16, 64), torch.float16), w, b)
        with pytest.raises(TypeError, match="of one type"):
            causal_conv_silu.forward(x, cuda((64, W), torch.float32),
                                     cuda((64,), torch.float32))
        with pytest.raises(TypeError, match="of one type"):
            causal_conv_silu.forward(x, w, cuda((64,), torch.float32))
        with pytest.raises(ValueError, match="width 1 to 4"):
            causal_conv_silu.forward(x, cuda((64, 5)), b)
        with pytest.raises(ValueError, match="contiguous channels"):
            causal_conv_silu.forward(cuda((1, 16, 64), strides=(2048, 1, 16)),
                                     w, b)
        with pytest.raises(ValueError, match="contiguous taps"):
            causal_conv_silu.forward(x, cuda((64, W), strides=(1, 64)), b)
        with pytest.raises(ValueError, match=r"x \(B, S, C\)"):
            causal_conv_silu.forward(x, cuda((32, W)), b)
        with pytest.raises(ValueError, match="at least one row"):
            causal_conv_silu.forward(cuda((1, 0, 64)), w, b)
        with pytest.raises(ValueError, match="backward takes g"):
            causal_conv_silu.backward(cuda((1, 8, 64)), x, w, b)
        out = causal_conv_silu.forward(x, w, b)
        dx, dw, db = causal_conv_silu.backward(cuda((1, 16, 64)), x, w, b)
    assert out.shape == x.shape and dx.shape == x.shape
    assert dw.shape == w.shape and db.shape == b.shape


def test_models_route_to_k5_what_it_takes(monkeypatch):
    """A dry run's fake CUDA tensor takes K5 in ``conv_silu``, through the
    fake implementation; a CPU tensor does not.  With the rule widened to
    CPU tensors a mamba2 block runs K5 for xs, B and C, and its output is
    the composed ops' bit for bit."""
    calls = []
    orig = K5.CausalConvSilu.forward

    def spy(self, x, w, b):
        calls.append(x.shape[-1])
        return orig(self, x, w, b)
    monkeypatch.setattr(K5.CausalConvSilu, "forward", spy)
    with FakeTensorMode():
        x = torch.empty((1, 64, 32), device="cuda", dtype=torch.bfloat16)
        w = torch.empty((32, W), device="cuda", dtype=torch.bfloat16)
        b = torch.empty(32, device="cuda", dtype=torch.bfloat16)
        assert K5.takes(x)
        out = S.conv_silu(x, w, b)
    assert out.shape == x.shape and out.device.type == "cuda"
    assert calls == [32] and not K5.takes(torch.empty(3))

    cfg = reduced(ARCHS["mamba2-2.7b"]).with_overrides(dtype="bfloat16",
                                                       param_dtype="bfloat16")
    bp = Transformer(cfg).init(0, device="cpu")["blocks"][0]
    x = torch.randn(2, 64, cfg.d_model, generator=_gen(13)).bfloat16()
    want = apply_mamba_block(bp, x, cfg)
    monkeypatch.setattr(K5, "takes", lambda t: True)
    calls.clear()
    got = apply_mamba_block(bp, x, cfg)
    GN = cfg.ssm_groups * cfg.ssm_state
    assert calls == [cfg.d_inner, GN, GN] and torch.equal(got, want)


# -- the count -------------------------------------------------------------------

def test_count_adds_no_flops_and_each_calls_bytes():
    ins, dout = _inputs(11, 2, 16, 32, torch.bfloat16, grad=True)
    plain = [t.detach() for t in ins]
    out = causal_conv_silu.forward(*plain)
    grads = causal_conv_silu.backward(dout, *plain)
    c = count_step(lambda a, b: torch.autograd.grad(
        causal_conv_silu(*ins), ins, dout), None, None)
    assert c.flops == 0.0 and c.detail_flops == {}
    assert c.detail_bytes["causal_conv_silu_fwd"] == _nbytes(*ins, out)
    assert c.detail_bytes["causal_conv_silu_bwd"] == _nbytes(dout, *ins,
                                                             *grads)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b-instruct"])
def test_step_counts_k5_three_times_a_layer_and_the_dry_count_equals_it(
        arch, monkeypatch):
    """With the models routed to K5 on the CPU too (as the card routes
    them), a reduced step counts three forward calls a mamba layer (xs, B,
    C) and as many backward ones, and the count under a
    ``FakeTensorMode`` (the dry run's) equals it."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_train_step
    monkeypatch.setattr(K5, "takes", lambda t: type(t).__name__ != "DTensor")
    cfg = reduced(get_arch(arch))
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
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = K5.CausalConvSilu.forward, K5.CausalConvSilu.backward

    def spy_fwd(self, *a):
        calls["forward"] += 1
        return fwd(self, *a)

    def spy_bwd(self, *a):
        calls["backward"] += 1
        return bwd(self, *a)
    monkeypatch.setattr(K5.CausalConvSilu, "forward", spy_fwd)
    monkeypatch.setattr(K5.CausalConvSilu, "backward", spy_bwd)
    want = count(False)
    assert calls == {"forward": 3 * cfg.num_layers,
                     "backward": 3 * cfg.num_layers}
    assert "causal_conv_silu_fwd" not in want.detail_flops
    assert want.detail_bytes["causal_conv_silu_bwd"] > 0
    dry = count(True)
    assert (dry.flops, dry.bytes) == (want.flops, want.bytes)
    assert dry.detail_bytes == want.detail_bytes


def test_bound_counts_each_byte_once():
    t = torch.empty((1, 2048, MAMBA2_XS), dtype=torch.bfloat16)
    assert K5.bound_ms([t, t]) == pytest.approx(
        2 * 2048 * MAMBA2_XS * 2 / 3.35e12 * 1e3)


# -- on the card -------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _steps(a, b):
    """Elementwise distance of two bf16 tensors in bf16 steps."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


#: (batch, rows, channels, type): mamba2-2.7b's xs and B/C convs at 2048
#: rows, the published Zamba2-7B's at 4096, a batch-4 serve prefill of a
#: ragged 37 rows, rows fewer than W, channels off the vector, and f32
K5_CASES = [(1, 2048, MAMBA2_XS, torch.bfloat16),
            (1, 2048, GROUP, torch.bfloat16),
            (1, 4096, ZAMBA2_XS, torch.bfloat16),
            (1, 4096, GROUP, torch.bfloat16),
            (4, 37, ZAMBA2_XS, torch.bfloat16),
            (4, 37, GROUP, torch.bfloat16),
            (3, 2, 40, torch.bfloat16),
            (2, 50, 102, torch.bfloat16),
            (2, 300, 512, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K5_CASES,
                         ids=[f"{b}x{s}x{c}-{str(t)[6:]}"
                              for b, s, c, t in K5_CASES])
def test_k5_matches_the_composed_ops_on_card(case):
    """The forward the composed ops' bits, or each differing element
    within one bf16 step (f32: 1e-6 of the largest); dx within 2^-7 of its
    largest (f32 1e-5: dpre and dx's sum taken in another order), dw and db
    within 2^-7 (f32 1e-4: sums over the rows in another order); the
    backward the same bits twice."""
    _cuda()
    B, S_, C, dtype = case
    ins, dout = _inputs(7, B, S_, C, dtype, grad=True, device="cuda")
    before = dict(causal_conv_silu.launches_by_direction)
    out = causal_conv_silu(*ins)
    grads = torch.autograd.grad(out, ins, dout)
    again = causal_conv_silu.backward(dout, *(t.detach() for t in ins))
    ref = F.silu(S._causal_conv(*ins))
    ref_grads = torch.autograd.grad(ref, ins, dout)
    torch.cuda.synchronize()
    assert causal_conv_silu.launches_by_direction == {
        "forward": before["forward"] + 1,
        "backward": before["backward"] + 2}
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.bfloat16:
        steps = _steps(out, ref)
        print(f"[k5] {case}: forward {int((steps > 0).sum())} of "
              f"{out.numel()} elements differ, at most {int(steps.max())} "
              f"bf16 step")
        assert int(steps.max()) <= 1
    else:
        assert _rel(out, ref) < 1e-6
    tols = (2.0 ** -7, 2.0 ** -7, 2.0 ** -7) if dtype == torch.bfloat16 \
        else (1e-5, 1e-4, 1e-4)
    for a, r, c, tol in zip(grads, ref_grads, again, tols):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        assert _rel(a, r) < tol, (_rel(a, r), tol)
        assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))


@pytest.mark.gpu
def test_k5_saves_x_alone_and_counts_its_launches():
    """At mamba2-2.7b's xs conv the graph saves x, the taps and the bias,
    by storage; the composed ops save (S + W - 1) C f32 bytes more."""
    _cuda()
    ins, dout = _inputs(8, 1, 2048, MAMBA2_XS, torch.bfloat16, grad=True,
                        device="cuda")
    causal_conv_silu.reset_counts()
    out, saved = _saved(lambda: causal_conv_silu(*ins))
    assert [t.data_ptr() for t in saved] == [t.data_ptr() for t in ins]
    assert _nbytes(*saved) == _nbytes(*ins)
    _, composed = _saved(lambda: F.silu(S._causal_conv(*ins)))
    assert _nbytes(*composed) - _nbytes(*saved) >= (2048 + W - 1) \
        * MAMBA2_XS * 4
    torch.autograd.grad(out, ins, dout)
    torch.cuda.synchronize()
    assert causal_conv_silu.launches == 2
    assert causal_conv_silu.launches_by_direction == {"forward": 1,
                                                      "backward": 1}


@pytest.mark.gpu
def test_k5_rejects_what_it_does_not_take():
    _cuda()
    ins, _ = _inputs(9, 1, 16, 64, torch.bfloat16, device="cuda")
    x, w, b = ins
    before = causal_conv_silu.launches
    with pytest.raises(TypeError):
        causal_conv_silu.forward(x.half(), w, b)
    with pytest.raises(ValueError):
        causal_conv_silu.forward(x.transpose(1, 2), w[:16], b[:16])
    with pytest.raises(ValueError):
        causal_conv_silu.forward(x, torch.cat([w, w[:, :1]], 1), b)
    with pytest.raises(ValueError):
        causal_conv_silu.forward(x, w.cpu(), b)
    assert causal_conv_silu.launches == before
