"""K6 (``repro_torch.kernels.cross_entropy``): its plain versions against
the composed ops of the training loss it replaces on the card, bit for bit
(the loss and its gradients), what its autograd function saves, its custom
ops' fake implementations, where the models route the loss, its count, and
(marked ``gpu``) the kernel against the composed ops on a CUDA device.

This file imports neither JAX nor the reference package, so it also runs
on the card's machine:  ``python -m pytest -q -m gpu tests/test_torch_loss.py``.
Without a CUDA device the ``gpu`` tests skip.
"""
import contextlib
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.kernels import cross_entropy as K6
from repro_torch.kernels.cross_entropy import (
    cross_entropy, cross_entropy_backward_reference, cross_entropy_reference)
from repro_torch.launch.step_cost import count_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Transformer

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

#: mamba2-2.7b's published vocabulary, its head as the port pads it (a
#: multiple of 256), and the published Zamba2-7B's
MAMBA2_VOCAB, MAMBA2_PADDED, ZAMBA2_VOCAB = 50_277, 50_432, 32_000
GEMMA2_SOFTCAP = 30.0


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _inputs(seed, rows, V, vocab, dtype, device="cpu", scale=2.0):
    """The head's product h (rows, V), labels below ``vocab`` with every
    fifth row padding (-1 or -100), and the nll's gradient, from the
    seed."""
    g = _gen(seed, device)
    h = (scale * torch.randn(rows, V, generator=g, device=device)).to(dtype)
    labels = torch.randint(0, vocab, (rows,), generator=g, device=device,
                           dtype=torch.int32)
    labels[::5] = -1
    labels[3::10] = -100
    dnll = torch.rand(rows, generator=g, device=device) / rows
    return h, labels, torch.where(labels >= 0, dnll, 0.0)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


#: (softcap, V, vocab size, product type): mamba2's head (no softcap, no
#: padding), gemma2-2b's softcap with padded columns, and both in f32
CPU_CASES = [(0.0, 61, 61, torch.bfloat16), (GEMMA2_SOFTCAP, 64, 53,
                                             torch.bfloat16),
             (0.0, 64, 53, torch.float32), (GEMMA2_SOFTCAP, 61, 61,
                                            torch.float32)]
CPU_IDS = [f"cap{int(c)}-V{v}-vocab{n}-{str(t)[6:]}" for c, v, n, t in CPU_CASES]


def _parent_loss(head, x, labels, vocab_size, softcap):
    """The training loss as the port computed it before K6
    (``layers.lm_logits``, then ``layers.cross_entropy``)."""
    logits = (x @ head.t()).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    keep = torch.arange(logits.shape[-1]) < vocab_size
    logits = torch.where(keep, logits, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    total = mask.sum().clamp(min=1.0)
    return ((lse - ll) * mask).sum() / total, total


# -- the plain versions against the composed ops -------------------------------

@pytest.mark.parametrize("softcap,V,vocab,dtype", CPU_CASES, ids=CPU_IDS)
def test_plain_forward_is_the_models_composed_ops(softcap, V, vocab, dtype):
    """``layers.lm_logits`` and ``cross_entropy_sums`` are K6's plain
    versions, and give the loss as the port computed it before K6."""
    g = _gen(1)
    x = torch.randn(3, 7, 16, generator=g).to(dtype)
    head = (2 * torch.randn(V, 16, generator=g)).to(dtype)
    labels = torch.randint(0, vocab, (3, 7), generator=g, dtype=torch.int32)
    labels[0, 2] = labels[2, 6] = -1
    logits = L.lm_logits(head, x, softcap)
    assert torch.equal(logits, K6.logits_reference(x @ head.t(), softcap))
    lse, nll = cross_entropy_reference(x @ head.t(), labels, vocab, softcap)
    assert lse.dtype == nll.dtype == torch.float32
    assert lse.shape == nll.shape == labels.shape
    want = _parent_loss(head, x, labels, vocab, softcap)
    got = L.cross_entropy(logits, labels, vocab)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    via_rows = L.mean_nll(*L.masked_sums(nll, labels))
    assert all(torch.equal(a, b) for a, b in zip(via_rows, want))


@pytest.mark.parametrize("through", ["function", "ops"])
@pytest.mark.parametrize("softcap,V,vocab,dtype", CPU_CASES, ids=CPU_IDS)
def test_k6_on_the_cpu_gives_the_composed_loss_and_gradients_bit_for_bit(
        softcap, V, vocab, dtype, through):
    """K6's autograd function, and its two custom ops called by hand, on
    CPU tensors: the loss and the gradients of x and the head are those of
    autograd through the composed ops, bit for bit (padding rows with -1
    and -100 included)."""
    g = _gen(2)
    x = torch.randn(2, 9, 16, generator=g).to(dtype).requires_grad_(True)
    head = (2 * torch.randn(V, 16, generator=g)).to(dtype) \
        .requires_grad_(True)
    labels = torch.randint(0, vocab, (2, 9), generator=g, dtype=torch.int32)
    labels[0, ::4] = -1
    labels[1, 5] = -100
    want = _parent_loss(head, x, labels, vocab, softcap)
    want_grads = torch.autograd.grad(want[0], (x, head))
    h = x @ head.t()
    if through == "function":
        rows = cross_entropy(h, labels, vocab, softcap)
        got = L.mean_nll(*L.masked_sums(rows, labels))
        grads = torch.autograd.grad(got[0], (x, head))
    else:
        flat, lab = h.detach().reshape(-1, V), labels.reshape(-1)
        lse, nll = torch.ops.repro_torch.cross_entropy_fwd(flat, lab, vocab,
                                                           softcap)
        nll = nll.reshape(labels.shape).requires_grad_(True)
        got = L.mean_nll(*L.masked_sums(nll, labels))
        (dnll,) = torch.autograd.grad(got[0], nll)
        dh = torch.ops.repro_torch.cross_entropy_bwd(
            dnll.reshape(-1), flat, lse, lab, vocab, softcap)
        grads = torch.autograd.grad(h, (x, head), dh.reshape(h.shape))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for a, b in zip(grads, want_grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_label_in_the_padded_columns_gives_the_composed_ops_nll():
    """The composed ops mask the padded columns with float32's lowest value,
    so a label there gives an nll of float32's largest and no gradient; a
    padding row's nll is its label clamped to 0."""
    h = torch.randn(3, 12)
    labels = torch.tensor([10, -1, 3], dtype=torch.int32)
    lse, nll = cross_entropy_reference(h, labels, 8, 0.0)
    assert float(nll[0]) == torch.finfo(torch.float32).max
    assert torch.equal(nll[1], lse[1] - h[1, 0])
    dh = cross_entropy_backward_reference(torch.ones(3), h, lse, labels, 8,
                                          0.0)
    assert torch.equal(dh[:, 8:], torch.zeros(3, 4))


# -- the autograd function -------------------------------------------------------

def _saved(fn):
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = fn()
    return out, saved


def test_function_saves_the_product_one_lse_a_row_and_the_labels():
    """h, a float32 lse a row and the labels, by storage; the composed ops
    keep the masked float32 logits besides: rows V 4 bytes more."""
    rows, V = 64, 512
    h, labels, _ = _inputs(3, rows, V, V - 7, torch.bfloat16)
    h.requires_grad_(True)
    nll, saved = _saved(lambda: cross_entropy(h, labels, V - 7))
    assert nll.shape == labels.shape and nll.dtype == torch.float32
    assert [t.data_ptr() for t in saved][::2] == [h.data_ptr(),
                                                   labels.data_ptr()]
    assert _nbytes(*saved) == _nbytes(h, labels) + rows * 4
    _, composed = _saved(lambda: K6.rows_reference(
        K6.logits_reference(h, 0.0), labels, V - 7))
    assert _nbytes(*composed) - _nbytes(*saved) >= rows * V * 4


# -- the wrapper's host path ------------------------------------------------------

def test_every_call_enters_through_its_custom_op():
    """Each direction is one ``repro_torch::cross_entropy_*`` op call even
    with nothing reading the dispatcher: the op's event is in the profile."""
    from torch.profiler import ProfilerActivity, profile
    h, labels, g = _inputs(4, 6, 40, 40, torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lse, nll = cross_entropy.forward(h, labels, 40, 0.0)
        dh = cross_entropy.backward(g, h, lse, labels, 40, 0.0)
    names = [e.name for e in prof.events()]
    assert names.count("repro_torch::cross_entropy_fwd") == 1
    assert names.count("repro_torch::cross_entropy_bwd") == 1
    want_lse, want = cross_entropy_reference(h, labels, 40, 0.0)
    assert torch.equal(lse, want_lse) and torch.equal(nll, want)
    assert torch.equal(dh, cross_entropy_backward_reference(
        g, h, lse, labels, 40, 0.0))


# -- the custom ops' fake implementations ---------------------------------------

def _fake(mode, tensors, device=None):
    with mode:
        return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device=device or t.device)
                for t in tensors]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations_match_the_real_call(dtype):
    h, labels, g = _inputs(5, 6, 24, 20, dtype)
    lse, nll = cross_entropy.forward(h, labels, 20, GEMMA2_SOFTCAP)
    dh = cross_entropy.backward(g, h, lse, labels, 20, GEMMA2_SOFTCAP)
    mode = FakeTensorMode()
    for device in (None, "cuda"):
        fh, flab, fg, flse = _fake(mode, [h, labels, g, lse], device)
        with mode:
            fout = cross_entropy.forward(fh, flab, 20, GEMMA2_SOFTCAP)
            fdh = cross_entropy.backward(fg, fh, flse, flab, 20,
                                         GEMMA2_SOFTCAP)
        for f, r in zip(list(fout) + [fdh], [lse, nll, dh]):
            assert tuple(f.shape) == tuple(r.shape) and f.dtype == r.dtype
            assert f.device.type == (device or "cpu")
    torch.library.opcheck(torch.ops.repro_torch.cross_entropy_fwd.default,
                          (h, labels, 20, GEMMA2_SOFTCAP),
                          test_utils=("test_schema", "test_faketensor"))
    torch.library.opcheck(torch.ops.repro_torch.cross_entropy_bwd.default,
                          (g, h, lse, labels, 20, GEMMA2_SOFTCAP),
                          test_utils=("test_schema", "test_faketensor"))


def test_fake_implementations_raise_the_card_checks():
    """The checks a launch makes before it reads data, on fake CUDA
    tensors."""
    def cuda(shape, dtype=torch.bfloat16, strides=None):
        return torch.empty_strided(shape, strides or torch.empty(
            shape, device="meta").stride(), dtype=dtype, device="cuda")
    with FakeTensorMode():
        h, labels = cuda((8, 64)), cuda((8,), torch.int32)
        g, lse = cuda((8,), torch.float32), cuda((8,), torch.float32)
        with pytest.raises(TypeError, match="float32 or bfloat16 product"):
            cross_entropy.forward(cuda((8, 64), torch.float16), labels, 64,
                                  0.0)
        with pytest.raises(TypeError, match="int32 or int64 labels"):
            cross_entropy.forward(h, cuda((8,), torch.float32), 64, 0.0)
        with pytest.raises(ValueError, match="contiguous product"):
            cross_entropy.forward(cuda((8, 64), strides=(1, 8)), labels, 64,
                                  0.0)
        with pytest.raises(ValueError, match=r"h \(rows, V\)"):
            cross_entropy.forward(h, cuda((4,), torch.int32), 64, 0.0)
        with pytest.raises(ValueError, match=r"h \(rows, V\)"):
            cross_entropy.forward(h, labels, 0, 0.0)
        with pytest.raises(ValueError, match="float32 gradient"):
            cross_entropy.backward(cuda((8,)), h, lse, labels, 64, 0.0)
        lse2, nll = cross_entropy.forward(h, labels, 64, 0.0)
        dh = cross_entropy.backward(g, h, lse, labels, 64, 0.0)
    assert lse2.shape == nll.shape == (8,) and dh.shape == h.shape
    assert dh.dtype == h.dtype and nll.dtype == torch.float32


# -- where the models route the loss ----------------------------------------------

class _Mesh:
    """A stand-in for a ``DistCtx`` with a mesh: the head and logits pass
    through unsharded."""
    mesh = object()

    @staticmethod
    def shard_vocab(w):
        return w

    @staticmethod
    def constrain_logits(x):
        return x


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "gemma2-2b"])
def test_loss_routes_to_k6_only_card_products_without_a_mesh(arch,
                                                             monkeypatch):
    """Under a dry run's fake tensors, a hidden state on the card takes K6
    (through its fake implementation) with no ``dist`` and with a
    ``dist`` that has no mesh; under a mesh, and on the CPU, the loss runs
    the composed ops (``_cross_entropy``).  ``logits`` (serving, decode)
    never takes K6 and stays f32."""
    cfg = reduced(ARCHS[arch], vocab=500)
    model = Transformer(cfg)
    k6_calls, composed = [], []
    orig_fwd = K6.CrossEntropy.forward

    def spy(self, h, labels, vocab_size, softcap):
        k6_calls.append((tuple(h.shape), h.device.type, vocab_size, softcap))
        return orig_fwd(self, h, labels, vocab_size, softcap)

    def spy_ce(logits, labels, vocab_size, dist=None):
        # the composed loss indexes, which a fake CUDA tensor cannot on a
        # PyTorch built without CUDA: the call is recorded, not run
        composed.append(logits.dtype)
        return logits.sum(), logits.new_ones(())
    monkeypatch.setattr(K6.CrossEntropy, "forward", spy)
    monkeypatch.setattr(T, "_cross_entropy", spy_ce)

    def loss(device, dist):
        model.dist = dist
        with FakeTensorMode() if device == "cuda" \
                else contextlib.nullcontext():
            hidden = torch.ones(2, 8, cfg.d_model, device=device)
            p = {"embed": {"table": torch.ones(cfg.padded_vocab,
                                               cfg.d_model, device=device)},
                 "lm_head": torch.ones(cfg.padded_vocab, cfg.d_model,
                                       device=device)}
            monkeypatch.setattr(model, "forward",
                                lambda p, b: (hidden, None, None))
            batch = {"labels": torch.zeros(2, 8, dtype=torch.int32,
                                           device=device)}
            out, parts = model._loss(p, batch)
            logits = model.logits(p, hidden)
        assert out.shape == () and parts["ntok"].shape == ()
        assert logits.dtype == torch.float32
        assert logits.shape == (2, 8, cfg.padded_vocab)
    from repro_torch.dist.sharding import DistCtx
    loss("cuda", None)
    assert k6_calls == [((16, cfg.padded_vocab), "cuda", 500,
                         cfg.logit_softcap)] and composed == []
    loss("cuda", DistCtx(None))
    assert len(k6_calls) == 2 and composed == []
    loss("cuda", _Mesh())
    assert len(k6_calls) == 2 and composed == [torch.float32]
    loss("cpu", None)
    assert len(k6_calls) == 2 and composed == [torch.float32] * 2


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "gemma2-2b"])
def test_cpu_loss_keeps_the_parents_bits_and_launches_nothing(arch,
                                                              monkeypatch):
    """On the CPU the models never reach K6: a reduced model's loss (bf16;
    gemma2's softcap 30 over 12 padded columns) and every gradient are the
    loss as computed before K6, bit for bit."""
    cfg = reduced(ARCHS[arch], vocab=500).with_overrides(
        dtype="bfloat16", param_dtype="bfloat16")
    model = Transformer(cfg)
    params = model.init(0, device="cpu")
    g = _gen(6)
    batch = {"tokens": torch.randint(0, 500, (2, 16), generator=g,
                                     dtype=torch.int32)}
    batch["labels"] = torch.randint(0, 500, (2, 16), generator=g,
                                    dtype=torch.int32)
    batch["labels"][0, :3] = -1

    def no_k6(*a, **k):
        raise AssertionError("K6 reached on the CPU")
    cross_entropy.reset_counts()
    monkeypatch.setattr(K6._CrossEntropy, "apply", no_k6)
    leaves = [params["embed"]["table"], params["final_norm"]["scale"]]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    hidden, _, _ = model.forward(params, batch)
    head = params["embed"]["table"] if cfg.tie_embeddings \
        else params["lm_head"]
    before, _ = _parent_loss(head, hidden, batch["labels"], cfg.vocab_size,
                             cfg.logit_softcap)
    grads_before = torch.autograd.grad(before, leaves)
    assert cross_entropy.launches == 0
    assert torch.equal(loss, before)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_before))


# -- the count -------------------------------------------------------------------

def test_count_adds_no_flops_and_each_calls_bytes():
    h, labels, g = _inputs(7, 8, 40, 36, torch.bfloat16)
    lse, nll = cross_entropy.forward(h, labels, 36, 0.0)
    dh = cross_entropy.backward(g, h, lse, labels, 36, 0.0)
    hg = h.clone().requires_grad_(True)
    c = count_step(lambda a, b: torch.autograd.grad(
        cross_entropy(hg, labels, 36), hg, g), None, None)
    assert c.flops == 0.0 and c.detail_flops == {}
    assert c.detail_bytes["cross_entropy_fwd"] == _nbytes(h, labels, lse,
                                                          nll)
    assert c.detail_bytes["cross_entropy_bwd"] == _nbytes(g, h, lse, labels,
                                                          dh)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b-instruct",
                                  "gemma2-2b"])
def test_step_counts_k6_once_each_way_and_the_dry_count_equals_it(
        arch, monkeypatch):
    """With the loss routed to K6 on the CPU too (as the card routes it), a
    reduced step of each cell's layout (and gemma2's softcap) counts one
    forward call and one backward call, and the count under a
    ``FakeTensorMode`` (the dry run's) equals it."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_train_step
    monkeypatch.setattr(K6, "takes", lambda t: type(t).__name__ != "DTensor")
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
    fwd, bwd = K6.CrossEntropy.forward, K6.CrossEntropy.backward

    def spy_fwd(self, *a):
        calls["forward"] += 1
        return fwd(self, *a)

    def spy_bwd(self, *a):
        calls["backward"] += 1
        return bwd(self, *a)
    monkeypatch.setattr(K6.CrossEntropy, "forward", spy_fwd)
    monkeypatch.setattr(K6.CrossEntropy, "backward", spy_bwd)
    want = count(False)
    assert calls == {"forward": 1, "backward": 1}
    assert "cross_entropy_fwd" not in want.detail_flops
    assert want.detail_bytes["cross_entropy_bwd"] > 0
    dry = count(True)
    assert (dry.flops, dry.bytes) == (want.flops, want.bytes)
    assert dry.detail_bytes == want.detail_bytes


def test_bound_counts_each_byte_once():
    t = torch.empty((2048, MAMBA2_VOCAB), dtype=torch.bfloat16)
    assert math.isclose(K6.bound_ms([t, t]),
                        2 * 2048 * MAMBA2_VOCAB * 2 / 3.35e12 * 1e3)


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


#: (label, rows, V, vocab size, softcap, type): mamba2-2.7b's head at the
#: published vocabulary (rows off the 16-byte grid) and as the port pads
#: it, the published Zamba2-7B's, gemma2-2b's softcap over padded columns,
#: and an f32 product
K6_CASES = [("mamba2 unaligned", 2048, MAMBA2_VOCAB, MAMBA2_VOCAB, 0.0,
             torch.bfloat16),
            ("mamba2 padded", 2048, MAMBA2_PADDED, MAMBA2_VOCAB, 0.0,
             torch.bfloat16),
            ("zamba2-7b-instruct", 4096, ZAMBA2_VOCAB, ZAMBA2_VOCAB, 0.0,
             torch.bfloat16),
            ("gemma2 softcap", 512, 256_000, 255_900, GEMMA2_SOFTCAP,
             torch.bfloat16),
            ("f32", 300, 5_003, 4_999, 0.0, torch.float32),
            ("f32 softcap", 64, 1_000, 1_000, GEMMA2_SOFTCAP, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K6_CASES, ids=[c[0] for c in K6_CASES])
def test_k6_matches_the_composed_ops_on_card(case):
    """The nll within 1e-5 of the composed ops' (relative, on the card),
    lse within 1e-5; dh within one step of h's type of autograd's through
    the composed ops (f32: 1e-5 of the element, 1e-12 absolute); the
    backward the same bits three times; one launch each way counted."""
    _cuda()
    _, rows, V, vocab, cap, dtype = case
    h, labels, g = _inputs(8, rows, V, vocab, dtype, device="cuda")
    before = dict(cross_entropy.launches_by_direction)
    hg = h.clone().requires_grad_(True)
    nll = cross_entropy(hg, labels, vocab, cap)
    (dh,) = torch.autograd.grad(nll, hg, g)
    lse, _ = cross_entropy.forward(h, labels, vocab, cap)
    again = [cross_entropy.backward(g, h, lse, labels, vocab, cap)
             for _ in range(2)]
    hr = h.clone().requires_grad_(True)
    ref_lse, ref = K6.cross_entropy_reference(hr, labels, vocab, cap)
    (ref_dh,) = torch.autograd.grad(ref, hr, g)
    torch.cuda.synchronize()
    nll, ref, ref_lse = nll.detach(), ref.detach(), ref_lse.detach()
    assert cross_entropy.launches_by_direction == {
        "forward": before["forward"] + 2, "backward": before["backward"] + 3}
    rel = float(((nll - ref).abs() / ref.abs()).max())
    print(f"[k6] {case[0]}: nll max relative error {rel:.3g}, lse "
          f"{float(((lse - ref_lse).abs() / ref_lse.abs()).max()):.3g}")
    assert rel <= 1e-5
    assert float(((lse - ref_lse).abs() / ref_lse.abs()).max()) <= 1e-5
    assert dh.dtype == dtype and dh.shape == h.shape
    assert bool(torch.isfinite(dh).all())
    if dtype == torch.bfloat16:
        steps = _steps(dh, ref_dh)
        print(f"[k6] {case[0]}: dh {int((steps > 0).sum())} of "
              f"{dh.numel()} elements differ, at most {int(steps.max())} "
              f"bf16 step")
        assert int(steps.max()) <= 1
    else:
        assert bool(((dh - ref_dh).abs()
                     <= 1e-5 * ref_dh.abs() + 1e-12).all())
    assert torch.equal(dh[:, vocab:], torch.zeros_like(dh[:, vocab:]))
    for run in again:
        assert torch.equal(run.view(torch.uint8), dh.view(torch.uint8))


@pytest.mark.gpu
def test_k6_rejects_what_it_does_not_take():
    _cuda()
    h, labels, _ = _inputs(9, 16, 64, 64, torch.bfloat16, device="cuda")
    before = cross_entropy.launches
    with pytest.raises(TypeError):
        cross_entropy.forward(h.half(), labels, 64, 0.0)
    with pytest.raises(ValueError):
        cross_entropy.forward(h.t(), labels, 64, 0.0)
    with pytest.raises(ValueError):
        cross_entropy.forward(h, labels.cpu(), 64, 0.0)
    assert cross_entropy.launches == before


def _f32_logit_blocks(step, rows, vocab) -> list:
    """The sizes of the blocks of at least rows x vocab f32 bytes that
    ``step()`` allocates on the card."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        step()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    return [e["size"] for trace in snap["device_traces"] for e in trace
            if e["action"] == "alloc" and e["size"] >= rows * vocab * 4]


@pytest.mark.gpu
def test_mamba2_step_launches_k6_once_each_way_and_holds_no_f32_logits(
        monkeypatch):
    """A reduced mamba2-2.7b step in bf16 at the published vocabulary and
    2048 tokens launches K6 once each way and allocates no f32 (tokens x
    vocab) block on the card; the same step with the loss on the composed
    ops allocates several."""
    _cuda()
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_train_step
    cfg = reduced(ARCHS["mamba2-2.7b"], vocab=MAMBA2_VOCAB).with_overrides(
        dtype="bfloat16", param_dtype="bfloat16")
    rows = 2048
    model, opt = Transformer(cfg), AdamW(OptConfig())
    params = model.init(0, device="cuda")
    state = opt.init(params)
    step = make_train_step(model, opt)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg, DataConfig(batch=1, seq_len=rows)).batch_at(0).items()}

    def run():
        nonlocal params, state
        params, state, _ = step(params, state, batch)
    run()                                          # builds and warms
    cross_entropy.reset_counts()
    blocks = _f32_logit_blocks(run, rows, MAMBA2_VOCAB)
    assert cross_entropy.launches_by_direction == {"forward": 1,
                                                   "backward": 1}
    assert blocks == []
    monkeypatch.setattr(K6, "takes", lambda t: False)
    composed = _f32_logit_blocks(run, rows, MAMBA2_VOCAB)
    print(f"[k6] composed loss: {len(composed)} f32 logit blocks, "
          f"{sum(composed)} bytes")
    assert len(composed) >= 4
    assert cross_entropy.launches_by_direction == {"forward": 1,
                                                   "backward": 1}
