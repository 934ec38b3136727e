"""The port's model inputs (``models.io``) against the reference's, on the
CPU: ``batch_shapes`` equal for every config and shape, ``input_specs``
meta tensors of the reference's shapes and dtypes, and ``synth_batch``
arrays equal to the reference's (token and label arrays bit for bit,
embeddings after the same cast) for every family and kind."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ALL_SHAPES as R_SHAPES
from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.models import io as RIO

from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.models import io as IO

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

#: one config per frontend: text, vision, audio
FRONTENDS = ["gemma2-2b", "internvl2-1b", "musicgen-medium"]
KINDS = ["train", "prefill", "decode"]


def _np(x):
    return np.asarray(x.astype(jnp.float32)) \
        if x.dtype == jnp.bfloat16 else np.asarray(x)


def test_batch_shapes_and_input_specs_match_reference():
    for name in ARCHS:
        for shape, rshape in zip(ALL_SHAPES, R_SHAPES):
            want = RIO.batch_shapes(R_ARCHS[name], rshape)
            assert IO.batch_shapes(ARCHS[name], shape) == want
            specs = IO.input_specs(ARCHS[name], shape)
            rspecs = RIO.input_specs(R_ARCHS[name], rshape)
            assert list(specs) == list(rspecs)
            for k, t in specs.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == rspecs[k].shape
                assert str(t.dtype).split(".")[-1] == str(rspecs[k].dtype)


@pytest.mark.parametrize("arch", FRONTENDS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synth_batch_matches_reference(arch, kind, dtype):
    cfg = reduced(ARCHS[arch]).with_overrides(dtype=dtype)
    rcfg = r_reduced(R_ARCHS[arch]).with_overrides(dtype=dtype)
    for seed in (0, 7):
        got = IO.synth_batch(cfg, kind, 3, 24, seed=seed, device="cpu")
        want = RIO.synth_batch(rcfg, kind, 3, 24, seed=seed)
        assert list(got) == list(want)
        for k, t in got.items():
            w = want[k]
            assert tuple(t.shape) == w.shape
            if k in ("tokens", "labels"):
                assert t.dtype == torch.int32 and w.dtype == jnp.int32
                np.testing.assert_array_equal(t.numpy(), np.asarray(w))
            else:
                assert str(t.dtype).split(".")[-1] == str(w.dtype)
                np.testing.assert_array_equal(t.float().numpy(), _np(w))


def test_synth_batch_without_a_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(ARCHS["gemma2-2b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IO.synth_batch(cfg, "train", 1, 8)
    assert IO.synth_batch(cfg, "train", 1, 8, device="cpu")["tokens"] \
        .device.type == "cpu"
