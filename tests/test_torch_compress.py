"""The port's gradient compression (``optim.compress``) against the
reference's, on the CPU.

* ``quantize_int8`` / ``dequantize_int8`` / ``compress_tree_int8`` equal the
  reference bit for bit (both round half to even), on random gradients,
  halves exactly on the rounding boundary, zeros, and over three steps of
  error feedback.
* ``psum_compressed`` over a one-rank ``gloo`` group: ``none`` returns the
  gradients, ``int8`` the reference's dequantized values and residual bit
  for bit, ``bf16`` the bf16 round trip; an unknown method raises.  The
  8-rank twin of the reference's ``test_grad_compression_psum`` is in
  tests/test_torch_dist.py.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compress as RC

from repro_torch.optim import compress as C

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1, (16, 32)).astype(np.float32),
            "b": {"c": (rng.normal(0, 1e-3, (7,)) * 3).astype(np.float32),
                  "z": np.zeros((4,), np.float32)}}


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_quantize_int8_is_the_reference_bit_for_bit():
    for seed in range(4):
        x = np.random.default_rng(seed).normal(0, 2, (64, 33)) \
            .astype(np.float32)
        q, s = C.quantize_int8(torch.from_numpy(x))
        rq, rs = RC.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        _eq(q, rq)
        _eq(s, rs)
        _eq(C.dequantize_int8(q, s), RC.dequantize_int8(rq, rs))
    # values on the rounding boundary: x / scale = k + 0.5 exactly
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5], np.float32)
    q, _ = C.quantize_int8(torch.from_numpy(x))
    _eq(q, RC.quantize_int8(jnp.asarray(x))[0])
    np.testing.assert_array_equal(q.numpy()[1:4], [0, 2, 2])


def test_compress_tree_int8_error_feedback_matches_reference():
    res, rres = None, None
    for step in range(3):
        g = _grads(step)
        quant, res = C.compress_tree_int8(_t(g), res)
        rquant, rres = RC.compress_tree_int8(
            jax.tree_util.tree_map(jnp.asarray, g), rres)
        _eq(quant["a"][0], rquant["a"][0])
        _eq(quant["a"][1], rquant["a"][1])
        _eq(quant["b"]["c"][0], rquant["b"]["c"][0])
        _eq(quant["b"]["z"][0], rquant["b"]["z"][0])
        _eq(res["a"], rres["a"])
        _eq(res["b"]["c"], rres["b"]["c"])
        _eq(res["b"]["z"], rres["b"]["z"])
    assert C.compression_ratio("int8") == RC.compression_ratio("int8") == 4.0
    assert [C.compression_ratio(m) for m in ("none", "bf16")] == [1.0, 2.0]


@pytest.fixture
def one_rank_group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_psum_compressed_on_one_rank_is_the_reference_round_trip(
        one_rank_group):
    g = _grads(5)
    out, _ = C.psum_compressed(_t(g), one_rank_group, "none")
    _eq(out["a"], g["a"])
    out, _ = C.psum_compressed(_t(g), one_rank_group, "bf16")
    _eq(out["b"]["c"], jnp.asarray(g["b"]["c"], jnp.bfloat16)
        .astype(jnp.float32))
    out, res = C.psum_compressed(_t(g), one_rank_group, "int8")
    rquant, rres = RC.compress_tree_int8(
        jax.tree_util.tree_map(jnp.asarray, g), None)
    for k in ("a",):
        _eq(out[k], RC.dequantize_int8(*rquant[k]))
        _eq(res[k], rres[k])
    _eq(out["b"]["c"], RC.dequantize_int8(*rquant["b"]["c"]))
    with pytest.raises(ValueError):
        C.psum_compressed(_t(g), one_rank_group, "fp8")
