"""Algorithm 1 in the PyTorch port against the JAX reference.

The port's host backends (``python``, ``numpy``) are copies of the
reference's and must agree bitwise.  Its ``torch`` backend, the plain torch
version of kernel K1, must give the python oracle's counts exactly and its
moments to 1e-5 (float64 prefix sums in another order than the oracle's).
The reference's Pallas kernel runs here in interpret mode.  The parity
cases hold the plain version to the oracle and to the Pallas kernel within
1e-7 with the count divided by n (both give float32 moments and fractions).
"""
import numpy as np
import pytest

from repro.core.events import FunctionEvent as RefEvent
from repro.core.events import Kind as RefKind
from repro.core.events import SampleStream as RefStream
from repro.core.events import WorkerProfile as RefProfile
from repro.core.patterns import critical_duration
from repro.kernels.pattern_summary import pattern_summary as pallas_summary
from repro.kernels.ref import pattern_summary_oracle
from repro.summarize.backends import NumpyBackend as RefNumpy
from repro.summarize.backends import PythonBackend as RefPython
from repro.summarize.engine import summarize_profile as ref_summarize_profile

from repro_torch.core.events import profile_from_reference
from repro_torch.summarize import ENV_BACKEND, get_backend, summarize_profile

from _prop import given, settings, st
from _torch_inputs import (RANDOM_CASES, case, edge_rows, long_row, matrices,
                           sparse_rows)
# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

ATOL = 1e-5
PARITY_ATOL = 1e-7   # float32 outputs of the oracle and the Pallas kernel

#: (E, n, density) of the parity cases: a single sample to rows past the
#: warp variant's 2048-sample cap, sparse to dense; row 0 is all zero
PARITY_CASES = [(3, 1, 0.5), (5, 2, 0.5), (4, 33, 0.3), (8, 97, 0.02),
                (8, 256, 0.9), (6, 1101, 0.5), (8, 2049, 0.1),
                (8, 4096, 0.02), (8, 4096, 0.9)]
#: row lengths of the one-run cases: the fleet's groups (121, 211, 1101)
#: and lengths on either side of a warp's 32 lanes
ONE_RUN_LENGTHS = [1, 31, 33, 121, 211, 1101]


def _torch_stats(u):
    return get_backend("torch", "cpu").batch_stats(u)


def _assert_matches_oracle(out, ref):
    np.testing.assert_array_equal(out[:, 2], ref[:, 2])       # counts exact
    np.testing.assert_allclose(out[:, :2], ref[:, :2], rtol=0, atol=ATOL)


# -- host backends: copies of the reference, bitwise --------------------------

@pytest.mark.parametrize("name,ref_cls", [("python", RefPython),
                                          ("numpy", RefNumpy)])
def test_host_backends_bitwise_equal_reference(name, ref_cls):
    be = get_backend(name, "cpu")
    for u in matrices():
        np.testing.assert_array_equal(be.batch_stats(u),
                                      ref_cls().batch_stats(u))


# -- the plain torch version of K1 against the python oracle ------------------

@pytest.mark.parametrize("seed,E,n", RANDOM_CASES)
def test_torch_backend_matches_python_oracle_randomized(seed, E, n):
    u = case(seed, E, n)
    _assert_matches_oracle(_torch_stats(u), RefPython().batch_stats(u))


def test_torch_backend_matches_python_oracle_edge_rows():
    u = edge_rows()
    out = _torch_stats(u)
    _assert_matches_oracle(out, RefPython().batch_stats(u))
    np.testing.assert_array_equal(out[0], [0.0, 0.0, 64.0])   # all-zero row
    assert out[4, 2] == 40                                    # both bursts


def test_torch_backend_matches_python_oracle_long_row():
    u = long_row()
    _assert_matches_oracle(_torch_stats(u), RefPython().batch_stats(u))


def test_torch_backend_matches_python_oracle_sparse_rows():
    u = sparse_rows()
    _assert_matches_oracle(_torch_stats(u), RefPython().batch_stats(u))


def test_torch_backend_matches_pallas_interpret():
    u = case(11, 64, 256)
    pal = np.asarray(pallas_summary(u, interpret=True), np.float64)
    out = _torch_stats(u)
    np.testing.assert_allclose(out[:, :2], pal[:, :2], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(np.rint(pal[:, 2] * u.shape[1]), out[:, 2])


# -- parity: the plain version, the oracle and the Pallas kernel ---------------

def parity_case(E, n, density, seed=1):
    """Positive samples at ``density``, uniform in [0.05, 1); row 0 all
    zero."""
    rng = np.random.default_rng(seed)
    keep = rng.random((E, n)) < density
    u = (keep * rng.uniform(0.05, 1.0, (E, n))).astype(np.float32)
    u[0] = 0.0
    return u


def one_run_rows(n, seed=2):
    """Rows whose positive samples form one run (the fleet's rows), the run
    starting at every offset (every ``n // 48``-th past 48) with lengths
    that vary from row to row."""
    rng = np.random.default_rng(seed)
    starts = range(0, n, max(1, n // 48))
    u = np.zeros((len(starts), n), np.float32)
    for r, a in enumerate(starts):
        b = a + 1 + (a * 7919) % (n - a)
        u[r, a:b] = rng.uniform(0.05, 1.0, b - a)
    return u


def _assert_parity(u):
    n = u.shape[1]
    out = _torch_stats(u)
    got = np.stack([out[:, 0], out[:, 1], out[:, 2] / n], axis=1)
    oracle = pattern_summary_oracle(u).astype(np.float64)
    pallas = np.asarray(pallas_summary(u, interpret=True), np.float64)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=PARITY_ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=PARITY_ATOL)


@pytest.mark.parametrize("E,n,density", PARITY_CASES)
def test_plain_version_parity_random_density(E, n, density):
    _assert_parity(parity_case(E, n, density))


@pytest.mark.parametrize("n", ONE_RUN_LENGTHS)
def test_plain_version_parity_one_run_rows(n):
    _assert_parity(one_run_rows(n))


@settings(max_examples=150, deadline=None)
@given(st.data())
def test_one_run_row_region_is_first_to_last_positive(data):
    """K1's pass-0 shortcut: a row whose positive-sample count is last -
    first + 1 has the region [first, last + 1) in the oracle, and the plain
    version counts it."""
    n = data.draw(st.integers(1, 400))
    a = data.draw(st.integers(0, n - 1))
    b = data.draw(st.integers(a + 1, n))
    vals = data.draw(st.lists(st.floats(2.0 ** -10, 1.0, width=32),
                              min_size=b - a, max_size=b - a))
    row = np.zeros(n, np.float32)
    row[a:b] = vals
    pos = np.flatnonzero(row > 0)
    first, last = int(pos[0]), int(pos[-1])
    assert len(pos) == last - first + 1
    assert critical_duration(row) == (first, last + 1)
    assert _torch_stats(row[None])[0, 2] == last + 1 - first


# -- engine: one worker's patterns --------------------------------------------

def _ref_profile(seed=0, rate=1000.0, T=4.0):
    rng = np.random.default_rng(seed)
    n = int(T * rate)
    gpu = np.clip(rng.normal(0.7, 0.2, n), 0, 1)
    cpu = np.clip(rng.normal(0.3, 0.2, n), 0, 1)
    gpu[1500:2100] = 0.0
    events = [
        RefEvent("matmul", RefKind.GPU, 0.0, 1.4, 0),
        RefEvent("matmul", RefKind.GPU, 1.5, 2.9, 0),
        RefEvent("allreduce", RefKind.COMM, 2.0, 3.1, 0),
        RefEvent("data.next", RefKind.PYTHON, 3.1, 3.9, 0, depth=1),
        RefEvent("h2d", RefKind.MEM, 0.2, 0.4, 0),      # no membw stream
    ]
    return RefProfile(worker=0, window=(0.0, T), events=events,
                      streams={"gpu_sm": RefStream(rate, 0.0, gpu),
                               "pcie_tx": RefStream(rate, 0.0, gpu * 0.5),
                               "cpu": RefStream(rate, 0.0, cpu)})


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_summarize_profile_matches_reference(backend):
    ref_prof = _ref_profile()
    ref, ref_kinds = ref_summarize_profile(ref_prof, backend="numpy")
    out, kinds = summarize_profile(profile_from_reference(ref_prof),
                                   backend=get_backend(backend, "cpu"))
    assert list(out) == list(ref)
    assert {k: int(v) for k, v in kinds.items()} == \
        {k: int(v) for k, v in ref_kinds.items()}
    for name in ref:
        if backend == "numpy":
            np.testing.assert_array_equal(out[name].as_array(),
                                          ref[name].as_array())
        else:
            np.testing.assert_allclose(out[name].as_array(),
                                       ref[name].as_array(), atol=1e-6)


# -- backend registry: no fallback --------------------------------------------

@pytest.mark.parametrize("name", ["bogus", "pallas"])
def test_unregistered_backend_raises(name, monkeypatch):
    with pytest.raises(KeyError, match="registered"):
        get_backend(name, "cpu")
    monkeypatch.setenv(ENV_BACKEND, name)
    with pytest.raises(KeyError):
        get_backend(None, "cpu")


def test_backend_defaults_follow_env_then_device(monkeypatch):
    monkeypatch.delenv(ENV_BACKEND, raising=False)
    assert get_backend(None, "cpu").name == "torch"
    monkeypatch.setenv(ENV_BACKEND, "numpy")
    assert get_backend(None, "cpu").name == "numpy"
    assert get_backend("python", "cpu").name == "python"
    with pytest.raises(ValueError):
        get_backend("cuda", "cpu")
