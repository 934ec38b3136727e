"""Utilization matrices shared by the port's kernel and parity tests
(``tests/test_torch_*.py``): numpy-seeded, so both packages see the same
inputs.  Imports neither JAX nor either package."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch's CPU ops on one thread: the suite runs in several worker
    processes, and torch's default of one thread per core would crowd the
    timing-sensitive tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

#: (seed, E, n) of tests/test_summarize.py's randomized parity cases
RANDOM_CASES = [(0, 16, 256), (1, 8, 97), (2, 32, 130), (3, 1, 1), (4, 5, 2),
                (5, 24, 512), (7, 12, 200)]


def rand_matrix(seed, E, n, zero_rows=(), single_rows=(), full_rows=()):
    """The adversarial matrices of tests/test_summarize.py."""
    rng = np.random.default_rng(seed)
    u = np.clip(rng.normal(0.45, 0.3, (E, n)), 0, 1).astype(np.float32)
    for _ in range(max(1, E // 4)):       # sprinkle zero bursts
        i = int(rng.integers(0, E))
        a = int(rng.integers(0, n))
        b = int(rng.integers(a, n)) + 1
        u[i, a:b] = 0
    for i in zero_rows:
        u[i] = 0.0
    for i in single_rows:
        u[i] = 0.0
        u[i, int(n * 0.6)] = 0.7
    for i in full_rows:                   # uniform: 80% mass needs it all
        u[i] = 0.5
    return u


def case(seed, E, n):
    """A randomized case with an all-zero, a single-sample and a full-mass
    row where the shape allows."""
    return rand_matrix(seed, E, n,
                       zero_rows=[0] if E > 2 else [],
                       single_rows=[1] if E > 2 and n > 2 else [],
                       full_rows=[2] if E > 3 else [])


def edge_rows():
    u = np.zeros((6, 64), np.float32)
    u[1, 10] = 0.9                     # single sample
    u[2, :] = 0.25                     # uniform: full window is the region
    u[3, :20] = 0.8                    # contiguous burst
    u[4, 5:10] = 0.5                   # two equal bursts: neither alone holds
    u[4, 40:45] = 0.5                  # 80%, so the region spans both
    u[5, 0] = u[5, 63] = 1.0           # mass only at the two ends
    return u


#: (mean, std, count) of each edge row, worked out by hand
EDGE_EXPECTED = [(0.0, 0.0, 64), (0.9, 0.0, 1), (0.25, 0.0, 64),
                 (0.8, 0.0, 20), (0.125, 0.2165063509461097, 40),
                 (2 / 64, 0.17399263633843817, 64)]


def long_row(n=40000, seed=3):
    """One row of ``n`` samples with 40 zero bursts of up to 3000."""
    rng = np.random.default_rng(seed)
    u = np.clip(rng.normal(0.45, 0.3, (1, n)), 0, 1).astype(np.float32)
    for _ in range(40):
        a = int(rng.integers(0, n))
        u[0, a:a + int(rng.integers(1, 3000))] = 0
    return u


def sparse_rows(E=16, n=2500, seed=9):
    """Rows of isolated nonzero samples at densities from 1% to 60%: many
    zero-runs, so many bisection passes, over several kernel tiles."""
    rng = np.random.default_rng(seed)
    dens = np.linspace(0.01, 0.6, E)[:, None]
    keep = rng.random((E, n)) < dens
    return (keep * rng.random((E, n))).astype(np.float32)


def matrices():
    return [case(*c) for c in RANDOM_CASES] + [edge_rows(), long_row(),
                                               sparse_rows()]
