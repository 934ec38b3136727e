"""On the card: each cell at a toy size, traced, gives its kernels' device
time through their launching ranges, and reads no share over 100%.
Run on the chip with ``python -m pytest -m gpu perfbench/tests``."""
import pytest
import torch

from perfbench.tests import toy


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return toy.toy_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell, share", [
    ("train.mamba2-2.7b.profiled", "train.k3_roofline")])
def test_traced_run_reads_kernel_time_on_the_card(card, bench, cell, share):
    from perfbench.harness import run_cell
    import time
    res = run_cell(cell, 2**31 + 77, 0.5, True, bench_dir=bench,
                   spec=toy.SPEC, t_start=time.perf_counter(),
                   emit=lambda line: None)
    assert res["correct"], res
    assert 0 < res["metrics"][share]["value"] <= 100.0
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
