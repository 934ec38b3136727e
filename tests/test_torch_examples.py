"""The port's examples (``examples_torch/``), each run in a subprocess with
``--device cpu`` at a toy size and its own timeout.

* ``diagnose_ring_fault`` and ``online_demo``'s default scenario print the
  same lines as the reference's ``examples/`` scripts run beside them
  (worker 9 flagged on ``AllGather_RING``, ``replace_hosts [9]``; the
  online demo's incidents, actions and timeline, every line).
* ``online_demo --scenario`` and ``--list-scenarios`` print the reference's
  lines too; ``--mitigate`` drives every incident to ``resolved``.
* ``quickstart`` flags the injected C2P1 fault on the dataloader and acts
  with ``migrate_dataloader``; ``train_lm`` lowers the loss and writes its
  checkpoints; ``serve_lm`` generates its tokens.
* Without ``--device cpu`` on a host with no card, an example raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(path, *args, timeout=60):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(ROOT / path), *args],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=ROOT)
    return p.returncode, p.stdout, p.stderr


def _ok(path, *args, timeout=60):
    rc, out, err = _run(path, *args, timeout=timeout)
    assert rc == 0, out[-2000:] + err[-3000:]
    return out


def test_diagnose_ring_fault_prints_the_reference_lines():
    port = _ok("examples_torch/diagnose_ring_fault.py", "--device", "cpu")
    ref = _ok("examples/diagnose_ring_fault.py")
    assert port == ref
    assert "AllGather_RING                           {9}" in port
    assert "mitigation: replace_hosts [9]" in port


@pytest.mark.parametrize("args", [
    (), ("--scenario", "E3_bad_standby_driver"), ("--list-scenarios",)],
    ids=["default", "scenario", "list"])
def test_online_demo_prints_the_reference_lines(args):
    port = _ok("examples_torch/online_demo.py", "--device", "cpu", *args)
    ref = _ok("examples/online_demo.py", *args)
    assert port == ref
    if not args:
        assert "incident #0: CUDA_GEMM_kernel [resolved]" in port
        assert "=== incident timeline" in port


def test_online_demo_mitigate_resolves_every_incident():
    out = _ok("examples_torch/online_demo.py", "--device", "cpu",
              "--mitigate")
    assert "ENGINE:" in out and "=== fleet after mitigation" in out
    states = [ln for ln in out.splitlines() if ln.startswith("incident #")]
    assert states and all("[resolved]" in ln for ln in states)


def test_quickstart_flags_the_dataloader():
    out = _ok("examples_torch/quickstart.py", "--device", "cpu",
              "--steps", "80", "--fault-step", "30")
    assert ">>> injecting slow-storage fault (case C2P1)" in out
    assert "-> migrate_dataloader" in out
    assert "dataloader.py:__next__" in out and "(C2P1)" in out


def test_train_lm_lowers_the_loss(tmp_path):
    out = _ok("examples_torch/train_lm.py", "--device", "cpu", "--steps",
              "30", "--d-model", "64", "--layers", "2", "--batch", "4",
              "--seq", "32", "--vocab", "256", "--ckpt-dir", str(tmp_path))
    assert "(improved)" in out
    # every 7 steps and the last, the newest three kept
    assert f"checkpoints: [21, 28, 30] in {tmp_path}" in out


def test_serve_lm_generates():
    out = _ok("examples_torch/serve_lm.py", "--device", "cpu",
              "--new-tokens", "6")
    assert "generated (4, 22)" in out
    assert "serving granite-34b (reduced" in out


def test_an_example_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    rc, out, err = _run("examples_torch/diagnose_ring_fault.py")
    assert rc != 0 and "no CUDA device" in err
