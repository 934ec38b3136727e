"""The port's launchers on the CPU: the training CLI (``launch.train``, the
reference's flags, ``main(argv)``) and the mesh constructors
(``launch.mesh``).  Imports no JAX."""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as CLI

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

#: the reference's flags (src/repro/launch/train.py)
REFERENCE_FLAGS = ["--arch", "--reduced", "--steps", "--batch", "--seq",
                   "--lr", "--ckpt-dir", "--ckpt-every", "--remat", "--mesh",
                   "--grad-compress", "--no-perftracker",
                   "--inject-slow-dataloader"]


def test_cli_takes_the_reference_flags():
    args = CLI.parse_args(["--reduced", "--steps", "7", "--remat", "dots",
                           "--grad-compress", "int8", "--mesh", "none",
                           "--inject-slow-dataloader", "0.01", "--lr",
                           "0.001", "--ckpt-every", "3"])
    assert (args.arch, args.steps, args.remat, args.grad_compress) == \
        ("gemma2-2b", 7, "dots", "int8")
    assert (args.batch, args.seq, args.device, args.layers) == \
        (4, 128, None, 0)
    text = CLI.parse_args.__code__.co_consts
    for flag in REFERENCE_FLAGS:
        assert flag in text
    with pytest.raises(SystemExit):
        CLI.parse_args(["--mesh", "pod"])


def test_cli_trains_and_checkpoints_on_the_cpu(tmp_path, capsys):
    trainer, res = CLI.main(["--reduced", "--steps", "4", "--batch", "2",
                             "--seq", "32", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "2", "--layers", "2"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out
    assert trainer.cfg.num_layers == 2 and trainer.device.type == "cpu"
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert trainer.ckpt.steps() == [2, 4]
    assert trainer.pt is not None            # --no-perftracker not given
    trainer2, _ = CLI.main(["--reduced", "--steps", "1", "--batch", "2",
                            "--seq", "32", "--device", "cpu",
                            "--no-perftracker", "--ckpt-dir",
                            str(tmp_path)])
    assert trainer2.pt is None
    assert trainer2.ckpt.latest_step() == 5  # resumed at 4, one more step


def test_cli_without_a_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["--reduced", "--steps", "1"])


def test_cli_mesh_runs_under_torchrun_only(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        CLI.main(["--reduced", "--steps", "1", "--device", "cpu",
                  "--mesh", "single"])


def test_meshes_name_the_world_size_they_need():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="256 ranks"):
            MESH.make_production_mesh(device_type="cpu")
        with pytest.raises(RuntimeError, match="512 ranks"):
            MESH.make_production_mesh(multi_pod=True, device_type="cpu")
        m = MESH.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.size() == 1
    finally:
        dist.destroy_process_group()
