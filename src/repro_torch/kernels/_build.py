"""Build helper shared by the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (it may
include the ``csrc/*.cuh`` headers), compiled by ``nvcc`` for ``sm_90a``
into a shared library under ``_build/`` beside this package (the file name
carries a hash of the source, the headers and the flags, so an edited
source or header rebuilds) and loaded with ``ctypes`` by its wrapper.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path, stem: str) -> Path:
    """Where the library built from ``source`` with ``NVCC_FLAGS`` lives: its
    name carries a hash of the source, of every header in ``CSRC`` (a
    source may include any of them) and of the flags."""
    key = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{key.hexdigest()[:16]}.so"


def build_all(specs: Sequence[Tuple[Path, str]]) -> List[Path]:
    """Compile every ``(source, stem)`` whose library is not built yet, all
    ``nvcc`` processes at once; returns the libraries' paths in order.  Each
    compiler's ``-Xptxas -v`` report is kept beside its library as ``.log``.
    Raises on the first failed build, after every process has ended."""
    libs = [library_path(src, stem) for src, stem in specs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for (src, _), lib in zip(specs, libs):
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(source: Path, stem: str) -> Path:
    return build_all([(source, stem)])[0]
