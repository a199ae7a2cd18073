"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface; code the kernels share
lives in ``csrc/*.cuh`` headers. At first use a source is compiled with
``nvcc`` for ``sm_90a`` into ``kbner_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``. The library's file name carries
a hash of the source, the headers and the flags, so an edited source or
header builds anew; a finished build is reused by later processes. Nothing
here runs at import time: the CPU tests import every module of the package
on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}  # one CDLL per kernel per process


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of kbner_tpu_torch are built from "
            "csrc/ at first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    compiler output (the ``-Xptxas -v`` register and shared-memory report);
    raises if ``nvcc`` fails."""
    out = library_path(name)
    if out.is_file():
        return "(already built)"
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
