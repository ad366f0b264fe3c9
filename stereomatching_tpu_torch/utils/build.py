"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into a shared library that ``ctypes``
loads.  The library goes to ``build/stereomatching_tpu_torch/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of its
source and flags: an edited source is rebuilt, an unchanged one is
reused.  Nothing falls back: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stereomatching_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of ``nvcc`` in the CUDA toolkit PyTorch's extension builder
    finds (``$CUDA_HOME``, else ``nvcc`` on ``PATH``, else the default
    install location).  Raises ``RuntimeError`` when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if nvcc is not None and os.access(nvcc, os.X_OK):
        return str(nvcc)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of stereomatching_tpu_torch cannot be built"
    )


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (plus the ``*.cuh`` it includes) into
    ``BUILD_DIR`` unless an up-to-date library is there -> its path."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {src.name} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(str(build(name)))
