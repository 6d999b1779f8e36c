"""Build and bind the hand-written CUDA kernels of ``dicp_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``dicp_tpu_torch/_build/lib<name>-<hash>.so`` at first use; the
hash covers the source text and the flags, so an edited source rebuilds and
an unchanged one is loaded as built.  The library is bound with ``ctypes``:
no PyTorch header is compiled, which keeps a build to seconds.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

# --fmad=false: no multiply-add contraction, so kernel arithmetic rounds
# exactly like the unfused elementwise PyTorch ops of the plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin): "
                       "the CUDA kernels of dicp_tpu_torch cannot be built")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.

    Returns the library's path.  The compiler's output (including the
    ``-Xptxas=-v`` register and shared-memory report) is kept beside it as
    ``<library>.log``."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        Path(str(lib) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
