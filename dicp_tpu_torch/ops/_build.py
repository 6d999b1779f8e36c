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


def _library(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of source and flags."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    see :func:`build_all`."""
    return build_all([name])[name]


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` per source, all started together.

    Returns {name: library path}.  The compiler's output (including the
    ``-Xptxas=-v`` register and shared-memory report) is kept beside each
    library as ``<library>.log``."""
    libs = {name: _library(name) for name in names}
    jobs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        for name, lib in libs.items():
            if lib.exists() or name in jobs:
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, tmp)
        failed = []
        for name, (proc, tmp) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {SRC_DIR / name}.cu "
                              f"(exit {proc.returncode}):\n{err}")
                continue
            Path(str(libs[name]) + ".log").write_text(out + err)
            os.replace(tmp, libs[name])  # atomic: a reader never sees half a library
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
