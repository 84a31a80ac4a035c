"""Build and load the port's CUDA kernel.

``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with `ctypes`. The build happens
at first use, from the package's own sources, into ``build/`` beside this
file (git-ignored); the library's file name carries a hash of its source,
so an edited source never loads a stale build. Nothing here runs at import
time."""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_source(source: Path) -> str:
    """Compile `source` unless built already; returns the compiler's
    output (``-Xptxas -v`` register and shared-memory report; empty for a
    library already built). Raises with that output if nvcc fails."""
    out = library_path(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def build(name: str) -> str:
    """Compile kernel ``csrc/<name>.cu`` if needed (see `build_source`)."""
    return build_source(CSRC / f"{name}.cu")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(CSRC / f"{name}.cu")))
