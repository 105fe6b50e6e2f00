"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources in ``tpufeat_torch/csrc/*.cu`` have a plain C interface (no
PyTorch headers), so one nvcc call builds them in seconds. The library goes
into ``tpufeat_torch/_build/<hash>/``, keyed by a hash of the sources and
the flags, at the first call that needs it — never at import. A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: pathlib.Path
    log: str               # nvcc's output, -Xptxas -v lines included
    build_seconds: float   # 0.0 when an earlier build was reused


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def load(csrc: str) -> Built:
    """Build (if needed) and load the library of every ``*.cu`` in ``csrc``."""
    sources = sorted(pathlib.Path(csrc).glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {csrc}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so, log = out_dir / "libtpufeat_kernels.so", out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"build.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)        # atomic: concurrent builds never tear
    text = log.read_text() if log.exists() else ""
    return Built(ctypes.CDLL(str(so)), so, text, seconds)
