"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources in ``tpufeat_torch/csrc/*.cu`` have a plain C interface (no
PyTorch headers): one nvcc process per source compiles them all at once,
so the build takes the slowest source's time rather than the sum, then one
links the library. It goes into ``tpufeat_torch/_build/<hash>/``, keyed by
a hash of the sources and the flags, at the first call that needs it —
never at import. A failed build raises with nvcc's output. ``build.log``
holds each source's compile seconds and nvcc's output.
"""

from __future__ import annotations

import concurrent.futures
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so, log = out_dir / "libtpufeat_kernels.so", out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        tmp = out_dir / f"build.{tag}.so"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        compiled = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources, objs)])
        (linked, _), = _run([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)]])
        seconds = time.perf_counter() - t0
        text = "".join(f"{src.name}: nvcc {secs:.2f} s\n{out}"
                       for src, (out, secs) in zip(sources, compiled))
        text += linked
        for obj in objs:
            obj.unlink()
        log.write_text(text)
        os.replace(tmp, so)        # atomic: concurrent builds never tear
    text = log.read_text() if log.exists() else ""
    return Built(ctypes.CDLL(str(so)), so, text, seconds)


def _run(cmds: list) -> list[tuple[str, float]]:
    """Run the commands at once and wait for all of them: each one's output
    and seconds, or RuntimeError with the failed ones' output."""
    def one(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(one, cmds))
    failed = [f"nvcc failed with exit code {proc.returncode}: "
              f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
              for cmd, (proc, _) in zip(cmds, done) if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [(proc.stdout + proc.stderr, secs) for proc, secs in done]
