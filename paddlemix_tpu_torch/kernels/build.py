"""Build `csrc/<name>.cu` with nvcc into a shared library and load it.

Each source has a plain C interface (pointers, ints, the stream) and is bound
with ctypes, so a build takes seconds instead of the minutes a source that
includes PyTorch's headers would. Libraries land in `<repo>/build/kernels/`
(listed in .gitignore), named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, and are built at first use: importing this
module compiles nothing. `build_all` builds several sources in parallel, one
nvcc process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build time (0.0 when the library was already built),
#          "ptxas": nvcc's -Xptxas -v register/shared-memory report, "path"}
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels cannot be built")
    return str(path)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load `csrc/<name>.cu`.

    Raises RuntimeError with nvcc's stderr when nvcc is missing or fails."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, ptxas = 0.0, "(already built)"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: another process never loads a partial file
        ptxas = proc.stderr
    build_log[name] = {"seconds": seconds, "ptxas": ptxas, "path": str(out)}
    return ctypes.CDLL(str(out))


def build_all(names) -> Dict[str, ctypes.CDLL]:
    """Build and load several sources at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load_library, names)))
