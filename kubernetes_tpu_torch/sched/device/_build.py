"""nvcc build of the package's CUDA sources into plain-C shared libraries.

Each `csrc/*.cu` file is compiled at first use for sm_90a into
`kubernetes_tpu_torch/_build/` (listed in .gitignore), under a name keyed
by a hash of the source and the flags, and loaded with ctypes. A source
that changes gets a new library; one that is already built is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict, List, Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    # CUDA_HOME, CUDA_PATH, nvcc on PATH, then the toolkit's default
    # install location, in PyTorch's own order
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to the "
                           "toolkit whose nvcc builds the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_all(sources: Sequence[str]) -> List[Dict]:
    """Build every source that has no library yet, all nvcc processes
    started together. -> one record per source: library path, seconds
    and the compiler's output (`-Xptxas -v` registers and shared memory).
    Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    t0 = time.monotonic()
    for src in sources:
        out = library_path(src)
        if os.path.exists(out):
            jobs.append((src, out, None, None))
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    records, failed = [], []
    for src, out, tmp, proc in jobs:
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            os.replace(tmp, out)
        records.append({"source": src, "library": out, "log": log,
                        "seconds": time.monotonic() - t0})
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return records


def load_library(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build_all([source])[0]["library"])
