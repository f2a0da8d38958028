"""Compile-on-first-use for the native key-value engine (kvstore.cc).

The library is built with g++ into `kubernetes_tpu_torch/_build/`
(listed in .gitignore) under a name keyed by a hash of the source and
the flags, so a changed source gets a new library and one already built
is reused. Concurrent builders (two processes of a split deployment
starting together) compile to per-process temporary names and install
with os.replace: a race wastes a compile, never serves a torn file.

Unlike the JAX package's builder, nothing here degrades: a missing
compiler, an unwritable directory or a compile error raises
NativeBuildError with the compiler's output. There is no fallback store.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native library could not be built; the message carries the
    command and the compiler's output."""


def library_path(src: str, build_dir: str = BUILD_DIR) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir,
                        f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_native(src: str, compiler: str = "g++",
                 build_dir: str = BUILD_DIR) -> str:
    """-> the path of the shared library built from `src`, compiling it
    now if no library of this source exists yet. Raises
    NativeBuildError on any failure. (`compiler` and `build_dir` let a
    test put a failing or counting compiler and a scratch directory in
    their places.)"""
    with _lock:
        try:
            out = library_path(src, build_dir)
        except OSError as e:
            raise NativeBuildError(f"cannot read {src}: {e}") from e
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [compiler, *GXX_FLAGS, src, "-o", tmp]
        try:
            os.makedirs(build_dir, exist_ok=True)
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise NativeBuildError(
                f"{' '.join(cmd)}: {e}") from e
        try:
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"{' '.join(cmd)} exited {proc.returncode}:\n"
                    f"{proc.stdout}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out
