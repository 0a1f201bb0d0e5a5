"""Build native libraries from the package's own sources, on first use.

Every native piece of the port is a plain C interface compiled into a
shared library and loaded with ctypes: CUDA sources with `nvcc`, the host
oracle with `g++`. Libraries go to `stringsearch_torch/_build/` (listed in
`.gitignore`), named by a hash of the sources and the compile command, so
an edited source or flag builds a fresh library instead of loading a stale
one. The compiler writes to a per-process temporary name that is renamed
into place, so concurrent processes (test workers) never load a half-written
file. Importing this module compiles nothing.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")

# Hopper only: `sm_90a` keeps wgmma/setmaxnreg available to later kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is not installed."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_library(name: str, sources: list[str], command: list[str]) -> str:
    """Compile `sources` with `command` into `_build/lib<name>-<hash>.so`.

    `command` is the compiler and its flags without sources or `-o`.
    Returns the library path; an existing library of the same hash is
    reused. Raises RuntimeError with the compiler's output on failure.
    """
    h = hashlib.sha256()
    h.update("\0".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    proc = subprocess.run([*command, "-o", tmp, *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(command)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path
