"""Build native libraries from the package's own sources, on first use.

Every native piece of the port is a plain C interface compiled into a
shared library and loaded with ctypes: CUDA sources with `nvcc`, the host
oracle with `g++`. Libraries go to `stringsearch_torch/_build/` (listed in
`.gitignore`), named by a hash of the sources and the compile command, so
an edited source or flag builds a fresh library instead of loading a stale
one. The compiler writes to a per-process temporary name that is renamed
into place, so concurrent processes (test workers) never load a half-written
file. Importing this module compiles nothing.

Each kernel library is one `Library`, the only code that loads, declares
and calls it; `on_cuda` is the rule by which every wrapper picks its
kernel or its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

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


class Library:
    """One CUDA kernel library: its source, the C functions its wrapper
    calls, and the checks the wrapper makes of it.

    `functions` maps each C function to (restype, argtypes), the launching
    ones with the stream as their last argument; `errors` names the
    function that turns a launch's return code into its message; `check`,
    if given, is called with the loaded library once and raises where its
    limits are not the wrapper's. Making one builds nothing: the first
    `load` (or `call`) builds the source with `nvcc` and NVCC_FLAGS.
    """

    def __init__(self, name: str, source: str, functions: dict,
                 errors: str, check=None):
        self.name = name
        self.source = source
        self.functions = {**functions,
                          errors: (ctypes.c_char_p, [ctypes.c_int])}
        self.errors = errors
        self.check = check
        self._lock = threading.Lock()
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (first call only), load and declare the library."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(build_library(
                        self.name, [self.source], [nvcc(), *NVCC_FLAGS]))
                    for fn, (restype, argtypes) in self.functions.items():
                        getattr(lib, fn).restype = restype
                        getattr(lib, fn).argtypes = argtypes
                    if self.check is not None:
                        self.check(lib)
                    self._lib = lib
        return self._lib

    def variant(self, source: str) -> "Library":
        """The library built from `source`, a patched copy of its source
        with the same C interface, named by its file: built and loaded
        now, and not held to `check`, since a variant may change a
        limit."""
        name = os.path.splitext(os.path.basename(source))[0]
        lib = Library(name, source, self.functions, self.errors)
        lib.load()
        return lib

    def call(self, fn: str, device, *args) -> None:
        """Call `fn` with `args` and the current stream of the CUDA
        `device`. Raises RuntimeError with the library's message where the
        launch failed."""
        lib = self.load()
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{fn} launch failed: "
                f"{getattr(lib, self.errors)(rc).decode()} (code {rc})")


def on_cuda(device: torch.device, what: str) -> bool:
    """Which version of a step runs for tensors on `device`: True (the
    kernel) on a CUDA device, False (the plain version) on the CPU.
    Raises ValueError on any other device, naming the tensors `what`."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what} must lie on the CPU or a CUDA device, got "
                     f"{device}")
