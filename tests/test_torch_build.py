"""The seam between the port's Python and its CUDA libraries
(`stringsearch_torch/ops/_build.py`: `Library`, `on_cuda`), on the CPU.

Every C function a wrapper declares is held against the `extern "C"`
block of its `.cu` source (name, return type, argument count), and every
function a wrapper names is declared. `Library` itself is driven on the
host's C library in place of a build: it declares, checks and loads once,
and a failed build or check leaves it unloaded. Nothing here needs nvcc
or a card.
"""

import ctypes
import ctypes.util
import importlib
import re
import subprocess
import sys

import pytest
import torch

from stringsearch_torch.ops import _build

WRAPPERS = ("bitonic", "radix", "radix_sort", "steps", "merge", "route")
RESTYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "const char*": ctypes.c_char_p}


def _module(name):
    return importlib.import_module(f"stringsearch_torch.ops.{name}")


def _extern_c(source: str) -> dict:
    """{name: (return type, argument count)} of the functions defined in
    the `extern "C"` block of `source`."""
    with open(source) as f:
        text = f.read()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    out = {}
    for ret, name, params in re.findall(
            r"^(const char\*|int64_t|int) (ss_\w+)\(([^)]*)\)", block, re.M):
        out[name] = (ret, len(params.split(",")) if params.strip() else 0)
    return out


@pytest.mark.parametrize("name", WRAPPERS)
def test_declared_functions_are_defined_in_the_source(name):
    """Each function of a wrapper's table is in its source's C interface,
    with the declared return type and as many arguments."""
    lib = _module(name).LIBRARY
    defined = _extern_c(lib.source)
    assert lib.errors in lib.functions
    for fn, (restype, argtypes) in lib.functions.items():
        assert fn in defined, fn
        ret, count = defined[fn]
        assert RESTYPES[ret] is restype, fn
        assert len(argtypes) == count, fn


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_name_only_declared_functions(name):
    """Every C function a wrapper module names, as a string or as an
    attribute, has a declaration: an undeclared one would return a C int,
    cutting an int64 to its low word."""
    module = _module(name)
    with open(module.__file__) as f:
        text = f.read()
    named = set(re.findall(r"""["'.](ss_\w+)\b""", text))
    assert named
    assert named <= set(module.LIBRARY.functions), named - set(
        module.LIBRARY.functions)


def test_importing_the_port_builds_no_library():
    """Importing every module of the package loads no kernel library."""
    code = ("import importlib, sys\n"
            f"names = {WRAPPERS!r}\n"
            "mods = [importlib.import_module('stringsearch_torch.ops.' + n)\n"
            "        for n in names]\n"
            "import stringsearch_torch.harness.profile_build\n"
            "print(sum(m.LIBRARY._lib is not None for m in mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0"


def test_on_cuda_picks_by_device_and_refuses_any_other():
    assert _build.on_cuda(torch.device("cuda"), "x") is True
    assert _build.on_cuda(torch.device("cuda", 3), "x") is True
    assert _build.on_cuda(torch.device("cpu"), "x") is False
    with pytest.raises(ValueError, match="^the planes must lie on the CPU "
                                         "or a CUDA device, got meta$"):
        _build.on_cuda(torch.device("meta"), "the planes")


@pytest.fixture
def host_libc(monkeypatch):
    """`build_library` answering with the host's C library, and a compiler
    path, so that `Library.load` runs without nvcc; records its calls."""
    path = ctypes.util.find_library("c")
    if path is None:
        pytest.skip("no C library found to stand in for a build")
    builds = []

    def build_library(name, sources, command):
        builds.append((name, tuple(sources), tuple(command)))
        return path

    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "build_library", build_library)
    return builds


def _libc(check=None):
    return _build.Library("c", "/src/c.cu", {"abs": (ctypes.c_int,
                                                      [ctypes.c_int])},
                          "strerror", check)


def test_library_loads_declares_and_checks_once(host_libc):
    checked = []
    lib = _libc(checked.append)
    assert not host_libc
    loaded = lib.load()
    assert lib.load() is loaded
    assert host_libc == [("c", ("/src/c.cu",), ("nvcc", *_build.NVCC_FLAGS))]
    assert checked == [loaded]
    assert loaded.abs.restype is ctypes.c_int
    assert loaded.abs.argtypes == [ctypes.c_int]
    assert loaded.abs(-7) == 7
    assert loaded.strerror.restype is ctypes.c_char_p
    assert isinstance(loaded.strerror(2), bytes)


def test_a_failed_check_or_build_leaves_the_library_unloaded(host_libc,
                                                             monkeypatch):
    def refuse(_lib):
        raise RuntimeError("limits differ")

    lib = _libc(refuse)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="limits differ"):
            lib.load()
    assert lib._lib is None and len(host_libc) == 2

    def no_compiler():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_compiler)
    lib = _libc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.load()
    assert lib._lib is None


def test_a_variant_is_named_by_its_file_and_not_checked(host_libc):
    checked = []
    lib = _libc(checked.append)
    variant = lib.variant("/tmp/variants/c_tile_4096.cu")
    assert host_libc == [("c_tile_4096", ("/tmp/variants/c_tile_4096.cu",),
                          ("nvcc", *_build.NVCC_FLAGS))]
    assert variant._lib is not None and lib._lib is None
    assert variant.functions == lib.functions and not checked
