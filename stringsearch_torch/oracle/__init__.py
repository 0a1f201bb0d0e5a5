"""Trusted host C++ oracle: independent SA-IS build, checker and search.

Counterpart of stringsearch_tpu/oracle. The same C++ source
(stringsearch_tpu/oracle/csrc/saca.cpp, read by path, so nothing of the
JAX package is imported) is compiled with g++ on first use into the port's
own build directory and bound with ctypes. All arrays here are host
numpy arrays; `sort` returns a SuffixArray on the requested device.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from stringsearch_torch.core.types import BytesLike, SuffixArray, host_u8
from stringsearch_torch.ops import _build

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "stringsearch_tpu", "oracle", "csrc", "saca.cpp")
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """Load (building on first use) the oracle shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build.build_library(
            "saca", [SOURCE],
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"])
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.saca_build.argtypes = [u8p, i32p, ctypes.c_int32]
        lib.saca_build.restype = ctypes.c_int32
        lib.saca_sufcheck.argtypes = [u8p, i32p, ctypes.c_int32]
        lib.saca_sufcheck.restype = ctypes.c_int32
        lib.saca_search.argtypes = [u8p, ctypes.c_int32, u8p, ctypes.c_int32,
                                    i32p, ctypes.c_int32, i32p]
        lib.saca_search.restype = ctypes.c_int64
        lib.saca_simplesearch.argtypes = [u8p, ctypes.c_int32, i32p,
                                          ctypes.c_int32, ctypes.c_int32, i32p]
        lib.saca_simplesearch.restype = ctypes.c_int64
        _lib = lib
        return lib


def _host_text(data: BytesLike) -> np.ndarray:
    return np.ascontiguousarray(host_u8(data))


def _host_sa(sa) -> np.ndarray:
    if hasattr(sa, "cpu"):
        sa = sa.cpu().numpy()
    return np.ascontiguousarray(np.asarray(sa, dtype=np.int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build(data: BytesLike) -> np.ndarray:
    """Suffix array of `data` as a host int32 array (SA-IS)."""
    t = _host_text(data)
    n = len(t)
    sa = np.zeros(n, dtype=np.int32)
    if n:
        rc = load().saca_build(_u8p(t), _i32p(sa), n)
        if rc != 0:
            raise RuntimeError(f"oracle saca_build failed: rc={rc}")
    return sa


def sort(data: BytesLike, device=None) -> SuffixArray:
    """Engine-shaped API: the oracle's SA as a SuffixArray on `device`."""
    return SuffixArray(data, build(data), device)


def sufcheck(data: BytesLike, sa) -> int:
    """0 if `sa` is the suffix array of `data`; -k for a stage-k failure."""
    t = _host_text(data)
    sa = _host_sa(sa)
    if len(sa) != len(t):
        return -1
    if len(t) == 0:
        return 0
    return int(load().saca_sufcheck(_u8p(t), _i32p(sa), len(t)))


def search(data: BytesLike, needle: BytesLike, sa) -> tuple[int, int]:
    """(count, leftmost SA index) of exact occurrences of `needle`."""
    t = _host_text(data)
    p = _host_text(needle)
    sa = _host_sa(sa)
    idx = np.zeros(1, dtype=np.int32)
    cnt = load().saca_search(_u8p(t), len(t), _u8p(p), len(p), _i32p(sa),
                             len(sa), _i32p(idx))
    if cnt < 0:
        raise RuntimeError(f"oracle saca_search failed: rc={cnt}")
    return int(cnt), int(idx[0])


def simplesearch(data: BytesLike, c: int, sa) -> tuple[int, int]:
    """Single-byte (count, leftmost SA index)."""
    t = _host_text(data)
    sa = _host_sa(sa)
    idx = np.zeros(1, dtype=np.int32)
    cnt = load().saca_simplesearch(_u8p(t), len(t), _i32p(sa), len(sa),
                                   int(c), _i32p(idx))
    if cnt < 0:
        raise RuntimeError(f"oracle saca_simplesearch failed: rc={cnt}")
    return int(cnt), int(idx[0])
