"""The max-clique library of PCM, built from ``csrc/maxclique.cpp`` with g++.

Counterpart of ``omniswarm_tpu/runtime/native.py``. The C++ source is a
copy of the reference's ``runtime/maxclique.cpp``; it is compiled on first
use into ``build/native/`` beside the package (the file name carries a hash
of the source and the flags, so an edited source rebuilds) and called
through its C ABI::

    int max_clique_heu(const uint8_t* adj, int n, int* out)

Unlike the reference, a failed build raises: the numpy greedy clique
(``_max_clique_numpy``, kept for the tests) can pick a different clique and
so change PCM's verdicts. This is host code, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "maxclique.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha1(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmaxclique-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; raises if the compiler fails
    or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except FileNotFoundError as err:
        raise RuntimeError(f"the C++ compiler {CXX!r} was not found: it is "
                           f"needed to build {SOURCE.name}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.max_clique_heu.restype = ctypes.c_int
            lib.max_clique_heu.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def max_clique(adj: np.ndarray) -> np.ndarray:
    """Indices of a (heuristic) maximum clique of a boolean adjacency
    matrix, from the native library (int64, ascending as the library
    returns them)."""
    adj = np.ascontiguousarray(np.asarray(adj).astype(np.uint8))
    n = adj.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    lib = _load()
    out = np.zeros(n, np.int32)
    k = lib.max_clique_heu(adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out[:k].astype(np.int64)


def _max_clique_numpy(adj: np.ndarray) -> np.ndarray:
    """Greedy degree-heuristic clique (the reference's fallback; tests)."""
    n = adj.shape[0]
    a = adj.copy()
    np.fill_diagonal(a, False)
    best: list[int] = []
    order = np.argsort(-a.sum(1))
    for seed in order[: min(n, 16)]:
        clique = [int(seed)]
        cand = np.flatnonzero(a[seed])
        while cand.size:
            sub = a[np.ix_(cand, cand)]
            pick = cand[int(np.argmax(sub.sum(1)))]
            clique.append(int(pick))
            cand = cand[a[pick, cand]]
        if len(clique) > len(best):
            best = clique
    if not best:
        best = [int(order[0])] if n else []
    return np.asarray(sorted(best), np.int64)
