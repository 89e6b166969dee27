"""The host's native libraries, built from ``csrc/*.cpp`` with g++: PCM's
max-clique and the UDP multicast socket of ``udp_transport``.

Counterpart of ``omniswarm_tpu/runtime/native.py``. The C++ sources are
copies of the reference's ``runtime/maxclique.cpp`` and
``runtime/udp_multicast.cpp``; each is compiled on first use into
``build/native/`` beside the package (the file name carries a hash of the
source and the flags, so an edited source rebuilds) and called through its
C ABI::

    int max_clique_heu(const uint8_t* adj, int n, int* out)
    int umc_open(const char* group, int port, int ttl, int loopback)
    int umc_send(int fd, const char* group, int port, const uint8_t* data,
                 int len)
    int umc_recv(int fd, uint8_t* buf, int cap)
    void umc_close(int fd)

Unlike the reference, a failed build raises: the numpy greedy clique
(``_max_clique_numpy``, kept for the tests) can pick a different clique and
so change PCM's verdicts, and there is no transport without the socket
library. This is host code, not a device kernel.
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
UDP_SOURCE = PKG_DIR / "csrc" / "udp_multicast.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None          # the max-clique library, once loaded
_udp_lib = None      # the UDP multicast library, once loaded


def library_path(source: Path | None = None) -> Path:
    source = source or SOURCE
    digest = hashlib.sha1(
        source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path | None = None) -> Path:
    """Compile ``source`` (the max-clique library by default) unless it is
    built; raises if the compiler fails or is missing."""
    source = source or SOURCE
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except FileNotFoundError as err:
        raise RuntimeError(f"the C++ compiler {CXX!r} was not found: it is "
                           f"needed to build {source.name}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed for {source}:\n{proc.stderr}")
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


def udp_library():
    """The UDP multicast library (built on first use) with its signatures."""
    global _udp_lib
    with _lock:
        if _udp_lib is None:
            lib = ctypes.CDLL(str(build(UDP_SOURCE)))
            lib.umc_open.restype = ctypes.c_int
            lib.umc_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
            lib.umc_send.restype = ctypes.c_int
            lib.umc_send.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int]
            lib.umc_recv.restype = ctypes.c_int
            lib.umc_recv.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int]
            lib.umc_close.restype = None
            lib.umc_close.argtypes = [ctypes.c_int]
            _udp_lib = lib
        return _udp_lib


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
