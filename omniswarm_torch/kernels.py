"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/kernels/`` beside the package (the file name carries a hash of the
source and flags, so an edited source is rebuilt). Libraries are loaded with
``ctypes``; every pointer and the stream are passed as ``c_void_p``. Kernels
launch on PyTorch's current stream and allocate nothing: the wrappers here
check their inputs, allocate the outputs and scratch with ``torch.empty``
(K3 also keeps one zeroed ticket counter per stream) and raise when the C
entry returns a CUDA error.

    python -c "from omniswarm_torch import kernels; print(kernels.build())"

builds every kernel (one ``nvcc`` per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = {name: PKG_DIR / "csrc" / f"{name}.cu"
           for name in ("fused_level", "grid_nms", "retrieval_top1")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FUSED_LEVEL_MAX_M = 80       # the reference never packs wider (dense.py:1101)
GRID_NMS_MAX_RADIUS = 16     # the kernel's shared strip is sized for it

build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[Tuple[Optional[int], int], torch.Tensor] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha1(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named kernels (default: all) that are not built yet.

    One ``nvcc`` per source, all started together. Returns the wall seconds
    spent; the compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept in ``build_logs``.
    """
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = None
        procs = {}
        try:
            for name in names:
                out = library_path(name)
                if out.exists():
                    continue
                nvcc = nvcc or _nvcc()
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                build_logs[name] = log
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {SOURCES[name]}:\n{log}")
                os.replace(tmp, out)
        finally:
            for proc, _, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return time.perf_counter() - t0


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = ctypes.CDLL(str(library_path(name)))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "fused_level":
            fn = lib.fused_level_launch
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ctypes.c_float, ptr]
            fn.restype = i32
            lib.fused_level_cluster_size.argtypes = [i32, i32]
            lib.fused_level_cluster_size.restype = i32
        elif name == "grid_nms":
            fn = lib.grid_nms_launch
            fn.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
        elif name == "retrieval_top1":
            fn = lib.retrieval_top1_launch
            fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr,
                           ptr]
            fn.restype = i32
            lib.retrieval_top1_blocks.argtypes = [i32]
            lib.retrieval_top1_blocks.restype = i32
        _libs[name] = lib
    return lib


def _check_blocks(name: str, x: torch.Tensor, shape,
                  dtype: torch.dtype = torch.float32) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")


def fused_level(A: torch.Tensor, B: torch.Tensor, X0: torch.Tensor,
                guard: float):
    """Launch csrc/fused_level.cu on one cyclic-reduction level.

    A: (2t, m, m); B: (2t-1, m, m), unpadded (the kernel takes the last
    pair's B_right as zero); X0: (t, m, m). All f32, contiguous, on one CUDA
    device, m <= 80, and starting on 16 bytes when m % 4 == 0 (the kernel
    loads them 16 bytes at a time). Returns the kernel's 8 outputs, each
    (t, m, m): Ainv, W_l, W_r, A_new (before the shifted add), corr_l, B_new
    (all t rows), B_left, B_right.
    """
    Fl, m = A.shape[0], A.shape[-1]
    if Fl < 2 or Fl % 2:
        raise ValueError(f"the level needs an even block count, got {Fl}")
    if m > FUSED_LEVEL_MAX_M:
        raise ValueError(f"block width {m} exceeds the kernel's "
                         f"{FUSED_LEVEL_MAX_M}")
    if tuple(B.shape) != (Fl - 1, m, m):
        raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                         f"{(Fl - 1, m, m)}: the kernel takes B unpadded")
    for name, x in (("A", A), ("B", B), ("X0", X0)):
        if m % 4 == 0 and x.data_ptr() % 16:
            raise ValueError(f"{name} does not start on 16 bytes")
    t = Fl // 2
    _check_blocks("A", A, (Fl, m, m))
    _check_blocks("B", B, (Fl - 1, m, m))
    _check_blocks("X0", X0, (t, m, m))
    if not (A.device == B.device == X0.device):
        raise ValueError("A, B and X0 must be on one device")
    lib = _load("fused_level")
    out = torch.empty((8, t, m, m), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = lib.fused_level_launch(A.data_ptr(), B.data_ptr(),
                                     X0.data_ptr(), out.data_ptr(), t, m,
                                     float(guard), _stream(A.device))
    if err != 0:
        raise RuntimeError(f"fused_level launch failed: CUDA error {err}")
    return out.unbind(0)


def fused_level_cluster(m: int, t: int, device=None) -> int:
    """CTAs per block pair that ``fused_level`` launches for t pairs of
    (m, m) blocks on ``device`` (the current CUDA device by default): the
    largest of 8, 4, 2 (at most m) whose t clusters the card holds at once,
    else 1."""
    lib = _load("fused_level")
    with torch.cuda.device(device):
        size = lib.fused_level_cluster_size(int(m), int(t))
    if size < 0:
        raise RuntimeError(f"fused_level cluster size query failed: CUDA "
                           f"error {-size}")
    return size


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _retrieval_ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The u32 ticket counter of csrc/retrieval_top1.cu for one stream of
    one device: zeroed once here, left at 0 by every launch. Launches on
    one stream run in order, so they never share it concurrently."""
    key = (device.index, stream)
    ticket = _tickets.get(key)
    if ticket is None:
        ticket = torch.zeros((1,), dtype=torch.int32, device=device)
        _tickets[key] = ticket
    return ticket


def grid_nms(heat: torch.Tensor, nms_dist: int) -> torch.Tensor:
    """Launch csrc/grid_nms.cu on a (B, H, W) f32 batch of heat maps.

    Returns ``heat`` where it is the maximum of its (2 nms_dist + 1)^2
    window (cells outside the map count as -inf), else 0; (B, H, W) f32.
    """
    if heat.dim() != 3:
        raise ValueError(f"heat must be (B, H, W), got {tuple(heat.shape)}")
    if not 0 <= nms_dist <= GRID_NMS_MAX_RADIUS:
        raise ValueError(f"nms_dist {nms_dist} outside the kernel's "
                         f"0..{GRID_NMS_MAX_RADIUS}")
    B, H, W = heat.shape
    if B < 1 or B > 65535 or H < 1 or W < 1:
        raise ValueError(f"heat batch shape {tuple(heat.shape)} not supported")
    _check_blocks("heat", heat, (B, H, W))
    lib = _load("grid_nms")
    out = torch.empty_like(heat)
    with torch.cuda.device(heat.device):
        err = lib.grid_nms_launch(heat.data_ptr(), out.data_ptr(), B, H, W,
                                  int(nms_dist), _stream(heat.device))
    if err != 0:
        raise RuntimeError(f"grid_nms launch failed: CUDA error {err}")
    return out


def retrieval_top1(db: torch.Tensor, query: torch.Tensor,
                   mask: torch.Tensor):
    """Launch csrc/retrieval_top1.cu: Q masked top-1 searches of one DB.

    db (N, D) f32, query (Q, D) f32, mask (Q, N) bool, contiguous on one
    CUDA device. Returns (best_idx (Q,) int64, best_sim (Q,) f32): the
    lowest index among the maxima of ``query @ db.T`` with masked entries
    at -inf; (0, -inf) for a query whose every entry is masked. Both are
    views of the one allocation that also holds the kernel's scratch.
    """
    if db.dim() != 2 or query.dim() != 2 or mask.dim() != 2:
        raise ValueError("db, query and mask must be 2-D")
    N, D = db.shape
    Q = query.shape[0]
    if N < 1 or D < 1 or Q < 1 or Q > 65535:
        raise ValueError(f"retrieval shapes N={N} D={D} Q={Q} not supported")
    _check_blocks("db", db, (N, D))
    _check_blocks("query", query, (Q, D))
    _check_blocks("mask", mask, (Q, N), torch.bool)
    if not (db.device == query.device == mask.device):
        raise ValueError("db, query and mask must be on one device")
    lib = _load("retrieval_top1")
    with torch.cuda.device(db.device):
        nb = lib.retrieval_top1_blocks(N)
        stream = _stream(db.device)
        ticket = _retrieval_ticket(db.device, stream)
        # one allocation: best_idx (Q i64), best_sim (Q f32 in ceil(Q/2)
        # i64) and the CTAs' (sim, index) pairs (Q * nb, 8 bytes each)
        n_sim = (Q + 1) // 2
        buf = torch.empty((Q + n_sim + Q * nb,), dtype=torch.int64,
                          device=db.device)
        best_idx = buf[:Q]
        best_sim = buf[Q:Q + n_sim].view(torch.float32)[:Q]
        err = lib.retrieval_top1_launch(
            db.data_ptr(), query.data_ptr(), mask.data_ptr(), N, D, Q,
            buf[Q + n_sim:].data_ptr(), ticket.data_ptr(),
            best_idx.data_ptr(), best_sim.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"retrieval_top1 launch failed: CUDA error {err}")
    return best_idx, best_sim
