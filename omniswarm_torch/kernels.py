"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/kernels/`` beside the package (the file name carries a hash of the
source and flags, so an edited source is rebuilt). Libraries are loaded with
``ctypes``; every pointer and the stream are passed as ``c_void_p``. Kernels
launch on PyTorch's current stream and allocate nothing: the wrappers here
check their inputs, allocate the outputs with ``torch.empty`` and raise when
the C entry returns a CUDA error.

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
from typing import Dict, Iterable, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = {"fused_level": PKG_DIR / "csrc" / "fused_level.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FUSED_LEVEL_MAX_M = 80       # the reference never packs wider (dense.py:1101)

build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
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
        if name == "fused_level":
            fn = lib.fused_level_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check_blocks(name: str, x: torch.Tensor, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")


def fused_level(A: torch.Tensor, Bp: torch.Tensor, X0: torch.Tensor,
                guard: float):
    """Launch csrc/fused_level.cu on one cyclic-reduction level.

    A: (2t, m, m); Bp: (2t, m, m), B padded with a zero last block;
    X0: (t, m, m). All f32, contiguous, on one CUDA device, m <= 80.
    Returns the kernel's 8 outputs, each (t, m, m): Ainv, W_l, W_r,
    A_new (before the shifted add), corr_l, B_new (all t rows), B_left,
    B_right.
    """
    Fl, m = A.shape[0], A.shape[-1]
    if Fl < 2 or Fl % 2:
        raise ValueError(f"the level needs an even block count, got {Fl}")
    if m > FUSED_LEVEL_MAX_M:
        raise ValueError(f"block width {m} exceeds the kernel's "
                         f"{FUSED_LEVEL_MAX_M}")
    t = Fl // 2
    _check_blocks("A", A, (Fl, m, m))
    _check_blocks("Bp", Bp, (Fl, m, m))
    _check_blocks("X0", X0, (t, m, m))
    if not (A.device == Bp.device == X0.device):
        raise ValueError("A, Bp and X0 must be on one device")
    lib = _load("fused_level")
    out = torch.empty((8, t, m, m), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.fused_level_launch(A.data_ptr(), Bp.data_ptr(),
                                     X0.data_ptr(), out.data_ptr(), t, m,
                                     float(guard), stream)
    if err != 0:
        raise RuntimeError(f"fused_level launch failed: CUDA error {err}")
    return out.unbind(0)
