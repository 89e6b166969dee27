"""Run one function on ``world`` ranks, one process each.

    results = run_ranks(fn, 4, backend="gloo", device="cuda", args=(...,))

``fn(axis, *args)`` runs on every rank with an ``Axis`` over the world's
process group, and its return value (tensors moved to the host as numpy
arrays, inside tuples, lists, dicts and named tuples) comes back in rank
order. The ranks are started with the ``spawn`` method (CUDA does not
survive ``fork``) and import only ``fn``'s module, which must be a module
of this package (``call_each`` below runs a list of the package's functions
on every rank). They meet through a ``file://`` store in a fresh temporary
directory, so runs started side by side never share a port. Each rank runs
with one intra-op thread and computes on ``device``: a CUDA device is the
rank's card modulo the card count, so under ``gloo`` several ranks share
one card; ``nccl`` needs one card per rank and raises otherwise.

``timeout_s`` bounds the whole run: it is the process group's timeout (a
rank that waits longer in a collective for a rank that diverged raises) and
the caller's deadline (past it every rank is killed and ``TimeoutError``
raised). A rank that raises, or dies, fails the run: its traceback is
re-raised here and the other ranks are stopped.
"""
from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from omniswarm_torch.parallel.collectives import BACKENDS, Axis


def to_host(x):
    """x with every tensor replaced by a numpy array (recursively)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, init_method, backend, device, call_path,
               timeout_s, results):
    try:
        with open(call_path, "rb") as f:        # written by run_ranks
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank, timeout=timeout)
        try:
            out = to_host(fn(Axis(dev, timeout=timeout), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:           # reported to the caller, which re-raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *, backend: str, device="cuda", args=(),
              timeout_s: float = 600.0) -> list:
    """[fn(axis, *args) of rank 0, ..., of rank world-1]."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if not fn.__module__.startswith("omniswarm_torch."):
        raise ValueError("the rank function must live in omniswarm_torch")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to "
                "run the ranks on the CPU")
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(
                f"nccl runs one rank per card: {world} ranks, "
                f"{torch.cuda.device_count()} cards (use gloo to share one)")
    elif backend == "nccl":
        raise ValueError("the nccl backend needs device='cuda'")

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="omniswarm-ranks-")
    # the function and its arguments go through a file: a rank that dies
    # while it starts would leave a large pickle blocked in its pipe
    call_path = os.path.join(tmp, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(rank, world, f"file://{os.path.join(tmp, 'store')}", backend,
              device, call_path, timeout_s, results))
        for rank in range(world)]
    try:
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} died with exit "
                                       f"code {dead[0][1]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _kernel_counts() -> dict:
    """The three kernels' launch counts and their plain versions' calls in
    this process."""
    from omniswarm_torch.ops.frontend_kernels import (
        grid_nms, grid_nms_ref, retrieval_top1, retrieval_top1_ref)
    from omniswarm_torch.solver.fused_level import (
        fused_reduction_level, fused_reduction_level_ref)

    return dict(k1=fused_reduction_level.launches,
                k2=grid_nms.launches, k3=retrieval_top1.launches,
                k1_plain=fused_reduction_level_ref.calls,
                k2_plain=grid_nms_ref.calls,
                k3_plain=retrieval_top1_ref.calls)


def call_each(axis: Axis, calls) -> list:
    """Rank target: for each ``("module:function", kwargs[, world])`` of
    this package, ``function(**kwargs, axis=axis.split(world))`` (world
    default: all ranks; a smaller world runs in every block of ``world``
    ranks side by side), with that Axis's counters zeroed before it.
    Returns one dict per call: ``result``, ``counts`` (the Axis counters of
    the call), ``seconds`` (synchronised wall) and ``kernels`` (the
    launches of K1-K3 and calls of their plain versions made during the
    call)."""
    out = []
    for name, kwargs, *world in calls:
        sub = axis.split(world[0]) if world else axis
        module, func = name.split(":")
        if not module.startswith("omniswarm_torch."):
            raise ValueError(f"{name} is not a function of omniswarm_torch")
        fn = getattr(importlib.import_module(module), func)
        sub.reset_counts()
        k0 = _kernel_counts()
        if sub.device.type == "cuda":
            torch.cuda.synchronize(sub.device)
        t0 = time.perf_counter()
        res = fn(**kwargs, axis=sub)
        if sub.device.type == "cuda":
            torch.cuda.synchronize(sub.device)
        seconds = time.perf_counter() - t0
        k1 = _kernel_counts()
        out.append(dict(result=res, counts=sub.counts(), seconds=seconds,
                        kernels={k: k1[k] - k0[k] for k in k1}))
    return out

