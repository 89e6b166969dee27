"""The counterpart of a mesh axis: one ``torch.distributed`` process group.

The JAX layouts run as one SPMD program per device under ``shard_map`` and
talk through ``jax.lax`` collectives on a named mesh axis. Here every rank is
a process running the same Python loop, and an ``Axis`` offers the same
operations over a process group:

- ``size`` and ``index`` (``psum(1, axis)`` and ``axis_index``);
- ``psum`` and ``pmax``: an ``all_reduce``;
- ``all_gather(x)`` -> ``(size, *x.shape)``;
- ``send_next(x)`` and ``recv_from_next(x)``: the two cyclic ``ppermute``s
  of the layouts (rank i sends to i+1, or to i-1; the last and the first
  rank wrap around and the caller masks what wraps, as the JAX code does),
  one ``batch_isend_irecv`` each. At size 1 a cyclic permute is the
  identity: it returns a copy and does not reach the backend.

Transport, fixed by the group's backend: ``nccl`` moves device tensors (one
rank per card); ``gloo`` runs on host tensors, so a CUDA payload is copied
to the host, reduced or exchanged there and copied back, which lets several
ranks share one card (the compute stays on the card). Any other backend
raises.

``split(size)`` gives the Axis of this rank's block of ``size``
consecutive ranks (every rank calls it alike: it creates the groups), so
one launch can run layouts at several world sizes side by side.

Every operation counts its calls and the bytes of its result (per rank, as
XLA's HLO types them), keyed by the operation's name, or ``name/label``
when the caller labels it (the layouts label the final gather of their
outputs ``output``); ``counts()`` reads them, ``reset_counts()`` zeroes
them.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class Axis:
    """One process group as a mesh axis; ``device`` is where this rank
    computes, ``timeout`` the collectives' timeout of the groups ``split``
    creates (a ``datetime.timedelta``; None: the backend's default)."""

    def __init__(self, device, group=None, timeout=None):
        self.group = dist.group.WORLD if group is None else group
        self.timeout = timeout
        self.backend = str(dist.get_backend(self.group))
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} is not one of "
                             f"{BACKENDS}")
        self.device = torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        self.size = dist.get_world_size(self.group)
        self.index = dist.get_rank(self.group)
        self._calls = collections.Counter()
        self._bytes = collections.Counter()
        self._splits = {}

    def split(self, size: int) -> "Axis":
        """The Axis of ranks [k*size, (k+1)*size) holding this rank."""
        if size == self.size:
            return self
        if self.size % size:
            raise ValueError(f"{size} does not divide the world {self.size}")
        if size not in self._splits:
            for start in range(0, self.size, size):
                group = dist.new_group(
                    [self._peer(r) for r in range(start, start + size)],
                    timeout=self.timeout)
                if start <= self.index < start + size:
                    mine = group
            self._splits[size] = Axis(self.device, mine, self.timeout)
        return self._splits[size]

    # --- counters ----------------------------------------------------
    def _count(self, op: str, label: str, nbytes: int) -> None:
        key = f"{op}/{label}" if label else op
        self._calls[key] += 1
        self._bytes[key] += nbytes

    def counts(self) -> dict:
        """{op or op/label: {"calls": n, "bytes": b}} since the last reset."""
        return {k: {"calls": self._calls[k], "bytes": self._bytes[k]}
                for k in sorted(self._calls)}

    def reset_counts(self) -> None:
        self._calls.clear()
        self._bytes.clear()

    # --- transport ---------------------------------------------------
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A private copy of x where the backend takes it."""
        if self.backend == "nccl":
            return x.detach().contiguous().clone()
        return x.detach().to("cpu", copy=True).contiguous()

    def _peer(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)

    # --- collectives -------------------------------------------------
    def _all_reduce(self, x: torch.Tensor, op, name: str,
                    label: str) -> torch.Tensor:
        y = self._wire(x)
        dist.all_reduce(y, op=op, group=self.group)
        self._count(name, label, y.numel() * y.element_size())
        return y.to(x.device)

    def psum(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        """Sum of x over the ranks (``jax.lax.psum``)."""
        return self._all_reduce(x, dist.ReduceOp.SUM, "psum", label)

    def pmax(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        """Elementwise max of x over the ranks (``jax.lax.pmax``); x is a
        numeric tensor (cast flags to int32)."""
        return self._all_reduce(x, dist.ReduceOp.MAX, "pmax", label)

    def all_gather(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        """(size, *x.shape): every rank's x in rank order
        (``jax.lax.all_gather``)."""
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        out = torch.stack(parts)
        self._count("all_gather", label, out.numel() * out.element_size())
        return out.to(x.device)

    def _permute(self, x: torch.Tensor, shift: int, name: str,
                 label: str) -> torch.Tensor:
        """Send x to rank index + shift and receive from index - shift,
        cyclically."""
        self._count(name, label, x.numel() * x.element_size())
        if self.size == 1:
            return x.clone()
        w = self._wire(x)
        r = torch.empty_like(w)
        ops = [dist.P2POp(dist.isend, w,
                          self._peer((self.index + shift) % self.size),
                          self.group),
               dist.P2POp(dist.irecv, r,
                          self._peer((self.index - shift) % self.size),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return r.to(x.device)

    def send_next(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        """Receive the PREVIOUS rank's x (each rank sends to the next); rank
        0 receives the last rank's."""
        return self._permute(x, 1, "send_next", label)

    def recv_from_next(self, x: torch.Tensor,
                       label: str = "") -> torch.Tensor:
        """Receive the NEXT rank's x; the last rank receives rank 0's."""
        return self._permute(x, -1, "recv_from_next", label)
