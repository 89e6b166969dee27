"""Frame-sharded block-tridiagonal solve over ranks (SPIKE).

Counterpart of ``omniswarm_tpu/parallel/bt_spike.py``. Rank p owns frames
[o, o + Fs). Its principal submatrix T_p is SPD, so

    x_p = Y_p - W_p b_{p-1} - V_p t_{p+1},
    Y_p = T_p^-1 rhs_p,  W_p = T_p^-1 (e_first B_left^T),
    V_p = T_p^-1 (e_last B_right),

where t_p = x_p[0] and b_p = x_p[-1] are the shard's boundary unknowns.
The first and last block rows give a reduced system in the 2P boundary
blocks, built from the all-gathered spike tips and solved replicated (size
2·P·m); each rank then corrects its interior locally.

Collectives per solve: one ``send_next`` of the m x m coupling block (none
when the caller already exchanged it) and ONE ``all_gather`` of the four
m x m spike tips and the two m x K boundary rows. The local solve is the
exact Cholesky ``block_tridiag.bt_solve`` with every right-hand side at
once; the solves run in true f32 (``highp``).
"""
from __future__ import annotations

import torch

from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver.block_tridiag import bt_solve
from omniswarm_torch.solver.gauss_newton import poses_to_device


def pad_B_to_F(B: torch.Tensor, F: int) -> torch.Tensor:
    """The (F-1, m, m) off-diagonal stack padded to (F, m, m) with a zero
    last row, so the frame axis shards evenly; B[f] couples f and f+1."""
    if B.shape[0] == F:
        return B
    return torch.cat([B, B.new_zeros((F - B.shape[0],) + B.shape[1:])], 0)


def solve_or_nan(R: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """R^-1 X by LU without raising: NaN where R is singular (as
    ``jnp.linalg.solve`` gives), so the LM step is rejected."""
    Y, info = torch.linalg.solve_ex(R, X)
    return torch.where(info != 0, float("nan"), Y)


@highp()
def spike_local_solve(A: torch.Tensor, Bfull: torch.Tensor,
                      rhs: torch.Tensor, axis, *, direct_threshold: int = 8,
                      B_left=None) -> torch.Tensor:
    """One rank's SPIKE solve: local solve, reduced boundary system,
    correction.

    A (Fs, m, m) local diagonal blocks; Bfull (Fs, m, m) local off-diagonal
    rows (row i couples local frames i, i+1; the last row couples to the
    NEXT rank and is zero on the last rank); rhs (Fs, m, K). ``B_left``
    (the previous rank's last Bfull row, zero on rank 0) skips the neighbour
    exchange when the caller already made it. Returns x (Fs, m, K).
    """
    Fs, m, K = rhs.shape
    P, p = axis.size, axis.index
    B_right = Bfull[-1]                                   # couples to p+1
    if B_left is None:
        B_left = axis.send_next(B_right)
        if p == 0:
            B_left = torch.zeros_like(B_left)
    # local solves, all right-hand sides at once: [rhs | W-cols | V-cols]
    ext = A.new_zeros((Fs, m, 2 * m))
    ext[0, :, :m] = B_left.mT                             # e_first B_left^T
    ext[-1, :, m:] = B_right                              # e_last  B_right
    sol = bt_solve(A, Bfull[:-1], torch.cat([rhs, ext], -1),
                   direct_threshold=direct_threshold)
    Y, W, V = sol[..., :K], sol[..., K:K + m], sol[..., K + m:]

    # reduced system in u = [t_0, b_0, t_1, b_1, ...]:
    #   t_q + W_q[0]  b_{q-1} + V_q[0]  t_{q+1} = Y_q[0]
    #   b_q + W_q[-1] b_{q-1} + V_q[-1] t_{q+1} = Y_q[-1]
    tips = torch.stack([W[0], W[-1], V[0], V[-1]])        # (4, m, m)
    ytips = torch.stack([Y[0], Y[-1]])                    # (2, m, K)
    packed = axis.all_gather(torch.cat([tips.reshape(-1),
                                        ytips.reshape(-1)]))
    tips_g = packed[:, :4 * m * m].reshape(P, 4, m, m)
    n = 2 * P * m
    R = torch.eye(n, dtype=A.dtype, device=A.device)
    for q in range(P):
        rt, rb = 2 * q * m, (2 * q + 1) * m
        if q > 0:
            cb = (2 * q - 1) * m                          # b_{q-1}
            R[rt:rt + m, cb:cb + m] = tips_g[q, 0]
            R[rb:rb + m, cb:cb + m] = tips_g[q, 1]
        if q < P - 1:
            ct = (2 * q + 2) * m                          # t_{q+1}
            R[rt:rt + m, ct:ct + m] = tips_g[q, 2]
            R[rb:rb + m, ct:ct + m] = tips_g[q, 3]
    u = solve_or_nan(R, packed[:, 4 * m * m:].reshape(n, K))
    u = u.reshape(P, 2, m, K)                             # replicated

    # local correction: x_p = Y_p - W_p b_{p-1} - V_p t_{p+1}
    x = Y
    if p > 0:
        x = x - W @ u[p - 1, 1]
    if p < P - 1:
        x = x - V @ u[p + 1, 0]
    return x


def spike_solve(A, B, rhs, axis, *,
                direct_threshold: int = 8) -> torch.Tensor:
    """The SPD block-tridiagonal system solved with its frames split over
    ``axis``; the contract of ``block_tridiag.bt_solve``. Every rank is
    handed the whole (F, m, m), (F-1 or F, m, m), (F, m, K) system (tensors
    or arrays) and returns the whole x (F, m, K) on ``axis.device``. F must
    divide by the world (``pad_for_mesh``)."""
    dev = axis.device
    A, B, rhs = (poses_to_device(x, dev) for x in (A, B, rhs))
    F, P = A.shape[0], axis.size
    if F % P:
        raise ValueError(f"F={F} does not divide by the world {P}; use "
                         "pad_for_mesh first")
    Fs = F // P
    rows = slice(axis.index * Fs, (axis.index + 1) * Fs)
    x = spike_local_solve(A[rows], pad_B_to_F(B, F)[rows], rhs[rows], axis,
                          direct_threshold=direct_threshold)
    return axis.all_gather(x, label="output").reshape(rhs.shape)


def pad_for_mesh(A: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor,
                 n_devices: int):
    """Frames padded so F divides ``n_devices``: identity diagonal blocks,
    zero couplings and right-hand sides. Returns (A, B (Fp, m, m), rhs,
    F_orig)."""
    F, m = A.shape[0], A.shape[1]
    Fp = -(-F // n_devices) * n_devices
    Bfull = pad_B_to_F(B, F)
    if Fp != F:
        eye = torch.eye(m, dtype=A.dtype, device=A.device)
        A = torch.cat([A, eye.expand(Fp - F, m, m)], 0)
        Bfull = torch.cat([Bfull, Bfull.new_zeros((Fp - F, m, m))], 0)
        rhs = torch.cat([rhs, rhs.new_zeros((Fp - F,) + rhs.shape[1:])], 0)
    return A, Bfull, rhs, F
