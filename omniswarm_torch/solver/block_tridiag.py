"""Block-tridiagonal SPD solver by cyclic reduction.

Counterpart of ``omniswarm_tpu/solver/block_tridiag.py``: the damped swarm
Hessian without its loop columns is block-tridiagonal over frames (A:
(F, m, m) diagonal blocks, B: (F-1, m, m) off-diagonals, B[f] couples f and
f+1). Cyclic reduction eliminates the odd frames level by level. Two forms:

- ``bt_solve``, exact: Cholesky block solves per level and one dense
  Cholesky for the tail (the covariance and ``exact_linear`` paths);
- ``bt_factor`` / ``bt_apply``, matmul-only: Newton-Schulz block inverses,
  so factor and apply are nothing but batched matmuls (the LM fast path);
  ``bt_solve_ns`` adds refinement passes against ``bt_matvec``.

A block that is not positive definite makes ``torch.linalg.cholesky_ex``
report ``info != 0``; its solve is then set to NaN (the reference's
Cholesky returns NaN there), so an LM step through it is non-finite and
rejected, and nothing raises.

Mixed precision follows the reference: factor matrices are f32, a bf16
right-hand side sweeps the levels in bf16, and every product of an f32
operator with a bf16 block is computed in f32 and rounded back (JAX promotes
the product to f32; ``torch.matmul`` refuses mixed dtypes, so the block is
upcast, which is exact).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from omniswarm_torch.core.precision import highp
from omniswarm_torch.solver.fused_level import fused_reduction_level


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def cholesky_solve_checked(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve A Y = X by Cholesky; NaN where A is not PD.

    ``cholesky_ex`` never raises and never syncs; a batch entry whose
    factorization failed (``info != 0``) gets an all-NaN solution, whatever
    the partial factor holds.
    """
    L, info = torch.linalg.cholesky_ex(A)
    Y = torch.linalg.solve_triangular(L, X, upper=False)
    Y = torch.linalg.solve_triangular(L.mT, Y, upper=True)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(Y, float("nan")), Y)


def _tridiag_dense(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The dense (Fl*m, Fl*m) matrix of a small block-tridiagonal system."""
    Fl, m = A.shape[0], A.shape[1]
    H = A.new_zeros((Fl, m, Fl, m))
    idx = torch.arange(Fl, device=A.device)
    H[idx, :, idx, :] = A
    if Fl > 1:
        H[idx[:-1], :, idx[:-1] + 1, :] = B[: Fl - 1]
        H[idx[:-1] + 1, :, idx[:-1], :] = B[: Fl - 1].mT
    return H.reshape(Fl * m, Fl * m)


@highp()
def bt_solve(A: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor, *,
             direct_threshold: int = 8) -> torch.Tensor:
    """Exact solve of the block-tridiagonal SPD system; returns (F, m, K).

    Cyclic reduction with Cholesky block solves halves the frame count per
    level until at most ``direct_threshold`` blocks remain, then one dense
    Cholesky finishes. Frames pad to a power of two (identity blocks).
    """
    A, B, rhs, F_orig, _ = _pad_pow2(A, B, rhs)
    levels = []
    while A.shape[0] > max(1, direct_threshold):
        Fl = A.shape[0]
        A_odd = A[1::2]
        B_left = B[0::2]                             # couples 2t <-> 2t+1
        B_right = torch.zeros_like(B_left)           # couples 2t+1 <-> 2t+2
        if Fl > 2:
            B_right[:-1] = B[1::2]
        rhs_odd = rhs[1::2]
        Ainv_Blt = cholesky_solve_checked(A_odd, B_left.mT)
        Ainv_Br = cholesky_solve_checked(A_odd, B_right)
        Ainv_r = cholesky_solve_checked(A_odd, rhs_odd)
        # A'[t] = A[2t] - B[2t] Ainv[2t+1] B[2t]^T - B[2t-1]^T Ainv B[2t-1]
        A_new = A[0::2] - B_left @ Ainv_Blt
        A_new[1:] -= (B_right.mT @ Ainv_Br)[:-1]
        # B'[t] couples 2t <-> 2t+2: -B[2t] Ainv[2t+1] B[2t+1]
        B_new = -(B_left @ Ainv_Br)[:-1]
        r_new = rhs[0::2] - B_left @ Ainv_r
        r_new[1:] -= (B_right.mT @ Ainv_r)[:-1]
        levels.append((A_odd, B_left, B_right, rhs_odd))
        A, B, rhs = A_new, B_new, r_new

    Fl, m, K = rhs.shape
    x = cholesky_solve_checked(_tridiag_dense(A, B)[None],
                               rhs.reshape(1, Fl * m, K))[0]
    x = x.reshape(Fl, m, K)
    for A_odd, B_left, B_right, rhs_odd in reversed(levels):
        # x[2t+1] = Ainv[2t+1] (rhs[2t+1] - B[2t]^T x[2t] - B[2t+1] x[2t+2])
        x_even = x
        x_shift = torch.cat([x_even[1:], torch.zeros_like(x_even[:1])], 0)
        r = rhs_odd - B_left.mT @ x_even - B_right @ x_shift
        x_odd = cholesky_solve_checked(A_odd, r)
        x = torch.stack([x_even, x_odd], dim=1).reshape(
            (2 * x_even.shape[0],) + x_even.shape[1:])
    return x[:F_orig]


def _pad_pow2(A, B, rhs):
    F = A.shape[0]
    L = max(1, (F - 1).bit_length())
    Fp = 1 << L
    m = A.shape[1]
    if Fp != F:
        eye = _eye(m, A).expand(Fp - F, m, m)
        A = torch.cat([A, eye], 0)
        rhs = torch.cat([rhs, rhs.new_zeros((Fp - F,) + rhs.shape[1:])], 0)
    # B always padded to length Fp-1 with zeros (no coupling to pad frames)
    Bp = B.new_zeros((Fp - 1,) + B.shape[1:])
    Bp[: B.shape[0]] = B
    return A, Bp, rhs, F, Fp


# ---------------------------------------------------------------------------
# Frame packing: p frames -> one fat (p*m) block (a pure re-partition of the
# same matrix: log2(p) fewer reduction levels)
# ---------------------------------------------------------------------------

def pack_bt_mats(A: torch.Tensor, B: torch.Tensor,
                 p: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Re-partition (A (F, m, m), B (F-1, m, m)) into fat (p*m) blocks.

    Returns (A' (F', pm, pm), B' (F'-1, pm, pm), F) with F' = ceil(F/p);
    trailing pad frames carry identity diagonals (no coupling).
    """
    F, m = A.shape[0], A.shape[1]
    Fp = -(-F // p) * p
    if Fp != F:
        A = torch.cat([A, _eye(m, A).expand(Fp - F, m, m)], 0)
    Bfull = A.new_zeros((Fp, m, m))
    Bfull[: B.shape[0]] = B
    K = Fp // p
    A4 = A.reshape(K, p, m, m)
    B4 = Bfull.reshape(K, p, m, m)              # B4[k, i] = B[p*k + i]
    idx = torch.arange(p, device=A.device)
    blocks = A.new_zeros((K, p, p, m, m))
    blocks[:, idx, idx] = A4
    if p > 1:
        blocks[:, idx[:-1], idx[:-1] + 1] = B4[:, :-1]
        blocks[:, idx[:-1] + 1, idx[:-1]] = B4[:, :-1].mT
    Ap = blocks.permute(0, 1, 3, 2, 4).reshape(K, p * m, p * m)
    Bp = A.new_zeros((max(K - 1, 0), p, p, m, m))
    if K > 1:
        Bp[:, p - 1, 0] = B4[:-1, p - 1]
    Bp = Bp.permute(0, 1, 3, 2, 4).reshape(max(K - 1, 0), p * m, p * m)
    return Ap, Bp, F


def pack_bt_cols(x: torch.Tensor, p: int) -> torch.Tensor:
    """(F, m, K) column stack -> (F', p*m, K); zero-padded trailing frames."""
    F, m, K = x.shape
    Fp = -(-F // p) * p
    if Fp != F:
        x = torch.cat([x, x.new_zeros((Fp - F, m, K))], 0)
    return x.reshape(Fp // p, p * m, K)


def unpack_bt_cols(x: torch.Tensor, p: int, F: int) -> torch.Tensor:
    """(F', p*m, K) -> (F, m, K)."""
    Kp, pm, K = x.shape
    return x.reshape(Kp * p, pm // p, K)[:F]


# ---------------------------------------------------------------------------
# Newton-Schulz inverses
# ---------------------------------------------------------------------------

@highp()
def ns_inverse(A: torch.Tensor, iters: int = 12,
               bf16_head: int = 0) -> torch.Tensor:
    """Approximate batched SPD inverse from the safe start I/rho.

    Jacobi scaling An = S A S, then X <- X (2I - An X) with rho >= lambda_max
    (row-sum bound). ``bf16_head`` leading iterations run in bfloat16 (each
    product rounded back), then ``iters`` in f32. Returns S X S ~= A^-1.
    """
    n = A.shape[-1]
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    An = A * s[..., :, None] * s[..., None, :]
    rho = torch.abs(An).sum(-1).amax(-1)
    eye = _eye(n, A)
    X = eye / rho[..., None, None]
    two_eye = 2.0 * eye
    if bf16_head:
        bf16 = torch.bfloat16
        Anb, Xb, tb = An.to(bf16), X.to(bf16), two_eye.to(bf16)
        for _ in range(bf16_head):
            Xb = (Xb @ (tb - Anb @ Xb)).to(bf16)
        X = Xb.to(A.dtype)
    for _ in range(iters):
        X = X @ (two_eye - An @ X)
    return X * s[..., :, None] * s[..., None, :]


@highp()
def ns_inverse_warm(A: torch.Tensor, X0: torch.Tensor, iters: int = 2,
                    guard: float = 0.95) -> torch.Tensor:
    """Newton-Schulz continued from an inverse X0 of a nearby matrix.

    Per block, the row-sum norm of the residual I - An X0n guards the warm
    start: above ``guard`` or not finite, the block restarts from I/rho.
    The residual product doubles as the first iteration's inner product.
    """
    n = A.shape[-1]
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    An = A * s[..., :, None] * s[..., None, :]
    eye = _eye(n, A)
    X0n = X0 / torch.clamp_min(s[..., :, None] * s[..., None, :], 1e-30)
    M = An @ X0n
    enorm = torch.abs(eye - M).sum(-1).amax(-1)
    rho = torch.abs(An).sum(-1).amax(-1)
    bad = (enorm > guard) | ~torch.isfinite(enorm)
    badm = bad[..., None, None]
    rho_ = rho[..., None, None]
    X = torch.where(badm, eye / rho_, X0n)
    M = torch.where(badm, An / rho_, M)
    two_eye = 2.0 * eye
    X = X @ (two_eye - M)
    for _ in range(max(iters - 1, 0)):
        X = X @ (two_eye - An @ X)
    return X * s[..., :, None] * s[..., None, :]


@highp()
def spd_ns_inverse(S: torch.Tensor, X0: torch.Tensor | None = None, *,
                   iters: int = 10, warm_iters: int = 2) -> torch.Tensor:
    """Approximate SPD inverse by bf16 Newton-Schulz (warm-startable).

    Runs in bf16 as the reference does; callers remove the ~cond*1e-2 stall
    error with f32 refinement passes against the exact matrix.
    """
    C = S.shape[-1]
    bf16 = torch.bfloat16
    d = torch.diagonal(S, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    Sn = S * s[..., :, None] * s[..., None, :]
    rho = torch.abs(Sn).sum(-1).amax(-1)
    eye = _eye(C, S)
    Snb = Sn.to(bf16)
    if X0 is None:
        X = (eye / rho[..., None, None]).to(bf16)
        n_iters = iters
    else:
        X0n = (X0 / torch.clamp_min(s[..., :, None] * s[..., None, :],
                                    1e-30)).to(bf16)
        E = eye.to(bf16) - Snb @ X0n
        enorm = torch.abs(E.to(S.dtype)).sum(-1).amax(-1)
        bad = (enorm > 0.9) | ~torch.isfinite(enorm)
        X = torch.where(bad[..., None, None],
                        (eye / rho[..., None, None]).to(bf16), X0n)
        n_iters = warm_iters
    two_eye = (2.0 * eye).to(bf16)
    for _ in range(n_iters):
        X = (X @ (two_eye - Snb @ X)).to(bf16)
    return X.to(S.dtype) * s[..., :, None] * s[..., None, :]


@highp()
def spd_solve_approx(S: torch.Tensor, b: torch.Tensor, *, iters: int = 10,
                     refine: int = 2,
                     X0: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate SPD solve S z = b (b: (..., C)): the bf16 Newton-Schulz
    inverse, then ``refine`` f32 refinement passes against S."""
    Xf = spd_ns_inverse(S, X0, iters=iters)
    z = (Xf @ b[..., None])[..., 0]
    for _ in range(refine):
        r = b - (S @ z[..., None])[..., 0]
        z = z + (Xf @ r[..., None])[..., 0]
    return z


# ---------------------------------------------------------------------------
# Factor / apply
# ---------------------------------------------------------------------------

class BTFactors(NamedTuple):
    """Reduction structure reused across right-hand sides."""
    levels: Tuple             # per level: (Ainv, B_left, B_right, W_l, W_r)
    tail_Hinv: torch.Tensor   # dense NS inverse of the small tail
    F_orig: int
    Fp: int


def bt_warm_state(fac: BTFactors) -> Tuple:
    """Warm-start state: (per-level inverses, tail inverse)."""
    return (tuple(lvl[0] for lvl in fac.levels), fac.tail_Hinv)


@highp()
def bt_factor(A: torch.Tensor, B: torch.Tensor, *, direct_threshold: int = 8,
              ns_iters: int = 12, tail_ns_iters: int = 14,
              warm: Tuple | None = None, warm_iters: int = 2,
              fused: bool = False) -> BTFactors:
    """Forward cyclic reduction of the matrices only (no rhs).

    Per level stores the Newton-Schulz inverse of the odd blocks and the
    operators W_l = B_left Ainv, W_r = B_right^T Ainv. ``warm`` (from
    bt_warm_state of a nearby factor) seeds every chain with ``warm_iters``
    squarings. Warm levels with ``fused`` and ``warm_iters == 2`` run as one
    fused level each (solver/fused_level.py): the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors.
    """
    dummy_rhs = A.new_zeros(A.shape[:1] + (A.shape[1], 0))
    A, B, _, F_orig, Fp = _pad_pow2(A, B, dummy_rhs)
    use_fused = fused and warm is not None and warm_iters == 2

    levels = []
    li = 0
    while A.shape[0] > max(1, direct_threshold):
        Fl = A.shape[0]
        if use_fused:
            (Ainv, B_left, B_right, W_l, W_r,
             A_new, B_new) = fused_reduction_level(
                A.float(), B.float(), warm[0][li])
            li += 1
            levels.append((Ainv, B_left, B_right, W_l, W_r))
            A, B = A_new, B_new
            continue
        A_odd = A[1::2]
        B_left = B[0::2]
        B_right = torch.zeros_like(B_left)
        if Fl > 2:
            B_right[:-1] = B[1::2]
        if warm is not None:
            Ainv = ns_inverse_warm(A_odd, warm[0][li], warm_iters)
        else:
            Ainv = ns_inverse(A_odd, ns_iters)
        li += 1
        W_l = B_left @ Ainv                   # B[2t] Ainv
        W_r = B_right.mT @ Ainv               # B^T Ainv
        A_new = A[0::2] - W_l @ B_left.mT
        A_new[1:] -= (W_r @ B_right)[:-1]
        B_new = -(W_l @ B_right)[:-1]
        levels.append((Ainv, B_left, B_right, W_l, W_r))
        A, B = A_new, B_new

    H_tail = _tridiag_dense(A, B)
    if warm is not None:
        tail_Hinv = ns_inverse_warm(H_tail, warm[1], warm_iters)
    else:
        tail_Hinv = ns_inverse(H_tail, tail_ns_iters)
    return BTFactors(levels=tuple(levels), tail_Hinv=tail_Hinv,
                     F_orig=F_orig, Fp=Fp)


def _mul(W: torch.Tensor, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """W x in W's (f32) precision, rounded to the sweep dtype ``dt``."""
    return (W @ x.to(W.dtype)).to(dt)


@highp()
def bt_apply(fac: BTFactors, rhs: torch.Tensor) -> torch.Tensor:
    """One approximate solve M^-1 rhs with precomputed factors.

    dtype-preserving: a bf16 rhs sweeps the levels in bf16 (each f32
    product rounded back), the tail solve runs in f32.
    """
    F_orig = fac.F_orig
    dt = rhs.dtype
    if fac.Fp != F_orig:
        rhs = torch.cat(
            [rhs, rhs.new_zeros((fac.Fp - F_orig,) + rhs.shape[1:])], 0)

    odd_rhs = []
    for Ainv, B_left, B_right, W_l, W_r in fac.levels:
        half = rhs.reshape((rhs.shape[0] // 2, 2) + rhs.shape[1:])
        rhs_even, rhs_odd = half[:, 0], half[:, 1]
        r_new = rhs_even - _mul(W_l, rhs_odd, dt)
        corr = _mul(W_r, rhs_odd, dt)[:-1]
        r_new = torch.cat([r_new[:1], r_new[1:] - corr], 0)
        odd_rhs.append(rhs_odd)
        rhs = r_new

    n = fac.tail_Hinv.shape[-1]
    Fl_tail = n // rhs.shape[1]
    K = rhs.shape[-1]
    x = fac.tail_Hinv @ rhs.to(fac.tail_Hinv.dtype).reshape(n, K)
    x = x.reshape(Fl_tail, rhs.shape[1], K).to(dt)

    for (Ainv, B_left, B_right, _, _), rhs_odd in zip(
            reversed(fac.levels), reversed(odd_rhs)):
        x_even = x
        r = rhs_odd - _mul(B_left.mT, x_even, dt)
        x_shift = torch.cat([x_even[1:], torch.zeros_like(x_even[:1])], 0)
        r = r - _mul(B_right, x_shift, dt)
        x_odd = _mul(Ainv, r, dt)
        Fl2 = x_even.shape[0]
        x = torch.stack([x_even, x_odd], dim=1).reshape(
            (2 * Fl2,) + x_even.shape[1:])
    return x[:F_orig]


@highp()
def bt_matvec(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """Exact block-tridiagonal matvec T x (x: (F, m, K))."""
    y = A @ x
    if B.shape[0] > 0:
        y = y + torch.cat([B @ x[1:], torch.zeros_like(x[:1])], 0)
        y = y + torch.cat([torch.zeros_like(x[:1]), B.mT @ x[:-1]], 0)
    return y


@highp()
def bt_solve_ns(A: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor, *,
                direct_threshold: int = 8, ns_iters: int = 12,
                refine: int = 1) -> torch.Tensor:
    """Matmul-only block-tridiagonal solve: the Newton-Schulz factor, one
    apply and ``refine`` residual-correction passes against the exact
    ``bt_matvec``. Same contract as ``bt_solve``."""
    fac = bt_factor(A, B, direct_threshold=direct_threshold,
                    ns_iters=ns_iters)
    x = bt_apply(fac, rhs)
    for _ in range(refine):
        x = x + bt_apply(fac, rhs - bt_matvec(A, B, x))
    return x
