"""Unrolled Cholesky solves of small systems (port of
promp_tpu/ops/smallsolve.py): the generic engine's (M + hC + h^2 K) qdd.

Batched plain tensor ops over any leading batch shape, statically unrolled
over the n pivots, with the JAX package's clamped pivots: a squared pivot
below ``pivot_floor`` is raised to it, so a numerically semidefinite
system yields finite output where ``torch.linalg.cholesky`` would fail
(and torch's batched CPU solve may stall, ROADMAP §3). The JAX
``solve_from_entries`` serves only its planar fast path, which the port
does not have; its scalar algorithm lives on in ``chol_solve_unrolled``.
"""
from __future__ import annotations

import torch


def _pivot_column(cj, j, pivot_floor):
    """Column j of L from column j of the partly reduced matrix: the
    clamped pivot d on the diagonal (not cj[j] / d, which is 0 for a
    semidefinite pivot), cj / d below it, zeros above. Returns (lj, the
    unclamped pivot)."""
    n = cj.shape[-1]
    idx = torch.arange(n, device=cj.device)
    piv = cj[..., j]
    d = torch.sqrt(torch.clamp_min(piv, pivot_floor))
    lj = torch.where(idx > j, cj / d[..., None], torch.zeros_like(cj))
    lj = torch.where(idx == j, d[..., None], lj)
    return lj, piv


def clamped_pivot_count(A, *, pivot_floor=1e-12):
    """The number of Cholesky pivots of ``A`` (..., n, n) that hit
    ``pivot_floor``: the directions of the system that were numerically
    semidefinite and were regularized into finite but inaccurate output.
    Zero for a healthy engine step. Returns (...,) int32."""
    n = A.shape[-1]
    clamped = torch.zeros(A.shape[:-2], dtype=torch.int32, device=A.device)
    for j in range(n):
        lj, piv = _pivot_column(A[..., :, j], j, pivot_floor)
        clamped = clamped + (piv <= pivot_floor).to(torch.int32)
        A = A - lj[..., :, None] * lj[..., None, :]
    return clamped


def chol_solve_cols(A, b, *, pivot_floor=1e-12):
    """Solve A x = b for SPD ``A`` (..., n, n), ``b`` (..., n) by a
    column-vectorized Cholesky: the matrix stays whole and only the n
    pivot steps are unrolled, each a handful of (..., n, n) ops, so the
    op count is O(n) at any size (the JAX package's solve above 16 dofs).
    Returns x (..., n)."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        lj, _ = _pivot_column(A[..., :, j], j, pivot_floor)
        cols.append(lj)
        # rank-1 update of the trailing submatrix; lj's entries above j are
        # zero, so the finished rows and columns are untouched
        A = A - lj[..., :, None] * lj[..., None, :]
    L = torch.stack(cols, dim=-1)                             # lower

    # forward substitution L y = b, one elimination per column
    y = b
    ys = []
    for j in range(n):
        yj = y[..., j] / L[..., j, j]
        ys.append(yj)
        y = y - L[..., :, j] * yj[..., None]
    # back substitution L^T x = y: x[k] adds row k of L, scaled by x[k],
    # to every j < k
    xs = [None] * n
    acc = torch.zeros_like(b)
    for j in range(n - 1, -1, -1):
        xj = (ys[j] - acc[..., j]) / L[..., j, j]
        xs[j] = xj
        acc = acc + L[..., j, :] * xj[..., None]
    return torch.stack(xs, dim=-1)


def chol_solve_unrolled(A, b, *, pivot_floor=1e-12):
    """Solve A x = b for SPD ``A`` (..., n, n), ``b`` (..., n) by a fully
    unrolled scalar Cholesky-Crout and substitution: O(n^3) ops on (...,)
    tensors, each entry computed as the JAX package's scalar unroll
    computes it (the generic engine's solve at up to 16 dofs). Returns x
    (..., n)."""
    n = A.shape[-1]
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp_min(s, pivot_floor))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d

    # forward substitution: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]

    # back substitution: L^T x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
