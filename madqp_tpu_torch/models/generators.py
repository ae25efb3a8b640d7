"""Test-problem generators (NumPy only).

The generators of `madqp_tpu/models/generators.py`, carried over
unchanged so the same seed gives the same problem in both packages:
MadNLPTests.DenseDummyQP (`dense_dummy_qp`), the reference's degenerate
`simple_lp`, the random LP/QP of the headline benchmark, and the large
sparse families (banded, separable, inequality-dominated, 2-D and 3-D
grids, grid network flow) that the structured suite builds on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .qp import QuadraticProblem, from_coo


def dense_dummy_qp(
    n: int = 10,
    m: int = 5,
    fixed_variables=(),
    equality_cons=(),
    seed: int = 0,
) -> QuadraticProblem:
    """Randomized dense convex QP, mirroring MadNLPTests.DenseDummyQP:

        min  0.5 x'Qx + c'x   s.t. rows of Ax vs bounds, 0 <= x <= 1,
    with Q = P'P + alpha I (SPD), a mix of <= / >= / == constraints, and
    optional fixed variables (lvar == uvar).
    """
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n)) / np.sqrt(n)
    Q = P.T @ P + 0.3 * np.eye(n)
    c = rng.standard_normal(n)

    lvar = np.zeros(n)
    uvar = np.ones(n)
    for i in fixed_variables:
        val = rng.uniform(0.2, 0.8)
        lvar[i] = uvar[i] = val

    if m > 0:
        A = rng.standard_normal((m, n)) / np.sqrt(n)
        rhs = A @ rng.uniform(0.25, 0.75, size=n)
        lcon = np.full(m, -np.inf)
        ucon = np.full(m, np.inf)
        for i in range(m):
            kind = i % 3
            if i in equality_cons or kind == 0:
                lcon[i] = ucon[i] = rhs[i]
            elif kind == 1:
                ucon[i] = rhs[i] + 0.1
            else:
                lcon[i] = rhs[i] - 0.1
        for i in equality_cons:
            lcon[i] = ucon[i] = rhs[i]
    else:
        A = np.zeros((0, n))
        lcon = np.zeros(0)
        ucon = np.zeros(0)

    return QuadraticProblem(
        c=c,
        H=sp.csr_matrix(Q),
        A=sp.csr_matrix(A),
        lcon=lcon,
        ucon=ucon,
        lvar=lvar,
        uvar=uvar,
        x0=np.full(n, 0.5),
        name=f"dense_dummy_qp_{n}_{m}",
    )


def simple_lp() -> QuadraticProblem:
    """The reference's 2-variable degenerate LP (test/runtests.jl:24-55):
    min x1 + x2 s.t. x1 + x2 = 1, x >= 0."""
    return from_coo(
        c=[1.0, 1.0],
        Arows=[0, 0],
        Acols=[0, 1],
        Avals=[1.0, 1.0],
        lcon=[1.0],
        ucon=[1.0],
        lvar=[0.0, 0.0],
        uvar=[np.inf, np.inf],
        x0=[1.0, 1.0],
        name="simpleLP",
    )


def random_lp(n: int = 50, m: int = 20, seed: int = 0) -> QuadraticProblem:
    """Random standard-form-ish LP with a known feasible interior point."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x_feas = rng.uniform(0.5, 1.5, size=n)
    b = A @ x_feas
    c = rng.standard_normal(n) + 2.0
    return QuadraticProblem(
        c=c,
        A=sp.csr_matrix(A),
        lcon=b,
        ucon=b,
        lvar=np.zeros(n),
        uvar=np.full(n, np.inf),
        name=f"random_lp_{n}_{m}",
    )


def random_qp(n: int = 100, m: int = 50, seed: int = 0, ineq: bool = True) -> QuadraticProblem:
    """Random dense convex QP with equality + optional inequality rows
    (the headline benchmark's problem at n=500, m=200)."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n)) / np.sqrt(n)
    Q = P.T @ P + 0.1 * np.eye(n)
    c = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x_feas = rng.uniform(-1.0, 1.0, size=n)
    rhs = A @ x_feas
    if ineq and m >= 2:
        half = m // 2
        lcon = np.concatenate([rhs[:half], rhs[half:] - 0.5])
        ucon = np.concatenate([rhs[:half], np.full(m - half, np.inf)])
    else:
        lcon = ucon = rhs
    return QuadraticProblem(
        c=c,
        H=sp.csr_matrix(Q),
        A=sp.csr_matrix(A),
        lcon=lcon,
        ucon=ucon,
        lvar=np.full(n, -5.0),
        uvar=np.full(n, 5.0),
        name=f"random_qp_{n}_{m}",
    )


def banded_sparse_lp(n: int = 20000, m: int = 10000, band: int = 5, seed: int = 0) -> QuadraticProblem:
    """Large banded sparse LP with a known feasible interior point.

    Staircase structure typical of real LP suites (each constraint couples a
    contiguous window of variables) — low fill under a bandwidth-style
    ordering.
    """
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), band)
    offs = np.tile(np.arange(band), m)
    cols = (rows * (n - band) // max(1, m - 1) if m > 1 else rows) + offs
    cols = np.minimum(cols, n - 1)
    vals = rng.standard_normal(m * band) + 0.1
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    # guarantee nonzero diagonal-ish entries for row rank
    A = A + sp.coo_matrix(
        (np.ones(m), (np.arange(m), (np.arange(m) * (n // m)) % n)), shape=(m, n)
    ).tocsr()
    x_feas = rng.uniform(0.5, 1.5, size=n)
    b = np.asarray(A @ x_feas).ravel()
    return QuadraticProblem(
        c=rng.uniform(1.0, 3.0, size=n),
        A=A,
        lcon=b,
        ucon=b,
        lvar=np.zeros(n),
        uvar=np.full(n, np.inf),
        name=f"banded_sparse_lp_{n}_{m}",
    )


def separable_qp(n: int = 20000, m: int = 10000, band: int = 5,
                 seed: int = 0) -> QuadraticProblem:
    """Banded sparse QP with a strictly positive diagonal Hessian.

    Separable objective ½Σ hᵢxᵢ² + cᵀx: W = H + Σ stays diagonal, so the
    normal-equations reduction applies.
    """
    rng = np.random.default_rng(seed + 7)
    lp = banded_sparse_lp(n=n, m=m, band=band, seed=seed)
    h = rng.uniform(0.1, 10.0, size=n)
    return dataclasses.replace(
        lp, H=sp.diags(h).tocsr(), name=f"separable_qp_{n}_{m}"
    )


def ineq_qp(n: int = 5000, m_factor: int = 2, band: int = 4,
            seed: int = 0,
            pattern_seed: Optional[int] = None) -> QuadraticProblem:
    """Inequality-dominated banded QP: m = m_factor·n sparse range rows,
    tridiagonal SPD Hessian, box bounds; feasible by construction.

    The home regime of the condensed KKT: with every row a slacked range,
    K2 is (n+2m)², the normal equations don't apply (non-diagonal H), but
    the condensed system stays n×n with a banded H + AᵀA pattern.

    pattern_seed (default: seed) fixes the sparsity structure separately
    from the values, so same-pattern instances share one symbolic
    analysis.
    """
    prng = np.random.default_rng(seed if pattern_seed is None
                                 else pattern_seed)
    rng = np.random.default_rng(seed)
    m = m_factor * n
    # Each row touches `band` consecutive columns at a random offset:
    # AᵀA stays banded (width ~band), so the condensed pattern is sparse.
    starts = prng.integers(0, n - band, size=m)
    rows = np.repeat(np.arange(m), band)
    cols = (starts[:, None] + np.arange(band)[None, :]).ravel()
    vals = rng.uniform(-1.0, 1.0, size=m * band)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    # Tridiagonal SPD Hessian.
    h0 = rng.uniform(1.0, 4.0, n)
    h1 = rng.uniform(-0.5, 0.5, n - 1)
    H = sp.diags([h1, h0, h1], [-1, 0, 1]).tocsr()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = np.asarray(A @ x_feas).ravel()
    half = rng.uniform(0.2, 1.0, m)
    return QuadraticProblem(
        c0=0.0,
        c=rng.uniform(-1.0, 1.0, n),
        H=H,
        A=A,
        lcon=Ax - half,
        ucon=Ax + half,
        lvar=np.full(n, -2.0),
        uvar=np.full(n, 2.0),
        x0=np.zeros(n),
        y0=np.zeros(m),
        name=f"ineq_qp_{n}_{m}",
    )


def grid_lp(g: int = 100, seed: int = 0) -> QuadraticProblem:
    """LP whose equality constraints couple variables on a g x g 2D grid:
    [L | I] x = b with L the 5-point Laplacian stencil (+4 diagonal), one
    slack-like column block, x >= 0.

    The normal matrix L L' + I has a 2D-mesh pattern whose elimination
    tree (under AMD) is a real tree with O(g)-wide root fronts, in contrast
    to banded chains whose etree is a sequential path.  COO built
    directly (scipy.sparse.random is slow at scale).
    """
    rng = np.random.default_rng(seed)
    m = g * g
    n = 2 * m
    rows, cols, vals = [], [], []
    for i in range(g):
        for j in range(g):
            r = i * g + j
            rows.append(r)
            cols.append(r)
            vals.append(4.0)
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < g and 0 <= jj < g:
                    rows.append(r)
                    cols.append(ii * g + jj)
                    vals.append(-1.0)
    # identity block for the second half of the variables
    rows.extend(range(m))
    cols.extend(range(m, n))
    vals.extend([1.0] * m)
    A = sp.coo_matrix(
        (np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
        shape=(m, n),
    ).tocsr()
    x_feas = rng.uniform(0.5, 2.0, n)
    b = np.asarray(A @ x_feas).ravel()
    c = rng.uniform(0.1, 1.0, n)
    return QuadraticProblem(
        c0=0.0,
        c=c,
        H=None,
        A=A,
        lcon=b,
        ucon=b,
        lvar=np.zeros(n),
        uvar=np.full(n, np.inf),
        x0=np.ones(n),
        y0=np.zeros(m),
        name=f"grid_lp_{g}",
    )


def grid3d_lp(g: int = 12, seed: int = 0) -> QuadraticProblem:
    """LP on a g x g x g 3D grid: [L3 | I] x = b with L3 the 7-point
    Laplacian stencil (+6 diagonal), x >= 0.

    3D meshes are nested dissection's home turf (separator theory gives
    O(n^{4/3}) fill for ND vs much worse for minimum-degree on large 3D
    grids).
    """
    rng = np.random.default_rng(seed)
    m = g * g * g
    n = 2 * m
    idx = np.arange(m).reshape(g, g, g)
    rows, cols, vals = [], [], []
    rows.append(idx.ravel()); cols.append(idx.ravel())
    vals.append(np.full(m, 6.0))
    for ax in range(3):
        lo = np.take(idx, np.arange(g - 1), axis=ax).ravel()
        hi = np.take(idx, np.arange(1, g), axis=ax).ravel()
        rows.extend([lo, hi]); cols.extend([hi, lo])
        vals.extend([np.full(lo.size, -1.0)] * 2)
    rows = np.concatenate(rows); cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A = sp.hstack([A, sp.identity(m, format="csr")], format="csr")
    x_feas = rng.uniform(0.5, 2.0, n)
    b = np.asarray(A @ x_feas).ravel()
    return QuadraticProblem(
        c=rng.uniform(0.1, 1.0, n),
        A=A,
        lcon=b, ucon=b,
        lvar=np.zeros(n), uvar=np.full(n, np.inf),
        name=f"grid3d_lp_{g}",
    )


def netflow_grid_lp(g: int = 20, seed: int = 0) -> QuadraticProblem:
    """Min-cost network flow on a g x g grid graph (node-arc incidence).

    A classic real-LP structure (Netlib's KEN/PDS families are network
    LPs): variables are directed arc flows on the 4-neighbor grid with
    capacities, constraints are node balances.  A A' is (degree-shifted)
    the grid's graph Laplacian — a 2D-mesh pattern arrived at through an
    incidence matrix rather than a stencil.  One node balance is dropped (flow conservation makes the
    system rank-deficient otherwise).
    """
    rng = np.random.default_rng(seed)
    nodes = g * g
    idx = np.arange(nodes).reshape(g, g)
    tails, heads = [], []
    for ax in (0, 1):
        lo = np.take(idx, np.arange(g - 1), axis=ax).ravel()
        hi = np.take(idx, np.arange(1, g), axis=ax).ravel()
        tails.extend([lo, hi]); heads.extend([hi, lo])
    tails = np.concatenate(tails); heads = np.concatenate(heads)
    narc = tails.size
    arc = np.arange(narc)
    # incidence: +1 at tail, -1 at head
    N = sp.coo_matrix(
        (np.concatenate([np.ones(narc), -np.ones(narc)]),
         (np.concatenate([tails, heads]), np.concatenate([arc, arc]))),
        shape=(nodes, narc)).tocsr()
    # supply/demand from a feasible circulation: b = N @ f for interior f
    f_feas = rng.uniform(0.3, 0.7, narc)
    b = np.asarray(N @ f_feas).ravel()
    keep = np.arange(1, nodes)  # drop node 0's (redundant) balance row
    return QuadraticProblem(
        c=rng.uniform(1.0, 4.0, narc),
        A=N[keep],
        lcon=b[keep], ucon=b[keep],
        lvar=np.zeros(narc), uvar=np.ones(narc),  # unit capacities
        name=f"netflow_grid_lp_{g}",
    )
