"""Plain reference of `mm_cvxqp_m`: the interior-point method of `ipm.py`
with SciPy's sparse matrices, each lane's KKT system factored by SuperLU
(`scipy.sparse.linalg.splu`)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from qpbench.reference import ipm


def solve(instances, dtype=np.float64, **kw) -> ipm.Result:
    H = [p.H.astype(dtype) for p in instances]
    A = [p.A.astype(dtype) for p in instances]
    n = instances[0].n

    def per_lane(mats, v):
        return np.stack([M @ row for M, row in zip(mats, v)])

    def kkt_factor(D, lanes):
        lus = [spla.splu(sp.bmat([[H[lane] + sp.diags(D[k]), A[lane].T], [A[lane], None]],
                                 format="csc"))
               for k, lane in enumerate(np.flatnonzero(lanes))]

        def kkt_solve(rx, ry):
            sol = np.stack([lu.solve(np.concatenate([rx[k], ry[k]]).astype(dtype))
                            for k, lu in enumerate(lus)])
            return sol[:, :n], sol[:, n:]
        return kkt_solve

    return ipm.solve(
        np.stack([p.c for p in instances]), np.stack([p.b for p in instances]),
        np.stack([p.lvar for p in instances]), np.stack([p.uvar for p in instances]),
        hv=lambda x: per_lane(H, x), av=lambda x: per_lane(A, x),
        atv=lambda y: per_lane([M.T for M in A], y),
        kkt_factor=kkt_factor, dtype=dtype, **kw)
