"""Maros–Mészáros CVXQP1, CVXQP2 and CVXQP3 (CUTE), in 1-based indices:

    min  sum_i (i/2) (x_i + x_{(2i-1) mod n + 1} + x_{(3i-1) mod n + 1})^2
    s.t. x_k + 2 x_{(4k-1) mod n + 1} + 3 x_{(5k-1) mod n + 1} = 6,  k = 1..m
         0.1 <= x <= 10

with m = n/2, n/4 and 3n/4 rows for variants 1, 2 and 3.  The published
instances fix every value: the seed only picks where a rotation starts.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from qpbench.problem import Instance

ROWS = {1: lambda n: n // 2, 2: lambda n: n // 4, 3: lambda n: 3 * n // 4}


def cvxqp(n: int, variant: int) -> Instance:
    m = ROWS[variant](n)
    i = np.arange(1, n + 1)
    cols = np.stack([i, (2 * i - 1) % n + 1, (3 * i - 1) % n + 1], axis=1) - 1
    V = sp.csr_matrix((np.ones(3 * n), (np.repeat(i - 1, 3), cols.ravel())), shape=(n, n))
    H = (V.T @ sp.diags(i.astype(np.float64)) @ V).tocsr()   # sum_i i v_i v_i'
    k = np.arange(1, m + 1)
    acols = np.stack([k, (4 * k - 1) % n + 1, (5 * k - 1) % n + 1], axis=1) - 1
    A = sp.csr_matrix((np.tile([1.0, 2.0, 3.0], m), (np.repeat(k - 1, 3), acols.ravel())),
                      shape=(m, n))
    H.sum_duplicates()
    A.sum_duplicates()
    return Instance(name=f"CVXQP{variant}_n{n}", H=H, c=np.zeros(n), A=A,
                    b=np.full(m, 6.0), lvar=np.full(n, 0.1), uvar=np.full(n, 10.0))


def make_pool(config: dict, traffic: dict, seed: int):
    """(calls, start): call k is the published instance of pattern
    `patterns[k % len(patterns)]`, one instance a call; the seed picks the
    call the window starts at."""
    patterns = traffic["patterns"]
    calls = [[cvxqp(config["n"], patterns[k % len(patterns)])]
             for k in range(traffic["pool_calls"])]
    return calls, seed % len(calls)
