"""Padding of one internal standard form to a larger shape (port of
`madqp_tpu/parallel/batched.py::pad_standard`, host NumPy).

  * padding variables get c = 0, unit Hessian diagonal (QP), box bounds
    [-1, 1] so their barrier terms keep the condensed diagonal positive;
  * padding constraint rows pin one padding variable each (x_pad = 0), so
    the Schur complement stays nonsingular.

The batched solver built on it (`BatchedMPCSolver`, `solve_batched`) is
not ported yet: ROADMAP.md Queue 1, item 9.
"""

from __future__ import annotations

import numpy as np

from ..models.qp import StandardQP


def pad_standard(
    std: StandardQP, x0, y0, n_tot: int, m_tot: int, force_H: bool
) -> tuple[StandardQP, np.ndarray, np.ndarray]:
    """Pad one internal standard form to (n_tot, m_tot)."""
    n, m = std.n, std.m
    nd, md = n_tot - n, m_tot - m
    if nd < md or md < 0:
        raise ValueError(
            f"cannot pad (n={n}, m={m}) to (n_tot={n_tot}, m_tot={m_tot}): "
            "need one padding variable per padding row")

    c = np.concatenate([std.c, np.zeros(nd)])
    b = np.concatenate([std.b, np.zeros(md)])
    A = np.zeros((m_tot, n_tot))
    A[:m, :n] = std.A
    # Pin the first md padding variables with the padding rows.
    for j in range(md):
        A[m + j, n + j] = 1.0

    H = None
    if force_H:
        H = np.zeros((n_tot, n_tot))
        if std.H is not None:
            H[:n, :n] = std.H
        # Unit curvature on padding variables keeps W well-conditioned.
        for j in range(nd):
            H[n + j, n + j] = 1.0

    lb = np.concatenate([std.lb, np.full(nd, -1.0)])
    ub = np.concatenate([std.ub, np.full(nd, 1.0)])
    has_lb = np.concatenate([std.has_lb, np.full(nd, True)])
    has_ub = np.concatenate([std.has_ub, np.full(nd, True)])

    padded = StandardQP(
        c0=std.c0, c=c, H=H, A=A, b=b,
        lb=lb, ub=ub, has_lb=has_lb, has_ub=has_ub,
    )
    x0p = np.concatenate([x0, np.zeros(nd)])
    y0p = np.concatenate([y0, np.zeros(md)])
    return padded, x0p, y0p
