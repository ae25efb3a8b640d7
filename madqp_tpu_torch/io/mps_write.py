"""MPS/QPS writer — the inverse of io.mps (round-trip capable).

Not present in the reference (QPSReader is read-only); useful for exporting
generated/transformed instances and for harness round-trip tests.

Carried over unchanged from `madqp_tpu/io/mps_write.py` (NumPy and SciPy only), so both
packages give bit-identical results.
"""

from __future__ import annotations

import numpy as np

from ..models.qp import QuadraticProblem


def write_mps(qp: QuadraticProblem, path: str) -> None:
    """Write a QuadraticProblem in (free-format) MPS/QPS."""
    lines = [f"NAME          {qp.name}"]
    if not qp.minimize:
        lines += ["OBJSENSE", "    MAX"]
    lines += ["ROWS", " N  obj"]
    m = qp.ncon
    rtypes: list[tuple[str, float, float | None]] = []
    for i in range(m):
        lo, hi = qp.lcon[i], qp.ucon[i]
        if lo == hi:
            rtypes.append(("E", lo, None))
            lines.append(f" E  c{i}")
        elif np.isfinite(hi) and not np.isfinite(lo):
            rtypes.append(("L", hi, None))
            lines.append(f" L  c{i}")
        elif np.isfinite(lo) and not np.isfinite(hi):
            rtypes.append(("G", lo, None))
            lines.append(f" G  c{i}")
        elif np.isfinite(lo) and np.isfinite(hi):
            rtypes.append(("L", hi, hi - lo))
            lines.append(f" L  c{i}")
        else:  # free row: emit as a range over (-inf, inf) via G -inf? keep G 0
            rtypes.append(("G", -np.inf, None))
            lines.append(f" G  c{i}")

    lines.append("COLUMNS")
    A = qp.A.tocsc()
    for j in range(qp.nvar):
        if qp.c[j] != 0.0:
            lines.append(f"    x{j}  obj  {float(qp.c[j])!r}")
        col = A.getcol(j).tocoo()
        for i, v in zip(col.row, col.data):
            lines.append(f"    x{j}  c{i}  {float(v)!r}")

    lines.append("RHS")
    if qp.c0 != 0.0:
        lines.append(f"    rhs  obj  {float(-qp.c0)!r}")
    for i, (t, b, rng_) in enumerate(rtypes):
        if np.isfinite(b) and b != 0.0:
            lines.append(f"    rhs  c{i}  {float(b)!r}")
    if any(r[2] is not None for r in rtypes):
        lines.append("RANGES")
        for i, (t, b, rng_) in enumerate(rtypes):
            if rng_ is not None:
                lines.append(f"    rng  c{i}  {float(rng_)!r}")

    lines.append("BOUNDS")
    for j in range(qp.nvar):
        lo, hi = qp.lvar[j], qp.uvar[j]
        if lo == hi:
            lines.append(f" FX bnd  x{j}  {float(lo)!r}")
            continue
        if not np.isfinite(lo):
            lines.append(f" MI bnd  x{j}")
        elif lo != 0.0:
            lines.append(f" LO bnd  x{j}  {float(lo)!r}")
        if np.isfinite(hi):
            lines.append(f" UP bnd  x{j}  {float(hi)!r}")

    if qp.H is not None and qp.H.nnz:
        lines.append("QUADOBJ")
        H = qp.H.tocoo()
        for i, j, v in zip(H.row, H.col, H.data):
            if i >= j:  # lower triangle
                lines.append(f"    x{j}  x{i}  {float(v)!r}")

    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
