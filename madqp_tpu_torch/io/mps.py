"""MPS / QPS file reader (fixed- and free-format).

Equivalent of the reference's `import_mps` (scripts/common.jl:21-36, via
QPSReader): parses the extension to handle `.mps`, `.sif`, `.SIF`, `.qps`
plus `.gz` / `.bz2` compressed variants, and returns a QuadraticProblem.

Supported sections: NAME, OBJSENSE, ROWS, COLUMNS (incl. integer markers,
parsed but relaxed), RHS, RANGES, BOUNDS (LO UP FX FR MI PL BV LI UI),
QUADOBJ / QMATRIX / QSECTION.  The QPS convention stores the objective as
c0 + c'x + 1/2 x'Qx with QUADOBJ holding the lower triangle of Q.

Carried over unchanged from `madqp_tpu/io/mps.py` (NumPy and SciPy only), so both
packages give bit-identical results.
"""

from __future__ import annotations

import bz2
import gzip
import io
import os
from typing import Dict, List, Optional, TextIO

import numpy as np
import scipy.sparse as sp

from ..models.qp import QuadraticProblem

_INF = np.inf


def _open_text(filename: str) -> TextIO:
    base = filename.lower()
    if base.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(filename, "rb"), encoding="utf-8")
    if base.endswith(".bz2"):
        return io.TextIOWrapper(bz2.open(filename, "rb"), encoding="utf-8")
    return open(filename, "r", encoding="utf-8", errors="replace")


def read_mps(filename: str) -> QuadraticProblem:
    """Read an MPS/QPS/SIF(-QP) file into a QuadraticProblem."""
    with _open_text(filename) as f:
        return parse_mps(f, name=os.path.basename(filename))


def parse_mps(f: TextIO, name: str = "mps") -> QuadraticProblem:
    section = None
    obj_name: Optional[str] = None
    minimize = True
    problem_name = name

    row_names: List[str] = []
    row_types: List[str] = []
    row_index: Dict[str, int] = {}

    col_names: List[str] = []
    col_index: Dict[str, int] = {}
    integer_cols: set = set()
    in_integer_block = False

    # COO triplets for A and the linear objective.
    ai: List[int] = []
    aj: List[int] = []
    av: List[float] = []
    c_entries: Dict[int, float] = {}
    c0 = 0.0

    rhs: Dict[int, float] = {}
    ranges: Dict[int, float] = {}

    lb: Dict[int, float] = {}
    ub: Dict[int, float] = {}

    qi: List[int] = []
    qj: List[int] = []
    qv: List[float] = []
    q_is_full = False  # QMATRIX stores both triangles

    def get_col(cname: str) -> int:
        if cname not in col_index:
            col_index[cname] = len(col_names)
            col_names.append(cname)
        return col_index[cname]

    pending_objsense = False
    saw_rows = False
    for raw in f:
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        if not line[0].isspace():
            fields = line.split()
            head = fields[0].upper()
            if head == "NAME":
                problem_name = fields[1] if len(fields) > 1 else name
                section = "NAME"
            elif head == "OBJSENSE":
                section = "OBJSENSE"
                pending_objsense = True
                if len(fields) > 1:
                    minimize = fields[1].upper() not in ("MAX", "MAXIMIZE")
                    pending_objsense = False
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                          "QUADOBJ", "QMATRIX", "QSECTION", "ENDATA",
                          "OBJECT", "SOS"):
                section = head
                if head == "ROWS":
                    saw_rows = True
                if head == "ENDATA":
                    break
            else:
                section = head  # unknown section: skip its content
            continue

        fields = line.split()
        if section == "OBJSENSE" and pending_objsense:
            minimize = fields[0].upper() not in ("MAX", "MAXIMIZE")
            pending_objsense = False
        elif section == "ROWS":
            rtype = fields[0].upper()
            rname = fields[1]
            if rtype == "N":
                if obj_name is None:
                    obj_name = rname
                # extra N rows are ignored (free rows)
                row_index.setdefault(rname, -1)
            else:
                row_index[rname] = len(row_names)
                row_names.append(rname)
                row_types.append(rtype)
        elif section == "COLUMNS":
            if len(fields) >= 3 and fields[1].upper() == "'MARKER'":
                marker = fields[2].upper()
                if "INTORG" in marker:
                    in_integer_block = True
                elif "INTEND" in marker:
                    in_integer_block = False
                continue
            cname = fields[0]
            j = get_col(cname)
            if in_integer_block:
                integer_cols.add(j)
            for k in range(1, len(fields) - 1, 2):
                rname, val = fields[k], float(fields[k + 1])
                i = row_index.get(rname)
                if i is None:
                    continue
                if i == -1 or rname == obj_name:
                    if rname == obj_name:
                        c_entries[j] = c_entries.get(j, 0.0) + val
                else:
                    ai.append(i)
                    aj.append(j)
                    av.append(val)
        elif section == "RHS":
            # fields[0] is the RHS-vector name (may be omitted in free MPS);
            # entries come in (row, value) pairs.
            start = 1 if len(fields) % 2 == 1 else 0
            for k in range(start, len(fields) - 1, 2):
                rname, val = fields[k], float(fields[k + 1])
                i = row_index.get(rname)
                if i is None:
                    continue
                if i == -1 or rname == obj_name:
                    if rname == obj_name:
                        c0 = -val  # objective constant enters negated
                else:
                    rhs[i] = val
        elif section == "RANGES":
            start = 1 if len(fields) % 2 == 1 else 0
            for k in range(start, len(fields) - 1, 2):
                rname, val = fields[k], float(fields[k + 1])
                i = row_index.get(rname)
                if i is not None and i >= 0:
                    ranges[i] = val
        elif section == "BOUNDS":
            btype = fields[0].upper()
            # fields[1] is the bound-set name; column is fields[2].
            if btype in ("FR", "MI", "PL", "BV") and len(fields) >= 3:
                cname = fields[2]
                val = 0.0
            elif len(fields) >= 4:
                cname = fields[2]
                val = float(fields[3])
            else:
                # two-token short form: TYPE COL
                cname = fields[1]
                val = 0.0
            j = get_col(cname)
            if btype == "LO":
                lb[j] = val
            elif btype == "UP":
                ub[j] = val
                # Classic MPS quirk: negative upper bound with no explicit
                # lower bound implies a free-below variable.
                if val < 0 and j not in lb:
                    lb[j] = -_INF
            elif btype == "FX":
                lb[j] = val
                ub[j] = val
            elif btype == "FR":
                lb[j] = -_INF
                ub[j] = _INF
            elif btype == "MI":
                lb[j] = -_INF
            elif btype == "PL":
                ub[j] = _INF
            elif btype == "BV":
                lb[j] = 0.0
                ub[j] = 1.0
                integer_cols.add(j)
            elif btype == "LI":
                lb[j] = val
                integer_cols.add(j)
            elif btype == "UI":
                ub[j] = val
                integer_cols.add(j)
        elif section in ("QUADOBJ", "QMATRIX", "QSECTION"):
            q_is_full = section == "QMATRIX"
            c1, c2, val = fields[0], fields[1], float(fields[2])
            qi.append(get_col(c1))
            qj.append(get_col(c2))
            qv.append(val)

    if not saw_rows:
        # Unknown *section* lines are skipped (SIF files carry extras), but a
        # file with no ROWS section at all is not MPS — without this check
        # arbitrary text parses as an empty, trivially "solved" problem.
        raise ValueError(f"{name}: not an MPS/QPS file (no ROWS section)")

    n = len(col_names)
    m = len(row_names)

    A = sp.coo_matrix(
        (np.asarray(av), (np.asarray(ai, dtype=np.int64), np.asarray(aj, dtype=np.int64))),
        shape=(m, n),
    ).tocsr() if av else sp.csr_matrix((m, n))

    c = np.zeros(n)
    for j, v in c_entries.items():
        c[j] = v

    lcon = np.full(m, -_INF)
    ucon = np.full(m, _INF)
    for i, t in enumerate(row_types):
        b = rhs.get(i, 0.0)
        if t == "E":
            lcon[i] = ucon[i] = b
        elif t == "L":
            ucon[i] = b
        elif t == "G":
            lcon[i] = b
    for i, r in ranges.items():
        t = row_types[i]
        b = rhs.get(i, 0.0)
        if t == "L":
            lcon[i] = ucon[i] - abs(r)
        elif t == "G":
            ucon[i] = lcon[i] + abs(r)
        elif t == "E":
            if r >= 0:
                lcon[i], ucon[i] = b, b + r
            else:
                lcon[i], ucon[i] = b + r, b

    lvar = np.zeros(n)
    uvar = np.full(n, _INF)
    for j, v in lb.items():
        lvar[j] = v
    for j, v in ub.items():
        uvar[j] = v

    H = None
    if qv:
        Q = sp.coo_matrix(
            (np.asarray(qv), (np.asarray(qi, dtype=np.int64), np.asarray(qj, dtype=np.int64))),
            shape=(n, n),
        ).tocsr()
        if q_is_full:
            H = Q
        else:
            D = sp.diags(Q.diagonal())
            H = (Q + Q.T - D).tocsr()

    qp = QuadraticProblem(
        c=c,
        A=A,
        H=H,
        c0=c0,
        lcon=lcon,
        ucon=ucon,
        lvar=lvar,
        uvar=uvar,
        minimize=minimize,
        name=problem_name,
    )
    qp.integer_cols = sorted(integer_cols)  # LP relaxation; recorded for info
    return qp
