"""ctypes binding of the repository's native C++ sparse kernels
(`native/src/sparse_ldl.cpp`): the host path's symbolic analysis
(elimination tree, postorder, column counts, orderings) and its LDL^T
factorization with a fixed symbolic pattern.

The port's own copy of the JAX package's binding, with its functions and
results unchanged.  The library is built at first use by `ops/_build.py`
(g++ with `_build.GXX_FLAGS`) into `madqp_tpu_torch/_build/`, named by a
hash of the source and the flags, under a temporary name renamed into
place: processes that build at once each load a whole library.  A failed
build raises with the compiler's output; only `available()` turns it into
False, for the callers that may choose another route (the sparse drivers'
`endgame="auto"`, the batched rescue).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..ops import _build

SOURCE = _build.PKG_DIR.parent / "native" / "src" / "sparse_ldl.cpp"

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_int = ctypes.c_int

# exported C function -> (argtypes, restype)
SIGNATURES = {
    "madqp_etree": ((_int, _i64p, _i32p, _i32p), None),
    "madqp_postorder": ((_int, _i32p, _i32p), None),
    "madqp_col_counts": ((_int, _i64p, _i32p, _i32p, _i32p), None),
    "madqp_amd_order": ((_int, _i64p, _i32p, _i32p), None),
    "madqp_amd_elem_order": ((_int, _i64p, _i32p, _i32p), None),
    "madqp_ldl_symbolic": ((_int, _i32p, _i64p), None),
    "madqp_ldl_numeric": ((_int, _i64p, _i32p, _f64p, _i32p, _i64p, _i32p, _f64p,
                           _f64p, _i32p, _i32p, _i32p, _f64p), _int),
    "madqp_ldl_solve": ((_int, _i64p, _i32p, _f64p, _i32p, _f64p, _f64p), None),
}


def build() -> str:
    """Compile the library if this checkout has not.  Returns its path."""
    return str(_build.build(SOURCE))


def _load() -> ctypes.CDLL:
    return _build.load(SOURCE, SIGNATURES)


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# High-level API
# ---------------------------------------------------------------------------


def _upper_csc(A: sp.spmatrix) -> sp.csc_matrix:
    U = sp.triu(A.tocsr(), k=0, format="csc").sorted_indices()
    return U


def etree(A: sp.spmatrix) -> np.ndarray:
    """Elimination tree of the symmetric matrix A (pattern only)."""
    lib = _load()
    U = _upper_csc(A)
    n = U.shape[0]
    parent = np.empty(n, np.int32)
    lib.madqp_etree(
        n, U.indptr.astype(np.int64), U.indices.astype(np.int32), parent
    )
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    lib = _load()
    n = parent.shape[0]
    post = np.empty(n, np.int32)
    lib.madqp_postorder(n, parent.astype(np.int32), post)
    return post


def col_counts(A: sp.spmatrix, parent: Optional[np.ndarray] = None) -> np.ndarray:
    lib = _load()
    U = _upper_csc(A)
    n = U.shape[0]
    if parent is None:
        parent = etree(A)
    counts = np.empty(n, np.int32)
    lib.madqp_col_counts(
        n, U.indptr.astype(np.int64), U.indices.astype(np.int32),
        parent.astype(np.int32), counts,
    )
    return counts


def amd_order(A: sp.spmatrix, variant: str = "elem") -> np.ndarray:
    """Fill-reducing minimum-degree permutation (perm[k] = original index).

    variant='elem' (default): quotient-graph approximate minimum degree —
    O(nnz) memory, scales to large n.  variant='clique': the explicit
    clique-merge variant (exact degrees, small n only)."""
    lib = _load()
    S = (abs(A) + abs(A).T).tocsc().sorted_indices()
    n = S.shape[0]
    perm = np.empty(n, np.int32)
    fn = lib.madqp_amd_elem_order if variant == "elem" else lib.madqp_amd_order
    fn(n, S.indptr.astype(np.int64), S.indices.astype(np.int32), perm)
    return perm


_AMD_SIZE_LIMIT = 200_000  # element-based AMD is O(nnz)-memory; cap anyway


def nd_order(A: sp.spmatrix, leaf: int = 96) -> np.ndarray:
    """Nested-dissection permutation via recursive level-set bisection.

    George-style: BFS from a pseudo-peripheral vertex gives level sets;
    split at the median level, peel the boundary of the near half as a
    vertex separator, recurse on the two halves, number the separator
    LAST.  Leaves (<= `leaf` vertices) are ordered with AMD.

    The point is tree *shape*, not fill: separators become the top
    supernodes, so the assembly tree is balanced with 2^k independent,
    same-shaped subtrees at depth k, which a batched numeric phase can
    factor one level at a time instead of as one long sequential chain.
    """
    G = (abs(A) + abs(A).T).tocsr()
    G.setdiag(0)
    G.eliminate_zeros()
    G = sp.csr_matrix((np.ones_like(G.data, dtype=np.int8),
                       G.indices, G.indptr), shape=G.shape)
    n = G.shape[0]
    out = np.empty(n, np.int32)
    pos = n  # fill from the back: separators first (= numbered last)
    # Explicit stack: arrays are vertex sets to split; 1-tuples are
    # separator blocks emitted as-is.
    stack = [np.arange(n, dtype=np.int32)]
    while stack:
        verts = stack.pop()
        if isinstance(verts, tuple):  # deferred separator block
            sep = verts[0]
            pos -= sep.size
            out[pos:pos + sep.size] = sep
            continue
        nv = verts.size
        if nv == 0:
            continue
        sub = G[verts][:, verts].tocsr()
        ncomp, labels = sp.csgraph.connected_components(sub, directed=False)
        if ncomp > 1:
            for c in range(ncomp):
                stack.append(verts[labels == c])
            continue
        if nv <= leaf:
            p = amd_order(sub) if nv > 2 else np.arange(nv, dtype=np.int32)
            pos -= nv
            out[pos:pos + nv] = verts[p]
            continue
        # pseudo-peripheral: two BFS sweeps
        d = sp.csgraph.dijkstra(sub, unweighted=True, indices=0,
                                directed=False)
        src = int(np.argmax(np.where(np.isinf(d), -1, d)))
        d = sp.csgraph.dijkstra(sub, unweighted=True, indices=src,
                                directed=False)
        levels = d.astype(np.int64)
        t = int(np.median(levels))
        near = levels <= t
        far = ~near
        # separator: near-side vertices adjacent to the far side
        far_mask = far
        adj_far = np.zeros(nv, bool)
        for v in np.flatnonzero(near):
            row = sub.indices[sub.indptr[v]:sub.indptr[v + 1]]
            if far_mask[row].any():
                adj_far[v] = True
        sep_l = near & adj_far
        if not sep_l.any() or not (near & ~sep_l).any() or not far.any():
            # degenerate split (e.g. star graphs): fall back to AMD
            p = amd_order(sub)
            pos -= nv
            out[pos:pos + nv] = verts[p]
            continue
        # Fill is back-to-front and the stack is LIFO, so push the
        # separator LAST: it pops first and takes the highest (= last
        # eliminated) slots, then the two halves fill below it.
        stack.append(verts[near & ~sep_l])
        stack.append(verts[far])
        stack.append((verts[sep_l],))
    assert pos == 0
    return out


def ordering(A: sp.spmatrix, method: str = "auto") -> np.ndarray:
    """Fill-reducing permutation: 'amd' (native minimum degree), 'nd'
    (nested dissection — balanced assembly tree for batched device
    factorization), 'rcm' (scipy reverse Cuthill-McKee), 'natural', or
    'auto' (amd below _AMD_SIZE_LIMIT, rcm above)."""
    n = A.shape[0]
    if method == "auto":
        method = "amd" if n <= _AMD_SIZE_LIMIT else "rcm"
    if method == "natural":
        return np.arange(n, dtype=np.int32)
    if method == "nd":
        return nd_order(A)
    if method == "rcm":
        return np.asarray(
            sp.csgraph.reverse_cuthill_mckee(
                sp.csr_matrix(abs(A) + abs(A).T), symmetric_mode=True
            ),
            dtype=np.int32,
        )
    if method == "amd":
        return amd_order(A)
    raise ValueError(f"unknown ordering '{method}'")


class SparseLDL:
    """LDL^T factorization with fixed symbolic pattern (host-side).

    Mirrors the reference's build-once / refactor-every-iteration split
    (normalkkt.jl:94-97 vs :166-180): construct once from the pattern, call
    `factorize(values)` per iteration, `solve(b)` for each RHS.
    """

    def __init__(self, A: sp.spmatrix, use_amd: bool = True,
                 order: str = "auto"):
        lib = _load()
        A = sp.csc_matrix(A)
        n = A.shape[0]
        self.n = n
        self.perm = (
            ordering(A, order) if use_amd
            else np.arange(n, dtype=np.int32)
        )
        self.iperm = np.empty(n, np.int32)
        self.iperm[self.perm] = np.arange(n, dtype=np.int32)
        Ap = A[self.perm][:, self.perm].tocsc()
        self._Aperm_pattern = Ap
        U = _upper_csc(Ap)
        self._U = U
        self.parent = np.empty(n, np.int32)
        lib.madqp_etree(
            n, U.indptr.astype(np.int64), U.indices.astype(np.int32),
            self.parent,
        )
        counts = np.empty(n, np.int32)
        lib.madqp_col_counts(
            n, U.indptr.astype(np.int64), U.indices.astype(np.int32),
            self.parent, counts,
        )
        self.Lp = np.empty(n + 1, np.int64)
        lib.madqp_ldl_symbolic(n, counts, self.Lp)
        nnzL = int(self.Lp[-1])
        self.Li = np.empty(nnzL, np.int32)
        self.Lx = np.empty(nnzL, np.float64)
        self.D = np.empty(n, np.float64)
        self.Lnz = np.empty(n, np.int32)
        self._pattern_ws = np.empty(2 * n, np.int32)
        self._flag_ws = np.empty(n, np.int32)
        self._y_ws = np.empty(n, np.float64)
        self._Up = U.indptr.astype(np.int64)
        self._Ui = U.indices.astype(np.int32)
        self.ok = False

    @property
    def nnz_factor(self) -> int:
        return int(self.Lp[-1]) + self.n

    def factorize(self, A: sp.spmatrix) -> bool:
        """Numeric factorization of a matrix with the SAME pattern."""
        lib = _load()
        Ap = sp.csc_matrix(A)[self.perm][:, self.perm]
        U = _upper_csc(Ap)
        rank = lib.madqp_ldl_numeric(
            self.n, self._Up, self._Ui, U.data.astype(np.float64),
            self.parent, self.Lp, self.Li, self.Lx, self.D, self.Lnz,
            self._pattern_ws, self._flag_ws, self._y_ws,
        )
        self.ok = rank == self.n
        return self.ok

    def solve(self, b: np.ndarray) -> np.ndarray:
        lib = _load()
        x = np.asarray(b, np.float64)[self.perm].copy()
        lib.madqp_ldl_solve(
            self.n, self.Lp, self.Li, self.Lx, self.Lnz, self.D, x
        )
        return x[self.iperm]

    @property
    def is_factorized(self) -> bool:
        """Success probe (reference is_factorized, src/utils.jl:54-62)."""
        return self.ok and bool(np.all(np.isfinite(self.D)))
