"""Shared infrastructure of the sparse device paths (port of
`madqp_tpu/solver/sparse_common.py`).

- `canonical_csc(M)`: the ONE canonicalization that the KKT constructors
  and value refills share (CSC, summed duplicates, sorted indices);
- `pattern_fingerprint(...)`: sha1 over shapes and index structure, the
  cache key for "same sparsity, different values";
- `get_sparse_kernel(...)`: an LRU of (KKT, MPCKernel) keyed by (kind,
  fingerprint, options), so repeated solves of problems with one pattern
  reuse the KKT's symbolic work (its contribution lists);
- `stepped_solve`: the host-stepped MPC loop of the sparse drivers;
- `resolve_endgame`, `measure_sparse_ls`: endgame="auto"'s resolution and
  the post-solve linear-solver timing (the two-phase scheme's option split
  is `policy.sparse_phases`).

The JAX package's executable cache and its compile plumbing
(`_exec_cache_dir`, `_exec_cache_key`, `_load_or_compile`,
`chunked_solve`, `dense_chunk_len`, `start_phase2_overlap`) have no
counterpart: the port compiles nothing per pattern, and its loop is always
stepped on the host (`chunked_solve` dispatched bounded chunks of the same
terminal-safe iteration, so the iterates are those of `stepped_solve`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import kernels as K
from ..utils.profiling import span
from . import state as S
from .mpc import MPCKernel
from .policy import best_time


def canonical_csc(M: sp.spmatrix) -> sp.csc_matrix:
    """Canonical CSC form: duplicates summed, indices sorted.  COO export
    of this form (column-major) is the value order every sparse-KKT
    consumer assumes."""
    M = sp.csc_matrix(M)
    M.sum_duplicates()
    return M.sorted_indices()


def canonical_coo_vals(M: sp.spmatrix) -> np.ndarray:
    """Values of canonical_csc(M) in its COO (column-major) order."""
    return canonical_csc(M).tocoo().data.copy()


def pattern_fingerprint(A: sp.spmatrix,
                        H: Optional[sp.spmatrix] = None) -> str:
    """sha1 of the sparsity structure (not values) of A (and H)."""
    h = hashlib.sha1()
    for M in (A, H):
        if M is None:
            h.update(b"none")
            continue
        M = canonical_csc(M)
        h.update(np.asarray(M.shape, np.int64).tobytes())
        h.update(M.indptr.astype(np.int64).tobytes())
        h.update(M.indices.astype(np.int64).tobytes())
    return h.hexdigest()


def upper_lookup(U: sp.csc_matrix):
    """Position lookup in the value array of the sorted upper-triangle CSC
    `U`: returns pos(i, j), the positions of the entries (i, j), i <= j
    (arrays), by a sorted key search (the JAX package's dict of (i, j))."""
    N = U.shape[0]
    col = np.repeat(np.arange(N, dtype=np.int64), np.diff(U.indptr))
    keys = col * N + U.indices.astype(np.int64)

    def pos(i, j):
        i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
        return np.searchsorted(keys, j * N + i)
    return pos


def value_gather(symb, U: sp.csc_matrix) -> np.ndarray:
    """For each entry of a supernodal schedule's permuted upper CSC
    (`symb.Up`, `symb.Ui`), its position in the value array of U, the
    matrix's sorted upper-triangle CSC: the permuted entry (Ui[p], j) is
    the matrix's (perm[Ui[p]], perm[j]), stored at the upper position of
    that pair (the JAX package's loop, by a sorted key search)."""
    N = U.shape[0]
    perm = np.asarray(symb.perm, np.int64)
    col = np.repeat(np.arange(N, dtype=np.int64), np.diff(symb.Up))
    gi, gj = perm[symb.Ui.astype(np.int64)], perm[col]
    return upper_lookup(U)(np.minimum(gi, gj), np.maximum(gi, gj)).astype(np.int32)


_KERNEL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_KERNEL_CACHE_SIZE = 16  # each entry holds a KKT's symbolic lists (MBs)


def get_sparse_kernel(kind: str, fingerprint: str, opts, make_kkt):
    """Return (kkt, kernel) for this (kind, pattern, options), building the
    KKT with make_kkt() on a miss.  The KKT keeps its symbolic index lists
    (host arrays, and a copy per device made at first use), so a problem
    with the same sparsity and other values skips the symbolic work.  The
    lookup is the span `construct.kkt`, its value True on a miss."""
    key = (kind, fingerprint, opts)
    hit = _KERNEL_CACHE.get(key)
    with span("construct.kkt", hit is None):
        if hit is not None:
            _KERNEL_CACHE.move_to_end(key)
            return hit
        kkt = make_kkt()
        hit = (kkt, MPCKernel(opts, kkt=kkt))
        _KERNEL_CACHE[key] = hit
        while len(_KERNEL_CACHE) > _KERNEL_CACHE_SIZE:
            _KERNEL_CACHE.popitem(last=False)
        return hit


def stepped_solve(kernel, prob, x0, y0, lb, ub, warm=None):
    """Host-stepped solve: `kernel.iteration` until the status leaves
    RUNNING (the JAX package's stepped and chunked loops dispatch the same
    terminal-safe iteration).  `warm` = (zl0, zu0) starts from the given
    point (`init_state_warm`)."""
    if warm is not None:
        state = kernel.init_state_warm(prob, x0, y0, *warm, lb, ub)
    else:
        state = kernel.init_state(prob, x0, y0, lb, ub)
    while state.status == S.RUNNING:
        state = kernel.iteration(prob, state)
    return state


def resolve_endgame(opts):
    """Resolve endgame='auto' for the sparse device drivers: 'host' when
    the native C++ LDL library builds and loads, else 'f64' (the JAX
    package's rule)."""
    if opts.endgame != "auto":
        return opts
    from ..native import available

    return dataclasses.replace(opts, endgame="host" if available() else "f64")


def measure_sparse_ls(kkt, prob, final, lb, ub, reps=3):
    """Measured cumulative factorize + backsolve seconds at the terminal
    iterate, scaled by the recorded counts (reference
    linear_solver_time, scripts/benchmarks_cpu.jl:55): one factorization
    and one backsolve at the final state, best of `reps` after a warm-up
    (the iterate perturbed per rep), times final.n_fact / final.n_solve.
    For a two-phase solve call it once per phase and sum."""
    device = final.x.device
    eps = 10.0 * float(torch.finfo(final.x.dtype).eps)

    def fact(i):
        x = final.x * (1.0 + eps * i)
        pr = K.sigma_diagonal(x, lb, ub, prob.has_lb, prob.has_ub,
                              final.zl, final.zu, final.del_w)
        f = kkt.factorize(prob, pr, final.del_c)
        kkt.factor_ok(f)
        return f

    t_fact, factors = best_time(fact, device, reps, warmup=1)
    t_solve, _ = best_time(lambda i: kkt.solve(factors, final.x * (1.0 + eps * i), final.y),
                           device, reps, warmup=1)
    return t_fact * int(final.n_fact) + t_solve * int(final.n_solve)
