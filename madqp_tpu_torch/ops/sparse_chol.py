"""Supernodal multifrontal sparse Cholesky on the device (port of
`madqp_tpu/ops/sparse_chol.py`).

Host symbolic phase (once per pattern), NumPy and the native orderings of
`madqp_tpu_torch.native`, copied from the JAX package so that every
schedule is bit-equal to its: the fill-reducing ordering, the elimination
tree, the relaxed supernodes, and static index maps for every front (the
A-scatter map and the children's extend-add maps).  `analyze` gives one
`Supernode` per front; `analyze_batched` groups same-shape fronts into a
schedule of `_Bucket` (one round of fronts), `_BucketScan` (consecutive
same-shape rounds) and `_Chain` (a single-child path, the "level" mode)
items.  `ScheduleTooLargeError` above MADQP_MAX_UPDATE_ENTRIES.

Numeric phase (every factorization), torch ops around K1 on the device the
values lie on.  A schedule's index arrays go to a device once
(`device_schedule`), rearranged for a deterministic reduction: every
front is assembled from ONE working vector `work` = [S's permuted upper
values | the flat child-update buffer `upd_buf` | 0 | 1 | a chain's
carried update], by a gather in the order of the front position each value
goes to (sorted at symbolic time, stably, so a position's values add in
the reference's order: A's entries, the unit padding, then the children)
and a sorted segment sum; contributions to a scratch slot are dropped
there, at symbolic time.  No scatter adds with atomics (PARITY section
2.4): two factorizations of the same values give the same bits on the
card.  The triangular sweeps of `solve_batched` add into shared rows the
same way.

Per front stack, in float64 and float32 alike: the diagonal blocks F11
(count, w_pad, w_pad) are factored by K1's batched form, one launch per
stack (`ops/pallas_chol.py::cholesky_lower_routed`; on the CPU the plain
twin of the route the card takes); L11^-1 is a triangular solve against
the identity, L21 = F21 L11^-T and U = F22 - L21 L21^T are batched
products.  The reference computes the same factor as blocked_ldl + sqrt(d)
(L11 = Lu sqrt(d)).  A front that is not SPD gives NaN on its diagonal,
which `factor_ok_batched` reports.  The signed LDL^T
(`factorize_batched_ldl`: the augmented K2 system, and the float32 phases'
pivot-floored fronts) factors each stack's F11 by `blocked_ldl`: on the
card K2-batched (`ops/blocked_dense.py::ldl_blocks` over
`ops/ldl_batched.py::ldl_lower_batched`, `csrc/ldl_batched.cu`, one launch
per stack), on the CPU the reference's recursion.  `lax.scan` over
a `_BucketScan`'s rounds or a `_Chain`'s steps is a Python loop here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .blocked_dense import blocked_ldl, inv_unit_lower
from .pallas_chol import cholesky_lower_routed
from .segment import lengths_tensor, segment_sum


class ScheduleTooLargeError(RuntimeError):
    """The flat scatter-map supernodal schedule would exceed the update-
    traffic cap (MADQP_MAX_UPDATE_ENTRIES) — the fill pattern needs a
    hierarchical multifrontal numeric phase; callers fall back to the
    host sparse path."""


@dataclasses.dataclass
class Supernode:
    cols: np.ndarray        # global (permuted) column indices, width w
    rows: np.ndarray        # full row structure incl. diagonal block, size r
    parent: int             # parent supernode id or -1
    # Assembly: scatter of A's upper-triangle entries into the (r, r) front.
    a_src: np.ndarray       # indices into the permuted upper-CSC value array
    a_dst: np.ndarray       # flat positions into the front (r*r)
    # Extend-add: for each child, positions of its update matrix in this front.
    child_ids: List[int]
    child_dst: List[np.ndarray]  # flat positions (uc*uc entries each)


@dataclasses.dataclass
class SupernodalSymbolic:
    n: int
    perm: np.ndarray
    iperm: np.ndarray
    supernodes: List[Supernode]
    Up: np.ndarray          # permuted upper-CSC structure (for value refill)
    Ui: np.ndarray
    max_width: int

    def permute_values(self, A: sp.spmatrix) -> np.ndarray:
        """Upper-triangle value array of P A P' in the stored CSC order."""
        Ap = sp.csc_matrix(A)[self.perm][:, self.perm]
        U = sp.triu(Ap.tocsr(), k=0, format="csc").sorted_indices()
        return np.asarray(U.data, dtype=np.float64)


def analyze(A: sp.spmatrix, order: str = "auto",
            max_supernode: int = 128, relax: int = 16) -> SupernodalSymbolic:
    """Host symbolic analysis of the SPD pattern of A.

    Supernodes use *relaxed amalgamation*: column j joins the running
    supernode when it is its elimination-tree parent and the merge adds at
    most `relax` padded rows to the panel.  Fundamental supernodes alone
    degenerate to width 1 on banded/chain patterns (struct(j-1) is never
    exactly {j} ∪ struct(j)); relaxation recovers wide dense panels
    — on a banded matrix the merge is exact (zero fill) and
    panels reach max_supernode width.
    """
    from ..native import SparseLDL, etree as _etree, ordering, postorder

    A = sp.csc_matrix(A)
    n = A.shape[0]
    perm0 = ordering(A, order)
    # Postorder the elimination tree so supernode columns are contiguous
    # and children precede parents (multifrontal traversal requirement).
    Aperm0 = A[perm0][:, perm0].tocsc()
    parent0 = _etree(Aperm0)
    post = postorder(parent0)
    perm = np.asarray(perm0)[post]

    # Exact factor structure from the native symbolic+numeric machinery
    # (numeric on a made-SPD proxy materializes Li in final order).
    Aperm = A[perm][:, perm].tocsc()
    proxy = Aperm.copy()
    proxy = (abs(proxy) + abs(proxy).T).tocsc()
    proxy = proxy + (abs(proxy).sum(axis=1).A1.max() + 1.0) * sp.eye(n)
    fs = SparseLDL(proxy, use_amd=False)
    ok = fs.factorize(proxy)
    assert ok, "symbolic proxy factorization failed"
    Lp, Li, Lnz = fs.Lp, fs.Li, fs.Lnz
    parent = np.asarray(_etree(Aperm))

    # column structures (strictly lower) of L
    col_rows = [np.sort(Li[Lp[j]: Lp[j] + Lnz[j]]) for j in range(n)]

    # Relaxed supernode partition.  B tracks the running panel's
    # strictly-below row set (as a python set for cheap union/diff).
    sn_start = [0]
    B = set(int(r) for r in col_rows[0]) if n else set()
    for j in range(1, n):
        chain = parent[j - 1] == j and (j - sn_start[-1]) < max_supernode
        if chain:
            newB = (B - {j}) | set(int(r) for r in col_rows[j])
            if len(newB) - col_rows[j].size <= relax:
                B = newB
                continue
        sn_start.append(j)
        B = set(int(r) for r in col_rows[j])
    sn_start.append(n)

    U = sp.triu(Aperm.tocsr(), k=0, format="csc").sorted_indices()
    Up = U.indptr.astype(np.int64)
    Ui = U.indices.astype(np.int32)

    # map column -> supernode id
    nsn = len(sn_start) - 1
    col_sn = np.empty(n, np.int32)
    for s in range(nsn):
        col_sn[sn_start[s]: sn_start[s + 1]] = s

    # Bottom-up row structures: a supernode's below set is the union of its
    # member columns' structures AND its children's update rows — with
    # amalgamated (padded) panels the update can carry rows absent from the
    # exact parent structure, so the union is required for the extend-add
    # maps to stay total.  Processing by ascending first column is
    # topological (postordered etree: children's columns precede parents').
    snodes: List[Supernode] = []
    pending: List[List[int]] = [[] for _ in range(nsn)]  # child ids per snode
    below_sets: List[np.ndarray] = [None] * nsn
    for s in range(nsn):
        j0, j1 = sn_start[s], sn_start[s + 1]
        rows = set()
        for i in range(j0, j1):
            rows.update(int(r) for r in col_rows[i])
        for c in pending[s]:
            rows.update(int(r) for r in below_sets[c])
        rows.difference_update(range(j0, j1))
        below = np.asarray(sorted(rows), np.int64)
        below_sets[s] = below
        cols = np.arange(j0, j1)
        all_rows = np.concatenate([cols, below]).astype(np.int64)
        snodes.append(Supernode(cols=cols, rows=all_rows, parent=-1,
                                a_src=None, a_dst=None,
                                child_ids=[], child_dst=[]))
        if below.size:
            p = int(col_sn[below[0]])
            snodes[s].parent = p
            pending[p].append(s)

    for s in range(nsn):
        snodes[s].child_ids = pending[s]

    # A-assembly maps.  An upper entry (i, j), i <= j, is the lower entry
    # (j, i) of column i, so it is assembled in the front of snode(i) at
    # local position (loc[j], loc[i]) — j is guaranteed to be in that
    # front's row structure (A's column pattern is a subset of L's).
    locs = [
        {int(g): k for k, g in enumerate(sn.rows)} for sn in snodes
    ]
    src_lists: List[List[int]] = [[] for _ in snodes]
    dst_lists: List[List[int]] = [[] for _ in snodes]
    for j in range(n):
        for p in range(Up[j], Up[j + 1]):
            i = int(Ui[p])  # i <= j
            s = int(col_sn[i])
            loc = locs[s]
            r = snodes[s].rows.size
            a, b = loc[j], loc[i]
            if a < b:
                a, b = b, a
            src_lists[s].append(p)
            dst_lists[s].append(a * r + b)
    for s, sn in enumerate(snodes):
        sn.a_src = np.asarray(src_lists[s], np.int64)
        sn.a_dst = np.asarray(dst_lists[s], np.int64)

    # extend-add maps: child update rows = child.rows[wc:] — all appear in
    # the parent's row set (by the etree property, possibly spread).
    # Incremental feasibility guard (round-5 laplqp post-mortem): these
    # flat uc^2-entry maps are where high-fill patterns (2-D-grid ND
    # factorizations) first explode — the 22.5k Laplacian ate >26M
    # entries on a SINGLE supernode and >55 GB in total before the OOM
    # killer fired.  Track the running total and fail fast with a typed
    # error the drivers turn into a clean host-path fallback.
    import os as _os

    _cap = int(float(_os.environ.get("MADQP_MAX_UPDATE_ENTRIES", 2.5e8)))
    _child_entries = 0
    for s, sn in enumerate(snodes):
        loc = {int(g): k for k, g in enumerate(sn.rows)}
        for c in sn.child_ids:
            ch = snodes[c]
            urows = ch.rows[ch.cols.size:]
            # positions of each (i, j) pair of the child's update (uc x uc,
            # lower triangle mirrored like above)
            uc = urows.size
            _child_entries += uc * uc
            if _child_entries > _cap:
                raise ScheduleTooLargeError(
                    f"supernodal extend-add maps exceed "
                    f"MADQP_MAX_UPDATE_ENTRIES={_cap:.2e} (running total "
                    f"{_child_entries:.2e} at supernode {s}/{len(snodes)});"
                    " this fill pattern needs a hierarchical multifrontal"
                    " numeric phase (use the host path)")
            lidx = np.asarray([loc[int(g)] for g in urows], np.int64)
            grid_a = np.repeat(lidx, uc)
            grid_b = np.tile(lidx, uc)
            a = np.maximum(grid_a, grid_b)
            b = np.minimum(grid_a, grid_b)
            r = sn.rows.size
            sn.child_dst.append(a * r + b)

    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    return SupernodalSymbolic(
        n=n, perm=np.asarray(perm, np.int64), iperm=iperm,
        supernodes=snodes, Up=Up, Ui=Ui,
        max_width=max(sn.cols.size for sn in snodes),
    )


# ---------------------------------------------------------------------------
# The batched numeric phase walks a SCHEDULE of item kinds, built here on
# the host exactly as the JAX package builds it:
#
#   * _Bucket - supernodes sharing a padded (width, update) shape, one
#     round of independent fronts factored as one stack;
#   * _BucketScan - consecutive same-shape rounds, stacked along a first
#     axis (the reference's lax.scan; a loop over the rounds here);
#   * _Chain - a maximal single-child path of constant padded shape, whose
#     running Schur update is carried from step to step ("level" mode).
#
# All irregularity is precomputed as static gather / scatter index arrays;
# cross-item Schur updates flow through a flat `upd_buf` with static
# per-supernode offsets and a scratch slot at its end.
# ---------------------------------------------------------------------------



def _pad_pow2(v: int, lo: int = 8) -> int:
    b = lo
    while b < v:
        b *= 2
    return b


def _pad_class(v: int, lo: int = 8) -> int:
    """Coarse pad classes: powers of 4 from 8 (8, 32, 128, 512), then
    powers of 2.  Fewer distinct front shapes means fewer, larger stacks:
    same-shape rounds merge and consecutive rounds stack into one scan."""
    if v <= 0:
        return 0
    b = lo
    while b < v:
        b *= 4 if b < 512 else 2
    return b


@dataclasses.dataclass
class _Bucket:
    """One (level, shape) group of supernodes, batched on device."""

    w_pad: int
    u_pad: int
    count: int
    cols_idx: np.ndarray     # (L, w_pad) gather/scatter idx into x; dummy = n
    below_idx: np.ndarray    # (L, u_pad) idx of below-diagonal rows; dummy = n
    asm_src: np.ndarray      # gather into a_values (A assembly)
    asm_dst: np.ndarray      # flat scatter into the (L*r_pad*r_pad,) fronts
    pad_dst: np.ndarray      # unit-diagonal positions for width padding
    child_src: np.ndarray    # gather into upd_buf (extend-add)
    child_dst: np.ndarray    # flat scatter into fronts
    upd_src: np.ndarray      # gather from the (L*u_pad*u_pad,) update tensor
    upd_dst: np.ndarray      # scatter (set) into upd_buf
    diag_rows: np.ndarray    # (L, w_pad) real-column mask


@dataclasses.dataclass
class _Chain:
    """A single-child assembly-tree path, factored step by step.

    Per-step stacked index arrays (first axis = chain position); the
    carry is the (u_pad, u_pad) padded Schur update handed to the next
    front.  `init_src` seeds the carry from a non-chain child's update in
    upd_buf (scratch slot = len(upd_buf) reads 0); `final_src/dst` write
    the last update out for the chain's parent.
    """

    w_pad: int
    u_pad: int
    count: int
    cols_idx: np.ndarray     # (K, w_pad) dummy = n
    below_idx: np.ndarray    # (K, u_pad) dummy = n
    asm_src: np.ndarray      # (K, La) into a_values (pad: src 0 -> scratch)
    asm_dst: np.ndarray      # (K, La) into flat front + scratch slot
    pad_dst: np.ndarray      # (K, Lp) unit-diagonal positions (scratch-padded)
    chain_dst: np.ndarray    # (K, Lt) carry tril pairs -> front (scratch-padded)
    tri_src: np.ndarray      # (Lt,) static tril gather from the (u_pad^2,) carry
    init_src: Optional[np.ndarray]   # (u_pad^2,) gather from upd_buf (+scratch)
    final_src: Optional[np.ndarray]  # gather from padded final carry
    final_dst: Optional[np.ndarray]  # scatter into upd_buf
    diag_rows: np.ndarray    # (K, w_pad) real-column mask


@dataclasses.dataclass
class _BucketScan:
    """K consecutive same-shape rounds as one item (leading axis of every
    array = round index).  Cross-round dependencies flow through the flat
    `upd_buf` update array — the generalization of `_Chain` to multi-node
    rounds.  Lane count
    is padded to the largest round; padding slots factor identity fronts
    (unit diagonal injected via pad_dst) and scatter their update to the
    upd_buf scratch slot."""

    w_pad: int
    u_pad: int
    count: int               # padded lanes per step
    steps: int               # K
    cols_idx: np.ndarray     # (K, count, w_pad); dummy = n
    below_idx: np.ndarray    # (K, count, max(u_pad, 1)); dummy = n
    asm_src: np.ndarray      # (K, Ea) into a_values (pad: src 0)
    asm_dst: np.ndarray      # (K, Ea) into flat fronts (pad: scratch)
    pad_dst: np.ndarray      # (K, Ep) unit-diagonal positions
    child_src: np.ndarray    # (K, Ec) gather from upd_buf (pad: 0)
    child_dst: np.ndarray    # (K, Ec) scatter into fronts (pad: scratch)
    upd_src: np.ndarray      # (K, Eu) gather from the update tensor
    upd_dst: np.ndarray      # (K, Eu) scatter into upd_buf (pad: scratch)
    diag_rows: np.ndarray    # (K, count, w_pad) real-column mask


@dataclasses.dataclass
class BucketedSymbolic:
    n: int
    perm: np.ndarray
    iperm: np.ndarray
    Up: np.ndarray
    Ui: np.ndarray
    schedule: List[object]    # topologically ordered _Bucket / _Chain items
    total_upd: int

    def permute_values(self, A: sp.spmatrix) -> np.ndarray:
        """Upper-triangle value array of P A P' in THIS schedule's CSC
        order.  Always use this (not a separate analyze()) — order='auto'
        may pick a different permutation per call."""
        Ap = sp.csc_matrix(A)[self.perm][:, self.perm]
        U = sp.triu(Ap.tocsr(), k=0, format="csc").sorted_indices()
        return np.asarray(U.data, dtype=np.float64)



_CHAIN_MIN = 4  # minimum path length worth a scan


def schedule_cost(bs: "BucketedSymbolic",
                  stage_s: float = 30e-6,
                  flops_per_s: float = 5e12) -> float:
    """Predicted device seconds for one factorization of this schedule.

    Two terms: sequential dispatch latency (every bucket is one stage;
    every chain element one step) and padded-front flops.  The constants
    are the JAX package's, kept so that order='auto' picks the ordering it
    picks; the model only ranks orderings, it predicts no time on this
    card.
    """
    cost = 0.0
    for it in bs.schedule:
        w, u = it.w_pad, it.u_pad
        if isinstance(it, _Chain):
            lanes, steps = 1, it.count
        else:
            lanes, steps = it.count, getattr(it, "steps", 1)
        fl = lanes * steps * (w ** 3 / 3 + w * w * u + w * u * u)
        cost += steps * stage_s + fl / flops_per_s
    return cost


def _greedy_rounds(snodes, w_pads, u_pads):
    """Greedy availability scheduling: repeatedly emit, as ONE round, every
    READY supernode of the shape class with the most ready members (ready =
    all children already emitted).  Simultaneously-ready nodes are mutually
    independent by construction, so each round is a valid batch; the round
    sequence is a topological order of the assembly tree.  Ties prefer the
    previous round's shape so consecutive rounds scan-group."""
    from collections import defaultdict

    nsn = len(snodes)
    left = [len(sn.child_ids) for sn in snodes]
    ready = defaultdict(list)
    for s in range(nsn):
        if not snodes[s].child_ids:
            ready[(int(w_pads[s]), int(u_pads[s]))].append(s)
    rounds = []
    last = None
    done = 0
    while done < nsn:
        # Continue the last shape while it has ready members — consecutive
        # same-shape rounds stack into one scan item.  Otherwise start the
        # largest ready batch.
        if last in ready:
            key = last
        else:
            key = max(ready, key=lambda k: (len(ready[k]), k))
        ids = sorted(ready.pop(key))
        rounds.append((key, ids))
        done += len(ids)
        for s in ids:
            p = snodes[s].parent
            if p >= 0:
                left[p] -= 1
                if left[p] == 0:
                    ready[(int(w_pads[p]), int(u_pads[p]))].append(p)
        last = key
    return rounds


def _stack_buckets(buckets: List[_Bucket], n: int,
                   total_upd: int) -> _BucketScan:
    """Stack K same-shape rounds into one _BucketScan: lane count padded to
    the largest round (padding slots factor identity fronts and write their
    update to the upd_buf scratch slot = total_upd), per-round index arrays
    padded to the longest round's lengths (gather pads read slot 0, scatter
    pads write the respective scratch slot)."""
    w_pad, u_pad = buckets[0].w_pad, buckets[0].u_pad
    r_pad = w_pad + u_pad
    K = len(buckets)
    L = max(b.count for b in buckets)
    scratch_f = L * r_pad * r_pad

    def pad_rows(arrs, fill, width):
        out = np.full((K, L, width), fill, arrs[0].dtype)
        for k, a in enumerate(arrs):
            out[k, : a.shape[0], : a.shape[1]] = a
        return out

    def pad_flat(arrs, fill):
        E = max(a.size for a in arrs) if arrs else 0
        out = np.full((K, E), fill, np.int64)
        for k, a in enumerate(arrs):
            out[k, : a.size] = a
        return out

    # Width padding + identity diagonals for the padding lanes of short
    # rounds (a zero front would put 0 pivots into the factorization).
    pad_dsts = []
    for b in buckets:
        extra = [k * r_pad * r_pad + i * r_pad + i
                 for k in range(b.count, L) for i in range(w_pad)]
        pad_dsts.append(np.concatenate(
            [b.pad_dst, np.asarray(extra, np.int64)]))

    return _BucketScan(
        w_pad=w_pad, u_pad=u_pad, count=L, steps=K,
        cols_idx=pad_rows([b.cols_idx for b in buckets], n, w_pad),
        below_idx=pad_rows([b.below_idx for b in buckets], n,
                           max(u_pad, 1)),
        asm_src=pad_flat([b.asm_src for b in buckets], 0),
        asm_dst=pad_flat([b.asm_dst for b in buckets], scratch_f),
        pad_dst=pad_flat(pad_dsts, scratch_f),
        child_src=pad_flat([b.child_src for b in buckets], 0),
        child_dst=pad_flat([b.child_dst for b in buckets], scratch_f),
        upd_src=pad_flat([b.upd_src for b in buckets], 0),
        upd_dst=pad_flat([b.upd_dst for b in buckets], total_upd),
        diag_rows=pad_rows([b.diag_rows for b in buckets], False, w_pad),
    )


def _group_scans(run, n: int, total_upd: int) -> List[object]:
    """Collapse maximal consecutive same-shape runs of `(key, _Bucket)`
    into _BucketScan items (single rounds stay plain _Bucket)."""
    schedule: List[object] = []
    i = 0
    while i < len(run):
        j = i
        while j + 1 < len(run) and run[j + 1][0] == run[i][0]:
            j += 1
        if j == i:
            schedule.append(run[i][1])
        else:
            schedule.append(_stack_buckets([b for _, b in run[i: j + 1]],
                                           n, total_upd))
        i = j + 1
    return schedule


def analyze_batched(A: sp.spmatrix, order: str = "auto",
                    max_supernode: int = 128,
                    relax: int = 16,
                    schedule_mode: str = "greedy") -> BucketedSymbolic:
    """Host symbolic analysis producing the bucket/chain/scan schedule.

    schedule_mode:
      * "greedy" (default) — coarse shape classes (`_pad_class`) plus
        greedy availability scheduling: each round batches EVERY ready
        supernode of the most numerous shape (ready = all children
        emitted; simultaneously-ready nodes are independent, so a round is
        one batched dense-front stage), and consecutive same-shape rounds
        collapse into one `_BucketScan`.  The item count scales with the
        number of shape runs (typically ≤ 10), not with supernodes or
        tree levels.
      * "level" — the round-2 scheduler: power-of-two pads, per-level
        shape buckets, single-child paths extracted as `_Chain` scans.
        Kept as the reference implementation for A/B tests.

    order='auto' builds the schedule under both AMD (minimum fill) and
    nested dissection (minimum critical path) and keeps the one with the
    lower predicted device cost (`schedule_cost`: sequential stages
    against padded flops).
    """
    if order == "auto":
        cands = []
        err = None
        for o in ("amd", "nd"):
            try:
                cands.append(analyze_batched(
                    A, order=o, max_supernode=max_supernode,
                    relax=relax, schedule_mode=schedule_mode))
            except ScheduleTooLargeError as e:
                err = e  # one ordering may still fit the cap
        if not cands:
            raise err
        return min(cands, key=schedule_cost)
    symb = analyze(A, order=order, max_supernode=max_supernode, relax=relax)
    snodes = symb.supernodes
    nsn = len(snodes)
    n = symb.n

    u_sizes = np.asarray([sn.rows.size - sn.cols.size for sn in snodes])
    w_sizes = np.asarray([sn.cols.size for sn in snodes])
    if schedule_mode == "greedy":
        w_pads = np.asarray([_pad_class(int(w)) for w in w_sizes])
        u_pads = np.asarray([_pad_class(int(u)) if u else 0
                             for u in u_sizes])
    else:
        w_pads = np.asarray([_pad_pow2(int(w)) for w in w_sizes])
        u_pads = np.asarray([_pad_pow2(int(u)) if u else 0 for u in u_sizes])

    rounds = None
    if schedule_mode == "greedy":
        rounds = _greedy_rounds(snodes, w_pads, u_pads)
        # Tail merge: the top of the assembly tree dissolves into many
        # small rounds of assorted shapes (one stage each).  Promote
        # every node in the maximal suffix of small rounds to the suffix's
        # max shape so the whole tail becomes consecutive same-shape
        # rounds == ONE scan item; the extra padded flops are small
        # against the leaf rounds.
        cut = len(rounds)
        while cut > 1 and len(rounds[cut - 1][1]) <= 8:
            cut -= 1
        if len(rounds) - cut >= 2:
            tail = rounds[cut:]
            w_t = max(k[0] for k, _ in tail)
            u_t = max(k[1] for k, _ in tail)
            for _, ids in tail:
                for s in ids:
                    w_pads[s] = w_t
                    u_pads[s] = u_t
            rounds = rounds[:cut] + [((w_t, u_t), ids) for _, ids in tail]

    upd_off = np.zeros(nsn + 1, np.int64)
    np.cumsum(u_sizes * u_sizes, out=upd_off[1:])
    total_upd = int(upd_off[-1])
    # Feasibility guard (round 5): the flat scatter-map numeric phase
    # materializes index arrays proportional to the PADDED update
    # traffic.  High-fill patterns (laplqp's 22.5k grid Laplacian ND
    # factorization) explode this to billions of entries — the symbolic
    # phase alone ate >55 GB before the OOM killer fired and took
    # sibling benchmark runs with it.  Fail fast with a typed error so
    # drivers can fall back to the host path cleanly.
    padded_upd = int(np.sum((u_pads.astype(np.int64)) ** 2))
    cap = int(float(__import__("os").environ.get(
        "MADQP_MAX_UPDATE_ENTRIES", 2.5e8)))
    if total_upd > cap or padded_upd > cap:
        raise ScheduleTooLargeError(
            f"supernodal schedule update traffic "
            f"(total {total_upd:.2e}, padded {padded_upd:.2e} entries) "
            f"exceeds MADQP_MAX_UPDATE_ENTRIES={cap:.2e}; this fill "
            "pattern needs a hierarchical multifrontal numeric phase "
            "(use the host path)")
    scratch_buf = total_upd  # read-as-zero / write-scratch slot

    # ---- chain extraction: maximal single-child constant-shape paths ----
    # (level mode only; the greedy mode's _BucketScan subsumes chains.)
    in_chain = np.zeros(nsn, bool)
    chains: List[List[int]] = []
    if schedule_mode != "greedy":
        for s in range(nsn):
            if in_chain[s] or u_pads[s] == 0:
                continue
            ch = snodes[s].child_ids
            if len(ch) > 1:
                continue  # multi-child assembly cannot live in a scan step
            # Skip s when its single child will extend a chain INTO s (s is
            # a tail element of a chain headed further down).
            if len(ch) == 1 and not in_chain[ch[0]] \
                    and len(snodes[ch[0]].child_ids) <= 1 \
                    and (w_pads[ch[0]], u_pads[ch[0]]) == (w_pads[s],
                                                           u_pads[s]) \
                    and u_pads[ch[0]] > 0:
                continue
            seq = [s]
            cur = s
            while True:
                p = snodes[cur].parent
                if p < 0 or snodes[p].child_ids != [cur]:
                    break
                if (w_pads[p], u_pads[p]) != (w_pads[s], u_pads[s]):
                    break
                if u_pads[p] == 0:
                    break
                seq.append(p)
                cur = p
            if len(seq) >= _CHAIN_MIN:
                for t in seq:
                    in_chain[t] = True
                chains.append(seq)

    # ---- helper: local-position map respecting padded update offset ----
    def loc_of(t):
        w = int(w_sizes[t])
        wp = int(w_pads[t])
        return {
            int(g): (k if k < w else wp + (k - w))
            for k, g in enumerate(snodes[t].rows)
        }

    # A-assembly entries per supernode, in padded-front coordinates.
    Up, Ui = symb.Up, symb.Ui
    col_sn = np.empty(n, np.int32)
    for sid, sn in enumerate(snodes):
        col_sn[sn.cols[0]: sn.cols[-1] + 1] = sid
    asm_by_sn: List[List[tuple]] = [[] for _ in range(nsn)]
    locmaps = [loc_of(t) for t in range(nsn)]
    for j in range(n):
        for p in range(Up[j], Up[j + 1]):
            i = int(Ui[p])  # i <= j
            sid = int(col_sn[i])
            loc = locmaps[sid]
            a, b = loc[j], loc[i]
            if a < b:
                a, b = b, a
            asm_by_sn[sid].append((p, a, b))

    schedule: List[object] = []

    def make_bucket(ids, w_pad, u_pad) -> _Bucket:
        r_pad = w_pad + u_pad
        L = len(ids)
        cols_idx = np.full((L, w_pad), n, np.int32)
        below_idx = np.full((L, max(u_pad, 1)), n, np.int32)
        diag_rows = np.zeros((L, w_pad), bool)
        asm_src, asm_dst, pad_dst = [], [], []
        child_src, child_dst = [], []
        upd_src, upd_dst = [], []
        for k, s in enumerate(ids):
            sn = snodes[s]
            w, u = int(w_sizes[s]), int(u_sizes[s])
            cols_idx[k, :w] = sn.cols
            if u:
                below_idx[k, :u] = sn.rows[w:]
            diag_rows[k, :w] = True
            base = k * r_pad * r_pad
            for p, a, b in asm_by_sn[s]:
                asm_src.append(p)
                asm_dst.append(base + a * r_pad + b)
            for i in range(w, w_pad):
                pad_dst.append(base + i * r_pad + i)
            lmap = locmaps[s]
            for c in sn.child_ids:
                chs = snodes[c]
                urows = chs.rows[chs.cols.size:]
                uc = urows.size
                lidx = np.asarray([lmap[int(g)] for g in urows])
                off = upd_off[c]
                for ci in range(uc):
                    for cj in range(ci + 1):
                        a2, b2 = lidx[ci], lidx[cj]
                        if a2 < b2:
                            a2, b2 = b2, a2
                        child_src.append(off + ci * uc + cj)
                        child_dst.append(base + a2 * r_pad + b2)
            ubase = k * u_pad * u_pad
            off = upd_off[s]
            for ci in range(u):
                for cj in range(u):
                    upd_src.append(ubase + ci * u_pad + cj)
                    upd_dst.append(off + ci * u + cj)
        return _Bucket(
            w_pad=w_pad, u_pad=u_pad, count=L,
            cols_idx=cols_idx, below_idx=below_idx,
            asm_src=np.asarray(asm_src, np.int64),
            asm_dst=np.asarray(asm_dst, np.int64),
            pad_dst=np.asarray(pad_dst, np.int64),
            child_src=np.asarray(child_src, np.int64),
            child_dst=np.asarray(child_dst, np.int64),
            upd_src=np.asarray(upd_src, np.int64),
            upd_dst=np.asarray(upd_dst, np.int64),
            diag_rows=diag_rows,
        )

    if schedule_mode == "greedy":
        run = [(key, make_bucket(ids, *key)) for key, ids in rounds]
        schedule = _group_scans(run, n, total_upd)
        return BucketedSymbolic(
            n=n, perm=symb.perm, iperm=symb.iperm, Up=symb.Up, Ui=symb.Ui,
            schedule=schedule, total_upd=total_upd,
        )

    # ---- level mode: regular buckets per level over non-chain nodes ----
    # Tree levels: leaves at 0, parent strictly above all children.
    level = np.zeros(nsn, np.int64)
    for s in range(nsn):  # postorder: children come first
        p = snodes[s].parent
        if p >= 0:
            level[p] = max(level[p], level[s] + 1)
    nlev = int(level.max()) + 1 if nsn else 0
    bucket_items = {}
    for lev in range(nlev):
        members = [s for s in range(nsn)
                   if level[s] == lev and not in_chain[s]]
        groups: dict = {}
        for s in members:
            groups.setdefault((int(w_pads[s]), int(u_pads[s])), []).append(s)
        for (w_pad, u_pad), ids in sorted(groups.items()):
            bucket_items.setdefault(lev, []).append(
                make_bucket(ids, w_pad, u_pad))

    # ---- chain records ----
    chain_items = []
    for seq in chains:
        s0 = seq[0]
        w_pad, u_pad = int(w_pads[s0]), int(u_pads[s0])
        r_pad = w_pad + u_pad
        scratch_f = r_pad * r_pad
        K = len(seq)
        tri_pairs = [(ci, cj) for ci in range(u_pad) for cj in range(ci + 1)]
        tri_src = np.asarray([ci * u_pad + cj for ci, cj in tri_pairs],
                             np.int64)
        La = max(len(asm_by_sn[s]) for s in seq)
        Lp = max(int(w_pads[s]) - int(w_sizes[s]) for s in seq)
        asm_src = np.zeros((K, max(La, 1)), np.int64)
        asm_dst = np.full((K, max(La, 1)), scratch_f, np.int64)
        pad_dst = np.full((K, max(Lp, 1)), scratch_f, np.int64)
        chain_dst = np.full((K, max(len(tri_pairs), 1)), scratch_f, np.int64)
        cols_idx = np.full((K, w_pad), n, np.int32)
        below_idx = np.full((K, max(u_pad, 1)), n, np.int32)
        diag_rows = np.zeros((K, w_pad), bool)
        for k, s in enumerate(seq):
            sn = snodes[s]
            w, u = int(w_sizes[s]), int(u_sizes[s])
            cols_idx[k, :w] = sn.cols
            below_idx[k, :u] = sn.rows[w:]
            diag_rows[k, :w] = True
            for e, (p, a, b) in enumerate(asm_by_sn[s]):
                asm_src[k, e] = p
                asm_dst[k, e] = a * r_pad + b
            for e, i in enumerate(range(w, w_pad)):
                pad_dst[k, e] = i * r_pad + i
            # carry extend-add: predecessor's update rows -> this front
            pred = seq[k - 1] if k else (sn.child_ids[0] if sn.child_ids
                                         else None)
            if pred is not None:
                urows = snodes[pred].rows[snodes[pred].cols.size:]
                u_prev = urows.size
                lmap = locmaps[s]
                lidx = np.asarray([lmap[int(g)] for g in urows])
                for e, (ci, cj) in enumerate(tri_pairs):
                    if ci < u_prev and cj < u_prev:
                        a2, b2 = lidx[ci], lidx[cj]
                        if a2 < b2:
                            a2, b2 = b2, a2
                        chain_dst[k, e] = a2 * r_pad + b2
        # init carry from the head's (single, non-chain) child, if any
        head_children = snodes[s0].child_ids
        assert len(head_children) <= 1
        init_src = None
        if head_children:
            c0 = head_children[0]
            u0 = int(u_sizes[c0])
            assert u0 <= u_pad, "chain head child update exceeds carry pad"
            init_src = np.full(u_pad * u_pad, scratch_buf, np.int64)
            for ci in range(u0):
                for cj in range(u0):
                    init_src[ci * u_pad + cj] = upd_off[c0] + ci * u0 + cj
        # final update write-out, if the chain's root has a parent
        s_last = seq[-1]
        final_src = final_dst = None
        if snodes[s_last].parent >= 0:
            uK = int(u_sizes[s_last])
            final_src = np.asarray(
                [ci * u_pad + cj for ci in range(uK) for cj in range(uK)],
                np.int64)
            final_dst = upd_off[s_last] + np.arange(uK * uK, dtype=np.int64)
        chain_items.append((int(level[s0]), _Chain(
            w_pad=w_pad, u_pad=u_pad, count=K,
            cols_idx=cols_idx, below_idx=below_idx,
            asm_src=asm_src, asm_dst=asm_dst, pad_dst=pad_dst,
            chain_dst=chain_dst, tri_src=tri_src,
            init_src=init_src, final_src=final_src, final_dst=final_dst,
            diag_rows=diag_rows,
        )))

    # ---- schedule: ascending by level of first element ----
    for lev in range(nlev):
        schedule.extend(bucket_items.get(lev, []))
        for lv, ch in chain_items:
            if lv == lev:
                schedule.append(ch)

    return BucketedSymbolic(
        n=n, perm=symb.perm, iperm=symb.iperm, Up=symb.Up, Ui=symb.Ui,
        schedule=schedule, total_upd=total_upd,
    )



# ---------------------------------------------------------------------------
# The schedule on a device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Step:
    """The index arrays of one front stack (a `_Bucket`, one round of a
    `_BucketScan`, one step of a `_Chain`) on a device.

    Assembly: the flat (count * r_pad * r_pad) fronts are
    `F[udst] = segment_sum(work[src], seg_len)`, `src` sorted by the front
    position it adds to.  Write-out: `work[upd_to] = U.reshape(-1)[upd_from]`
    (unique targets), and for a chain step `carry` (the whole padded U goes
    to the carry region).  Solves: `cols` / `below` gather and set x;
    the below rows' additions are `x[b_uniq] += segment_sum(v[b_order],
    b_len)`."""

    count: int
    w_pad: int
    u_pad: int
    src: torch.Tensor
    seg_len: torch.Tensor
    udst: torch.Tensor
    upd_from: torch.Tensor
    upd_to: torch.Tensor
    carry: bool
    cols: torch.Tensor       # (count, w_pad); dummy = n
    below: torch.Tensor      # (count, max(u_pad, 1)); dummy = n
    b_order: torch.Tensor
    b_uniq: torch.Tensor
    b_len: torch.Tensor


@dataclasses.dataclass
class _DeviceSchedule:
    """A `BucketedSymbolic` on a device: one list of `_Step` per schedule
    item, the `work` vector's layout, and per `_Chain` the gather that
    seeds its carry (None: zeros)."""

    n_a: int                 # S's upper entries: work[:n_a]; then upd_buf
    one: int                 # work[one] = 1 (unit padding of the fronts)
    carry0: int              # a chain's carried update: work[carry0:]
    size: int
    perm: torch.Tensor
    iperm: torch.Tensor
    items: List[List[_Step]]
    chain_init: List[Optional[torch.Tensor]]


def _sorted_sum_index(src: np.ndarray, dst: np.ndarray, scratch: int):
    """(src sorted stably by dst, segment lengths, unique dst) of the
    contributions `dst <- src`, those to `scratch` dropped."""
    keep = dst != scratch
    src, dst = src[keep], dst[keep]
    order = np.argsort(dst, kind="stable")
    udst, counts = np.unique(dst[order], return_counts=True)
    return src[order], counts, udst


def _below_index(below: np.ndarray):
    flat = below.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    uniq, counts = np.unique(flat[order], return_counts=True)
    return order, uniq, counts


def device_schedule(bs: "BucketedSymbolic", device) -> _DeviceSchedule:
    """The schedule's index arrays on `device`, made once per device and
    kept on `bs`."""
    device = torch.device(device)
    cache = bs.__dict__.setdefault("_device", {})
    if device in cache:
        return cache[device]
    n_a, T = int(len(bs.Ui)), bs.total_upd
    # work[n_a + T] stays 0: upd_buf's scratch slot, which a chain's
    # init_src reads
    one, carry0 = n_a + T + 1, n_a + T + 2
    c_max = max([it.u_pad * it.u_pad for it in bs.schedule
                 if isinstance(it, _Chain)] or [0])

    def t(v):
        return torch.as_tensor(np.ascontiguousarray(v, np.int64), device=device)

    def step(count, w_pad, u_pad, srcs, dsts, scratch, upd_from, upd_to, carry,
             cols, below):
        src, seg_len, udst = _sorted_sum_index(
            np.concatenate(srcs).astype(np.int64), np.concatenate(dsts).astype(np.int64),
            scratch)
        b_order, b_uniq, b_len = _below_index(below)
        return _Step(count=count, w_pad=w_pad, u_pad=u_pad, src=t(src),
                     seg_len=lengths_tensor(seg_len, src.size, device), udst=t(udst),
                     upd_from=t(upd_from), upd_to=t(upd_to), carry=carry, cols=t(cols),
                     below=t(below), b_order=t(b_order), b_uniq=t(b_uniq),
                     b_len=lengths_tensor(b_len, b_order.size, device))

    items, chain_init = [], []
    for it in bs.schedule:
        w_pad, u_pad = it.w_pad, it.u_pad
        r_pad = w_pad + u_pad
        if isinstance(it, _Chain):
            scratch = r_pad * r_pad
            tri = carry0 + it.tri_src
            steps = []
            for k in range(it.count):
                last = k == it.count - 1 and it.final_dst is not None
                steps.append(step(
                    1, w_pad, u_pad,
                    [it.asm_src[k], np.full(it.pad_dst.shape[1], one), tri],
                    [it.asm_dst[k], it.pad_dst[k], it.chain_dst[k]], scratch,
                    it.final_src if last else np.zeros(0, np.int64),
                    n_a + it.final_dst if last else np.zeros(0, np.int64),
                    True, it.cols_idx[k][None], it.below_idx[k][None]))
            items.append(steps)
            chain_init.append(None if it.init_src is None else t(n_a + it.init_src))
            continue
        chain_init.append(None)
        if isinstance(it, _BucketScan):
            rounds = [(it.asm_src[k], it.asm_dst[k], it.pad_dst[k], it.child_src[k],
                       it.child_dst[k], it.upd_src[k], it.upd_dst[k], it.cols_idx[k],
                       it.below_idx[k]) for k in range(it.steps)]
        else:
            rounds = [(it.asm_src, it.asm_dst, it.pad_dst, it.child_src, it.child_dst,
                       it.upd_src, it.upd_dst, it.cols_idx, it.below_idx)]
        scratch = it.count * r_pad * r_pad
        steps = []
        for a_s, a_d, p_d, c_s, c_d, u_s, u_d, cols, below in rounds:
            keep = u_d != T    # the scratch slot of padding lanes
            steps.append(step(it.count, w_pad, u_pad,
                              [a_s, np.full(p_d.shape[0], one), n_a + c_s],
                              [a_d, p_d, c_d], scratch, u_s[keep], n_a + u_d[keep],
                              False, cols, below))
        items.append(steps)
    ds = _DeviceSchedule(n_a=n_a, one=one, carry0=carry0, size=carry0 + c_max,
                         perm=t(bs.perm), iperm=t(bs.iperm), items=items,
                         chain_init=chain_init)
    cache[device] = ds
    return ds


# ---------------------------------------------------------------------------
# Numeric phase
# ---------------------------------------------------------------------------


def _work(ds: _DeviceSchedule, a_values: torch.Tensor) -> torch.Tensor:
    """The working vector of each lane: (..., size) for values (..., n_a)."""
    w = a_values.new_zeros(a_values.shape[:-1] + (ds.size,))
    w[..., :ds.n_a] = a_values
    w[..., ds.one].fill_(1.0)   # a fill on the device: a store copies from the host
    return w


def _assemble(st: _Step, work: torch.Tensor) -> torch.Tensor:
    """The step's fronts (B * count, r_pad, r_pad), lane-major (B = 1
    without a lane axis), symmetrized from the lower-stored assembly
    (deterministic sorted sums, see the module docstring)."""
    r_pad = st.w_pad + st.u_pad
    F = work.new_zeros(work.shape[:-1] + (st.count * r_pad * r_pad,))
    F[..., st.udst] = segment_sum(work[..., st.src], st.seg_len)
    F = F.view(-1, r_pad, r_pad)
    return torch.tril(F) + torch.tril(F, -1).mT


def _chain_start(ds: _DeviceSchedule, work: torch.Tensor, i: int, u_pad: int) -> None:
    """Seed a chain's carried update, in each lane's own carry region, from
    its head's child (or zeros)."""
    init = ds.chain_init[i]
    region = work[..., ds.carry0:ds.carry0 + u_pad * u_pad]
    if init is None:
        region.zero_()
    else:
        region.copy_(work[..., init])


def _write_out(st: _Step, ds: _DeviceSchedule, work: torch.Tensor, U: torch.Tensor) -> None:
    """The update blocks U (B * count, u_pad, u_pad) of the step into each
    lane's `upd_buf` (and, in a chain, its carry region)."""
    flat = U.reshape(work.shape[:-1] + (-1,))
    if st.upd_to.numel():
        work[..., st.upd_to] = flat[..., st.upd_from]
    if st.carry:
        work[..., ds.carry0:ds.carry0 + flat.shape[-1]] = flat


def _eye(w: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(w, dtype=like.dtype, device=like.device)


def _chol_front(F: torch.Tensor, w_pad: int, inverse: bool):
    """Cholesky of each front's leading block by K1's batched form (one
    launch for the whole stack, every lane's fronts in it): returns
    (top, L21, U) with top = L11 (or L11^-1 with inverse), L21 = F21
    L11^-T and U = F22 - L21 L21^T (None when u_pad = 0)."""
    L11 = cholesky_lower_routed(F[:, :w_pad, :w_pad].contiguous())
    i11 = torch.linalg.solve_triangular(L11, _eye(w_pad, L11).expand_as(L11), upper=False)
    top = i11 if inverse else L11
    if F.shape[-1] == w_pad:
        return top, None, None
    L21 = F[:, w_pad:, :w_pad] @ i11.mT
    U = F[:, w_pad:, w_pad:] - L21 @ L21.mT
    return top, L21, U


def _ldl_front(F: torch.Tensor, w_pad: int, sgn, floor: float, inverse: bool):
    """Signed (pivot-floored with `sgn`) LDL^T of each front's leading
    block: (top, L21, U, d) with top = L11 (or its inverse), Z = F21
    L11^-T, L21 = Z / d, U = F22 - Z L21^T.  `blocked_ldl` and
    `inv_unit_lower`: on the card K2-batched factors the stack (one launch
    up to order 128) and L11^-1 is one triangular solve against the
    identity; on the CPU the reference's recursions, so the CPU comparisons
    follow its algorithm."""
    L11, d = blocked_ldl(F[:, :w_pad, :w_pad], sgn=sgn, floor=floor)
    i11 = inv_unit_lower(L11)
    top = i11 if inverse else L11
    if F.shape[-1] == w_pad:
        return top, None, None, d
    Z = F[:, w_pad:, :w_pad] @ i11.mT
    L21 = Z / d[:, None, :]
    U = F[:, w_pad:, w_pad:] - Z @ L21.mT
    return top, L21, U, d


def _panel(top, L21):
    return top if L21 is None else torch.cat([top, L21], dim=1)


def _stack(item, blocks, lanes=()):
    """An item's per-step lanes + (count, ...) blocks stacked as the
    reference stacks them, after the lane axes: a bucket's one block
    (L, ...), a scan's along a new axis (K, L, ...), a chain's stacks of
    one along the first (K, ...)."""
    if isinstance(item, _Bucket):
        return blocks[0]
    axis = len(lanes)
    return torch.cat(blocks, axis) if isinstance(item, _Chain) else torch.stack(blocks, axis)


def _factorize(bs, a_values, inverse, ldl=False, signs=None, pivot_floor=0.0):
    ds = device_schedule(bs, a_values.device)
    work = _work(ds, a_values)
    lanes = a_values.shape[:-1]
    panels, dvecs = [], []
    for i, (item, steps) in enumerate(zip(bs.schedule, ds.items)):
        if isinstance(item, _Chain):
            _chain_start(ds, work, i, item.u_pad)
        sgn_item = None
        if ldl and signs is not None and pivot_floor > 0.0:
            sgn_item = torch.as_tensor(signs[i], dtype=work.dtype, device=work.device)
        blocks, dblocks = [], []
        for k, st in enumerate(steps):
            F = _assemble(st, work)
            if ldl:
                sg = None
                if sgn_item is not None:
                    # the signs come from the pattern: the same in every lane
                    sg = (sgn_item if isinstance(item, _Bucket) else sgn_item[k])
                    sg = sg.reshape(st.count, st.w_pad).expand(
                        lanes + (st.count, st.w_pad)).reshape(-1, st.w_pad)
                top, L21, U, d = _ldl_front(F, st.w_pad, sg, pivot_floor, inverse)
                dblocks.append(d.reshape(lanes + (st.count, st.w_pad)))
            else:
                top, L21, U = _chol_front(F, st.w_pad, inverse)
            P = _panel(top, L21)
            blocks.append(P.reshape(lanes + (st.count,) + P.shape[1:]))
            if U is not None:
                _write_out(st, ds, work, U)
        panels.append(_stack(item, blocks, lanes))
        dvecs.append(_stack(item, dblocks, lanes) if ldl else None)
    return panels, dvecs


def factorize_batched(bs: "BucketedSymbolic", a_values: torch.Tensor,
                      inverse: bool = False) -> List[torch.Tensor]:
    """Batched numeric Cholesky over the schedule, on the device of
    `a_values` (S's values in the schedule's permuted upper-CSC order,
    `permute_values`).  Returns one panel stack per schedule item ((L,
    r_pad, w_pad) for buckets, (K, L, r_pad, w_pad) for scans, (K, r_pad,
    w_pad) for chains).  With inverse=True the stored diagonal block is
    L11^-1 and the solves are products.

    `a_values` of shape (B, n_a) factors B instances of the pattern at once
    (a leading lane axis on every panel stack): each front stack of the
    schedule becomes one stack of B times as many fronts, one kernel
    launch for all lanes."""
    return _factorize(bs, a_values, inverse)[0]


def _sweep_steps(item, P, steps, lanes=()):
    """(step, its panels lanes + (count, r_pad, w_pad)) of an item in the
    forward order."""
    if isinstance(item, _Bucket):
        return [(steps[0], P)]
    axis = len(lanes)
    if isinstance(item, _Chain):
        return [(st, P.narrow(axis, k, 1)) for k, st in enumerate(steps)]
    return [(st, P.select(axis, k)) for k, st in enumerate(steps)]


def _forward(x, st: _Step, P, n, unit, inverse):
    w = st.w_pad
    lanes = x.shape[:-1]
    P = P.reshape((-1,) + P.shape[-2:])
    xc = x[..., st.cols].reshape(-1, w)
    if inverse:
        xj = (P[:, :w, :] @ xc[..., None])[..., 0]
    else:
        xj = torch.linalg.solve_triangular(P[:, :w, :], xc[..., None], upper=False,
                                           unitriangular=unit)[..., 0]
    x[..., st.cols.reshape(-1)] = xj.reshape(lanes + (-1,))
    if st.u_pad:
        y = (P[:, w:, :] @ xj[..., None])[..., 0].reshape(lanes + (-1,))
        x[..., st.b_uniq] = x[..., st.b_uniq] - segment_sum(y[..., st.b_order], st.b_len)
    x[..., n].zero_()


def _backward(x, st: _Step, P, n, unit, inverse):
    w = st.w_pad
    lanes = x.shape[:-1]
    P = P.reshape((-1,) + P.shape[-2:])
    rhs = x[..., st.cols].reshape(-1, w)
    if st.u_pad:
        below = x[..., st.below].reshape(-1, st.u_pad)
        rhs = rhs - (P[:, w:, :].mT @ below[..., None])[..., 0]
    if inverse:
        xj = (P[:, :w, :].mT @ rhs[..., None])[..., 0]
    else:
        xj = torch.linalg.solve_triangular(P[:, :w, :].mT, rhs[..., None], upper=True,
                                           unitriangular=unit)[..., 0]
    x[..., st.cols.reshape(-1)] = xj.reshape(lanes + (-1,))
    x[..., n].zero_()


def _solve(bs, panels, b, inverse, unit=False, dglob=None):
    """x of shape b's: (n,), or (B, n) against lane-stacked panels; each
    lane keeps its own sentinel x[..., n] = 0."""
    ds = device_schedule(bs, b.device)
    n = bs.n
    lanes = b.shape[:-1]
    x = torch.cat([b[..., ds.perm], b.new_zeros(lanes + (1,))], dim=-1)
    for item, P, steps in zip(bs.schedule, panels, ds.items):
        for st, Pk in _sweep_steps(item, P, steps, lanes):
            _forward(x, st, Pk, n, unit, inverse)
    if dglob is not None:
        x = x / dglob
    for item, P, steps in zip(bs.schedule[::-1], panels[::-1], ds.items[::-1]):
        for st, Pk in _sweep_steps(item, P, steps, lanes)[::-1]:
            _backward(x, st, Pk, n, unit, inverse)
    return x[..., :-1][..., ds.iperm]


def solve_batched(bs: "BucketedSymbolic", panels, b: torch.Tensor,
                  inverse: bool = False) -> torch.Tensor:
    """Level-scheduled batched triangular solves: L y = b, then L' x = y.
    inverse must match the factorization's.  b (B, n) solves each lane
    against its lane of the panels."""
    return _solve(bs, panels, b, inverse)


def factor_ok_batched(panels, lanes=()) -> torch.Tensor:
    """All diagonal pivots finite and positive (padding diag is 1): a bool
    tensor of shape `lanes` (0-d for one instance; (B,) for panels with a
    leading lane axis, one flag per lane) on the panels' device."""
    ok = torch.ones(lanes, dtype=torch.bool, device=panels[0].device)
    for P in panels:
        w = P.shape[-1]
        d = torch.diagonal(P[..., :w, :], dim1=-2, dim2=-1).reshape(lanes + (-1,))
        ok = ok & torch.isfinite(d).all(-1) & (d > 0).all(-1)
    return ok


# ---------------------------------------------------------------------------
# Signed LDL^T over the same schedule: the quasi-definite augmented K2
# system (signs +1 on the primal block, -1 on the dual one,
# `solver/sparse_qp.py`) and the pivot-floored route of the float32 phases
# (all signs +1 on the normal and condensed systems, floor 1e-6).
# ---------------------------------------------------------------------------


def dense_ldl(F, sgn=None, floor: float = 0.0):
    """No-pivot LDL^T of (..., w, w) symmetric matrices, F = L D L' with L
    unit lower triangular; with `sgn` and `floor` > 0 the pivots are
    perturbed to sgn * max(sgn * d, floor) (`blocked_ldl`)."""
    return blocked_ldl(F, sgn=sgn, floor=floor)


def factorize_batched_ldl(bs: "BucketedSymbolic", a_values: torch.Tensor, signs=None,
                          pivot_floor: float = 0.0, inverse: bool = False):
    """Batched supernodal LDL^T over the schedule.  Returns (panels, dvecs,
    dglob): per-item unit-lower panels, pivot vectors, and the pivot
    vector in permuted order (n + 1, the last slot 1).  `signs`
    (`bucket_signs`) with pivot_floor > 0 turn on the sign-directed pivot
    floor.  `a_values` (B, n_a) factors B lanes at once, as
    `factorize_batched` does (dglob (B, n + 1))."""
    panels, dvecs = _factorize(bs, a_values, inverse, ldl=True, signs=signs,
                               pivot_floor=pivot_floor)
    ds = device_schedule(bs, a_values.device)
    lanes = a_values.shape[:-1]
    dglob = a_values.new_ones(lanes + (bs.n + 1,))
    for steps, item, d in zip(ds.items, bs.schedule, dvecs):
        cols = torch.cat([st.cols.reshape(-1) for st in steps])
        dglob[..., cols] = d.reshape(lanes + (-1,))
    dglob[..., bs.n].fill_(1.0)
    return panels, dvecs, dglob


def solve_batched_ldl(bs: "BucketedSymbolic", factors, b: torch.Tensor,
                      inverse: bool = False) -> torch.Tensor:
    """Solve A x = b given the supernodal LDL^T factors: L z = b (unit
    lower), z /= d, L' x = z."""
    panels, _, dglob = factors
    return _solve(bs, panels, b, inverse, unit=True, dglob=dglob)


def bucket_signs(bs: "BucketedSymbolic", signs: np.ndarray) -> List[np.ndarray]:
    """Expected pivot signs per schedule-item column (original order ->
    padded layout); padding columns expect +1.  Host-side, once."""
    sp_perm = np.concatenate([np.asarray(signs)[bs.perm], [1.0]])
    return [sp_perm[item.cols_idx] for item in bs.schedule]


def factor_ok_batched_ldl(factors, expected_signs) -> torch.Tensor:
    """Inertia check: every pivot finite, nonzero and of the expected sign.
    A bool tensor of the factors' lane shape (0-d for one instance, (B,)
    with a lane axis: one flag per lane) on the pivots' device."""
    _, dvecs, dglob = factors
    lanes = dglob.shape[:-1] if dglob is not None else ()
    ok = torch.ones(lanes, dtype=torch.bool, device=dvecs[0].device)
    for d, s in zip(dvecs, expected_signs):
        s = torch.as_tensor(s, dtype=d.dtype, device=d.device)
        good = torch.isfinite(d) & (d * s > 0)
        ok = ok & good.reshape(lanes + (-1,)).all(-1)
    return ok


# ---------------------------------------------------------------------------
# One front at a time (`analyze`; `solve_sparse_lp`'s modes other than "batched")
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _DeviceSupernode:
    a_src: torch.Tensor
    a_dst: torch.Tensor
    child_pos: List[torch.Tensor]   # lower (ci >= cj) entries of the child's update
    child_dst: List[torch.Tensor]
    cols: torch.Tensor
    below: torch.Tensor


def _device_supernodes(symb: "SupernodalSymbolic", device):
    device = torch.device(device)
    cache = symb.__dict__.setdefault("_device", {})
    if device in cache:
        return cache[device]

    def t(v):
        return torch.as_tensor(np.ascontiguousarray(v, np.int64), device=device)

    out = []
    for sn in symb.supernodes:
        pos, dst = [], []
        for c, cd in zip(sn.child_ids, sn.child_dst):
            ch = symb.supernodes[c]
            uc = ch.rows.size - ch.cols.size
            ci, cj = np.divmod(np.arange(uc * uc), uc)
            lower = np.flatnonzero(ci >= cj)   # the upper entries add 0 there
            pos.append(t(lower))
            dst.append(t(cd[lower]))
        w = sn.cols.size
        out.append(_DeviceSupernode(a_src=t(sn.a_src), a_dst=t(sn.a_dst), child_pos=pos,
                                    child_dst=dst, cols=t(sn.cols), below=t(sn.rows[w:])))
    cache[device] = (out, t(symb.perm), t(symb.iperm))
    return cache[device]


def factorize(symb: "SupernodalSymbolic", a_values: torch.Tensor) -> List[torch.Tensor]:
    """Numeric factorization one supernode at a time: the (r, w) panel
    [L11; L21] of each.  Each front uses its lower triangle; the trailing
    (r - w) Schur complement goes to the parent.  The children's updates
    add to distinct positions (only their lower triangles: the mirrored
    map would double-count), so every scatter writes unique entries."""
    dev, _, _ = _device_supernodes(symb, a_values.device)
    panels: List[Optional[torch.Tensor]] = [None] * len(dev)
    updates: List[Optional[torch.Tensor]] = [None] * len(dev)
    for s, (sn, d) in enumerate(zip(symb.supernodes, dev)):
        r, w = sn.rows.size, sn.cols.size
        F = a_values.new_zeros(r * r)
        F[d.a_dst] = a_values[d.a_src]
        for c, pos, dst in zip(sn.child_ids, d.child_pos, d.child_dst):
            F[dst] = F[dst] + updates[c].reshape(-1)[pos]
            updates[c] = None
        F = F.view(r, r)
        F = torch.tril(F) + torch.tril(F, -1).T
        L11 = cholesky_lower_routed(F[:w, :w].contiguous())
        if r > w:
            L21 = torch.linalg.solve_triangular(L11, F[w:, :w].T, upper=False).T
            updates[s] = F[w:, w:] - L21 @ L21.T
            panels[s] = torch.cat([L11, L21], dim=0)
        else:
            panels[s] = L11
    return panels


def solve(symb: "SupernodalSymbolic", panels, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the per-supernode panels."""
    dev, perm, iperm = _device_supernodes(symb, b.device)
    x = b[perm].clone()
    for sn, d, P in zip(symb.supernodes, dev, panels):
        w = sn.cols.size
        xj = torch.linalg.solve_triangular(P[:w, :], x[d.cols][:, None], upper=False)[:, 0]
        x[d.cols] = xj
        if sn.rows.size > w:
            x[d.below] = x[d.below] - P[w:, :] @ xj
    for sn, d, P in zip(symb.supernodes[::-1], dev[::-1], panels[::-1]):
        w = sn.cols.size
        rhs = x[d.cols]
        if sn.rows.size > w:
            rhs = rhs - P[w:, :].T @ x[d.below]
        x[d.cols] = torch.linalg.solve_triangular(P[:w, :].T, rhs[:, None], upper=True)[:, 0]
    return x[iperm]


class DeviceSparseCholesky:
    """Analyze once, refactorize values on `device` per call."""

    def __init__(self, A: sp.spmatrix, order: str = "auto", max_supernode: int = 128,
                 device="cuda"):
        self.symb = analyze(A, order=order, max_supernode=max_supernode)
        self.device = torch.device(device)

    def factorize(self, A: sp.spmatrix):
        vals = torch.as_tensor(self.symb.permute_values(A), device=self.device)
        self.panels = factorize(self.symb, vals)
        return self

    def solve(self, b):
        return solve(self.symb, self.panels,
                     torch.as_tensor(b, dtype=self.panels[0].dtype, device=self.device))

    @property
    def n_supernodes(self) -> int:
        return len(self.symb.supernodes)
