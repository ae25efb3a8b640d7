"""Batched sparse solving: the supernodal sparse path over many instances
sharing one sparsity pattern (port of `madqp_tpu/parallel/sparse_batched.py`).

The symbolic phase (ordering, supernodes, the schedule of front stacks:
the host's expensive part) is computed ONCE from the shared pattern, by the
KKT's constructor.  The numeric phase carries a leading lane axis: the
problem's values are (B, ...) tensors over shared index lists, and every
front stack (count, r, r) of the schedule becomes one (B * count, r, r)
stack, factored by K1's batched form (the normal equations in float64) or
K2-batched (the augmented K2 system, and the float32 phase's floored
LDL^T) in ONE launch for the whole batch: the launches per iteration are
those of one instance, each doing B times the work.  The reference vmaps
its `MPCKernel.solve_from` over the instances; here the lane-masked
`solver/mpc.py::BatchedMPCKernel` steps them in lockstep
(`parallel/batched.py::run_lanes`), lanes that converge freezing while
the rest iterate, each lane retrying its own factorization (`factor_ok`
gives one flag per lane); phase 2 of the two-phase scheme starts every
lane from phase 1's iterate (`init_state_warm`).

Use cases: scenario sweeps of one model (same network, different data),
receding-horizon re-solves, Monte-Carlo LP/QP studies.

With `mesh=` (a `torch.distributed` DeviceMesh, one process per card;
`parallel/mesh.py`) the lanes are sharded over `batch_axis` as in
`parallel/batched.py`: the batch rounded up to a multiple of the mesh
size, rank r keeping the block [r L, (r + 1) L) and building the standard
forms of those lanes only.  Each rank runs the symbolic phase itself (the
schedule is a deterministic function of the shared pattern, so every rank
holds the same one: the pattern arrays are replicated, the values
sharded) and launches each front stack of its own lanes once per trial.
The solve has no collective; the pattern check and the results are
gathered (`gather_objects`), so every rank returns every instance's stats.

Where this differs from the reference: the KKTs are cached with their
BatchedMPCKernel rather than a compiled program, since nothing is compiled
per pattern.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import List, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..ops.kkt import torch_dtype
from ..solver.mpc import BatchedMPCKernel
from ..solver.policy import full_f32_products, make_sparse_kkt, sparse_phases, sync
from ..solver.sparse_common import canonical_coo_vals, pattern_fingerprint
from ..utils import ExecutionStats, load_options
from .batched import own_lanes, run_lanes, state_to_host, unpack_lane
from .mesh import resolve


def _diag_hessian(H) -> bool:
    if H is None or H.nnz == 0:
        return True
    Hcoo = sp.coo_matrix(H)
    return bool((Hcoo.row == Hcoo.col).all())


def _mesh_key(mesh):
    if mesh is None:
        return None
    return (mesh.device_type, tuple(mesh.mesh_dim_names or ()), tuple(mesh.shape),
            tuple(mesh.mesh.flatten().tolist()))


# Pattern-keyed cache of the KKTs (their symbolic schedules: the dominant
# fixed cost of a batched solve) and kernels per phase, as in the
# reference: the KKT objects hold only the PATTERN (the values arrive with
# the problem arrays), so reuse across same-pattern batches is safe.
_BATCHED_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_BATCHED_CACHE_SIZE = 8


def _stack_problem(stds, kkt, dtype, device):
    """The batch's sparse problem: the first instance's index lists
    (`make_problem`, the KKT's canonical COO order) with every value field
    stacked over the lanes."""
    from ..solver.sparse_lp import make_problem

    base = make_problem(stds[0], kkt, dtype, device)

    def stack(f, dt=dtype):
        return torch.as_tensor(np.stack([np.asarray(f(s)) for s in stds]), dtype=dt,
                               device=device)

    fields = dict(c0=stack(lambda s: s.c0), c=stack(lambda s: s.c), b=stack(lambda s: s.b),
                  has_lb=stack(lambda s: s.has_lb, torch.bool),
                  has_ub=stack(lambda s: s.has_ub, torch.bool),
                  a_vals=stack(lambda s: canonical_coo_vals(s.A)))
    if hasattr(base, "h_vals"):
        fields["h_vals"] = stack(lambda s: canonical_coo_vals(s.H))
    return base._replace(**fields)


def solve_sparse_batched(
    qps: Sequence[QuadraticProblem],
    order: str = "auto",
    kkt_system: str = "auto",
    mesh=None,
    batch_axis: str = "batch",
    *,
    device="cuda",
    **options,
) -> List[ExecutionStats]:
    """Solve a batch of same-pattern sparse LPs/QPs in lockstep on `device`
    (the CUDA card unless the caller asks for the CPU).

    All instances must share the sparsity patterns of A (and H); values,
    rhs, costs, and bounds may differ.  kkt_system as in solve_sparse_qp:
    'auto' picks normal equations when the Hessian is absent/diagonal
    ("normal" insists on them, "augmented" takes the K2 system).  The
    normal equations always run the supernodal "batched" mode, whatever
    `dense_normal_limit` says.  Under `mesh` (its dimension `batch_axis`)
    the device is the one the rank computes on, and every rank returns
    every instance's stats."""
    if not qps:
        return []
    axis = None if mesh is None else resolve(mesh, batch_axis, device)
    device = torch.device(device) if axis is None else axis.device
    opts, _ = load_options(**options)
    lanes = own_lanes(len(qps), axis)
    built = {i: build_standard_form_sparse(qps[i], scaling=opts.scaling,
                                           max_gradient=opts.max_gradient)
             for i in sorted(set(lanes))}
    stds = [built[i][0] for i in lanes]
    infos = [built[i][1] for i in lanes]
    fps = {pattern_fingerprint(s.A, s.H) for s, *_ in built.values()}
    if axis is not None:
        fps = set(axis.gather_objects(sorted(fps)))
    if len(fps) != 1:
        raise ValueError(
            "solve_sparse_batched requires all instances to share the "
            f"A/H sparsity pattern (got {len(fps)} distinct patterns); "
            "use parallel.solve_batched (dense, padded) for ragged batches."
        )
    std0 = stds[0]
    use_normal = kkt_system != "augmented" and _diag_hessian(std0.H)
    if kkt_system == "normal" and not _diag_hessian(std0.H):
        raise ValueError("kkt_system='normal' needs an LP or diagonal Hessian.")
    full_f32_products(device)
    opts1, opts2 = sparse_phases(opts)

    def make_kkt(o):
        # As the JAX package builds them (ROADMAP.md Queue 3, item 31): the
        # greedy schedule whatever sparse_schedule says, and no CG, so
        # endgame="krylov"'s phase 2 refactors in float32.
        return make_sparse_kkt("normal" if use_normal else "augmented", std0, o, order,
                               schedule_mode="greedy", krylov=False)

    fp = fps.pop()
    mkey = _mesh_key(mesh)

    def cached(o, entry, build):
        key = (fp, o, use_normal, order, mkey, batch_axis, entry)
        hit = _BATCHED_CACHE.get(key)
        if hit is not None:
            _BATCHED_CACHE.move_to_end(key)
            return hit
        val = build()
        _BATCHED_CACHE[key] = val
        while len(_BATCHED_CACHE) > _BATCHED_CACHE_SIZE:
            _BATCHED_CACHE.popitem(last=False)
        return val

    kkt1 = cached(opts1, "kkt", lambda: make_kkt(opts1))

    # --- stacked problem arrays (canonical CSC value order per instance) --
    dtype = torch_dtype(opts.dtype)
    prob = _stack_problem(stds, kkt1, dtype, device)

    def stack(vs):
        return torch.as_tensor(np.stack(vs), dtype=dtype, device=device)

    x0 = stack([built[i][2] for i in lanes])
    y0 = stack([built[i][3] for i in lanes])
    lb = stack([s.lb for s in stds])
    ub = stack([s.ub for s in stds])

    kern1 = cached(opts1, "solve", lambda: BatchedMPCKernel(opts1, kkt=kkt1))

    t0 = time.time()
    final = run_lanes(kern1, prob, kern1.init_state(prob, x0, y0, lb, ub))
    extra = None
    if opts2 is not None:
        # Phase 2 runs on every lane, warm-started from phase 1's iterate.
        extra = final.k
        kern2 = cached(opts2, "warm_solve", lambda: BatchedMPCKernel(
            opts2, kkt=cached(opts2, "kkt", lambda: make_kkt(opts2))))
        final = run_lanes(kern2, prob, kern2.init_state_warm(
            prob, final.x, final.y, final.zl, final.zu, lb, ub))
        extra = extra.cpu().numpy()
    sync(device)
    wall = time.time() - t0

    host = state_to_host(final)
    start = 0 if axis is None else axis.rank * len(lanes)
    out = [unpack_lane(host, lane, infos[lane], qps[i], opts, wall,
                       int(host["k"][lane]) + (int(extra[lane]) if extra is not None else 0))
           for lane, i in enumerate(lanes) if start + lane < len(qps)]
    return out if axis is None else axis.gather_objects(out)
