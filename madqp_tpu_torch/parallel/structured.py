"""Block-angular two-stage QPs with a Schur-complement KKT (port of
`madqp_tpu/parallel/structured.py`).

BASELINE config #5: a two-stage stochastic program

    min  c00 + c0'x0 + 1/2 x0'H0 x0 + sum_i [ ci'xi + 1/2 xi'Hi xi ]
    s.t. A0 x0 = b0
         Ti x0 + Wi xi = bi          for each scenario i = 1..N
         bounds on x0 and each xi

whose Newton/KKT system has arrow structure.  Per iteration every scenario
factors its blocks Ui = Hi + diag(sigma_i) and Si = Wi Ui^-1 Wi' - dc I
(each one factorization of the whole (N, ., .) stack), contributes
Ci = Ti' Si^-1 Ti to the first-stage Schur complement (a sum over the
scenario axis), and back-substitutes on its own.

The flat solver state is reused unchanged: `TwoStageProblem` exposes the
c0/c/b/has_lb/has_ub + hess_mv/jac_mv/jac_rmv protocol of `ProblemArrays`
with variables laid out [x0; vec(x_s)] and rows [y0; vec(y_s)], so
`MPCKernel`'s masked IPM math runs verbatim; only the KKT factorization
is structured.

Where this differs from the reference:
  * `linear_solver="pallas"` reaches every factorization: the scenario
    stacks U and S go through K1 on the stack (one launch each) and the
    first stage's C00 and S0 through K1 on one matrix.  The reference's
    `make_kkt` drops the backend for "schur", so there every factor is the
    library Cholesky; any backend but "pallas" does the same here.
  * The reference's sharding hooks (`_replicate`, `_to_scen`,
    `_reduce_einsum`, with XLA placing the collectives) are explicit here:
    with `mesh=` (a `torch.distributed` DeviceMesh, one process per card;
    `parallel/mesh.py`) the problem carries the `Axis` of `scen_axis`.

Under a mesh the scenario stacks H_s, T_s and W_s are sharded (rank r
keeps scenarios [r L, (r + 1) L), L = N / world); everything else is
replicated on every rank: the flat IPM state with c, b and the bound
masks, H0 and A0, and the whole first stage (C00 and S0 are factored on
every rank).  The collectives, by site:
  * `split_x` / `split_y` take the rank's rows of a replicated vector (no
    communication); `join_x` / `join_y` all-gather the (L, ns) / (L, ms)
    pieces (`gather_rows`);
  * `jac_rmv`'s first-stage term is A0'y0 + sum_across(sum_i Ti'yi);
  * `SchurKKT.factorize`: C00 = diag(d0) + sum_across(sum_i Ti' Si^-1 Ti)
    (+ H0), one n0^2 all-reduce per factorization trial; `factor_ok` is
    global (`all_true`), since the host's retry loop branches on it;
  * `SchurKKT.solve`: one n0 all-reduce of sum_i Ti' qi, then the joins.
Every host decision reads replicated tensors, which every rank holds
bit-equal.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.kkt import CondensedFactors, DenseCondensedKKT, torch_dtype
from ..ops.pallas_chol import select_cholesky
from ..solver import state as S
from ..solver.mpc import MPCKernel, tree_map
from ..solver.policy import STATUS_MAP, full_f32_products
from ..utils import Counters, ExecutionStats, Status, load_options
from ..utils.profiling import span, to_host
from .mesh import Axis, resolve


def _own(axis: Optional[Axis], rows):
    """This rank's block of a replicated (N, .) stack (all of it without a
    mesh)."""
    if axis is None:
        return rows
    per = rows.shape[0] // axis.world
    return rows[axis.rank * per:(axis.rank + 1) * per]


def _join(axis: Optional[Axis], v0, vs):
    """The flat replicated [v0; vec(v_s)] from the first-stage part and this
    rank's scenario rows."""
    return torch.cat([v0, (vs if axis is None else axis.gather_rows(vs)).reshape(-1)])


def _sum(axis: Optional[Axis], t):
    """A sum over the scenario axis: this rank's part, summed across ranks."""
    return t if axis is None else axis.sum_across(t)


class TwoStageProblem(NamedTuple):
    """Block-angular problem data.  Scenario blocks are stacked on a leading
    axis of size N; flat vectors follow the [x0; vec(x_s)] layout."""

    # Flat protocol fields (shared with ProblemArrays).
    c0: torch.Tensor        # objective constant (0-d)
    c: torch.Tensor         # (n_tot,) = [c_0; vec(c_s)]
    b: torch.Tensor         # (m_tot,) = [b_0; vec(b_s)]
    has_lb: torch.Tensor    # (n_tot,) bool
    has_ub: torch.Tensor    # (n_tot,) bool
    # First-stage blocks.
    H0: Optional[torch.Tensor]   # (n0, n0) or None for LP
    A0: torch.Tensor             # (m0, n0)
    # Scenario blocks (stacked).
    H_s: Optional[torch.Tensor]  # (N, ns, ns) or None
    T_s: torch.Tensor            # (N, ms, n0)
    W_s: torch.Tensor            # (N, ms, ns)
    # The mesh's scenario axis: the stacks hold this rank's scenarios only.
    axis: Optional[Axis] = None

    # -- layout --------------------------------------------------------------

    @property
    def n0(self) -> int:
        return self.A0.shape[1]

    @property
    def m0(self) -> int:
        return self.A0.shape[0]

    @property
    def N(self) -> int:
        """Scenarios in all (on every rank of a mesh)."""
        return self.T_s.shape[0] * (1 if self.axis is None else self.axis.world)

    @property
    def ns(self) -> int:
        return self.W_s.shape[2]

    @property
    def ms(self) -> int:
        return self.W_s.shape[1]

    @property
    def n(self) -> int:
        return self.n0 + self.N * self.ns

    @property
    def m(self) -> int:
        return self.m0 + self.N * self.ms

    @property
    def is_lp(self) -> bool:
        return self.H0 is None and self.H_s is None

    def split_x(self, x):
        return x[: self.n0], _own(self.axis, x[self.n0:].reshape(self.N, self.ns))

    def split_y(self, y):
        return y[: self.m0], _own(self.axis, y[self.m0:].reshape(self.N, self.ms))

    def join_x(self, x0, xs):
        return _join(self.axis, x0, xs)

    def join_y(self, y0, ys):
        return _join(self.axis, y0, ys)

    # -- matvec protocol -----------------------------------------------------

    def hess_mv(self, x):
        x0, xs = self.split_x(x)
        h0 = torch.zeros_like(x0) if self.H0 is None else self.H0 @ x0
        hs = (torch.zeros_like(xs) if self.H_s is None
              else torch.einsum("imn,in->im", self.H_s, xs))
        return self.join_x(h0, hs)

    def jac_mv(self, x):
        x0, xs = self.split_x(x)
        y0 = self.A0 @ x0
        ys = (torch.einsum("imk,k->im", self.T_s, x0)
              + torch.einsum("imn,in->im", self.W_s, xs))
        return self.join_y(y0, ys)

    def jac_rmv(self, y):
        y0, ys = self.split_y(y)
        x0 = self.A0.T @ y0 + _sum(self.axis, torch.einsum("imk,im->k", self.T_s, ys))
        xs = torch.einsum("imn,im->in", self.W_s, ys)
        return self.join_x(x0, xs)


class SchurFactors(NamedTuple):
    chol_U: Optional[torch.Tensor]  # (N, ns, ns) scenario Cholesky; None for LP
    u_diag: torch.Tensor            # (N, ns) sigma_s (diagonal U when LP)
    chol_S: torch.Tensor            # (N, ms, ms) local Schur Cholesky
    X: torch.Tensor                 # (N, ms, n0) = S_i^-1 T_i
    first: CondensedFactors         # first-stage condensed factors over C00
    W_s: torch.Tensor               # (N, ms, ns) scenario recourse blocks
    T_s: torch.Tensor               # (N, ms, n0) scenario coupling blocks
    axis: Optional[Axis] = None     # the problem's (the stacks: this rank's)


class _FirstStageProb(NamedTuple):
    """Adapter handing the first-stage dense blocks to DenseCondensedKKT."""

    H: torch.Tensor
    A: torch.Tensor


class SchurKKT:
    """Schur-complement KKT for TwoStageProblem.

    The scenario stacks U and S are factored in the working dtype, one
    factorization of each (N, ., .) stack; `fact_dtype` reaches only the
    first stage, which `DenseCondensedKKT` factors (C00, then
    S0 = A0 C00^-1 A0' - dc I) and solves, as in the reference.
    `chol_backend="pallas"` takes K1 for all four factorizations, any other
    backend the library Cholesky."""

    name = "schur"

    def __init__(self, fact_dtype=None, chol_backend: str = "xla"):
        backend = "pallas" if chol_backend == "pallas" else "xla"
        self._chol = select_cholesky(backend)
        self._dense = DenseCondensedKKT(fact_dtype=fact_dtype, chol_backend=backend)

    def factorize(self, p: TwoStageProblem, pr_diag, del_c):
        d0, ds = p.split_x(pr_diag)
        with span("schur.scenarios"):
            # Scenario blocks: U_i = H_i + diag(sigma_i); S_i = W U^-1 W' - dc I.
            WT = p.W_s.mT  # (N, ns, ms)
            if p.H_s is None:
                chol_U = None
                Uinv_WT = WT / ds[:, :, None]
            else:
                chol_U = self._chol(p.H_s + torch.diag_embed(ds))
                Uinv_WT = torch.cholesky_solve(WT, chol_U)
            S_i = (p.W_s @ Uinv_WT).contiguous()
            # U^-1 W' is as large as the W stack: it goes before S is
            # factored, and dc comes off S's diagonal in place.
            del Uinv_WT
            S_i.diagonal(dim1=-2, dim2=-1).sub_(del_c)
            with span("schur.factor_S"):
                chol_S = self._chol(S_i)
            del S_i
            X = torch.cholesky_solve(p.T_s, chol_S)  # S_i^-1 T_i

        with span("schur.first"):
            # First-stage Schur complement C00 = H0 + diag(d0) + sum_i Ti' Si^-1 Ti.
            C00 = torch.diag(d0) + _sum(p.axis, torch.einsum("imk,iml->kl", p.T_s, X))
            if p.H0 is not None:
                C00 = C00 + p.H0
            # C00 is the first stage's whole W: no diagonal added to it.
            first = self._dense.factorize(_FirstStageProb(H=C00.contiguous(), A=p.A0),
                                          torch.zeros_like(d0), del_c)
        return SchurFactors(chol_U=chol_U, u_diag=ds, chol_S=chol_S, X=X,
                            first=first, W_s=p.W_s, T_s=p.T_s, axis=p.axis)

    def _U_solve(self, f: SchurFactors, r):
        """U_i^-1 r per scenario, r of shape (N, ns) or (N, ns, k)."""
        if f.chol_U is None:
            return r / (f.u_diag if r.dim() == 2 else f.u_diag[:, :, None])
        return DenseCondensedKKT._cho_solve(f.chol_U, r)

    def solve(self, f: SchurFactors, rx, ry):
        with span("schur.solve"):
            _, ms, n0 = f.X.shape
            ns = f.u_diag.shape[1]
            m0 = f.first.A.shape[0]
            rx0, rxs = rx[:n0], _own(f.axis, rx[n0:].reshape(-1, ns))
            ry0, rys = ry[:m0], _own(f.axis, ry[m0:].reshape(-1, ms))

            # Local forward elimination: q_i = S_i^-1 (W_i U_i^-1 rx_i - ry_i).
            w_term = torch.einsum("imn,in->im", f.W_s, self._U_solve(f, rxs))
            q = DenseCondensedKKT._cho_solve(f.chol_S, w_term - rys)

            # First-stage solve with reduced rhs r0 - sum_i Ti' q_i.
            TtQ = _sum(f.axis, torch.einsum("imk,im->k", f.T_s, q))
            dx0, dy0 = self._dense.solve(f.first, rx0 - TtQ, ry0)

            # Local back-substitution.
            dys = q + torch.einsum("imk,k->im", f.X, dx0)
            dxs = self._U_solve(f, rxs - torch.einsum("imn,im->in", f.W_s, dys))
            return _join(f.axis, dx0, dxs), _join(f.axis, dy0, dys)

    def factor_ok(self, f: SchurFactors) -> torch.Tensor:
        """Every factor diagonal finite and positive (U's diagonal itself
        for an LP): a 0-d bool tensor, on every rank of a mesh whether every
        rank's factors are."""
        def diag_ok(L):
            d = torch.diagonal(L, dim1=-2, dim2=-1)
            return (torch.isfinite(d) & (d > 0)).all()

        ok_U = (f.u_diag > 0).all() if f.chol_U is None else diag_ok(f.chol_U)
        ok = ok_U & diag_ok(f.chol_S) & self._dense.factor_ok(f.first)
        return ok if f.axis is None else f.axis.all_true(ok)


# ---------------------------------------------------------------------------
# Builders / drivers
# ---------------------------------------------------------------------------


def build_two_stage(
    c0_vec, A0, b0, lb0, ub0,
    c_s, T_s, W_s, b_s, lb_s, ub_s,
    H0=None, H_s=None, c_const=0.0, dtype=torch.float64, *, device="cuda",
):
    """Assemble a TwoStageProblem on `device` (the CUDA card unless the
    caller asks for the CPU) from block data (equality-form rows, +-inf
    bounds).  Returns (problem, lb_flat, ub_flat) with sanitized bounds +
    masks following the models.qp convention.

    A block may be a NumPy array or a torch tensor.  A tensor already on
    `device` in `dtype` and contiguous is kept as it is, not copied (the
    scenario stacks of a large problem made on the card stay there); the
    bounds' masks are taken at each block's own precision, before the
    cast to `dtype`, whichever it is."""
    dtype = torch_dtype(dtype)

    def own(v):
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))

    def as_dev(v):
        return own(v).to(device=device, dtype=dtype).contiguous()

    def flat(v0, vs):
        return torch.cat([own(v0).to(device).reshape(-1), own(vs).to(device).reshape(-1)])

    lb_flat, ub_flat = flat(lb0, lb_s), flat(ub0, ub_s)
    has_lb, has_ub = torch.isfinite(lb_flat), torch.isfinite(ub_flat)

    prob = TwoStageProblem(
        c0=as_dev(c_const),
        c=torch.cat([as_dev(c0_vec), as_dev(c_s).reshape(-1)]),
        b=torch.cat([as_dev(b0), as_dev(b_s).reshape(-1)]),
        has_lb=has_lb,
        has_ub=has_ub,
        H0=None if H0 is None else as_dev(H0),
        A0=as_dev(A0),
        H_s=None if H_s is None else as_dev(H_s),
        T_s=as_dev(T_s),
        W_s=as_dev(W_s),
    )
    return (prob, as_dev(torch.where(has_lb, lb_flat, 0.0)),
            as_dev(torch.where(has_ub, ub_flat, 0.0)))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def two_stage_to_flat_qp(p: TwoStageProblem, lb, ub):
    """Materialize the equivalent flat dense QP (for oracle testing)."""
    from ..models.qp import QuadraticProblem

    n0, ns, ms, m0, N = p.n0, p.ns, p.ms, p.m0, p.N
    A = np.zeros((p.m, p.n))
    A[:m0, :n0] = _host(p.A0)
    T_s, W_s = _host(p.T_s), _host(p.W_s)
    for i in range(N):
        r0 = m0 + i * ms
        A[r0:r0 + ms, :n0] = T_s[i]
        c0_ = n0 + i * ns
        A[r0:r0 + ms, c0_:c0_ + ns] = W_s[i]
    H = None
    if not p.is_lp:
        H = np.zeros((p.n, p.n))
        if p.H0 is not None:
            H[:n0, :n0] = _host(p.H0)
        if p.H_s is not None:
            H_s = _host(p.H_s)
            for i in range(N):
                c0_ = n0 + i * ns
                H[c0_:c0_ + ns, c0_:c0_ + ns] = H_s[i]
    b = _host(p.b)
    has_lb, has_ub = p.has_lb.cpu().numpy(), p.has_ub.cpu().numpy()
    return QuadraticProblem(
        c=_host(p.c),
        A=A,
        H=H,
        c0=float(p.c0),
        lcon=b,
        ucon=b,
        lvar=np.where(has_lb, _host(lb), -np.inf),
        uvar=np.where(has_ub, _host(ub), np.inf),
        name="two_stage_flat",
    )


def random_two_stage(
    n0=8, ns=6, ms=4, m0=3, N=16, seed=0, qp=True, *, device="cuda"
):
    """Random feasible two-stage stochastic QP generator (the reference's
    NumPy generator: the same seed gives bit-equal data), on `device`."""
    rng = np.random.default_rng(seed)
    A0 = rng.standard_normal((m0, n0))
    T_s = rng.standard_normal((N, ms, n0)) / np.sqrt(n0)
    W_s = rng.standard_normal((N, ms, ns)) + 2.0 * np.eye(ms, ns)[None]
    x0_feas = rng.uniform(0.2, 0.8, size=n0)
    xs_feas = rng.uniform(0.2, 0.8, size=(N, ns))
    b0 = A0 @ x0_feas
    b_s = np.einsum("imk,k->im", T_s, x0_feas) + np.einsum(
        "imn,in->im", W_s, xs_feas
    )
    c0_vec = rng.standard_normal(n0)
    c_s = rng.standard_normal((N, ns)) / N
    H0 = H_s = None
    if qp:
        P0 = rng.standard_normal((n0, n0)) / np.sqrt(n0)
        H0 = P0.T @ P0 + 0.2 * np.eye(n0)
        Ps = rng.standard_normal((N, ns, ns)) / np.sqrt(ns)
        H_s = np.einsum("inm,ink->imk", Ps, Ps) + 0.2 * np.eye(ns)[None]
        H_s = H_s / N
    lb0 = np.zeros(n0)
    ub0 = np.full(n0, 5.0)
    lb_s = np.zeros((N, ns))
    ub_s = np.full((N, ns), 5.0)
    return build_two_stage(
        c0_vec, A0, b0, lb0, ub0, c_s, T_s, W_s, b_s, lb_s, ub_s,
        H0=H0, H_s=H_s, device=device,
    )


def solve_two_stage(
    prob: TwoStageProblem, lb, ub, mesh=None, scen_axis="scen", *,
    device="cuda", **options
):
    """Solve a two-stage problem with the Schur-complement KKT on `device`
    (the CUDA card unless the caller asks for the CPU; the problem and the
    bounds are moved there if they lie elsewhere).  Every other keyword is
    a solver option; `kkt_system` is always "schur".

    As the reference's `solve_from`: the MPC loop from x = 0, y = 0 until
    the status leaves RUNNING, with no two-phase rescue and no wall-time
    limit.

    With `mesh` (a DeviceMesh whose dimension `scen_axis` holds this rank)
    `prob` is the whole problem and each rank keeps its block of the
    scenario stacks, as the reference's `device_put` with `P(scen_axis)`
    does (N % world != 0 raises ValueError); every rank returns the same
    stats."""
    opts, _ = load_options(**options)
    opts = opts.replace(kkt_system="schur")
    axis = None if mesh is None else resolve(mesh, scen_axis, device)
    device = torch.device(device) if axis is None else axis.device
    full_f32_products(device)
    if axis is not None:
        if prob.N % axis.world:
            raise ValueError(f"{prob.N} scenarios do not split evenly over the "
                             f"{axis.world} ranks of the mesh axis {scen_axis!r}")
        prob = prob._replace(
            H_s=None if prob.H_s is None else _own(axis, prob.H_s),
            T_s=_own(axis, prob.T_s), W_s=_own(axis, prob.W_s), axis=axis)
    prob = tree_map(lambda t: t.to(device), prob)
    lb, ub = lb.to(device), ub.to(device)
    kernel = MPCKernel(opts)
    dtype = torch_dtype(opts.dtype)

    with span("solve"):
        t0 = time.time()
        final = kernel.init_state(prob, torch.zeros(prob.n, dtype=dtype, device=device),
                                  torch.zeros(prob.m, dtype=dtype, device=device), lb, ub)
        while final.status == S.RUNNING:
            final = kernel.iteration(prob, final)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.time() - t0

        def read(t):
            return to_host(t, "finish", numpy=t.dim() > 0)

        return ExecutionStats(
            status=STATUS_MAP.get(final.status, Status.INTERNAL_ERROR),
            objective=read(final.obj_val),
            solution=read(final.x),
            constraints=read(prob.jac_mv(final.x)),
            multipliers=read(final.y),
            multipliers_L=read(final.zl),
            multipliers_U=read(final.zu),
            iter=final.k,
            counters=Counters(total_time=wall, k=final.k, factorizations=final.n_fact),
            primal_feas=read(final.inf_pr),
            dual_feas=read(final.inf_du),
            complementarity=read(final.inf_compl),
            options=opts,
        )
