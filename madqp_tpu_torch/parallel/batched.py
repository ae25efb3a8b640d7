"""Batched QP solving in lockstep (port of `madqp_tpu/parallel/batched.py`).

Instances are padded to a common internal shape (`pad_standard`, host
NumPy) and stacked on the device with a leading lane axis; the lane-masked
`solver.mpc.BatchedMPCKernel` steps them together on the host:

  * padding variables get c = 0, unit Hessian diagonal (QP), box bounds
    [-1, 1] so their barrier terms keep the condensed diagonal positive;
  * padding constraint rows pin one padding variable each (x_pad = 0), so
    the Schur complement stays nonsingular;
  * convergence masking: lanes whose status leaves RUNNING stop updating
    while the rest iterate (`run_lanes`, the counterpart of the reference's
    vmapped `lax.while_loop`), with one host sync per iteration.

Where this differs from the reference:
  * `mesh=` (sharding the lanes over devices) raises `NotImplementedError`:
    one card here; ROADMAP.md Queue 1, item 17 brings `torch.distributed`.
  * The host rescue of the mixed-precision scheme needs the host solver
    (ROADMAP.md Queue 1, item 12): `endgame="host"` raises, and
    `endgame="auto"` takes the device rescue, as the reference does when
    its native library is missing.
  * `loop_mode` is accepted and has no effect: the loop is always stepped
    on the host, so the reference's chunked dispatch has no counterpart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.qp import QuadraticProblem, StandardQP, TransformInfo, build_standard_form
from ..ops.kkt import torch_dtype
from ..solver import state as S
from ..solver.mpc import BatchedMPCKernel, select_lanes, tree_map
from ..solver.state import IPMState, ProblemArrays
from ..utils import Counters, ExecutionStats, Status, load_options
from ..utils.options import IPMOptions

_STATUS_MAP = {
    S.SUCCESS: Status.SOLVE_SUCCEEDED,
    S.MAX_ITER: Status.MAXIMUM_ITERATIONS_EXCEEDED,
    S.STEP_ERROR: Status.ERROR_IN_STEP_COMPUTATION,
    S.DIVERGED: Status.DIVERGING_ITERATES,
    S.STALLED: Status.SOLVED_TO_ACCEPTABLE_LEVEL,
    S.RUNNING: Status.REGULAR,
}

MESH_ITEM = "Queue 1, item 17"   # lanes sharded over cards
HOST_ITEM = "Queue 1, item 12"   # the host path behind endgame="host"


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


def run_lanes(kernel: BatchedMPCKernel, prob: ProblemArrays,
              state: IPMState) -> IPMState:
    """Step the batch until no lane is RUNNING, one host sync per
    iteration.  A lane that had stopped before an iteration keeps its
    state bit for bit through it (the vmapped while_loop's select)."""
    lanes = state.status.numel()
    while True:
        running = state.status == S.RUNNING
        n_running = int(running.sum())
        if n_running == 0:
            return state
        new = kernel.iteration(prob, state)
        state = new if n_running == lanes else select_lanes(running, new, state)


@dataclasses.dataclass
class BatchedMPCSolver:
    """Solve a batch of QPs in lockstep on one card."""

    prob: ProblemArrays          # leading batch axis on every tensor
    x0: torch.Tensor
    y0: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    infos: List[TransformInfo]
    qps: List[QuadraticProblem]
    opts: IPMOptions
    n_real: int                  # instances (no batch padding on one card)

    @classmethod
    def from_problems(
        cls,
        qps: Sequence[QuadraticProblem],
        mesh=None,
        *,
        device="cuda",
        **options,
    ) -> "BatchedMPCSolver":
        """Build the padded batch on `device` (the CUDA card unless the
        caller asks for the CPU).  Every other keyword is a solver option.
        `mesh` must be None (one card)."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: sharding the batch over several devices is not ported "
                f"yet (ROADMAP.md {MESH_ITEM}, torch.distributed)")
        opts, _ = load_options(**options)
        if opts.endgame == "host":
            raise NotImplementedError(
                "endgame='host': the host rescue needs the host solver, which is "
                f"not ported yet (ROADMAP.md {HOST_ITEM})")
        device = torch.device(device)
        if device.type == "cuda":
            # Full-f32 products: the float32 factorization's accuracy rests
            # on them (as in MPCSolver).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        built = [
            build_standard_form(qp, scaling=opts.scaling, max_gradient=opts.max_gradient)
            for qp in qps
        ]
        stds = [b[0] for b in built]

        m_tot = max(s.m for s in stds)
        n_tot = max(s.n + (m_tot - s.m) for s in stds)
        force_H = any(s.H is not None for s in stds)
        padded = [
            pad_standard(s, b[2], b[3], n_tot, m_tot, force_H)
            for s, b in zip(stds, built)
        ]

        dtype = torch_dtype(opts.dtype)

        def stack(xs, dt=dtype):
            return torch.as_tensor(np.stack(xs), dtype=dt, device=device)

        stds = [p for p, _, _ in padded]
        prob = ProblemArrays(
            c0=stack([s.c0 for s in stds]),
            c=stack([s.c for s in stds]),
            H=stack([s.H for s in stds]) if force_H else None,
            A=stack([s.A for s in stds]),
            b=stack([s.b for s in stds]),
            has_lb=stack([s.has_lb for s in stds], torch.bool),
            has_ub=stack([s.has_ub for s in stds], torch.bool),
        )
        solver = cls(
            prob=prob, x0=stack([x for _, x, _ in padded]),
            y0=stack([y for _, _, y in padded]),
            lb=stack([s.lb for s in stds]), ub=stack([s.ub for s in stds]),
            infos=[b[1] for b in built], qps=list(qps), opts=opts,
            n_real=len(qps),
        )
        solver._bind_kernels()
        return solver

    def _bind_kernels(self):
        """The batched kernel and, for the mixed-precision rescue, the
        full-precision kernel of phase 2 (the driver's scheme)."""
        opts = self.opts
        rescue = (opts.factorization_dtype
                  and opts.factorization_dtype != opts.dtype
                  and opts.precision_scheme == "two-phase")
        if not rescue:
            self._kernel, self._phase2 = BatchedMPCKernel(opts), None
            return
        # f32 lanes run with stall detection armed; lanes that exit
        # unconverged warm-restart a full-precision phase.
        self._kernel = BatchedMPCKernel(dataclasses.replace(
            opts, stall_exit=opts.stall_exit if opts.stall_exit > 0 else 5,
            max_iter=min(opts.max_iter, opts.phase1_max_iter)))
        self._phase2 = BatchedMPCKernel(
            dataclasses.replace(opts, factorization_dtype=""))

    def _solve(self, prob: ProblemArrays) -> IPMState:
        kern, kern2 = self._kernel, self._phase2
        f1 = run_lanes(kern, prob, kern.init_state(prob, self.x0, self.y0,
                                                   self.lb, self.ub))
        if kern2 is None:
            return f1
        statuses = f1.status.cpu().numpy()
        bad = np.flatnonzero(statuses != S.SUCCESS)
        if bad.size == 0:
            return f1
        if bad.size > statuses.size // 2:
            # Mostly-failed batches keep the full-width lockstep rescue.
            f2 = run_lanes(kern2, prob, kern2.init_state_warm(
                prob, f1.x, f1.y, f1.zl, f1.zu, self.lb, self.ub))
            return f2._replace(k=f1.k + f2.k)
        # Lane-shrunk rescue: gather the failed lanes, pad to a power-of-two
        # lane count, run the warm full-precision phase on that small
        # batch, and scatter the results back.
        nl = 1
        while nl < bad.size:
            nl *= 2
        idx = torch.as_tensor(np.concatenate([bad, np.full(nl - bad.size, bad[0])]),
                              device=f1.x.device)
        sub = tree_map(lambda v: v[idx], prob)
        f2 = run_lanes(kern2, sub, kern2.init_state_warm(
            sub, f1.x[idx], f1.y[idx], f1.zl[idx], f1.zu[idx],
            self.lb[idx], self.ub[idx]))
        lanes = idx[: bad.size]
        merged = tree_map(lambda u, v: u.index_put((lanes,), v[: bad.size]), f1, f2)
        return merged._replace(k=f1.k.index_add(0, lanes, f2.k[: bad.size]))

    def solve_batch(self, prob: Optional[ProblemArrays] = None) -> IPMState:
        """Run all instances; returns the stacked final IPMState (the device
        work finished).

        `prob` optionally overrides the problem values (same shapes)."""
        final = self._solve(prob if prob is not None else self.prob)
        if final.x.device.type == "cuda":
            torch.cuda.synchronize(final.x.device)
        return final

    def solve_all(self) -> List[ExecutionStats]:
        """Solve and unpack per-instance ExecutionStats."""
        t0 = time.time()
        final = self.solve_batch()
        wall = time.time() - t0
        host = {name: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for name, v in final._asdict().items() if name != "d"}
        out = []
        for i in range(self.n_real):
            info = self.infos[i]
            qp = self.qps[i]
            x_int = np.asarray(host["x"][i], dtype=np.float64)[: info.n]
            y_int = np.asarray(host["y"][i], dtype=np.float64)[: info.m]
            zl_int = np.asarray(host["zl"][i], dtype=np.float64)[: info.n]
            zu_int = np.asarray(host["zu"][i], dtype=np.float64)[: info.n]
            x_user = info.recover_x(x_int)
            y_user = info.recover_y(y_int)
            g_user = qp.grad(x_user)
            r_fix = g_user + qp.jtprod(y_user)
            zl_user = info.recover_z(zl_int, np.maximum(r_fix, 0.0))
            zu_user = info.recover_z(zu_int, np.maximum(-r_fix, 0.0))
            k = int(host["k"][i])
            out.append(
                ExecutionStats(
                    status=_STATUS_MAP.get(int(host["status"][i]), Status.INTERNAL_ERROR),
                    objective=float(qp.obj(x_user)),
                    solution=x_user,
                    constraints=qp.cons(x_user),
                    multipliers=y_user,
                    multipliers_L=zl_user,
                    multipliers_U=zu_user,
                    iter=k,
                    counters=Counters(total_time=wall, k=k),
                    primal_feas=float(host["inf_pr"][i]),
                    dual_feas=float(host["inf_du"][i]),
                    complementarity=float(host["inf_compl"][i]),
                    options=self.opts,
                )
            )
        return out


def solve_batched(
    qps: Sequence[QuadraticProblem],
    mesh=None,
    *,
    device="cuda",
    **options,
) -> List[ExecutionStats]:
    """Convenience wrapper: batch-solve a list of QPs on `device` (the CUDA
    card unless the caller asks for the CPU)."""
    return BatchedMPCSolver.from_problems(
        qps, mesh=mesh, device=device, **options).solve_all()
