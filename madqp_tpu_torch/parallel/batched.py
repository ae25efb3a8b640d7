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
    vmapped `lax.while_loop`), with one host sync per iteration;
  * the mixed-precision rescue of the lanes whose float32 phase fails: with
    `endgame="auto"` or `"host"` and the native library, each such lane is
    re-solved on the host path (`HostMPCSolver`, cold), and `solve_all`
    returns the host's stats for it; `endgame="f64"` (or no native
    library) runs a warm float64 phase of the failed lanes on the card.

With `mesh=` (a `torch.distributed` DeviceMesh, one process per card;
`parallel/mesh.py`) the lanes are sharded over the mesh's `batch_axis`,
as the reference's `shard_map` shards them:
  * the batch is rounded up to a multiple of the mesh size with copies of
    the last instance, and rank r keeps the lanes [r L, (r + 1) L);
  * each rank builds the standard forms of its own lanes only; the padded
    shape (m_tot, n_tot, whether any lane has a Hessian) is agreed in one
    `gather_objects`;
  * the solve has no collective: each rank steps its own lanes;
  * under the float32 phase no lane is rescued on the host, and when any
    lane of the whole batch fails (`sum_across` of the failed-lane count)
    every lane of every rank runs the full-width float64 phase 2;
  * `solve_all` gathers every rank's stats (`gather_objects`), so every
    rank returns all instances in order.

Where this differs from the reference: `loop_mode` is accepted and has no
effect: the loop is always stepped on the host, so the reference's
chunked dispatch has no counterpart.
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
from ..solver.policy import dense_phases, full_f32_products, status_of, sync, user_stats
from ..solver.state import IPMState, ProblemArrays
from ..utils import Counters, ExecutionStats, load_options
from ..utils.options import IPMOptions
from .mesh import Axis, resolve


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


def own_lanes(n_real: int, axis: Optional[Axis]) -> List[int]:
    """The instance behind each lane this rank keeps: the batch rounded up
    to a multiple of the mesh size with copies of the last instance (the
    reference's padding), block `axis.rank` of it; every instance without a
    mesh."""
    idx = list(range(n_real))
    if axis is None:
        return idx
    idx += idx[-1:] * (-n_real % axis.world)
    per = len(idx) // axis.world
    return idx[axis.rank * per:(axis.rank + 1) * per]


def unpack_lane(final_host: dict, lane: int, info: TransformInfo, qp: QuadraticProblem,
                opts: IPMOptions, wall: float, k: int) -> ExecutionStats:
    """The ExecutionStats of one lane of a final state fetched to the host
    (recovered to user coordinates)."""
    def field(name):
        return final_host[name][lane]

    return user_stats(qp, info, opts, [field(f) for f in ("x", "y", "zl", "zu")],
                      status_of(field("status")), k, Counters(total_time=wall, k=k),
                      [field(f) for f in ("inf_pr", "inf_du", "inf_compl")])


def state_to_host(final: IPMState) -> dict:
    """Every tensor field of a final state but the direction, on the host."""
    return {name: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for name, v in final._asdict().items() if name != "d"}


@dataclasses.dataclass
class BatchedMPCSolver:
    """Solve a batch of QPs in lockstep on one card, or sharded over the
    cards of a mesh (then `prob` and the starting point hold this rank's
    lanes only)."""

    prob: ProblemArrays          # leading batch axis on every tensor
    x0: torch.Tensor
    y0: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    infos: List[TransformInfo]   # this rank's lanes'
    qps: List[QuadraticProblem]  # every instance
    opts: IPMOptions
    n_real: int                  # instances before batch padding
    mesh: object = None          # a DeviceMesh, or None (one card)
    batch_axis: str = "batch"
    lanes: Optional[List[int]] = None   # the instance behind each local lane
    axis: Optional[Axis] = None

    @classmethod
    def from_problems(
        cls,
        qps: Sequence[QuadraticProblem],
        mesh=None,
        batch_axis: str = "batch",
        *,
        device="cuda",
        **options,
    ) -> "BatchedMPCSolver":
        """Build the padded batch on `device` (the CUDA card unless the
        caller asks for the CPU; under a mesh the device its rank computes
        on, which `device` must agree with).  Every other keyword is a
        solver option."""
        opts, _ = load_options(**options)
        axis = None if mesh is None else resolve(mesh, batch_axis, device)
        device = torch.device(device) if axis is None else axis.device
        full_f32_products(device)
        lanes = own_lanes(len(qps), axis)
        built = {i: build_standard_form(qps[i], scaling=opts.scaling,
                                        max_gradient=opts.max_gradient)
                 for i in sorted(set(lanes))}
        shapes = [(max(b[0].m for b in built.values()),
                   max(b[0].n - b[0].m for b in built.values()),
                   any(b[0].H is not None for b in built.values()))]
        if axis is not None:
            shapes = axis.gather_objects(shapes)
        m_tot = max(m for m, _, _ in shapes)
        n_tot = m_tot + max(d for _, d, _ in shapes)
        force_H = any(h for _, _, h in shapes)
        padded = {i: pad_standard(s, x, y, n_tot, m_tot, force_H)
                  for i, (s, _, x, y) in built.items()}

        dtype = torch_dtype(opts.dtype)

        def stack(xs, dt=dtype):
            return torch.as_tensor(np.stack(xs), dtype=dt, device=device)

        rows = [padded[i] for i in lanes]
        stds = [p for p, _, _ in rows]
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
            prob=prob, x0=stack([x for _, x, _ in rows]),
            y0=stack([y for _, _, y in rows]),
            lb=stack([s.lb for s in stds]), ub=stack([s.ub for s in stds]),
            infos=[built[i][1] for i in lanes], qps=list(qps), opts=opts,
            n_real=len(qps), mesh=mesh, batch_axis=batch_axis, lanes=lanes,
            axis=axis,
        )
        solver._bind_kernels()
        return solver

    def _bind_kernels(self):
        """The batched kernel and, for the mixed-precision rescue, the
        full-precision kernel of phase 2 (`policy.dense_phases`): lanes
        that exit phase 1 unconverged warm-restart it."""
        opts1, opts2 = dense_phases(self.opts)
        self._kernel = BatchedMPCKernel(opts1)
        self._phase2 = BatchedMPCKernel(opts2) if opts2 is not None else None

    def _host_rescue(self, bad):
        """Re-solve the lanes `bad` one by one on the host path (the
        reference's options, no banners); `solve_all` returns these stats
        for them."""
        from ..solver.host import HostMPCSolver

        for i in sorted(set(int(i) for i in bad)):
            self._rescue_overrides[i] = HostMPCSolver.from_device_options(
                self.qps[i], self.opts, print_level=30).solve()

    def _solve(self, prob: ProblemArrays) -> IPMState:
        kern, kern2 = self._kernel, self._phase2
        self._rescue_overrides = {}
        f1 = run_lanes(kern, prob, kern.init_state(prob, self.x0, self.y0,
                                                   self.lb, self.ub))
        if kern2 is None:
            return f1
        statuses = f1.status.cpu().numpy()
        bad = np.flatnonzero(statuses != S.SUCCESS)

        def full_width():
            f2 = run_lanes(kern2, prob, kern2.init_state_warm(
                prob, f1.x, f1.y, f1.zl, f1.zu, self.lb, self.ub))
            return f2._replace(k=f1.k + f2.k)

        if self.axis is not None:
            # Lanes span cards: no host rescue, and the full-width phase 2
            # on every lane of every rank when any lane of the batch failed.
            n_bad = self.axis.sum_across(torch.tensor(bad.size, device=f1.x.device))
            return f1 if int(n_bad) == 0 else full_width()
        if bad.size == 0:
            return f1
        if self.opts.endgame in ("auto", "host"):
            from ..native import available

            if available():
                # The device state keeps the failed lanes' phase-1 result.
                self._host_rescue(bad)
                return f1
        if bad.size > statuses.size // 2:
            # Mostly-failed batches keep the full-width lockstep rescue.
            return full_width()
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
        work finished): under a mesh this rank's lanes only.

        `prob` optionally overrides the problem values (same shapes)."""
        final = self._solve(prob if prob is not None else self.prob)
        sync(final.x.device)
        return final

    def solve_all(self) -> List[ExecutionStats]:
        """Solve and unpack per-instance ExecutionStats (a host-rescued
        lane's are the host solver's, in user coordinates).  Under a mesh
        every rank returns every instance's, in order; each carries the
        wall of the rank that solved it."""
        t0 = time.time()
        final = self.solve_batch()
        wall = time.time() - t0
        host = state_to_host(final)
        start = 0 if self.axis is None else self.axis.rank * len(self.lanes)
        out = []
        for lane, i in enumerate(self.lanes):
            if start + lane >= self.n_real:
                continue  # batch-padding copy
            if i in self._rescue_overrides:
                out.append(self._rescue_overrides[i])
                continue
            out.append(unpack_lane(host, lane, self.infos[lane], self.qps[i], self.opts,
                                   wall, int(host["k"][lane])))
        return out if self.axis is None else self.axis.gather_objects(out)


def solve_batched(
    qps: Sequence[QuadraticProblem],
    mesh=None,
    batch_axis: str = "batch",
    *,
    device="cuda",
    **options,
) -> List[ExecutionStats]:
    """Convenience wrapper: batch-solve a list of QPs on `device` (the CUDA
    card unless the caller asks for the CPU), or sharded over `mesh`."""
    return BatchedMPCSolver.from_problems(
        qps, mesh=mesh, batch_axis=batch_axis, device=device, **options).solve_all()
