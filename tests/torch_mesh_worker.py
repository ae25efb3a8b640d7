"""Rank-side cases of the port's mesh tests (tests/test_torch_mesh*.py).

`madqp_tpu_torch.parallel.mesh.spawn` runs `run_cases` in every rank of a
gloo group on the CPU; the children import this module by name, and it
imports the port only.  Each case is (name, kind, payload); every rank
runs every case in order (a collective per case), and returns
{name: result}.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

import madqp_tpu_torch as mt
from madqp_tpu_torch.parallel import BatchedMPCSolver, mesh as M


def _mesh(axis):
    return init_device_mesh("cpu", (dist.get_world_size(),), mesh_dim_names=(axis,))


def batched(payload):
    """The batch sharded over "batch": every rank's stats, its own lanes,
    its host-rescue overrides and the iteration calls of its float64
    phase 2."""
    qps, options = payload
    solver = BatchedMPCSolver.from_problems(qps, mesh=_mesh("batch"), device="cpu", **options)
    calls = [0]
    if solver._phase2 is not None:
        step = solver._phase2.iteration

        def counted(p, s):
            calls[0] += 1
            return step(p, s)
        solver._phase2.iteration = counted
    stats = solver.solve_all()
    return dict(stats=stats, lanes=solver.lanes, overrides=dict(solver._rescue_overrides),
                phase2_calls=calls[0])


def two_stage(payload):
    """random_two_stage(**spec) sharded over "scen"."""
    spec, options = payload
    prob, lb, ub = mt.random_two_stage(**spec, device="cpu")
    return mt.solve_two_stage(prob, lb, ub, mesh=_mesh("scen"), device="cpu", **options)


def sparse(payload):
    """solve_sparse_batched sharded over "batch"."""
    qps, options = payload
    return mt.solve_sparse_batched(qps, mesh=_mesh("batch"), device="cpu", **options)


def two_stage_uneven(spec):
    """The ValueError of a scenario count the ranks do not divide."""
    prob, lb, ub = mt.random_two_stage(**spec, device="cpu")
    try:
        mt.solve_two_stage(prob, lb, ub, mesh=_mesh("scen"), device="cpu", print_level=40)
    except ValueError as exc:
        return str(exc)
    return None


def resolve_errors(_):
    """resolve's errors on a real mesh: an axis it lacks, a device of
    another type."""
    mesh = _mesh("batch")
    out = []
    for axis, device in (("nope", "cpu"), ("batch", "cuda")):
        try:
            M.resolve(mesh, axis, device)
        except ValueError as exc:
            out.append(str(exc))
    ax = M.resolve(mesh, "batch", "cpu")
    return dict(errors=out, rank=ax.rank, world=ax.world, device=str(ax.device),
                gather=ax.gather_rows(torch.full((2, 3), float(ax.rank))).tolist(),
                sum=ax.sum_across(torch.tensor([1.5, float(ax.rank)])).tolist(),
                all_true=bool(ax.all_true(ax.rank == 0)),
                objects=ax.gather_objects([ax.rank, f"r{ax.rank}"]))


def one_rank(payload):
    """On rank 0 alone, a mesh of one rank (a subgroup): each of `payload`'s
    (kind, case payload) solved through the mesh and without it.  The other
    ranks return None."""
    group = dist.new_group([0])
    if dist.get_rank() != 0:
        return None
    out = []
    for kind, (what, options) in payload:
        mesh = DeviceMesh.from_group(group, "cpu",
                                     mesh_dim_names=("scen" if kind == "two_stage" else "batch",))
        if kind == "batched":
            solve = lambda m: mt.solve_batched(what, mesh=m, device="cpu", **options)  # noqa: E731
        else:
            prob, lb, ub = mt.random_two_stage(**what, device="cpu")
            solve = lambda m: mt.solve_two_stage(prob, lb, ub, mesh=m,  # noqa: E731
                                                 device="cpu", **options)
        out.append((solve(mesh), solve(None)))
    return out


KINDS = dict(batched=batched, two_stage=two_stage, sparse=sparse,
             two_stage_uneven=two_stage_uneven, resolve_errors=resolve_errors,
             one_rank=one_rank)


def run_cases(cases):
    return {name: KINDS[kind](payload) for name, kind, payload in cases}
