"""Batched and structured solving (port of `madqp_tpu/parallel`): lockstep
solves of padded batches (`BatchedMPCSolver`, `solve_batched`), the
padding that `pad_mode="bucket"` also uses (`pad_standard`), and the
two-stage stochastic QP with its Schur-complement KKT (`TwoStageProblem`,
`SchurKKT`, `solve_two_stage`); and the shared-pattern sparse batch
(`solve_sparse_batched`: one symbolic phase, every front stack of the
supernodal factorization holding all lanes' fronts).  Each takes `mesh=`,
a `torch.distributed` DeviceMesh with one process per card, and shards
its lanes or scenarios over it (`mesh`: the axis, its collectives, and
`spawn` for a group of processes)."""

from .batched import BatchedMPCSolver, solve_batched, pad_standard
from .sparse_batched import solve_sparse_batched
from .structured import (
    TwoStageProblem,
    SchurKKT,
    build_two_stage,
    two_stage_to_flat_qp,
    random_two_stage,
    solve_two_stage,
)

__all__ = [
    "BatchedMPCSolver",
    "solve_batched",
    "pad_standard",
    "solve_sparse_batched",
    "TwoStageProblem",
    "SchurKKT",
    "build_two_stage",
    "two_stage_to_flat_qp",
    "random_two_stage",
    "solve_two_stage",
]
