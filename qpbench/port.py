"""What the entries share: the benchmark's instances as the program's
problems, and the program's results as the benchmark's answers."""

from __future__ import annotations

from qpbench.compare import Answer


def problem(inst):
    """An instance as the program's `QuadraticProblem` (equality rows as
    lcon = ucon)."""
    from madqp_tpu_torch import QuadraticProblem

    return QuadraticProblem(c=inst.c, A=inst.A, lcon=inst.b, ucon=inst.b, lvar=inst.lvar,
                            uvar=inst.uvar, H=inst.H, name=inst.name)


def answer(stats) -> Answer:
    """An `ExecutionStats` as the benchmark's answer.  The sparse path's
    host-full route (`endgame_backend`) is no answer of the device path:
    it reads as a status of its own."""
    status = stats.status.name
    if stats.counters.endgame_backend == "host-full":
        status = "HOST_FULL_ROUTE"
    return Answer(status=status, objective=stats.objective, x=stats.solution,
                  y=stats.multipliers, zl=stats.multipliers_L, zu=stats.multipliers_U,
                  iters=int(stats.iter))
