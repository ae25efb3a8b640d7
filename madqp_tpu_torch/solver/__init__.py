from .state import IPMState, ProblemArrays, problem_to_device, count_onesided
from .mpc import MPCKernel
from .driver import MPCSolver, autosolve, solve
from .host import HostMPCSolver, solve_host
from .sparse_lp import solve_sparse_lp
from .sparse_qp import solve_sparse_qp
from .sparse_condensed import solve_sparse_condensed

__all__ = [
    "IPMState",
    "ProblemArrays",
    "problem_to_device",
    "count_onesided",
    "MPCKernel",
    "MPCSolver",
    "solve",
    "autosolve",
    "HostMPCSolver",
    "solve_host",
    "solve_sparse_lp",
    "solve_sparse_qp",
    "solve_sparse_condensed",
]
