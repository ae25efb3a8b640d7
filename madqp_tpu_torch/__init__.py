"""madqp_tpu_torch — the LP/QP interior-point solver in PyTorch, for CUDA.

Port of `madqp_tpu` (the JAX package, which stays the reference): the
dense Mehrotra predictor-corrector solve with the condensed, normal, K2
and K2.5 KKT systems, shape bucketing and the shape-routed `autosolve`;
batched lockstep solves of many small QPs (`solve_batched`,
`BatchedMPCSolver`); two-stage stochastic QPs through their
Schur-complement KKT (`solve_two_stage`); and the differentiable QP layer
(`qp_layer`, `qp_layer_general`, a `torch.autograd.Function`); and the
MPS → presolve → Ruiz scaling pipeline (`read_mps`, `presolve_qp`,
`scale_qp`, `unscale_stats`, NumPy and SciPy as in the reference) with the
structured suite (`structured_suite`, `write_suite`) that
`tools/run_suite_torch.py` drives.
The reference's Pallas kernels are hand-written CUDA kernels here: the
Cholesky (K1: `ops/pallas_chol.py`, `csrc/cholesky.cu`), selected with
`linear_solver="pallas"`, and the rank-k update (K8: `ops/syrk.py`,
`csrc/syrk.cu`), the trailing update of the panel Cholesky behind
`linear_solver="blocked"`.  On a stack of matrices (a batch, or the
two-stage scenarios) K1 factors every matrix in one launch
(`csrc/cholesky_batched.cu`).

Importing the package sets no global state: every tensor carries an
explicit dtype (float64 by default, `factorization_dtype` for the
factors) and device (the CUDA card unless the caller passes
`device="cpu"`).
"""

from .utils import (
    Status,
    ExecutionStats,
    Counters,
    IPMOptions,
    Mehrotra,
    ConservativeStep,
    AdaptiveStep,
    MehrotraAdaptiveStep,
    NoRegularization,
    FixedRegularization,
    AdaptiveRegularization,
    KKTSystem,
    LinearSolverBackend,
    MadLogger,
)
from .models import (
    QuadraticProblem,
    StandardQP,
    TransformInfo,
    build_standard_form,
    build_standard_form_sparse,
    from_coo,
    dense_dummy_qp,
    simple_lp,
    random_lp,
    random_qp,
    banded_sparse_lp,
    separable_qp,
    ineq_qp,
    grid_lp,
    grid3d_lp,
    netflow_grid_lp,
    scale_qp,
    ruiz_scaling_factors,
    unscale_stats,
    RuizScaling,
    presolve_qp,
    PresolveInfo,
    PresolveStatus,
    structured_suite,
    write_suite,
)
from .io import read_mps, parse_mps, write_mps
from .solver import MPCSolver, solve, autosolve
from .parallel import (
    BatchedMPCSolver,
    solve_batched,
    TwoStageProblem,
    SchurKKT,
    build_two_stage,
    two_stage_to_flat_qp,
    random_two_stage,
    solve_two_stage,
)
from .diff import qp_layer, qp_layer_general, QPLayerSolution
from .convert import problem_arrays_from_numpy, ipm_state_from_numpy, two_stage_from_numpy

__version__ = "0.1.0"

__all__ = [
    "Status",
    "ExecutionStats",
    "Counters",
    "IPMOptions",
    "Mehrotra",
    "ConservativeStep",
    "AdaptiveStep",
    "MehrotraAdaptiveStep",
    "NoRegularization",
    "FixedRegularization",
    "AdaptiveRegularization",
    "KKTSystem",
    "LinearSolverBackend",
    "MadLogger",
    "QuadraticProblem",
    "StandardQP",
    "TransformInfo",
    "build_standard_form",
    "build_standard_form_sparse",
    "from_coo",
    "dense_dummy_qp",
    "simple_lp",
    "random_lp",
    "random_qp",
    "banded_sparse_lp",
    "separable_qp",
    "ineq_qp",
    "grid_lp",
    "grid3d_lp",
    "netflow_grid_lp",
    "scale_qp",
    "ruiz_scaling_factors",
    "unscale_stats",
    "RuizScaling",
    "presolve_qp",
    "PresolveInfo",
    "PresolveStatus",
    "structured_suite",
    "write_suite",
    "read_mps",
    "parse_mps",
    "write_mps",
    "MPCSolver",
    "solve",
    "autosolve",
    "BatchedMPCSolver",
    "solve_batched",
    "TwoStageProblem",
    "SchurKKT",
    "build_two_stage",
    "two_stage_to_flat_qp",
    "random_two_stage",
    "solve_two_stage",
    "qp_layer",
    "qp_layer_general",
    "QPLayerSolution",
    "problem_arrays_from_numpy",
    "ipm_state_from_numpy",
    "two_stage_from_numpy",
]
