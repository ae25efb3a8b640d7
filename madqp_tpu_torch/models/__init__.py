from .qp import (
    QuadraticProblem,
    StandardQP,
    SparseStandardQP,
    TransformInfo,
    build_standard_form,
    build_standard_form_sparse,
    from_coo,
)
from .generators import (dense_dummy_qp, simple_lp, random_lp, random_qp,
                         banded_sparse_lp, separable_qp, ineq_qp, grid_lp, grid3d_lp,
                         netflow_grid_lp)
from .scaling import scale_qp, ruiz_scaling_factors, unscale_stats, RuizScaling
from .presolve import presolve_qp, PresolveInfo, PresolveStatus
from .suite import structured_suite, write_suite

__all__ = [
    "QuadraticProblem",
    "StandardQP",
    "SparseStandardQP",
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
]
