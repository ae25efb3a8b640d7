from . import blocked_dense, kernels
from .kkt import (DenseCondensedKKT, DenseK2KKT, DenseK25KKT, DenseNormalKKT,
                  make_kkt, kkt_mul)
from .pallas_chol import (cholesky_lower, cholesky_lower_reference,
                          dense_cholesky, select_cholesky)
from .syrk import syrk_update, syrk_update_reference

__all__ = [
    "blocked_dense",
    "kernels",
    "DenseCondensedKKT",
    "DenseK2KKT",
    "DenseK25KKT",
    "DenseNormalKKT",
    "make_kkt",
    "kkt_mul",
    "cholesky_lower",
    "cholesky_lower_reference",
    "dense_cholesky",
    "select_cholesky",
    "syrk_update",
    "syrk_update_reference",
]
