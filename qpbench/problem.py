"""The benchmark's own problem record, shared by the generators, the
plain references and the comparison.

    min  1/2 x'Hx + c'x   s.t.  A x = b,  lvar <= x <= uvar

Every configuration of this benchmark has equality rows and boxed
variables only.  The record is plain NumPy and SciPy: the reference reads
it as it is, and an entry turns it into the program's own problem type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class Instance:
    name: str
    H: sp.csr_matrix       # the full symmetric Hessian
    c: np.ndarray
    A: sp.csr_matrix
    b: np.ndarray
    lvar: np.ndarray
    uvar: np.ndarray

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[0]

    def objective(self, x: np.ndarray) -> float:
        return float(0.5 * x @ (self.H @ x) + self.c @ x)


def seed_sequence(seed: int, *keys: int) -> np.random.SeedSequence:
    """The sub-stream of `seed` named by `keys` (a seed may be any whole
    number; it is taken modulo 2**64)."""
    return np.random.SeedSequence([seed % 2 ** 64, *keys])
