"""Carry the reference package's data across into this package's structures.

Each function takes a dict of NumPy arrays, one per field of the
reference's `ProblemArrays` / `IPMState` / `TwoStageProblem` (as
`np.asarray` of each field gives them), and returns this package's
NamedTuple with every floating array as a tensor of `dtype` on `device`.
Masks become bool tensors;
integer counters, the status code and the `initialized` flag become
Python scalars (this package keeps them on the host).  The tests use this
to feed one identical state to both packages' MPC `iteration`.

A batch (the reference's vmapped arrays, a leading lane axis on every
field) carries across the same way, into the layout of
`solver.mpc.BatchedMPCKernel`: the counters and the status become int64
tensors (B,), and `initialized`, which must agree in every lane, one host
bool.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.kernels import KKTVec
from .parallel.structured import TwoStageProblem
from .solver.state import IPMState, ProblemArrays

_HOST_INTS = ("k", "n_fact", "n_solve", "status", "stall_k")


def _is_none(v) -> bool:
    # np.asarray(None) is a 0-d object array holding None
    return v is None or (isinstance(v, np.ndarray) and v.dtype == object
                         and v.shape == () and v.item() is None)


def _fields_to_device(cls, fields: dict, dtype, device, optional):
    """`cls` from NumPy arrays: bool masks, the `optional` fields None
    where the reference has None, every other field a tensor (a field with
    a default that `fields` lacks, such as a problem's mesh axis, keeps
    its default)."""
    def convert(name):
        v = fields.get(name)
        if name in optional and _is_none(v):
            return None
        if name.startswith("has_"):
            return torch.as_tensor(np.array(v, dtype=bool), device=device)
        # np.array copies: arrays exported by other frameworks are read-only
        return torch.as_tensor(np.array(v), dtype=dtype, device=device).contiguous()

    return cls(**{name: convert(name) for name in cls._fields
                  if name in fields or name not in cls._field_defaults})


def problem_arrays_from_numpy(fields: dict, dtype=torch.float64, *,
                              device) -> ProblemArrays:
    """ProblemArrays from NumPy arrays; `H` may be None (an LP)."""
    return _fields_to_device(ProblemArrays, fields, dtype, device, ("H",))


def two_stage_from_numpy(fields: dict, dtype=torch.float64, *,
                         device) -> TwoStageProblem:
    """TwoStageProblem from NumPy arrays; `H0` and `H_s` may be None (an
    LP)."""
    return _fields_to_device(TwoStageProblem, fields, dtype, device, ("H0", "H_s"))


def ipm_state_from_numpy(fields: dict, dtype=torch.float64, *,
                         device) -> IPMState:
    """IPMState from NumPy arrays, of one problem or of a batch (`k` of
    shape (B,)).  `d` is a sequence (x, y, zl, zu) of arrays, since the
    direction is itself a NamedTuple of unequal parts."""
    def as_dev(v):
        return torch.as_tensor(np.array(v), dtype=dtype, device=device)

    batched = np.ndim(fields["k"]) == 1
    out = {}
    for name in IPMState._fields:
        v = fields[name]
        if name == "d":
            out[name] = KKTVec(*(as_dev(part) for part in v))
        elif name in _HOST_INTS:
            out[name] = (torch.as_tensor(np.array(v), dtype=torch.int64, device=device)
                         if batched else int(np.asarray(v)))
        elif name == "initialized":
            flags = np.asarray(v, dtype=bool)
            if flags.min() != flags.max():
                raise ValueError("the lanes of a batched state must agree on "
                                 "`initialized`: they start together")
            out[name] = bool(flags.all())
        else:
            out[name] = as_dev(v)
    return IPMState(**out)
