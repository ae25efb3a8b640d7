"""How `correct` is decided: the answers the timed calls returned, judged
against the benchmark's own data and the plain reference.

Every answer kept from the window (`harness.sample_lanes`) is judged by
what it says, in float64 NumPy from the instance the benchmark built:

* `bad_status`: answers whose status is not SOLVE_SUCCEEDED (every
  instance is feasible and bounded by construction);
* `kkt_res`: the largest relative residual of the optimality conditions
  at the returned point and multipliers (`reference/ipm.py::optimality`,
  the reference's own test): A x = b, H x + c + A'y - zl + zu = 0,
  l <= x <= u, zl, zu >= 0 and the complementarity of each bound; for a
  convex QP these certify the point optimal;
* `obj_res`: |f - f(x)| / (1 + |f(x)|) of the returned objective against
  the objective of the returned point.

Where the cell's limits name them, a draw from the seed of at most
`reference_lanes` of the kept instances is solved again by the
configuration's plain reference (`reference/<config>`, which imports
nothing of the program), and every kept answer of those instances is
compared with it:

* `obj_gap`: |f - f_ref| / max(1, |f_ref|) of the returned objective;
* `x_err`: max |x - x_ref| / max(1, max |x_ref|).

(The multipliers are judged through `kkt_res` and not against the
reference's: on degenerate instances they are not unique.)  A cell
compares the numbers its `check.limits` names, each against its limit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answer:
    """What a timed call returned for one instance."""
    status: str
    objective: float
    x: np.ndarray
    y: np.ndarray
    zl: np.ndarray
    zu: np.ndarray
    iters: int


def residual(inst, a: Answer) -> float:
    """The largest relative residual of the optimality conditions."""
    from qpbench.reference.ipm import optimality

    return optimality(inst, *(np.asarray(v, np.float64) for v in (a.x, a.y, a.zl, a.zu)))


def solve_groups(reference, insts, dtype=np.float64) -> list:
    """The reference's (x, y, zl, zu, iterations, converged) of each of
    `insts`, solved together where they share a shape."""
    groups = {}
    for j, p in enumerate(insts):
        groups.setdefault((p.n, p.m), []).append(j)
    out = [None] * len(insts)
    for idx in groups.values():
        r = reference.solve([insts[j] for j in idx], dtype=dtype)
        for k, j in enumerate(idx):
            out[j] = (r.x[k], r.y[k], r.zl[k], r.zu[k], r.iters[k], r.converged[k])
    return out


def judge(pool, kept, check: dict, reference, rng) -> dict:
    """{number: {"value", "limit"}} of the numbers `check["limits"]`
    names, over the kept answers `kept`, a list of (pool call, lane,
    Answer)."""
    limits = check["limits"]
    ok = [k for k in kept if k[2].status == "SOLVE_SUCCEEDED"]
    values = {
        "bad_status": float(len(kept) - len(ok)),
        "kkt_res": max((residual(pool[i][lane], a) for i, lane, a in ok), default=0.0),
        "obj_res": max((abs(a.objective - pool[i][lane].objective(np.asarray(a.x, np.float64)))
                        / (1.0 + abs(pool[i][lane].objective(np.asarray(a.x, np.float64))))
                        for i, lane, a in ok), default=0.0),
    }
    if "obj_gap" in limits or "x_err" in limits:
        values.update(against_reference(pool, ok, check, reference, rng))
    return {name: {"value": values[name], "limit": limit} for name, limit in limits.items()}


def against_reference(pool, ok, check: dict, reference, rng) -> dict:
    """`obj_gap` and `x_err` of the answers of a draw of the instances."""
    keys = sorted({(i, lane) for i, lane, _ in ok})
    pick = rng.permutation(len(keys))[: check["reference_lanes"]]
    chosen = [keys[j] for j in sorted(pick)]
    insts = [pool[i][lane] for i, lane in chosen]
    row = {}
    for key, p, sol in zip(chosen, insts, solve_groups(reference, insts)):
        if not sol[-1]:
            raise RuntimeError(f"the reference did not converge on {p.name}")
        row[key] = sol[0]
    obj_gap = x_err = 0.0
    for i, lane, a in ok:
        xr = row.get((i, lane))
        if xr is None:
            continue
        fr = pool[i][lane].objective(xr)
        obj_gap = max(obj_gap, abs(a.objective - fr) / max(1.0, abs(fr)))
        x_err = max(x_err, float(np.max(np.abs(np.asarray(a.x) - xr)))
                    / max(1.0, float(np.max(np.abs(xr)))))
    return {"obj_gap": obj_gap, "x_err": x_err}
