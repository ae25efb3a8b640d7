"""A plain primal-dual interior-point method (Mehrotra predictor-corrector)
for the benchmark's problems, in NumPy, over a stack of lanes in lockstep:

    min  1/2 x'Hx + c'x   s.t.  A x = b,  l <= x <= u   (l, u finite)

with the multiplier convention  H x + c + A'y - zl + zu = 0,  zl, zu >= 0.
It shares no code with the program under test.  The linear algebra is the
caller's: `kkt_factor(D, lanes)` factors, for every running lane, and
returns a function of (rx, ry) that gives (dx, dy) of

    [H + diag(D)  A'] [dx]   [rx]
    [A            0 ] [dy] = [ry]

and `hv`, `av`, `atv` are the products with H, A and A'.  Everything
runs in `dtype`: float64 for the reference, a lower precision for the
control.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Result:
    x: np.ndarray          # (L, n)
    y: np.ndarray          # (L, m)
    zl: np.ndarray
    zu: np.ndarray
    converged: np.ndarray  # (L,) bool
    iters: np.ndarray      # (L,) int


def residuals(x, y, zl, zu, c, b, l, u, hv, av, atv):
    """Per-lane relative primal, dual and complementarity residuals."""
    inf = lambda v: np.max(np.abs(v), axis=-1)
    hx, aty = hv(x), atv(y)
    rp = inf(av(x) - b) / (1.0 + inf(b))
    rd = inf(hx + c + aty - zl + zu) / (1.0 + np.maximum.reduce(
        [inf(hx), inf(c), inf(aty), inf(zl), inf(zu)]))
    f = 0.5 * np.sum(x * hx, axis=-1) + np.sum(c * x, axis=-1)
    comp = np.maximum(inf(zl * (x - l)), inf(zu * (u - x))) / (1.0 + np.abs(f))
    return rp, rd, comp


def optimality(inst, x, y, zl, zu) -> float:
    """The largest relative residual of the optimality conditions of one
    instance at (x, y, zl, zu), in float64: the three of `residuals`, the
    bounds' violation and the multipliers' sign."""
    inf = lambda v: float(np.max(np.abs(v))) if v.size else 0.0
    rp, rd, comp = residuals(x[None], y[None], zl[None], zu[None], inst.c[None], inst.b[None],
                             inst.lvar[None], inst.uvar[None], lambda v: (inst.H @ v[0])[None],
                             lambda v: (inst.A @ v[0])[None], lambda v: (inst.A.T @ v[0])[None])
    bound = max(0.0, float(np.max(inst.lvar - x)), float(np.max(x - inst.uvar))) / (1.0 + inf(x))
    sign = max(0.0, -float(np.min(zl)), -float(np.min(zu))) / (1.0 + max(inf(zl), inf(zu)))
    return max(float(rp[0]), float(rd[0]), float(comp[0]), bound, sign)


def _max_step(v, dv):
    """Largest a in (0, 1] with v + a dv >= 0, per lane."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(dv < 0, -v / dv, np.inf)
    return np.minimum(1.0, np.min(ratio, axis=-1))


def solve(c, b, l, u, hv, av, atv, kkt_factor, *, dtype=np.float64, tol=1e-10,
          max_iter=100, stall=8) -> Result:
    """Solve every lane; a lane stops when its three residuals are under
    `tol`, or when its worst residual has not improved for `stall`
    iterations or its iterate has reached a bound (in a low precision);
    such a lane returns its best iterate, `converged` False."""
    c, b, l, u = (np.asarray(v, dtype) for v in (c, b, l, u))
    L, n = c.shape
    x = (0.5 * (l + u)).astype(dtype)
    y = np.zeros(b.shape, dtype)
    zl = np.ones((L, n), dtype)
    zu = np.ones((L, n), dtype)
    best = [x.copy(), y.copy(), zl.copy(), zu.copy()]
    best_err = np.full(L, np.inf)
    since = np.zeros(L, int)
    converged = np.zeros(L, bool)
    iters = np.zeros(L, int)
    running = np.ones(L, bool)
    for _ in range(max_iter):
        err = np.maximum.reduce(residuals(x, y, zl, zu, c, b, l, u, hv, av, atv))
        better = running & (err < best_err)
        for keep, cur in zip(best, (x, y, zl, zu)):
            keep[better] = cur[better]
        best_err = np.where(better, err, best_err)
        since = np.where(better, 0, since + 1)
        converged |= running & (err <= tol)
        interior = np.all(x > l, axis=-1) & np.all(x < u, axis=-1)
        running &= ~converged & (since < stall) & interior
        if not running.any():
            break
        iters += running
        r = running
        sl, su = x - l, u - x
        rd = hv(x) + c + atv(y) - zl + zu
        rp = av(x) - b
        mu = (np.sum(sl * zl, -1) + np.sum(su * zu, -1)) / (2 * n)
        kkt_solve = kkt_factor((zl / sl + zu / su)[r], r)

        def direction(tl, tu):
            dx, dy = kkt_solve((-rd + tl / sl - tu / su)[r], -rp[r])
            dzl = (tl[r] - zl[r] * dx) / sl[r]
            dzu = (tu[r] + zu[r] * dx) / su[r]
            return dx, dy, dzl, dzu

        dx, dy, dzl, dzu = direction(-sl * zl, -su * zu)
        a = np.minimum.reduce([_max_step(sl[r], dx), _max_step(su[r], -dx),
                               _max_step(zl[r], dzl), _max_step(zu[r], dzu)])[:, None]
        mu_aff = (np.sum((sl[r] + a * dx) * (zl[r] + a * dzl), -1)
                  + np.sum((su[r] - a * dx) * (zu[r] + a * dzu), -1)) / (2 * n)
        sigma = np.clip(mu_aff / mu[r], 0.0, 1.0) ** 3
        tl = np.zeros_like(x)
        tu = np.zeros_like(x)
        tl[r] = (sigma * mu[r])[:, None] - sl[r] * zl[r] - dx * dzl
        tu[r] = (sigma * mu[r])[:, None] - su[r] * zu[r] + dx * dzu
        dx, dy, dzl, dzu = direction(tl, tu)
        a = 0.99 * np.minimum.reduce([_max_step(sl[r], dx), _max_step(su[r], -dx),
                                      _max_step(zl[r], dzl), _max_step(zu[r], dzu)])[:, None]
        x[r] += (a * dx).astype(dtype)
        y[r] += (a * dy).astype(dtype)
        zl[r] += (a * dzl).astype(dtype)
        zu[r] += (a * dzu).astype(dtype)
    x, y, zl, zu = best
    return Result(x=x, y=y, zl=zl, zu=zu, converged=converged, iters=iters)
