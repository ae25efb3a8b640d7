"""Plain reference of `ssn_saa`: the interior-point method of `ipm.py`,
step for step, and its linear algebra, in plain PyTorch on a
replication's blocks (`SAAInstance.blocks`: on the card where the
generator put them, on the CPU without one), every product in full
precision (no TF32).  It imports nothing of the program.

`ipm.solve` itself does the method's vector arithmetic in NumPy on the
host, about 4 s an iteration over the 6.5M columns of a full
replication; here the same steps (starting point, Mehrotra predictor and
corrector, one step to 0.99 of the boundary, the interior rule, the best
iterate kept, the same residuals and tolerance) run where the data is,
one lane at a time.  The stall rule waits STALL = 30 iterations, not 8:
on this problem the largest complementarity product climbs for a dozen
iterations while the primal residual falls, and the float64 method then
recovers and converges.

The problem has no Hessian, so for the method's diagonal D the KKT system

    D0 dx0 + A0' dy0 + sum_s T_s' dy_s = rx0     D_s dx_s + W_s' dy_s = rx_s
    A0 dx0 = ry0                                  T_s dx0 + W_s dx_s = ry_s

gives each scenario dx_s = D_s^-1 (rx_s - W_s' dy_s) and, with
S_s = W_s D_s^-1 W_s' (LU with partial pivoting on the (N, ms, ms)
stack, `torch.linalg.lu_factor_ex`: a Cholesky breaks down once D spreads
over twenty orders of magnitude), dy_s = X_s dx0 + q_s, X_s = S_s^-1 T_s,
q_s = S_s^-1 (W_s D_s^-1 rx_s - ry_s); the first stage is the
(n0 + m0)-square system

    [C   A0'] [dx0]   [rx0 - sum_s T_s' q_s]
    [A0  0  ] [dy0] = [ry0                 ]      C = D0 + sum_s T_s' X_s

solved by LU too, then REFINE steps of iterative refinement on the whole
system.  A factor that fails gives NaNs, which the stall rule stops on.
"""

from __future__ import annotations

import numpy as np
import torch

from qpbench.reference import ipm

REFINE = 2
TOL, MAX_ITER, STALL = 1e-10, 100, 30   # ipm.solve's tolerance and cap; see above for STALL


class _Lane:
    """One instance's blocks in the working precision, with its flat
    layout."""

    def __init__(self, blocks: dict, dtype):
        self.W = blocks["W_s"].to(dtype)      # (N, ms, ns)
        self.T = blocks["T_s"].to(dtype)      # (N, ms, n0)
        self.A0 = blocks["A0"].to(dtype)      # (m0, n0)
        self.N, self.ms, self.ns = self.W.shape
        self.m0, self.n0 = self.A0.shape
        self.dtype = dtype

    def tensor(self, v):
        return torch.as_tensor(np.ascontiguousarray(v), device=self.W.device).to(self.dtype)

    def split_x(self, v):
        return v[: self.n0], v[self.n0:].reshape(self.N, self.ns)

    def split_y(self, v):
        return v[: self.m0], v[self.m0:].reshape(self.N, self.ms)

    def av(self, x):
        x0, xs = self.split_x(x)
        ys = self.T @ x0 + (self.W @ xs[..., None])[..., 0]
        return torch.cat([self.A0 @ x0, ys.reshape(-1)])

    def atv(self, y):
        y0, ys = self.split_y(y)
        x0 = self.A0.T @ y0 + torch.einsum("imk,im->k", self.T, ys)
        return torch.cat([x0, (self.W.mT @ ys[..., None])[..., 0].reshape(-1)])

    def factor(self, d):
        d0, ds = self.split_x(d)
        S_lu, S_piv, _ = torch.linalg.lu_factor_ex((self.W / ds[:, None, :]) @ self.W.mT)
        X = torch.linalg.lu_solve(S_lu, S_piv, self.T)
        C = torch.diag(d0) + torch.einsum("imk,iml->kl", self.T, X)
        lu, piv, _ = torch.linalg.lu_factor_ex(torch.cat([
            torch.cat([C, self.A0.T], 1),
            torch.cat([self.A0, self.A0.new_zeros(self.m0, self.m0)], 1)]))

        def direct(rx, ry):
            r0, rs = self.split_x(rx)
            q0, qs = self.split_y(ry)
            q = torch.linalg.lu_solve(S_lu, S_piv, ((self.W @ (rs / ds)[..., None])[..., 0]
                                                    - qs)[..., None])[..., 0]
            rhs = torch.cat([r0 - torch.einsum("imk,im->k", self.T, q), q0])
            sol = torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]
            dx0, dy0 = sol[: self.n0], sol[self.n0:]
            dys = q + X @ dx0
            dxs = (rs - (self.W.mT @ dys[..., None])[..., 0]) / ds
            return torch.cat([dx0, dxs.reshape(-1)]), torch.cat([dy0, dys.reshape(-1)])

        def solve(rx, ry):
            """`direct`, then REFINE steps of iterative refinement on the
            whole system (the elimination loses the primal residual as D
            spreads)."""
            dx, dy = direct(rx, ry)
            for _ in range(REFINE):
                ex, ey = direct(rx - d * dx - self.atv(dy), ry - self.av(dx))
                dx, dy = dx + ex, dy + ey
            return dx, dy
        return solve


def _inf(v) -> float:
    return float(v.abs().max()) if v.numel() else 0.0


def _max_step(v, dv):
    """Largest a in (0, 1] with v + a dv >= 0."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return min(1.0, float(ratio.min()))


def _solve_lane(lane: _Lane, p):
    """`ipm.solve`'s method on one lane, step for step, in torch where the
    lane's blocks are: (x, y, zl, zu, iterations, converged)."""
    c, b, l, u = (lane.tensor(v) for v in (p.c, p.b, p.lvar, p.uvar))
    n = c.numel()
    x = 0.5 * (l + u)
    y = torch.zeros_like(b)
    zl, zu = torch.ones_like(x), torch.ones_like(x)
    best, best_err, since, iters = [x, y, zl, zu], float("inf"), 0, 0
    for _ in range(MAX_ITER):
        aty = lane.atv(y)
        rp = _inf(lane.av(x) - b) / (1.0 + _inf(b))
        rd = _inf(c + aty - zl + zu) / (1.0 + max(0.0, _inf(c), _inf(aty), _inf(zl), _inf(zu)))
        comp = max(_inf(zl * (x - l)), _inf(zu * (u - x))) / (1.0 + abs(float(c @ x)))
        err = max(rp, rd, comp)
        if err < best_err:
            best, best_err, since = [x, y, zl, zu], err, 0
        else:
            since += 1
        if err <= TOL:
            return (*best, iters, True)
        if since >= STALL or not bool(((x > l) & (x < u)).all()):
            break
        iters += 1
        sl, su = x - l, u - x
        rd = c + aty - zl + zu
        rp = lane.av(x) - b
        mu = float(sl @ zl + su @ zu) / (2 * n)
        kkt_solve = lane.factor(zl / sl + zu / su)

        def direction(tl, tu):
            dx, dy = kkt_solve(-rd + tl / sl - tu / su, -rp)
            return dx, dy, (tl - zl * dx) / sl, (tu + zu * dx) / su

        dx, dy, dzl, dzu = direction(-sl * zl, -su * zu)
        a = min(_max_step(sl, dx), _max_step(su, -dx), _max_step(zl, dzl), _max_step(zu, dzu))
        mu_aff = float((sl + a * dx) @ (zl + a * dzl) + (su - a * dx) @ (zu + a * dzu)) / (2 * n)
        sigma = min(max(mu_aff / mu, 0.0), 1.0) ** 3
        dx, dy, dzl, dzu = direction(sigma * mu - sl * zl - dx * dzl,
                                     sigma * mu - su * zu + dx * dzu)
        a = 0.99 * min(_max_step(sl, dx), _max_step(su, -dx), _max_step(zl, dzl),
                       _max_step(zu, dzu))
        x, y, zl, zu = x + a * dx, y + a * dy, zl + a * dzl, zu + a * dzu
    return (*best, iters, False)


def solve(instances, dtype=np.float64) -> ipm.Result:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    out = [_solve_lane(_Lane(p.blocks, tdtype), p) for p in instances]

    def stack(k):
        return np.stack([o[k].cpu().numpy() for o in out])

    return ipm.Result(x=stack(0), y=stack(1), zl=stack(2), zu=stack(3),
                      converged=np.array([o[5] for o in out]),
                      iters=np.array([o[4] for o in out]))
