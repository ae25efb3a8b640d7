"""GEMM-rich blocked dense factorizations (port of
`madqp_tpu/ops/blocked_dense.py`).

The same algorithms as the JAX package, so the CPU tests can hold each
function against its counterpart: every O(w^3) step is a matrix product and
only O(w) steps of (..., b, b) elementwise work stay sequential (b = the
32-wide unblocked base).  Loops that the JAX package runs as
`lax.fori_loop` are Python loops here.

Contents (batched over leading dims where the JAX function is; last two
dims w x w):
  * `unblocked_ldl`    - masked rank-1 sweep LDL^T with the optional
    sign-directed pivot floor; the base case.
  * `blocked_ldl`      - recursive block LDL^T (`panel_ldl` for 2-D inputs
    of order >= 1024); on a CUDA tensor `ldl_blocks`.
  * `ldl_blocks`       - the card's signed LDL^T of any leading dims: one
    K2-batched launch (`ldl_batched.ldl_lower_batched`) per 128-wide
    diagonal block of the whole stack, the panel and trailing update as
    batched products.
  * `blocked_cholesky` - SPD Cholesky via blocked_ldl (L_chol = L sqrt(d)),
    or `panel_chol` for large 2-D inputs.
  * `inv_unit_lower` / `inv_lower` - blocked triangular inversion.
  * `panel_chol`       - two-level right-looking Cholesky for large SPD
    matrices; both of its trailing updates are K8 (`syrk.syrk_update`),
    whose launches `panel_update_shapes` lists.
  * `panel_inv_lower` / `panel_inv_unit_lower` / `panel_ldl` - the
    right-looking large-n forms.
  * `factor_inv_chol` / `chol_explicit_inverse` - factor plus the explicit
    inverse factor (or inverse) used by `linear_solver="blocked"`.

The lane path.  Under `jax.vmap` the JAX package sees one 2-D lane, so a
batch of order >= 1024 takes the panel forms, while a plain 3-D call (the
supernodal fronts) takes the recursion.  Here the batched KKT asks for the
panel forms explicitly with `lanes=True` (`blocked_ldl`, `inv_unit_lower`,
`factor_inv_chol`, `chol_explicit_inverse`); the panel forms themselves
take a (L, n, n) stack as they take one matrix, and `panel_chol` issues
each of its K8 updates once for all lanes (K8's lane axis), so a trial
launches `panel_update_shapes` whatever the lane count.  A 3-D call
without `lanes` keeps the recursion.

On a CUDA tensor `blocked_ldl` is `ldl_blocks` and `inv_unit_lower` one
triangular solve against the identity, whatever the order and leading
dims (no Python sweep over columns or rows); the CPU keeps the JAX
package's algorithms, so the CPU comparisons follow them.

Contract (the solver's factor_ok tests read it): a matrix that is not SPD
gives NaN or a non-positive value on the Cholesky diagonal, and a wrong
or non-finite pivot in the LDL^T forms; nothing raises.  Masks select with
`torch.where`, never by multiplying, so a NaN in an unselected entry stays
out.  Every constant is created in the working dtype.
"""

from __future__ import annotations

import math

import torch

from .ldl_batched import MAX_N as LDL_BLOCK
from .ldl_batched import ldl_lower_batched
from .syrk import syrk_update

BLK = 32
PANEL = 256          # right-looking panel width for large matrices
OUTER = 2048         # outer stripe width of the two-level SPD path
_PANEL_MIN = 1024    # 2-D inputs at least this wide take the panel path


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def _lib_cholesky(M: torch.Tensor) -> torch.Tensor:
    """Library Cholesky with the NaN-diagonal contract: `cholesky_ex`
    leaves a partial factor without a NaN on a non-SPD matrix, so the
    failure reported in `info` is written into the diagonal (no host
    sync)."""
    L, info = torch.linalg.cholesky_ex(M)
    L.diagonal(dim1=-2, dim2=-1).masked_fill_((info > 0)[..., None],
                                              float("nan"))
    return L


def _pad_identity(F: torch.Tensor, npad: int) -> torch.Tensor:
    """Pad (..., n, n) matrices to (..., npad, npad) with an identity tail."""
    n = F.shape[-1]
    if npad == n:
        return F
    P = F.new_zeros(F.shape[:-2] + (npad, npad))
    P[..., :n, :n] = F
    idx = torch.arange(n, npad, device=F.device)
    P[..., idx, idx] = 1.0
    return P


def unblocked_ldl(F, sgn=None, floor: float = 0.0):
    """No-pivot LDL^T of (..., w, w) symmetric matrices: F = L D L' with
    L unit lower triangular.  Sequential masked rank-1 sweep over the w
    columns - use only as the blocked base case (w <= ~32).

    With `sgn` ((..., w) expected pivot signs) and `floor` > 0, pivots
    are perturbed to sgn * max(sgn * d, floor)."""
    w = F.shape[-1]
    idx = torch.arange(w, device=F.device)
    floor_t = torch.tensor(floor, dtype=F.dtype, device=F.device)
    zero = _zero(F)
    L = torch.zeros_like(F)
    d = torch.zeros(F.shape[:-1], dtype=F.dtype, device=F.device)
    for j in range(w):
        dj = F[..., j, j]
        if sgn is not None and floor > 0.0:
            sj = sgn[..., j]
            dj = sj * torch.maximum(sj * dj, floor_t)
        col = F[..., :, j] / dj[..., None]
        col = torch.where(idx > j, col, zero)
        F = F - dj[..., None, None] * col[..., :, None] * col[..., None, :]
        L[..., :, j] = col
        d[..., j] = dj
    return L + _eye(w, F), d


def inv_unit_lower(L, blk: int = BLK, lanes: bool = False):
    """Explicit inverse of a batched UNIT lower-triangular (..., w, w):
    blocked 2x2 recursion - inv([[A,0],[B,C]]) = [[iA,0],[-iC B iA, iC]] -
    with a sequential row-sweep base case.  Large 2-D inputs (or a stack
    with `lanes`) dispatch to the right-looking panel_inv_unit_lower.  A
    CUDA tensor takes one triangular solve against the identity."""
    w = L.shape[-1]
    if L.device.type == "cuda":
        return torch.linalg.solve_triangular(L, _eye(w, L).expand(L.shape), upper=False,
                                             unitriangular=True)
    if (L.dim() == 2 or lanes) and w >= _PANEL_MIN:
        return panel_inv_unit_lower(L)
    if w > blk:
        h = blk * (((w + 1) // 2 + blk - 1) // blk)  # split at a blk multiple
        h = min(h, w - 1)
        iA = inv_unit_lower(L[..., :h, :h], blk)
        iC = inv_unit_lower(L[..., h:, h:], blk)
        B = L[..., h:, :h]
        off = -(iC @ (B @ iA))
        top = torch.cat([iA, torch.zeros_like(L[..., :h, h:])], dim=-1)
        bot = torch.cat([off, iC], dim=-1)
        return torch.cat([top, bot], dim=-2)

    idx = torch.arange(w, device=L.device)
    zero = _zero(L)
    X = torch.zeros_like(L)
    for i in range(w):
        # row i of inv: e_i - L[i, :i] @ X[:i, :]  (unit diagonal)
        li = torch.where(idx < i, L[..., i, :], zero)          # (..., w)
        acc = (li[..., None, :] @ X)[..., 0, :]
        X[..., i, :] = (idx == i).to(L.dtype) - acc
    return X


def inv_lower(L, unit: bool = False, blk: int = BLK):
    """Explicit inverse of batched lower-triangular (..., w, w).
    Non-unit L = L_u @ diag(d)  =>  inv(L) = diag(1/d) @ inv(L_u)."""
    if unit:
        return inv_unit_lower(L, blk)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    Lu = L / d[..., None, :]
    return inv_unit_lower(Lu, blk) / d[..., :, None]


def _chol_block(D):
    """Cholesky + explicit inverse of (..., w, w) SPD panels through the
    library factorization and triangular solve (the JAX package uses XLA's
    here); a non-SPD panel gives a NaN diagonal in both."""
    Lp = _lib_cholesky(D)
    iLp = torch.linalg.solve_triangular(Lp, _eye(D.shape[-1], D).expand(D.shape),
                                        upper=False)
    return Lp, iLp


def _stripes(npad: int, outer: int):
    """(j0, width) of each outer stripe of a padded order npad."""
    return [(j0, min(outer, npad - j0)) for j0 in range(0, npad, outer)]


def panel_chol(F, panel: int = PANEL, outer: int = OUTER):
    """Two-level right-looking Cholesky for LARGE (n, n) SPD matrices, or
    a stack (L, n, n) of them (the lane path): returns the lower NON-unit
    factor L with F = L L'.

    Level 1: stripes of `outer` columns; after a stripe is factored, one
    K8 update of the trailing square.  Level 2: `panel`-column steps
    inside the stripe, each a library Cholesky + triangular inverse of the
    diagonal block, the panel's factor column Z below it, and one K8
    update of the stripe's block right of and below the panel.

    The JAX package updates the whole (h, w) stripe with a masked Zb that
    is zero above row c0 + panel, and takes Zb[:w] for the masked Lwb; so
    only S[c0 + panel:, c0 + panel:] changes, and here Z is computed for
    those rows only and K8 updates that block alone.  Every update works
    in place on views of one working copy of the (padded) matrix: no
    stripe or trailing square is copied.  The last panel of a stripe
    leaves nothing to update and launches nothing; `panel_update_shapes`
    lists the launches, for one matrix and for a stack alike (each a
    stacked K8 launch).

    NaN from a non-SPD input propagates through the panel Cholesky and is
    caught by the caller's factor_ok check."""
    n = F.shape[-1]
    npad = -(-n // panel) * panel
    T = _pad_identity(F, npad)
    if T is F:
        T = F.clone()  # the updates below work in place
    L = F.new_zeros(F.shape[:-2] + (npad, npad))
    for j0, w in _stripes(npad, outer):
        S = T[..., :, :w]                 # the (h, w) stripe, h = npad - j0
        Lst = L[..., j0:, j0:j0 + w]      # its factor block-column
        for c0 in range(0, w, panel):
            c1 = c0 + panel
            Lp, iLp = _chol_block(S[..., c0:c1, c0:c1])
            Z = S[..., c1:, c0:c1] @ iLp.mT
            if c1 < w:
                syrk_update(S[..., c1:, c1:], Z, out=S[..., c1:, c1:])
            Lst[..., c1:, c0:c1] = Z
            Lst[..., c0:c1, c0:c1] = Lp
        if T.shape[-2] > w:
            syrk_update(T[..., w:, w:], Lst[..., w:, :], out=T[..., w:, w:])
            T = T[..., w:, w:]
    return L[..., :n, :n]


def panel_update_shapes(n: int, panel: int = PANEL, outer: int = OUTER):
    """(r, c, k) of every K8 launch of one `panel_chol` of order n, in
    order: per stripe of width w over h rows, one (h - c1, w - c1, panel)
    in-stripe update for each panel that ends at c1 < w, and one
    (h - w, h - w, w) cross-stripe update when rows remain below it."""
    npad = -(-n // panel) * panel
    shapes = []
    for j0, w in _stripes(npad, outer):
        h = npad - j0
        shapes += [(h - c1, w - c1, panel) for c1 in range(panel, w, panel)]
        if h > w:
            shapes.append((h - w, h - w, w))
    return shapes


def panel_inv_lower(L, unit: bool = False, panel: int = PANEL):
    """Explicit inverse of a LARGE (n, n) lower-triangular L (unit or
    not), or of a stack (L, n, n) of them: block forward solve L X = I
    with library triangular-solve panel bases and one masked rank-panel
    GEMM per step."""
    n = L.shape[-1]
    npad = -(-n // panel) * panel
    L = _pad_identity(L, npad)
    rows = torch.arange(npad, device=L.device)
    eye = _eye(panel, L).expand(L.shape[:-2] + (panel, panel))
    zero = _zero(L)
    X = _eye(npad, L).expand(L.shape)
    for j0 in range(0, npad, panel):
        L11 = L[..., j0:j0 + panel, j0:j0 + panel]
        i11 = torch.linalg.solve_triangular(L11, eye, upper=False,
                                            unitriangular=unit)
        Xk = i11 @ X[..., j0:j0 + panel, :]
        colLm = torch.where((rows >= j0 + panel)[:, None],
                            L[..., :, j0:j0 + panel], zero)
        X = X - colLm @ Xk
        X[..., j0:j0 + panel, :] = Xk
    return X[..., :n, :n]


def factor_inv_chol(Ms, lanes: bool = False):
    """Factor an SPD (n, n) matrix (or, with `lanes`, each of a stack
    (L, n, n), as `jax.vmap` of the JAX function does) and invert the
    CHOLESKY FACTOR:
    returns (L_chol, iL) with iL = L_chol^-1, so Ms^-1 r = iL' (iL r) is
    two matvecs.  The full inverse iL'iL is deliberately not formed.  A
    non-SPD input yields NaN or a non-positive value in L_chol's diagonal
    (factor_ok contract).

    Path choice, as in the JAX package: large 2-D inputs of either dtype
    take the two-level panel path; float32 below the panel threshold the
    library Cholesky + triangular solve; float64 the GEMM-rich LDL
    recursion."""
    n = Ms.shape[-1]
    if (Ms.dim() == 2 or lanes) and n >= _PANEL_MIN:
        L = panel_chol(Ms)
        return L, panel_inv_lower(L)
    if Ms.dtype == torch.float32:
        L = _lib_cholesky(Ms)
        eye = _eye(n, Ms).expand(Ms.shape)
        return L, torch.linalg.solve_triangular(L, eye, upper=False)
    Lu, dd = blocked_ldl(Ms)
    sq = torch.sqrt(dd)
    i11 = inv_unit_lower(Lu)
    return Lu * sq[..., None, :], i11 / sq[..., :, None]


def chol_explicit_inverse(Ms, lanes: bool = False):
    """Factor an SPD (n, n) matrix (or each of a stack, with `lanes`) and
    form its explicit inverse: returns (L_chol, Ms_inv).  Prefer
    factor_inv_chol unless the full inverse matrix itself is needed."""
    L, iL = factor_inv_chol(Ms, lanes)
    return L, iL.mT @ iL


def panel_ldl(F, sgn=None, floor: float = 0.0, panel: int = PANEL):
    """Right-looking no-pivot LDL^T for LARGE (n, n) matrices, or a stack
    (L, n, n) of them with signs (L, n): a loop over n/panel column
    panels - the panel factorizes via the blocked base and the trailing
    update is one full-width masked rank-panel GEMM per step (scaled by
    the signed pivots, so not a K8 update)."""
    n = F.shape[-1]
    npad = -(-n // panel) * panel
    dtype, device = F.dtype, F.device
    lead = F.shape[:-2]
    F = _pad_identity(F, npad)
    use_floor = sgn is not None and floor > 0.0
    if use_floor:
        sgn = torch.as_tensor(sgn, dtype=dtype, device=device)
        sgn_arr = torch.cat([sgn, torch.ones(sgn.shape[:-1] + (npad - n,), dtype=dtype,
                                             device=device)], dim=-1)
    rows = torch.arange(npad, device=device)
    eye = _eye(panel, F).expand(lead + (panel, panel))
    zero = _zero(F)
    W = F
    L = torch.zeros(lead + (npad, npad), dtype=dtype, device=device)
    d = torch.ones(lead + (npad,), dtype=dtype, device=device)
    for j0 in range(0, npad, panel):
        D11 = W[..., j0:j0 + panel, j0:j0 + panel]
        L11, d1 = blocked_ldl(
            D11, sgn=sgn_arr[..., j0:j0 + panel] if use_floor else None,
            floor=floor)
        i11 = torch.linalg.solve_triangular(L11, eye, upper=False,
                                            unitriangular=True)
        Z = W[..., :, j0:j0 + panel] @ i11.mT
        Zm = torch.where((rows >= j0 + panel)[:, None], Z, zero)
        L21 = Zm / d1[..., None, :]
        W = W - Zm @ L21.mT
        L[..., :, j0:j0 + panel] = L21
        L[..., j0:j0 + panel, j0:j0 + panel] = L11
        d[..., j0:j0 + panel] = d1
    return L[..., :n, :n], d[..., :n]


def panel_inv_unit_lower(L, panel: int = PANEL):
    """Explicit inverse of a LARGE (n, n) unit lower-triangular L."""
    return panel_inv_lower(L, unit=True, panel=panel)


def ldl_blocks(F, sgn=None, floor: float = 0.0):
    """The card's no-pivot signed LDL^T of (..., n, n) (any leading dims),
    with the optional sign-directed pivot floor: returns (L, d) as
    `blocked_ldl` does.  Order <= LDL_BLOCK (128, K2-batched's largest):
    one K2-batched launch (`ldl_lower_batched`) for the whole stack.
    Above: a right-looking loop over 128-wide block columns, each diagonal
    block one K2-batched launch for the stack, L11^-1 one triangular solve
    against the identity, Z = F21 L11^-T, L21 = Z / d1 and the trailing
    update F22 - Z L21^T batched products.  On a CPU tensor the base is
    K2-batched's plain version, so the CPU tests can hold this route
    against the JAX recursion."""
    lead, n = F.shape[:-2], F.shape[-1]
    A = F.reshape((math.prod(lead), n, n))
    s = None
    if sgn is not None and floor > 0.0:
        s = torch.as_tensor(sgn, dtype=F.dtype, device=F.device).expand(lead + (n,))
        s = s.reshape(A.shape[:-1])
    if n <= LDL_BLOCK:
        L, d = ldl_lower_batched(A, s, floor)
        return L.reshape(F.shape), d.reshape(lead + (n,))
    A = A.clone()   # the trailing updates below work in place
    L = torch.zeros_like(A)
    d = A.new_empty(A.shape[:-1])
    for c0 in range(0, n, LDL_BLOCK):
        c1 = min(c0 + LDL_BLOCK, n)
        L11, d1 = ldl_lower_batched(A[:, c0:c1, c0:c1],
                                    None if s is None else s[:, c0:c1], floor)
        L[:, c0:c1, c0:c1] = L11
        d[:, c0:c1] = d1
        if c1 == n:
            break
        i11 = torch.linalg.solve_triangular(L11, _eye(c1 - c0, A).expand(L11.shape),
                                            upper=False, unitriangular=True)
        Z = A[:, c1:, c0:c1] @ i11.mT
        L21 = Z / d1[:, None, :]
        A[:, c1:, c1:] -= Z @ L21.mT
        L[:, c1:, c0:c1] = L21
    return L.reshape(F.shape), d.reshape(lead + (n,))


def blocked_ldl(F, sgn=None, floor: float = 0.0, blk: int = BLK, lanes: bool = False):
    """Blocked no-pivot LDL^T of (..., w, w): same result as
    unblocked_ldl, but panel solves and trailing updates are GEMMs and
    only blk-column base sweeps stay sequential.  Large 2-D inputs (or a
    stack with `lanes`) dispatch to the right-looking panel_ldl.  A CUDA
    tensor of any order and leading dims takes `ldl_blocks`."""
    w = F.shape[-1]
    if F.device.type == "cuda":
        return ldl_blocks(F, sgn=sgn, floor=floor)
    if (F.dim() == 2 or lanes) and w >= _PANEL_MIN:
        return panel_ldl(F, sgn=sgn, floor=floor)
    if w <= blk:
        return unblocked_ldl(F, sgn=sgn, floor=floor)
    h = blk
    F11 = F[..., :h, :h]
    F21 = F[..., h:, :h]
    F22 = F[..., h:, h:]
    L11, d1 = unblocked_ldl(F11, sgn=None if sgn is None else sgn[..., :h],
                            floor=floor)
    i11 = inv_unit_lower(L11, blk)
    Z = F21 @ i11.transpose(-1, -2)        # Z = F21 L11^{-T}
    L21 = Z / d1[..., None, :]
    S22 = F22 - Z @ L21.transpose(-1, -2)
    L22, d2 = blocked_ldl(S22, sgn=None if sgn is None else sgn[..., h:],
                          floor=floor, blk=blk)
    top = torch.cat([L11, torch.zeros_like(F[..., :h, h:])], dim=-1)
    bot = torch.cat([L21, L22], dim=-1)
    return torch.cat([top, bot], dim=-2), torch.cat([d1, d2], dim=-1)


def blocked_cholesky(F, blk: int = BLK):
    """SPD Cholesky of (..., w, w) via blocked LDL^T: L_chol = L * sqrt(d).
    No pivoting: NaN from a non-SPD input propagates and is caught by
    factor_ok.  Large 2-D inputs take the two-level panel path."""
    if F.dim() == 2 and F.shape[-1] >= _PANEL_MIN:
        return panel_chol(F)
    L, d = blocked_ldl(F, blk=blk)
    return L * torch.sqrt(d)[..., None, :]
