"""Typed option system and policy objects.

Carried over from `madqp_tpu/utils/options.py` with the same fields,
defaults, aliases and validation, so one options cascade serves both
packages: a frozen dataclass of solver options with policy objects (step
rule, regularization, barrier update) passed as *values*.

Some options select paths this package has not ported yet (see
`ROADMAP.md`, Queue 1).  They are still accepted and validated here; the
KKT factory and the driver raise `NotImplementedError` naming the roadmap
item when such a path is requested.  `loop_mode`, which exists only for
the reference package's compile plumbing, is accepted and has no effect:
this package always steps the MPC loop on the host.  `sparse_schedule`
("greedy" or "level") picks the supernodal schedule of the sparse LP's
"batched" mode, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# Problem classes (reference: src/utils.jl:1-4)
# ---------------------------------------------------------------------------


class ProblemClass:
    LINEAR = "lp"
    QUADRATIC = "qp"


# ---------------------------------------------------------------------------
# Barrier update policies (reference: src/utils.jl:10-11)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mehrotra:
    """Mehrotra adaptive centering: sigma = clamp((mu_aff/mu)^3, 1e-6, 10).

    For pure LPs without inequalities the reference forces sigma = 1
    (src/kernels.jl:226-236).
    """

    sigma_min: float = 1e-6
    sigma_max: float = 10.0


# ---------------------------------------------------------------------------
# Step rules (reference: src/utils.jl:17-29, impls src/kernels.jl:307-374)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConservativeStep:
    """Fixed fraction-to-boundary factor tau."""

    tau: float = 0.995


@dataclasses.dataclass(frozen=True)
class AdaptiveStep:
    """tau = max(1 - mu, tau_min)."""

    tau_min: float = 0.99


@dataclasses.dataclass(frozen=True)
class MehrotraAdaptiveStep:
    """Mehrotra's GTSF procedure (per-blocking-index rescue of alpha)."""

    gamma_f: float = 0.99


StepRule = ConservativeStep | AdaptiveStep | MehrotraAdaptiveStep


# ---------------------------------------------------------------------------
# Regularization policies (reference: src/utils.jl:35-48, src/kernels.jl:380-417)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NoRegularization:
    """del_w = 1 at init (for the starting-point KKT), 0 in the loop."""


@dataclasses.dataclass(frozen=True)
class FixedRegularization:
    """Constant primal delta_p >= 0 and dual delta_d <= 0 regularization."""

    delta_p: float = 1e-8
    delta_d: float = 0.0


@dataclasses.dataclass(frozen=True)
class AdaptiveRegularization:
    """Divide both deltas by 10 each iteration, floored at delta_min."""

    delta_p: float = 1e-8
    delta_d: float = -1e-9
    delta_min: float = 1e-9


Regularization = NoRegularization | FixedRegularization | AdaptiveRegularization


# ---------------------------------------------------------------------------
# KKT formulation / linear solver selection
# ---------------------------------------------------------------------------


class KKTSystem:
    """Names of the KKT formulations."""

    K2 = "k2"                  # augmented symmetric-indefinite system
    K2_5 = "k2.5"              # diagonally scaled augmented system
    CONDENSED = "condensed"    # eliminate bound duals + primal block (SPD Schur)
    NORMAL = "normal"          # normal equations A Sigma^-1 A^T (LP only)


class LinearSolverBackend:
    DENSE = "dense"            # library dense Cholesky (torch.linalg)
    PALLAS = "pallas"          # the hand-written blocked Cholesky kernel (K1)
    BLOCKED = "blocked"        # blocked LDL + explicit triangular inverse
    SPARSE = "sparse"          # host symbolic + on-device numeric (block sparse)


# ---------------------------------------------------------------------------
# Main options (reference: IPMOptions, src/utils.jl:69-117)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    # Convergence
    tol: float = 1e-8
    max_iter: int = 3000
    max_wall_time: float = 1e6   # seconds; enforced host-side between iterations
    measure_linear_solver: bool = False  # per-iterate factorize/backsolve timing
    kappa_d: float = 1e-5
    # KKT / linear solver
    kkt_system: str = KKTSystem.CONDENSED
    linear_solver: str = LinearSolverBackend.DENSE
    tol_linear_solve: float = 1e-8
    check_residual: bool = False
    max_refine_steps: int = 0   # iterative-refinement rounds per backsolve
    # 'chol' = triangular backsolves; 'inverse' = explicit inverses of the
    # scaled SPD blocks (dense path).
    solve_mode: str = "chol"
    # Mixed precision: with factorization_dtype != dtype, 'two-phase' runs
    # the low-precision kernel first and chains a warm-started
    # full-precision phase when it exits unconverged (the dense rescue);
    # 'simple' = single-phase low precision + iterative refinement.
    precision_scheme: str = "two-phase"
    phase1_tol: float = 1e-3
    # Endgame of the sparse two-phase scheme: "f64" a float64 phase of the
    # device path, "host" the host C++ LDL solver warm-started from the
    # float32 iterate, "krylov" float64 CG preconditioned by the float32
    # factor (ops/krylov.py::pcg); "auto" is "host" when the native library
    # builds, else "f64".  The batched solver's "auto" and "host" re-solve
    # the lanes its float32 phase failed on the host path.
    endgame: str = "auto"
    krylov_tol: float = 1e-12   # PCG relative-residual target
    krylov_maxit: int = 64
    # Supernodal schedule of the sparse paths ("greedy" or "level").
    sparse_schedule: str = "greedy"
    # Internal: phase-2 marker of the sparse krylov endgame.
    krylov_solve: bool = False
    # Exit the loop with Status.SOLVED_TO_ACCEPTABLE_LEVEL after this many
    # consecutive iterations without a 10% improvement of the best
    # max-infeasibility (0 = disabled).  The dense rescue enables it (5)
    # for the low-precision phase.
    stall_exit: int = 0
    # Iteration cap for the low-precision phase whenever a full-precision
    # rescue phase exists.  Must be >= 1 (validated in load_options).
    phase1_max_iter: int = 80
    # Output — Python-logging-style thresholds (HIGHER = quieter):
    # 5=TRACE 10=DEBUG 20=INFO 25=NOTICE 30=WARN 40=ERROR.  0 is NOTSET and
    # means "logging disabled" (silent); it is normalized to 100 in
    # load_options.  print_level <= 20 prints the per-iteration table.
    print_level: int = 20       # logging.INFO
    file_print_level: int = 20
    output_file: str = ""
    rethrow_error: bool = False
    # Initialization
    scaling: bool = True
    max_gradient: float = 100.0
    bound_push: float = 1e-2
    bound_fac: float = 1e-2
    bound_relax_factor: float = 1e-8
    # Fixed-variable treatment (reference src/utils.jl:81-82):
    # "make_parameter" eliminates lvar==uvar columns by substitution;
    # "relax_bound" keeps them, widening the bound pair by
    # bound_relax_factor * max(1, |value|) on each side.
    fixed_variable_treatment: str = "make_parameter"
    # Policies
    regularization: Regularization = FixedRegularization(1e-8, 0.0)
    step_rule: StepRule = AdaptiveStep(0.99)
    barrier_update: Mehrotra = Mehrotra()
    # Gate for the Mehrotra sigma-vs-1 branch: "any-bound" (default)
    # applies the cube rule whenever any finite bound exists; "one-sided"
    # reproduces the reference's gate (src/kernels.jl:227-233).
    barrier_gate: str = "any-bound"
    max_ncorr: int = 0          # Gondzio multi-corrections
    s_max: float = 100.0
    mu_init: float = 1e-1
    mu_min: float = 1e-11
    mu_superlinear_decrease_power: float = 1.5
    tau_min: float = 0.99
    # Infeasibility detection: declare infeasibility when one side of the
    # KKT conditions has converged, the other is stuck, and the
    # corresponding iterates have diverged past this magnitude.
    diverge_tol: float = 1e8
    # Sparse normal equations (solve_sparse_lp mode="auto"): m <= this is
    # assembled and factored as one dense matrix; above it the supernodal
    # factorization (ops/sparse_chol.py).  The JAX package's value, tuned on a
    # TPU and not re-measured on the card.
    dense_normal_limit: int = 12288
    # Numerics: dtype of the solver state, and an optionally lower dtype
    # for the KKT factorization (float32 factorization + float64 iterative
    # refinement with max_refine_steps >= 1).
    dtype: str = "float64"
    factorization_dtype: str = ""  # "" = same as dtype
    # Dtype of the whole phase-1 state on the sparse two-phase drivers.
    phase1_dtype: str = "float32"
    # "jit", "python" or "auto"; validated only: this package always steps
    # the MPC loop on the host.
    loop_mode: str = "auto"
    # "bucket" pads the dense path to power-of-two shapes.
    pad_mode: str = ""
    # Warm starting is driver-level state, not an option: use
    # MPCSolver.set_initial_point() / clear_initial_point().

    def replace(self, **kwargs) -> "IPMOptions":
        return dataclasses.replace(self, **kwargs)


def load_options(**kwargs) -> Tuple[IPMOptions, dict]:
    """Build IPMOptions from kwargs; return (options, ignored_kwargs).

    Mirrors the reference's cascade (src/utils.jl:119-146): recognized keys
    set IPMOptions fields, leftovers are returned for the caller to log as
    ignored.
    """
    fields = {f.name for f in dataclasses.fields(IPMOptions)}
    known = {k: v for k, v in kwargs.items() if k in fields}
    ignored = {k: v for k, v in kwargs.items() if k not in fields}
    # Accept the sparse-path spellings on the dense path too, so one
    # kkt_system vocabulary works everywhere ("augmented" == K2,
    # "scaled" == K2.5).
    aliases = {"augmented": KKTSystem.K2, "scaled": KKTSystem.K2_5}
    if known.get("kkt_system") in aliases:
        known["kkt_system"] = aliases[known["kkt_system"]]
    # print_level=0 is NOTSET = "logging disabled", not "print everything"
    # (thresholds are higher-is-quieter; see the field comment).
    for key in ("print_level", "file_print_level"):
        if known.get(key) == 0:
            known[key] = 100
    if known.get("sparse_schedule", "greedy") not in ("greedy", "level"):
        raise ValueError(
            f"sparse_schedule={known['sparse_schedule']!r} is not "
            "supported; choose one of 'greedy', 'level'."
        )
    if known.get("endgame", "auto") not in ("auto", "f64", "krylov",
                                            "host"):
        raise ValueError(
            f"endgame={known['endgame']!r} is not supported; "
            "valid values: 'f64', 'krylov', 'host'")
    if known.get("loop_mode", "auto") not in ("auto", "jit", "python"):
        raise ValueError(
            f"loop_mode={known['loop_mode']!r} is not supported; "
            "valid values: 'auto', 'jit', 'python'")
    if known.get("phase1_max_iter", 80) < 1:
        raise ValueError(
            f"phase1_max_iter={known['phase1_max_iter']} must be >= 1 "
            "(a zero-iteration low-precision phase would push all work "
            "to the full-precision rescue)")
    return IPMOptions(**known), ignored
