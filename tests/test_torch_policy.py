"""The driver layer's solve policies (`madqp_tpu_torch/solver/policy.py`)
against the forms they replaced, on the CPU.

* The precision phases: `sparse_phases` (the predicate, `two_phase_opts`
  and the augmented system's krylov fallback) and `dense_phases` (the
  mixed-precision rescue), each at every combination its callers use,
  against the inline form each entry point wrote (equal options) and
  against the JAX package's `two_phase_opts` and dense rescue (equal
  phase fields).
* `make_sparse_kkt`, through every entry point that builds a sparse KKT:
  each KKT in the pattern caches equals, in class, factorization dtype,
  backsolve mode, krylov fields and supernodal schedule, the KKT that the
  entry point's own constructor call built from the same options, the two
  kept departures included (`MPCSolver` and `solve_sparse_batched` build
  the greedy schedule whatever `sparse_schedule` says, and
  `solve_sparse_batched` builds no CG: ROADMAP.md Queue 3, item 31).
"""

import collections
import dataclasses

import pytest
import torch

import madqp_tpu_torch as mt
from madqp_tpu.solver import sparse_common as JC
from madqp_tpu.utils.options import IPMOptions as JOpts
from madqp_tpu_torch.models.qp import build_standard_form_sparse
from madqp_tpu_torch.parallel import sparse_batched as TB
from madqp_tpu_torch.solver import policy as P
from madqp_tpu_torch.solver import sparse_common as TC
from madqp_tpu_torch.solver.sparse_condensed import DeviceSparseCondensedKKT, relax_equalities
from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT
from madqp_tpu_torch.solver.sparse_qp import DeviceSparseAugmentedKKT
from madqp_tpu_torch.utils.options import IPMOptions as TOpts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per module: six workers with a thread per core
    each oversubscribe the machine (tests/test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PHASE_FIELDS = ("tol", "stall_exit", "max_iter", "dtype", "factorization_dtype",
                "phase1_tol", "krylov_solve", "endgame", "precision_scheme")

# the option sets of tests/test_torch_sparse_lp.py::test_two_phase_opts_match_reference,
# and the sets where one phase runs
OPTION_SETS = {
    "default": {},
    "f32": dict(factorization_dtype="float32", max_iter=300),
    "f32-f64": dict(factorization_dtype="float32", max_iter=40, endgame="f64"),
    "f32-krylov": dict(factorization_dtype="float32", endgame="krylov", stall_exit=3),
    "f32-simple": dict(factorization_dtype="float32", precision_scheme="simple"),
    "f32-loose-tol": dict(factorization_dtype="float32", tol=1e-2),
    "f64-factor": dict(factorization_dtype="float64"),
    "f32-phase1-cap": dict(factorization_dtype="float32", phase1_max_iter=7, tol=1e-9),
}


def _sparse_inline(o, typed, cg, two_phase_opts):
    """The sparse drivers' inline form (and the JAX package's): the
    predicate, the split, and on the augmented system (no SPD reduction)
    the krylov endgame turned into a float64 refactorization."""
    two_phase = (o.factorization_dtype == "float32"
                 and o.precision_scheme == "two-phase"
                 and o.tol < o.phase1_tol)
    if not two_phase:
        return o, None
    o1, o2 = two_phase_opts(o, typed_phase1=typed)
    if not cg and o2.krylov_solve:
        o2 = dataclasses.replace(o2, krylov_solve=False, factorization_dtype="")
    return o1, o2


def _dense_inline(o):
    """The dense rescue as `MPCSolver` and `BatchedMPCSolver` (and the JAX
    package's driver and batched solver) wrote it."""
    rescue = (o.factorization_dtype
              and o.factorization_dtype != o.dtype
              and o.precision_scheme == "two-phase")
    if not rescue:
        return o, None
    return (dataclasses.replace(o, stall_exit=o.stall_exit if o.stall_exit > 0 else 5,
                                max_iter=min(o.max_iter, o.phase1_max_iter)),
            dataclasses.replace(o, factorization_dtype=""))


def _fields(o):
    return None if o is None else {f: getattr(o, f) for f in PHASE_FIELDS}


# (typed_phase1, cg) of each sparse caller: MPCSolver sparse-normal /
# solve_sparse_condensed / solve_sparse_batched, solve_sparse_lp,
# MPCSolver sparse-augmented, solve_sparse_qp
SPARSE_CALLERS = {"untyped": (False, True), "typed": (True, True),
                  "untyped-no-cg": (False, False), "typed-no-cg": (True, False)}


@pytest.mark.parametrize("opt_set", list(OPTION_SETS))
@pytest.mark.parametrize("scheme", [*SPARSE_CALLERS, "dense"])
def test_phases_match_inline_forms_and_reference(scheme, opt_set):
    kw = OPTION_SETS[opt_set]
    if scheme == "dense":
        got = P.dense_phases(TOpts(**kw))
        inline = _dense_inline(TOpts(**kw))
        want = _dense_inline(JOpts(**kw))
    else:
        typed, cg = SPARSE_CALLERS[scheme]
        got = P.sparse_phases(TOpts(**kw), typed_phase1=typed, cg=cg)
        inline = _sparse_inline(TOpts(**kw), typed, cg, P.two_phase_opts)
        want = _sparse_inline(JOpts(**kw), typed, cg, JC.two_phase_opts)
    assert got == inline
    assert [_fields(o) for o in got] == [_fields(o) for o in want]


# --- make_sparse_kkt through the entry points -------------------------------------------


def _inverse(o):
    return o.solve_mode == "inverse"


def _n0(std):
    """The structural variables of a standard form that slacks every row."""
    return std.A.shape[1] - std.A.shape[0]


def _krylov(o):
    return dict(krylov=o.krylov_solve, krylov_tol=o.krylov_tol, krylov_maxit=o.krylov_maxit)


# Each entry point's own constructor call before `make_sparse_kkt`, from
# the standard form and the options the pattern cache holds the KKT under.
OLD_CALLS = {
    # MPCSolver: phase 1 (and a single phase), the float64 phase 2, and the
    # krylov endgame's phase 2 on the normal equations; the greedy schedule
    "mpc-normal": lambda std, o: DeviceSparseNormalKKT(
        std.A, fact_dtype=o.factorization_dtype or None, inverse=_inverse(o),
        **(dict(krylov=True, krylov_tol=o.krylov_tol, krylov_maxit=o.krylov_maxit)
           if o.krylov_solve else {})),
    "mpc-augmented": lambda std, o: DeviceSparseAugmentedKKT(
        std.H, std.A, fact_dtype=o.factorization_dtype or None, inverse=_inverse(o)),
    "lp": lambda std, o: DeviceSparseNormalKKT(
        std.A, order="auto", mode="batched", fact_dtype=o.factorization_dtype or None,
        inverse=_inverse(o), **_krylov(o), schedule_mode=o.sparse_schedule),
    "qp": lambda std, o: DeviceSparseAugmentedKKT(
        std.H, std.A, order="auto", fact_dtype=o.factorization_dtype or None,
        inverse=_inverse(o), schedule_mode=o.sparse_schedule),
    "condensed": lambda std, o: DeviceSparseCondensedKKT(
        None if std.H is None else std.H[:_n0(std), :_n0(std)].tocsc(),
        std.A[:, :_n0(std)].tocsc(), order="auto", fact_dtype=o.factorization_dtype or None,
        inverse=_inverse(o), **_krylov(o), schedule_mode=o.sparse_schedule),
    # solve_sparse_batched: no schedule_mode and no krylov arguments
    "batched-normal": lambda std, o: DeviceSparseNormalKKT(
        std.A, order="auto", fact_dtype=o.factorization_dtype or None, inverse=_inverse(o)),
    "batched-augmented": lambda std, o: DeviceSparseAugmentedKKT(
        std.H, std.A, order="auto", fact_dtype=o.factorization_dtype or None,
        inverse=_inverse(o)),
}

# the kept departures: these build the greedy schedule under "level"
GREEDY_ALWAYS = {"mpc-normal", "mpc-augmented", "batched-normal", "batched-augmented"}

KKT_OPTIONS = {
    "level": dict(sparse_schedule="level"),
    "f32-krylov-inverse": dict(factorization_dtype="float32", endgame="krylov",
                               solve_mode="inverse"),
    "f32-f64": dict(factorization_dtype="float32", endgame="f64"),
}


def _summary(kkt):
    symb = getattr(kkt, "symb", None) or getattr(kkt, "bs", None)
    return (type(kkt).__name__, kkt.fact_dtype, kkt.inverse, getattr(kkt, "mode", None),
            getattr(kkt, "krylov", None), getattr(kkt, "krylov_tol", None),
            getattr(kkt, "krylov_maxit", None),
            tuple((type(it).__name__, it.w_pad, it.u_pad, it.count) for it in symb.schedule))


def _built(site, qp, kw):
    """[(options, KKT)] that the entry point of `site` put in its pattern
    cache for `qp` under the options `kw` (one short solve each)."""
    run = dict(device="cpu", print_level=40, max_iter=1, **kw)
    if site.startswith("mpc-"):
        mt.MPCSolver(qp, kkt_system="sparse-" + site[4:], **run)
    elif site.startswith("batched-"):
        mt.solve_sparse_batched([qp, qp], kkt_system=site[8:], **run)
        return [(key[1], kkt) for key, kkt in TB._BATCHED_CACHE.items() if key[-1] == "kkt"]
    elif site == "lp":
        mt.solve_sparse_lp(qp, mode="batched", **run)
    elif site == "qp":
        mt.solve_sparse_qp(qp, kkt_system="augmented", **run)
    else:
        mt.solve_sparse_condensed(qp, **run)
    return [(key[2], kkt) for key, (kkt, _kernel) in TC._KERNEL_CACHE.items()]


@pytest.mark.parametrize("opt_set", list(KKT_OPTIONS))
@pytest.mark.parametrize("site", list(OLD_CALLS))
def test_make_sparse_kkt_matches_old_call_sites(site, opt_set, monkeypatch):
    monkeypatch.setattr(TC, "_KERNEL_CACHE", collections.OrderedDict())
    monkeypatch.setattr(TB, "_BATCHED_CACHE", collections.OrderedDict())
    qp = mt.grid_lp(5)   # n = 50: the greedy and level schedules differ
    kw = KKT_OPTIONS[opt_set]
    std = build_standard_form_sparse(
        relax_equalities(qp, TOpts().tol) if site == "condensed" else qp)[0]
    built = _built(site, qp, kw)
    assert len(built) == (1 if opt_set == "level" else 2)   # both phases' KKTs
    for o, kkt in built:
        assert _summary(kkt) == _summary(OLD_CALLS[site](std, o))
    if opt_set == "level" and site != "condensed":
        system = "normal" if site in ("lp", "mpc-normal", "batched-normal") else "augmented"
        level, greedy = (_summary(P.make_sparse_kkt(system, std, TOpts(sparse_schedule=s)))[-1]
                         for s in ("level", "greedy"))
        assert level != greedy
        assert _summary(built[0][1])[-1] == (greedy if site in GREEDY_ALWAYS else level)
