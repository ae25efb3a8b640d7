"""The suite runner end to end on the CPU: tools/run_suite_torch.py against
the reference's benchmarks/run_suite.py.

`run_instance` of both runners (read -> presolve -> Ruiz scaling -> solve
-> unscale -> record) on the structured suite's medium tier (seed 0) and
on the tests/data/real_mm corpus, with the runner's default options.  Same
status, status_detail and objective (1e-8 relative), and equal
iterations, except on the transport family: its balance rows are
linearly dependent (presolve keeps them), so near the optimum the Schur
complement's smallest eigenvalue is at float64 rounding and whether a
Cholesky trial passes differs between LAPACK builds on the same bits
(ROADMAP Queue 3); its iterations are not compared.

The port runs the medium tier with `linear_solver="dense"` and with
`"pallas"` (on the CPU, K1's plain version `cholesky_lower_reference`),
both against the reference's `dense` record: the reference's Pallas path
off the TPU is interpret-mode Pallas, which takes minutes to compile at
these orders on a loaded CPU, and on this tier it iterates as its dense
path but on two instances where it fails (lasso_200_0: error:TypeError,
transport_12x15_0: MAXIMUM_ITERATIONS; see
tests/test_torch_pipeline_pallas.py, which holds the reference's Pallas
path against the port's on the corpus).

Also: the --repeat rule for the endgame fields, the --dir reader (gzip
included), the exclusion presets, the unported backends, and that a
reference QuadraticProblem is accepted at the runner's input
(tests/test_torch_pipeline_batched.py holds --batched).
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.models import suite as JSuite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))
sys.path.insert(0, os.path.join(REPO, "tools"))

import run_suite as R  # noqa: E402  (the reference's runner)
import run_suite_torch as T  # noqa: E402

CORPUS = os.path.join(REPO, "tests", "data", "real_mm")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU solves here are chains of small torch ops (K1's plain
    version steps through 64-column blocks); under the tier-1 command's six
    workers, torch's default of one thread per core in every worker
    oversubscribes the CPU and this file took 15 minutes.  One torch thread
    for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# Families whose iteration counts depend on the LAPACK build (see above).
ITER_UNSTABLE = ("transport_",)


def options(pkg, linear_solver, device=None):
    """The runner's default options (run_suite.py's main) for a package."""
    opts = dict(print_level=40, tol=1e-8, max_iter=300, max_ncorr=3,
                kkt_system="condensed", linear_solver=linear_solver,
                step_rule=pkg.AdaptiveStep(0.995),
                regularization=pkg.FixedRegularization(1e-8, -1e-8),
                backend="device", pad_mode="bucket")
    if device is not None:
        opts["device"] = device
    return opts


def assert_same_record(got, want):
    assert got["name"] == want["name"]
    for key in ("nvar", "ncon", "nnzj", "nnzh", "status", "status_detail"):
        assert got.get(key) == want.get(key), (got["name"], key, got.get(key), want.get(key))
    assert got["objective"] == pytest.approx(want["objective"], rel=1e-8, abs=1e-12), got["name"]
    if not got["name"].startswith(ITER_UNSTABLE):
        assert got["iter"] == want["iter"], (got["name"], got["iter"], want["iter"])
    assert set(got) == set(want), (got["name"], set(got) ^ set(want))


MEDIUM = [nm for nm, _ in JSuite.structured_suite("medium", seeds=(0,))]


@functools.lru_cache(maxsize=None)
def medium_problems():
    return (dict(JSuite.structured_suite("medium", seeds=(0,))),
            dict(mt.structured_suite("medium", seeds=(0,))))


@functools.lru_cache(maxsize=None)
def medium_reference(name):
    """The reference runner's dense record of a medium-tier instance."""
    return R.run_instance(name, medium_problems()[0][name], options(mq, "dense"))


@pytest.mark.parametrize("name", MEDIUM)
def test_medium_tier_dense_matches_reference(name):
    got = T.run_instance(name, medium_problems()[1][name], options(mt, "dense", "cpu"))
    assert_same_record(got, medium_reference(name))
    assert got["status"] == 1


@pytest.mark.parametrize("name", MEDIUM)
def test_medium_tier_pallas_matches_reference(name):
    got = T.run_instance(name, medium_problems()[1][name], options(mt, "pallas", "cpu"))
    assert_same_record(got, medium_reference(name))
    assert got["status"] == 1


def corpus_pairs():
    """(name, reference problem, port problem) of every corpus file, as the
    port's --dir reads them (HS35_gz.qps.gz included)."""
    port = T.read_dir(CORPUS)
    ref = {nm: mq.read_mps(os.path.join(CORPUS, f)) for f in sorted(os.listdir(CORPUS))
           for nm in [f.split(".")[0]]}
    return [(nm, ref[nm], qp) for nm, qp in port]


def test_dir_reads_every_corpus_file():
    names = [nm for nm, _ in T.read_dir(CORPUS)]
    assert names == ["HS118", "HS21", "HS35", "HS35_gz", "HS51", "HS52", "HS53", "HS76"]
    assert T.read_dir(CORPUS, excluded={"HS21"})[1][0] == "HS35"


@pytest.mark.parametrize("name,jqp,tqp", corpus_pairs(), ids=lambda v: v if isinstance(v, str) else "")
def test_corpus_dense_matches_reference(name, jqp, tqp):
    want = R.run_instance(name, jqp, options(mq, "dense"))
    got = T.run_instance(name, tqp, options(mt, "dense", "cpu"))
    assert_same_record(got, want)


def test_reference_problem_accepted_at_the_runner():
    """A reference QuadraticProblem and the port's built from the same
    arrays give the port's runner the same record."""
    jqp = dict(JSuite.structured_suite("small", seeds=(0,), families=("ranges",)))["ranges_30_0"]
    tqp = mt.QuadraticProblem(**{f.name: getattr(jqp, f.name)
                                 for f in dataclasses.fields(mq.QuadraticProblem)})
    a = T.run_instance("ranges", jqp, options(mt, "dense", "cpu"))
    b = T.run_instance("ranges", tqp, options(mt, "dense", "cpu"))
    for rec in (a, b):
        rec.pop("total_time"), rec.pop("load_1min")
    assert a == b and a["status"] == 1


def test_stage_seconds_leave_the_record_as_the_reference_writes_it():
    """read_dir's parse_s and run_instance's stages get every stage that
    ran; the record keeps the reference's keys."""
    parse_s, stages = {}, {}
    (name, qp), = [p for p in T.read_dir(CORPUS, parse_s=parse_s) if p[0] == "HS21"]
    rec = T.run_instance(name, qp, options(mt, "dense", "cpu"), stages=stages)
    want = R.run_instance(name, mq.read_mps(os.path.join(CORPUS, "HS21.qps")),
                          options(mq, "dense"))
    assert_same_record(rec, want)
    assert sorted(parse_s) == [nm for nm, _ in T.read_dir(CORPUS)]
    assert sorted(stages) == ["presolve_s", "scale_s", "solve_s", "unscale_s"]
    assert stages["solve_s"] == rec["total_time"]
    assert all(v >= 0.0 for v in (*parse_s.values(), *stages.values()))


def _fake_dispatch(endgames):
    """A stand-in for the runner's solve call whose k-th call reports the
    k-th (endgame_time, backend)."""
    calls = iter(endgames)

    def dispatch(qp_s, solve_opts, backend):
        eg_t, eg_b = next(calls)
        n, m = qp_s.nvar, qp_s.ncon
        return mt.ExecutionStats(
            status=mt.Status.SOLVE_SUCCEEDED, objective=1.0, solution=np.zeros(n),
            constraints=np.zeros(m), multipliers=np.zeros(m),
            multipliers_L=np.zeros(n), multipliers_U=np.zeros(n), iter=4,
            counters=mt.Counters(endgame_time=eg_t, endgame_backend=eg_b))
    return dispatch


@pytest.mark.parametrize("endgames,want", [
    # the best warm solve ran no endgame: the cold run's fields are dropped
    ([(0.5, "f64"), (0.0, ""), (0.0, "")], {}),
    # the best warm solve ran one: its fields, not the cold run's
    ([(0.5, "f64"), (0.25, "krylov")], {"endgame_time": 0.25, "endgame_backend": "krylov"}),
    # no warm solve: the cold run's fields stay
    ([(0.5, "f64")], {"endgame_time": 0.5, "endgame_backend": "f64"}),
])
def test_repeat_takes_endgame_fields_from_the_best_warm_solve(monkeypatch, endgames, want):
    monkeypatch.setattr(T, "_dispatch", _fake_dispatch(endgames))
    rec = T.run_instance("simple", mt.dense_dummy_qp(6, 3, seed=1), options(mt, "dense", "cpu"),
                         repeat=len(endgames))
    assert {k: rec[k] for k in ("endgame_time", "endgame_backend") if k in rec} == want
    assert ("warm_time" in rec) == (len(endgames) > 1)


@pytest.mark.parametrize("backend,item", [("host", "item 12"), ("sparse-device", "item 13")])
def test_unported_backends_raise(backend, item):
    rec = T.run_instance("x", mt.dense_dummy_qp(6, 3, seed=1),
                         dict(options(mt, "dense", "cpu"), backend=backend))
    assert rec["status"] == "error:NotImplementedError"
    with pytest.raises(NotImplementedError, match=item):
        T.main(["--suite", "random_qp", "--sizes", "10", "--backend", backend, "--device", "cpu"])


def test_exclusion_presets_match_the_reference_lists():
    import fetch_suites

    assert T.EXCLUSIONS == fetch_suites.EXCLUSIONS


def test_main_writes_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "res.json")
    args = ["--suite", "structured:small", "--families", "ranges,svm", "--device", "cpu",
            "--out", out, "--exclude", "svm_30x8_1"]
    first = T.main(args)
    assert [r["name"] for r in first] == ["svm_30x8_0", "ranges_30_0", "ranges_30_1"]
    assert all(r["status"] == 1 for r in first)
    again = T.main(args + ["--resume"])
    assert [r["name"] for r in again] == [r["name"] for r in first]
    assert "resume: 3 done, 0 remaining" in capsys.readouterr().err
