"""The structured suite and the six large sparse generators: the port
against the JAX package.

Every family of `structured_suite` at the small and medium tiers, seeds 0
and 1, and at the large tier, seed 0, is generated by both packages and
must be bit-equal (every field of the QuadraticProblem).  The xlarge tier
is constructed for the families tests/test_suite.py checks there
(Netlib/MM-scale dimensions, a non-diagonal Hessian at n = 20000).  The
generators the suite does not call are compared at small sizes.
`write_suite` of both packages writes the same bytes, which read back to
the same problems.  The small tier's solves of tests/test_suite.py run
through both packages too.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.models import suite as JSuite
from madqp_tpu_torch.models import suite as TSuite
from test_torch_mps import assert_same_qp
from test_torch_pipeline import one_torch_thread  # noqa: F401  (an autouse fixture)

TIERS = [("small", 0), ("small", 1), ("medium", 0), ("medium", 1), ("large", 0)]


def test_same_families_and_dims():
    assert list(TSuite._MAKERS) == list(JSuite._MAKERS)
    assert TSuite._DIMS == JSuite._DIMS


@pytest.mark.parametrize("family", list(JSuite._MAKERS))
@pytest.mark.parametrize("tier,seed", TIERS, ids=[f"{t}{s}" for t, s in TIERS])
def test_family_matches_reference(tier, seed, family):
    (jname, jqp), = JSuite.structured_suite(tier, seeds=(seed,), families=(family,))
    (tname, tqp), = mt.structured_suite(tier, seeds=(seed,), families=(family,))
    assert tname == jname
    assert_same_qp(tqp, jqp)


XLARGE = ("chainqp", "lasso", "bandedlp", "cvxqp", "gridlp", "staircase")


def test_xlarge_tier_reaches_netlib_mm_scale():
    """tests/test_suite.py's xlarge check on the port's suite: n up to 5e4,
    a sparse non-diagonal Hessian at n = 20000; the same problems as the
    reference's."""
    dims = {}
    for kind in XLARGE:
        tqp = TSuite._MAKERS[kind](*TSuite._XLARGE[kind], seed=0)
        assert_same_qp(tqp, JSuite._MAKERS[kind](*JSuite._XLARGE[kind], seed=0))
        dims[kind] = tqp.nvar
    assert dims["chainqp"] == 50000 and dims["lasso"] == 50000
    assert max(dims.values()) >= 50000
    Hc = sp.coo_matrix(TSuite._MAKERS["cvxqp"](*TSuite._XLARGE["cvxqp"], seed=0).H)
    assert Hc.shape == (20000, 20000) and (Hc.row != Hc.col).any()


GENERATORS = {
    "banded_sparse_lp": dict(n=300, m=120, band=5, seed=3),
    "separable_qp": dict(n=300, m=120, band=4, seed=2),
    "ineq_qp": dict(n=200, m_factor=2, band=4, seed=1),
    "ineq_qp_pattern": dict(n=200, m_factor=2, band=4, seed=1, pattern_seed=9),
    "grid_lp": dict(g=9, seed=4),
    "grid3d_lp": dict(g=5, seed=2),
    "netflow_grid_lp": dict(g=7, seed=5),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_reference(name):
    fn = name.replace("_pattern", "")
    kw = GENERATORS[name]
    assert_same_qp(getattr(mt, fn)(**kw), getattr(mq, fn)(**kw))


def test_write_suite_round_trip(tmp_path):
    """The small tier, seed 0, as files: the same bytes from both packages,
    read back to the same problems, and to the generated ones within the
    writer's decimal rounding (1e-14 relative)."""
    jpaths = JSuite.write_suite(str(tmp_path / "ref"), size="small", seeds=(0,))
    tpaths = mt.write_suite(str(tmp_path / "port"), size="small", seeds=(0,))
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    generated = dict(mt.structured_suite("small", seeds=(0,)))
    assert len(tpaths) == len(generated) == 19
    for jp, tp in zip(jpaths, tpaths):
        with open(jp, "rb") as a, open(tp, "rb") as b:
            assert a.read() == b.read(), tp
        back = mt.read_mps(tp)
        assert_same_qp(back, mq.read_mps(jp))
        qp = generated[back.name]
        assert (back.nvar, back.ncon, back.minimize) == (qp.nvar, qp.ncon, qp.minimize)
        close = dict(rtol=1e-14, atol=0)
        for f in ("c", "lcon", "ucon", "lvar", "uvar"):
            np.testing.assert_allclose(getattr(back, f), getattr(qp, f), err_msg=f, **close)
        np.testing.assert_allclose(back.A.toarray(), qp.A.toarray(), **close)
        if qp.H is not None:
            np.testing.assert_allclose(back.H.toarray(), qp.H.toarray(), **close)


SMALL = list(JSuite.structured_suite("small", seeds=(0,)))


@pytest.mark.parametrize("name", [nm for nm, _ in SMALL])
def test_small_tier_k2_solve_matches_reference(name):
    """tests/test_suite.py::test_suite_instance_solves through both
    packages: presolve, then the K2 system with dual regularization.  Same
    status and objective (1e-8 relative); iterations equal except on the
    transport family (tests/test_torch_pipeline.py says why).  The
    illscaled family is solved unscaled here, where its 1e-8 stopping
    point depends on reduction order (its objective moves by ~1e-3):
    status only, as tests/test_suite.py asserts."""
    jqp = dict(SMALL)[name]
    tqp = dict(mt.structured_suite("small", seeds=(0,)))[name]
    kw = dict(kkt_system="k2", tol=1e-8, print_level=40, max_ncorr=2)
    jp, _, jok = mq.presolve_qp(jqp)
    tp, _, tok = mt.presolve_qp(tqp)
    assert jok and tok
    want = mq.solve(jp, regularization=mq.FixedRegularization(1e-8, -1e-8), **kw)
    got = mt.solve(tp, device="cpu", regularization=mt.FixedRegularization(1e-8, -1e-8), **kw)
    assert got.status.name == want.status.name == "SOLVE_SUCCEEDED"
    if name.startswith("illscaled_"):
        return
    assert got.objective == pytest.approx(want.objective, rel=1e-8, abs=1e-12)
    if not name.startswith("transport_"):
        assert got.iter == want.iter


def test_illscaled_needs_equilibration_like_reference():
    """tests/test_suite.py::test_illscaled_needs_equilibration on both."""
    out = []
    for pkg, suite, kw in ((mq, JSuite, {}), (mt, TSuite, dict(device="cpu"))):
        qp_s, scaling = pkg.scale_qp(suite.illscaled_lp(60, seed=1))
        st = pkg.solve(qp_s, tol=1e-8, print_level=40,
                       regularization=pkg.FixedRegularization(1e-8, -1e-8), **kw)
        out.append(pkg.unscale_stats(scaling, st))
    want, got = out
    assert got.status.name == want.status.name == "SOLVE_SUCCEEDED"
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-8)
    np.testing.assert_allclose(got.solution, want.solution, atol=1e-6)
