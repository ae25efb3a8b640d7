"""The generator and the plain reference: the published optima and the
stated sizes."""

import pytest

from qpbench import harness
from qpbench.generators import cvxqp
from qpbench.reference import mm_cvxqp_m


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_cvxqp_s_published_optimum(variant):
    optimum = harness.load_json("configs", "mm_cvxqp_m.json")["published_optima"][f"CVXQP{variant}_S"]
    p = cvxqp.cvxqp(100, variant)
    r = mm_cvxqp_m.solve([p])
    assert r.converged.all()
    assert abs(p.objective(r.x[0]) - optimum) <= 1e-8 * abs(optimum)


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_cvxqp_m_published_optimum(variant):
    config = harness.load_json("configs", "mm_cvxqp_m.json")
    optimum = config["published_optima"][f"CVXQP{variant}_M"]
    p = cvxqp.cvxqp(config["n"], variant)
    r = mm_cvxqp_m.solve([p])
    assert r.converged.all()
    assert abs(p.objective(r.x[0]) - optimum) <= 1e-8 * abs(optimum)


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_cvxqp_m_sizes(variant):
    config = harness.load_json("configs", "mm_cvxqp_m.json")
    p = cvxqp.cvxqp(config["n"], variant)
    assert (p.n, p.m) == (1000, config["rows"][f"CVXQP{variant}_M"])
    assert abs(p.H - p.H.T).max() == 0


def test_rotation_is_the_published_instances():
    cell = harness.load_json("workloads", "mm_cvxqp_m.rotate.json")
    config = harness.load_json("configs", "mm_cvxqp_m.json")
    pool, start = cvxqp.make_pool(config, cell["traffic_params"], 2 ** 31 + 3)
    assert start == (2 ** 31 + 3) % 3
    assert [len(call) for call in pool] == [1, 1, 1]
    assert [call[0].m for call in pool] == [500, 250, 750]
