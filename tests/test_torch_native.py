"""The port's own binding of the native sparse LDL (madqp_tpu_torch.native)
against the JAX package's binding of the same C++ source.

* The symbolic functions (etree, postorder, column counts, the AMD
  variants, nested dissection, every ordering) give equal arrays on the
  inputs of tests/test_native.py;
* SparseLDL's factorization, solve and refactorization on a new value set
  with the same pattern give equal results, bit for bit (the same source
  compiled with the same flags), on an SPD and a quasi-definite K2 matrix,
  and a numerically singular matrix is reported as a breakdown;
* six processes that build the library at once into one empty directory
  all load a whole library (the build writes a temporary name and renames
  it), and a source that does not compile raises with the compiler's
  output while available() turns that into False.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import madqp_tpu.native as JN
import madqp_tpu_torch.native as TN
from madqp_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def spd_matrix(n=120, density=0.03, seed=7):
    M = sp.random(n, n, density=density, random_state=seed)
    return (M @ M.T + 10 * sp.eye(n)).tocsc()


def k2_matrix():
    n, m = 80, 30
    M = sp.random(n, n, density=0.05, random_state=3)
    W = (M @ M.T + 5 * sp.eye(n)).tocsc()
    B = sp.random(m, n, density=0.1, random_state=4)
    return sp.bmat([[W, B.T], [B, -1e-6 * sp.eye(m)]]).tocsc()


def test_binding_builds_from_the_repository_source():
    assert TN.available() and JN.available()
    assert TN.SOURCE == REPO / "native" / "src" / "sparse_ldl.cpp"
    path = Path(TN.build())
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libmadqp_sparse_ldl_")
    assert path != Path(JN._LIB_PATH).resolve()


@pytest.mark.parametrize("n,density", [(120, 0.03), (60, 0.03), (200, 0.02)])
def test_symbolic_functions_match_reference(n, density):
    A = spd_matrix(n, density)
    parent = TN.etree(A)
    np.testing.assert_array_equal(parent, JN.etree(A))
    np.testing.assert_array_equal(TN.postorder(parent), JN.postorder(parent))
    np.testing.assert_array_equal(TN.col_counts(A), JN.col_counts(A))
    np.testing.assert_array_equal(TN.col_counts(A, parent), JN.col_counts(A, parent))


@pytest.mark.parametrize("variant", ["elem", "clique"])
def test_amd_orders_match_reference(variant):
    A = spd_matrix(150, 0.03)
    np.testing.assert_array_equal(TN.amd_order(A, variant), JN.amd_order(A, variant))


@pytest.mark.parametrize("method", ["amd", "rcm", "natural", "auto", "nd"])
def test_orderings_match_reference(method):
    A = spd_matrix(300, 0.01)
    perm = TN.ordering(A, method)
    np.testing.assert_array_equal(perm, JN.ordering(A, method))
    assert sorted(perm) == list(range(300))


def test_nested_dissection_matches_reference_on_a_grid():
    g = 20
    T = sp.diags([-np.ones(g - 1), 2 * np.ones(g), -np.ones(g - 1)], (-1, 0, 1))
    A = (sp.kron(T, sp.eye(g)) + sp.kron(sp.eye(g), T)).tocsc()
    np.testing.assert_array_equal(TN.nd_order(A), JN.nd_order(A))


@pytest.mark.parametrize("make,order", [(spd_matrix, "auto"), (spd_matrix, "amd"),
                                        (k2_matrix, "auto"), (k2_matrix, "nd")],
                         ids=["spd-auto", "spd-amd", "k2-auto", "k2-nd"])
def test_sparse_ldl_solve_and_refactor_match_reference(make, order):
    A = make()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    port, ref = TN.SparseLDL(A, order=order), JN.SparseLDL(A, order=order)
    np.testing.assert_array_equal(port.perm, ref.perm)
    assert port.nnz_factor == ref.nnz_factor
    for values in (A, (A * 2.0).tocsc()):  # same pattern, other values
        assert port.factorize(values) and ref.factorize(values)
        assert port.is_factorized and ref.is_factorized
        np.testing.assert_array_equal(port.D, ref.D)
        np.testing.assert_array_equal(port.solve(b), ref.solve(b))
        # and the solve is a solve (1e-9 relative to the dense one)
        x = np.linalg.solve(values.toarray(), b)
        np.testing.assert_allclose(port.solve(b), x, rtol=1e-6, atol=1e-8)


def test_breakdown_detected():
    A = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, 1.0]]))
    port, ref = TN.SparseLDL(A), JN.SparseLDL(A)
    assert not port.factorize(A) and not ref.factorize(A)
    assert not port.is_factorized and not ref.is_factorized


def test_six_processes_building_at_once_all_load(tmp_path):
    """Six processes start the build into one empty directory together;
    each loads a whole library and solves, and one library is left (no
    temporary file)."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(REPO)!r})
        from madqp_tpu_torch.ops import _build
        _build.BUILD_DIR = Path({str(tmp_path)!r})
        import numpy as np, scipy.sparse as sp
        from madqp_tpu_torch import native
        A = sp.csc_matrix(np.array([[4.0, 1.0], [1.0, 3.0]]))
        f = native.SparseLDL(A)
        assert f.factorize(A)
        print(native.build(), float(f.solve(np.ones(2)) @ np.ones(2)))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in outs]
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines
    assert sorted(f.suffix for f in tmp_path.iterdir()) == [".log", ".so"]


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        TN.build()
    assert not TN.available()
    assert not any((tmp_path / "build").iterdir())  # no partial library left
