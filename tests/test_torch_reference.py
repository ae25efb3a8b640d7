"""The reference values that chip_smoke.py checks the port against.

`madqp_tpu_torch/testdata/jax_reference.json` holds status, iteration
count and objective of the JAX package on the smoke's problems, all with
the headline options (float32 factorization, one refinement step):
  * n500 / n2000: the headline benchmark QP random_qp(500, 200, seed) for
    seeds 0-3 and random_qp(2000, 1000, seed=0) through `solve`;
  * autosolve_n2000: random_qp(2000, 1000, seed=0) through `autosolve`,
    which buckets it to W 2048^2, S 1024^2 and picks the blocked backend;
  * n500_variants: random_qp(500, 200, seed=0) with each dense KKT variant
    (its extra options are stored beside its result, and chip_smoke.py
    reads them from there).
The card's machine has no JAX, so the smoke reads them from the file; this
test regenerates them on the CPU and asserts the committed file still
holds them.

The n500 / n2000 entries use linear_solver="dense": interpret-mode Pallas
at these sizes is slow, and the two backends iterate identically on these
problems (tests/test_pallas.py::test_solver_with_pallas_backend, and the
n=500 seeds 0-3 check recorded in CHANGES.md).

Regenerate the file with:  python tests/test_torch_reference.py --write
"""

import json
import sys
from pathlib import Path

import pytest

import madqp_tpu as mq

REF_PATH = (Path(__file__).resolve().parent.parent / "madqp_tpu_torch"
            / "testdata" / "jax_reference.json")


# Extra options of each n = 500 KKT variant (on top of the headline ones).
VARIANTS = {
    "blocked": {"linear_solver": "blocked"},
    "inverse": {"solve_mode": "inverse"},
    "k2": {"kkt_system": "k2"},
    "k2.5-blocked": {"kkt_system": "k2.5", "linear_solver": "blocked"},
}


def _headline():
    return dict(print_level=40, tol=1e-8, max_ncorr=0,
                step_rule=mq.AdaptiveStep(0.995),
                regularization=mq.FixedRegularization(1e-8, -1e-8),
                factorization_dtype="float32", max_refine_steps=1)


def _options():
    return dict(_headline(), linear_solver="dense")


def _record(stats):
    return {"status": int(stats.status), "iter": int(stats.iter),
            "objective": float(stats.objective)}


def generate_reference():
    n500 = mq.random_qp(500, 200, seed=0, ineq=True)
    out = {
        "source": "madqp_tpu on the CPU (tests/test_torch_reference.py), "
                  "float32 factorization, max_refine_steps=1, tol=1e-8, "
                  "max_ncorr=0, AdaptiveStep(0.995), "
                  "FixedRegularization(1e-8, -1e-8); n500 and n2000: solve "
                  "with linear_solver='dense'; autosolve_n2000: autosolve "
                  "with its own routing (pad_mode='bucket', "
                  "linear_solver='blocked'); n500_variants: solve on seed 0 "
                  "with each entry's options",
        "n500": {str(seed): _record(mq.solve(
            mq.random_qp(500, 200, seed=seed, ineq=True), **_options()))
            for seed in range(4)},
        "n2000": _record(mq.solve(mq.random_qp(2000, 1000, seed=0),
                                  **_options())),
        "autosolve_n2000": _record(mq.autosolve(
            mq.random_qp(2000, 1000, seed=0), **_headline())),
        "n500_variants": {
            name: {"options": extra,
                   **_record(mq.solve(n500, **_headline(), **extra))}
            for name, extra in VARIANTS.items()},
    }
    return out


def _flatten(ref):
    rows = {f"n500/{seed}": rec for seed, rec in ref["n500"].items()}
    rows["n2000"] = ref["n2000"]
    rows["autosolve_n2000"] = ref["autosolve_n2000"]
    for name, rec in ref["n500_variants"].items():
        rows[f"n500_variants/{name}"] = rec
    return rows


def test_committed_reference_matches_jax():
    """Status and iterations equal; objective to 1e-10 relative (the last
    digits of an XLA:CPU reduction may differ between CPU models)."""
    committed = _flatten(json.loads(REF_PATH.read_text()))
    fresh = _flatten(generate_reference())
    assert committed.keys() == fresh.keys()
    for key, want in fresh.items():
        got = committed[key]
        assert got["status"] == want["status"] == 1, key
        assert got["iter"] == want["iter"], key
        assert got["objective"] == pytest.approx(want["objective"], rel=1e-10), key
        assert got.get("options") == want.get("options"), key


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    ref = generate_reference()
    text = json.dumps(ref, indent=1) + "\n"
    if "--write" in sys.argv:
        REF_PATH.write_text(text)
    print(text, end="")
