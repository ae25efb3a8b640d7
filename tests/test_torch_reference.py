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
    reads them from there);
  * batched512: per-lane status / iterations / objective of the batched
    solver on 512 x dense_dummy_qp(32, 16, seed=i) with bench.py's batched
    options and endgame="f64" (smoke phase 10);
  * qp_layer64: iterations and the gradients of all six inputs of
    qp_layer for four lanes of the smoke's batch of 64 random QPs (phase
    11; the problems come from chip_smoke.layer_problem);
  * two_stage_1024: status, iterations, objective, the first-stage x0 and
    the norms of x and y of `solve_two_stage` on random_two_stage(n0=128,
    ns=96, ms=48, m0=16, N=1024, seed=0) under each of three option sets
    (phase 12; default options otherwise).  The reference's Schur system
    takes the library Cholesky whatever linear_solver says, so its
    "pallas" and "dense" entries are one solve.
The card's machine has no JAX, so the smoke reads them from the file; this
test regenerates them on the CPU and asserts the committed file still
holds them.

The n500 / n2000 entries use linear_solver="dense": interpret-mode Pallas
at these sizes is slow, and the two backends iterate identically on these
problems (tests/test_pallas.py::test_solver_with_pallas_backend, and the
n=500 seeds 0-3 check recorded in CHANGES.md).

All 512 batched lanes have one shape (no padding), so each lane's result
is independent of the batch: the staleness check recomputes CHECKED_LANES
as a batch of their own and compares them with the file.

Regenerate the file with:  python tests/test_torch_reference.py --write
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import madqp_tpu as mq

REPO = Path(__file__).resolve().parent.parent
REF_PATH = REPO / "madqp_tpu_torch" / "testdata" / "jax_reference.json"
BATCH = 512
CHECKED_LANES = (0, 1, 97, 200, 311, 402, 480, 511)
LAYER_LANES = (0, 21, 42, 63)


def _smoke():
    """chip_smoke.py as a module (its problem generators; it imports no
    JAX and nothing of the port at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


def batched_reference(lanes):
    """Per-lane lists of the batched solve of dense_dummy_qp(32, 16, seed=i)
    for i in `lanes`, with the smoke's phase-10 options."""
    from madqp_tpu.parallel import BatchedMPCSolver

    stats = BatchedMPCSolver.from_problems(
        [mq.dense_dummy_qp(32, 16, seed=i) for i in lanes],
        tol=1e-8, print_level=40, step_rule=mq.AdaptiveStep(0.995),
        regularization=mq.FixedRegularization(1e-8, -1e-8),
        factorization_dtype="float32", max_refine_steps=1,
        endgame="f64").solve_all()
    recs = [_record(st) for st in stats]
    return {key: [r[key] for r in recs] for key in ("status", "iter", "objective")}


def layer_reference():
    """qp_layer iterations and gradients (all six inputs) of the loss
    sum(w * x^2) + 0.1 * sum(y) for LAYER_LANES of the smoke's batch."""
    import jax
    import jax.numpy as jnp

    smoke = _smoke()
    w = jnp.asarray(smoke.layer_weights())
    tol = smoke.LAYER["tol"]

    def loss(*args):
        sol = mq.qp_layer(*args, tol=tol, print_level=40)
        return jnp.sum(w * sol.x ** 2) + 0.1 * jnp.sum(sol.y)

    grad = jax.grad(loss, argnums=tuple(range(6)))
    lanes = {}
    for i in LAYER_LANES:
        data = [jnp.asarray(a) for a in smoke.layer_problem(i)]
        sol = mq.qp_layer(*data, tol=tol, print_level=40)
        lanes[str(i)] = {
            "iter": int(sol.iters),
            "grads": {name: np.asarray(g).tolist()
                      for name, g in zip(("H", "c", "A", "b", "lb", "ub"), grad(*data))},
        }
    return {"problems": "chip_smoke.layer_problem(seed), seeds 0.."
                        f"{smoke.LAYER['lanes'] - 1}", **smoke.LAYER,
            "lanes": lanes}


def dense_reference():
    """The single-problem entries of the file."""
    n500 = mq.random_qp(500, 200, seed=0, ineq=True)
    out = {
        "source": "madqp_tpu on the CPU (tests/test_torch_reference.py), "
                  "float32 factorization, max_refine_steps=1, tol=1e-8, "
                  "max_ncorr=0, AdaptiveStep(0.995), "
                  "FixedRegularization(1e-8, -1e-8); n500 and n2000: solve "
                  "with linear_solver='dense'; autosolve_n2000: autosolve "
                  "with its own routing (pad_mode='bucket', "
                  "linear_solver='blocked'); n500_variants: solve on seed 0 "
                  "with each entry's options; batched512: BatchedMPCSolver "
                  "with the same options (max_ncorr default 0), "
                  "endgame='f64', linear_solver='dense'; qp_layer64: qp_layer, "
                  "float64, default options, tol as stored",
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


# Phase 12's problem (random_two_stage's arguments but N) and option sets.
TWO_STAGE = dict(n0=128, ns=96, ms=48, m0=16, seed=0, qp=True)
TWO_STAGE_N = (1024, 512, 256)  # the largest N that every option set solves
TWO_STAGE_OPTIONS = {
    "pallas": {"linear_solver": "pallas"},
    "dense": {"linear_solver": "dense"},
    "pallas_f32": {"linear_solver": "pallas", "factorization_dtype": "float32",
                   "max_refine_steps": 1},
}


def two_stage_record(prob, lb, ub, options):
    from madqp_tpu.parallel import solve_two_stage

    st = solve_two_stage(prob, lb, ub, print_level=40, **options)
    y = np.asarray(st.multipliers)
    return {"options": options, **_record(st),
            "x0": np.asarray(st.solution[:TWO_STAGE["n0"]]).tolist(),
            "norm_x": float(np.linalg.norm(st.solution)),
            "norm_y": float(np.linalg.norm(y))}


def two_stage_reference(names=tuple(TWO_STAGE_OPTIONS), sizes=TWO_STAGE_N):
    """`solve_two_stage` on TWO_STAGE at the largest N of `sizes` where
    every option set of `names` reaches SOLVE_SUCCEEDED."""
    from madqp_tpu.parallel import random_two_stage

    for N in sizes:
        prob, lb, ub = random_two_stage(N=N, **TWO_STAGE)
        recs = {name: two_stage_record(prob, lb, ub, TWO_STAGE_OPTIONS[name])
                for name in names}
        if all(rec["status"] == 1 for rec in recs.values()):
            return {"problem": dict(TWO_STAGE, N=N), "solves": recs}
    raise RuntimeError("no N of TWO_STAGE_N solves under every option set")


def generate_reference():
    return {**dense_reference(), "batched512": batched_reference(range(BATCH)),
            "qp_layer64": layer_reference(), "two_stage_1024": two_stage_reference()}


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
    fresh = _flatten(dense_reference())
    assert committed.keys() == fresh.keys()
    for key, want in fresh.items():
        got = committed[key]
        assert got["status"] == want["status"] == 1, key
        assert got["iter"] == want["iter"], key
        assert got["objective"] == pytest.approx(want["objective"], rel=1e-10), key
        assert got.get("options") == want.get("options"), key


def test_committed_batched_lanes_match_jax():
    """CHECKED_LANES of batched512 recomputed as a batch of their own:
    status and iterations equal, objective to 1e-10 relative."""
    committed = json.loads(REF_PATH.read_text())["batched512"]
    assert all(len(v) == BATCH for v in committed.values())
    fresh = batched_reference(CHECKED_LANES)
    for j, i in enumerate(CHECKED_LANES):
        assert committed["status"][i] == fresh["status"][j] == 1, i
        assert committed["iter"][i] == fresh["iter"][j], i
        assert committed["objective"][i] == pytest.approx(fresh["objective"][j],
                                                          rel=1e-10), i


def test_committed_layer_gradients_match_jax():
    """qp_layer64: iterations equal, every gradient to 1e-10 relative to
    its largest magnitude."""
    committed = json.loads(REF_PATH.read_text())["qp_layer64"]
    fresh = layer_reference()
    assert {k: v for k, v in committed.items() if k != "lanes"} == \
        {k: v for k, v in fresh.items() if k != "lanes"}
    assert committed["lanes"].keys() == fresh["lanes"].keys()
    for lane, want in fresh["lanes"].items():
        got = committed["lanes"][lane]
        assert got["iter"] == want["iter"], lane
        for name, g in want["grads"].items():
            g = np.asarray(g)
            np.testing.assert_allclose(np.asarray(got["grads"][name]), g, rtol=1e-10,
                                       atol=1e-10 * np.abs(g).max(), err_msg=f"{lane} {name}")


def test_committed_two_stage_matches_jax():
    """two_stage_1024: the float64 solve recomputed (about a minute on the
    CPU): status and iterations equal, objective, x0 and the norms to 1e-10
    relative.  The reference's Schur system ignores linear_solver, so its
    "pallas" entry must equal its "dense" one; the float32 entry is
    recomputed only by the --write run."""
    committed = json.loads(REF_PATH.read_text())["two_stage_1024"]
    assert committed["problem"]["N"] in TWO_STAGE_N
    assert committed["problem"] == dict(TWO_STAGE, N=committed["problem"]["N"])
    solves = committed["solves"]
    assert solves.keys() == TWO_STAGE_OPTIONS.keys()
    for name, rec in solves.items():
        assert rec["options"] == TWO_STAGE_OPTIONS[name] and rec["status"] == 1, name
        assert len(rec["x0"]) == TWO_STAGE["n0"], name
    assert {k: v for k, v in solves["pallas"].items() if k != "options"} == \
        {k: v for k, v in solves["dense"].items() if k != "options"}
    fresh = two_stage_reference(("dense",), (committed["problem"]["N"],))["solves"]["dense"]
    got = solves["dense"]
    assert got["status"] == fresh["status"] and got["iter"] == fresh["iter"]
    for key in ("objective", "norm_x", "norm_y"):
        assert got[key] == pytest.approx(fresh[key], rel=1e-10), key
    np.testing.assert_allclose(got["x0"], fresh["x0"], rtol=1e-10, atol=1e-12)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    ref = generate_reference()
    text = json.dumps(ref, indent=1) + "\n"
    if "--write" in sys.argv:
        REF_PATH.write_text(text)
    print(text, end="")
