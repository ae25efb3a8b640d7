"""Suite runner of madqp_tpu_torch, emitting the reference's 9-column schema.

The port's counterpart of `benchmarks/run_suite.py` (the reference's
scripts/benchmarks_{cpu,gpu}.jl): every instance goes through
`read_mps` (or a generator) -> `presolve_qp` -> `scale_qp` -> `solve` ->
`unscale_stats`, and one record per instance holds nvar, ncon, nnzj, nnzh,
status, iter, objective, total_time and linear_solver_time, plus
status_detail, the endgame fields where a solve reports them, warm_time
under --repeat and the host's 1-minute load.  Instances come from a
directory of MPS/QPS files (--dir, .gz and .bz2 included) or from a
generated suite (--suite).  Imports madqp_tpu_torch only.

Usage:
    python tools/run_suite_torch.py --suite structured:large --linear-solver pallas
    python tools/run_suite_torch.py --dir tests/data/real_mm --device cpu
    python tools/run_suite_torch.py --suite structured:small --batched --device cpu

`run_instance` is importable (`chip_smoke.py` and the tests call it).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import madqp_tpu_torch as mt  # noqa: E402

# The reference's scripts/excluded_problems.jl:1-3, as
# benchmarks/fetch_suites.py stores them (basenames, no suffix).
EXCLUSIONS = {
    "netlib": ["BLEND", "DFL001", "FORPLAN", "GFRD-PNC", "SIERRA"],
    "mm": ["EXDATA", "QFORPLAN", "QGFRDXPN", "VALUES"],
    "": [],
}

# Backends of the reference's runner that wait on their own port.
UNPORTED_BACKENDS = {
    "host": "ROADMAP Queue 1 item 12 (the host path, solve_host)",
    "sparse-device": "ROADMAP Queue 1 item 13 (the sparse device paths)",
}

MPS_PATTERNS = ("*.mps", "*.qps", "*.sif", "*.SIF", "*.mps.gz", "*.mps.bz2",
                "*.qps.gz", "*.qps.bz2", "*.SIF.gz", "*.sif.gz")


def _load_guard(context, threshold=1.0, wait=False):
    """The host's 1-minute load average before a timed section, with a
    warning above `threshold`; with wait=True, sleep (at most 10 min)
    until the host quiets down."""
    load = os.getloadavg()[0]
    if wait:
        deadline = time.time() + 600
        while load > threshold and time.time() < deadline:
            print(f"# load-guard: load {load:.2f} > {threshold} before "
                  f"{context}; waiting for quiet host", file=sys.stderr)
            time.sleep(15)
            load = os.getloadavg()[0]
    if load > threshold:
        print(f"# LOAD WARNING: 1-min load {load:.2f} > {threshold} at "
              f"start of {context} — wall times may be inflated by "
              "contention; do not commit as a baseline", file=sys.stderr)
    return load


def _require_ported(backend):
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"--backend {backend} is not ported yet: {UNPORTED_BACKENDS[backend]}")


def _dispatch(qp_s, solve_opts, backend):
    _require_ported(backend)
    return mt.solve(qp_s, **solve_opts)


def _endgame_fields(stats) -> dict:
    eg_t = getattr(stats.counters, "endgame_time", 0.0)
    if not eg_t:
        return {}
    return {"endgame_time": eg_t,
            "endgame_backend": getattr(stats.counters, "endgame_backend", "")}


def run_instance(name, qp, options, repeat=1, quiet_load=False, stages=None):
    """read -> presolve -> scale -> solve -> 9-column record (reference
    run_benchmark, scripts/benchmarks_cpu.jl:12-60).

    `options` are `mt.solve`'s (device included) plus `backend`.  An
    exception is recorded as status "error:<type>" and the run goes on.
    repeat > 1 re-solves the instance on value-perturbed data and records
    the best wall as warm_time; the endgame fields then come from that best
    warm solve, or are dropped when it ran no endgame.  A dict `stages`
    receives the host seconds of the stages that ran (presolve_s, scale_s,
    solve_s, unscale_s; the record itself keeps the reference's keys)."""
    record = {
        "name": name,
        "nvar": qp.nvar,
        "ncon": qp.ncon,
        "nnzj": qp.nnzj,
        "nnzh": qp.nnzh,
        "status": -1,
        "iter": -1,
        "objective": float("nan"),
        "total_time": -1.0,
        "linear_solver_time": -1.0,
    }
    try:
        backend = options.get("backend", "device")
        solve_opts = {k: v for k, v in options.items() if k != "backend"}
        stages = {} if stages is None else stages
        t0 = time.perf_counter()
        qp_p, pinfo, ok = mt.presolve_qp(qp)
        stages["presolve_s"] = time.perf_counter() - t0
        if not ok:
            record["status"] = f"presolve:{pinfo.status.value}"
            if pinfo.status.value == "solved":
                # fully reduced: presolve determined the solution
                x = pinfo.postsolve_x(np.zeros(0))
                record["objective"] = float(qp.obj(x))
                record["iter"] = 0
            return record
        t0 = time.perf_counter()
        qp_s, scaling = mt.scale_qp(qp_p)
        stages["scale_s"] = time.perf_counter() - t0
        record["load_1min"] = _load_guard(f"solve of {name}", wait=quiet_load)
        t0 = time.time()
        stats = _dispatch(qp_s, solve_opts, backend)
        record["total_time"] = stages["solve_s"] = time.time() - t0
        t0 = time.perf_counter()
        stats = mt.unscale_stats(scaling, stats)
        stages["unscale_s"] = time.perf_counter() - t0
        record["status"] = int(stats.status == mt.Status.SOLVE_SUCCEEDED)
        record["status_detail"] = stats.status.name
        record["iter"] = stats.iter
        record["objective"] = stats.objective
        # linear_solver_time only where it was measured: a 0.0 placeholder
        # would read as "free"
        ls_t = stats.counters.linear_solver_time
        record["linear_solver_time"] = (
            ls_t if (options.get("measure_linear_solver") or ls_t > 0.0) else None)
        record.update(_endgame_fields(stats))
        if repeat > 1 and record["status"] == 1:
            walls, best = [], {}
            for r in range(1, repeat):
                qp_r = dataclasses.replace(qp_s, c=qp_s.c * (1.0 + 1e-6 * r))
                record["load_1min"] = _load_guard(
                    f"warm re-solve of {name}", wait=quiet_load)
                tw = time.time()
                stats_w = _dispatch(qp_r, solve_opts, backend)
                walls.append(time.time() - tw)
                if walls[-1] == min(walls):
                    best = _endgame_fields(stats_w)
            record.pop("endgame_time", None)
            record.pop("endgame_backend", None)
            record.update(best)
            record["warm_time"] = min(walls)
    except Exception as e:  # record and continue, as the reference's harness
        traceback.print_exc(file=sys.stderr)
        record["status"] = f"error:{type(e).__name__}"
    return record


def generated_suite(kind: str, sizes, families=()):
    if kind.startswith("structured"):
        size = kind.split(":")[1] if ":" in kind else "medium"
        yield from mt.structured_suite(size, families=tuple(families))
        return
    for n in sizes:
        m = max(1, n // 2)
        if kind == "random_qp":
            yield f"random_qp_{n}", mt.random_qp(n, m, seed=n)
        elif kind == "random_lp":
            yield f"random_lp_{n}", mt.random_lp(n, m, seed=n)
        elif kind == "dense_dummy":
            yield f"dense_dummy_{n}", mt.dense_dummy_qp(n, m, seed=n)
        else:
            raise ValueError(f"unknown suite {kind}")


def read_dir(path: str, excluded=(), parse_s=None):
    """(name, problem) of every MPS/QPS/SIF file in `path`, sorted by file
    name; a file that does not parse is reported and skipped.  A dict
    `parse_s` receives each parsed file's host seconds by name."""
    files = sorted({f for pat in MPS_PATTERNS for f in glob.glob(os.path.join(path, pat))})
    out = []
    for f in files:
        nm = os.path.basename(f).split(".")[0]
        if nm in excluded:
            continue
        try:
            t0 = time.perf_counter()
            out.append((nm, mt.read_mps(f)))
            if parse_s is not None:
                parse_s[nm] = time.perf_counter() - t0
        except Exception as e:
            print(json.dumps({"name": nm, "status": f"read_error:{e}"}))
    return out


def _bucket(v, lo=32):
    b = lo
    while b < v:
        b *= 2
    return b


def run_batched(instances, options, repeat=1, quiet_load=False):
    """One lockstep `BatchedMPCSolver` per power-of-two size bucket
    (nvar + ncon); records share their bucket's wall times."""
    solve_opts = {k: v for k, v in options.items() if k not in ("backend", "pad_mode")}
    groups: dict = {}
    for nm, qp in instances:
        groups.setdefault(_bucket(qp.nvar + qp.ncon), []).append((nm, qp))
    for key in sorted(groups):
        batch = groups[key]
        load = _load_guard(f"batched bucket {key}", wait=quiet_load)
        t0 = time.time()
        solver = mt.BatchedMPCSolver.from_problems([qp for _, qp in batch], **solve_opts)
        stats = solver.solve_all()
        total = time.time() - t0
        warm = None
        if repeat > 1:
            walls = []
            for r in range(1, repeat):
                prob_r = solver.prob._replace(c=solver.prob.c * (1.0 + 1e-5 * r))
                tw = time.time()
                solver.solve_batch(prob_r)  # returns with the device work done
                walls.append(time.time() - tw)
            warm = min(walls)
        warm_s = f", {warm:.3f}s warm" if warm is not None else ""
        print(f"# bucket {key}: {len(batch)} instances, {total:.2f}s cold{warm_s}",
              file=sys.stderr)
        for (nm, qp), st in zip(batch, stats):
            yield {
                "name": nm, "nvar": qp.nvar, "ncon": qp.ncon,
                "nnzj": qp.nnzj, "nnzh": qp.nnzh,
                "status": int(st.status == mt.Status.SOLVE_SUCCEEDED),
                "iter": st.iter, "objective": st.objective,
                "total_time": total,  # the bucket's shared wall time
                "warm_time": warm,
                "linear_solver_time": None,  # not measured in batched mode
                "load_1min": load,
            }


def solve_options(args) -> dict:
    """`mt.solve` options of the reference runner's defaults (its
    AdaptiveStep(0.995), FixedRegularization(1e-8, -1e-8), bucketed
    padding on the device path) from the parsed arguments."""
    options = dict(
        print_level=40,
        tol=args.tol,
        max_iter=args.max_iter,
        max_ncorr=args.max_ncorr,
        kkt_system=args.kkt,
        linear_solver=args.linear_solver,
        step_rule=mt.AdaptiveStep(0.995),
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        backend=args.backend,
        device=args.device,
    )
    if args.backend == "device":
        options["pad_mode"] = "bucket"
    if args.mixed_precision:
        options.update(factorization_dtype="float32", max_refine_steps=1)
    if args.measure_ls:
        options["measure_linear_solver"] = True
    return options


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", help="directory of .mps/.qps/.sif[.gz|.bz2] files")
    ap.add_argument("--suite", default="random_qp",
                    help="random_qp | random_lp | dense_dummy | "
                         "structured[:small|medium|large|xlarge]")
    ap.add_argument("--sizes", default="100,200,500")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-iter", type=int, default=300)
    ap.add_argument("--max-ncorr", type=int, default=3)
    ap.add_argument("--kkt", default="condensed")
    ap.add_argument("--linear-solver", default="dense",
                    choices=["dense", "blocked", "pallas"],
                    help="dense-path factorization: library Cholesky, the "
                         "blocked factor + inverse (K8), or K1")
    ap.add_argument("--backend", choices=["device", "host", "sparse-device"],
                    default="device",
                    help="device = the dense solve on --device; host and "
                         "sparse-device are not ported yet (they raise)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (cuda or cpu)")
    ap.add_argument("--mixed-precision", action="store_true",
                    help="float32 factorization + one float64 refinement step")
    ap.add_argument("--measure-ls", action="store_true",
                    help="measure linear_solver_time (extra timed "
                         "factorize/backsolve after each solve)")
    ap.add_argument("--batched", action="store_true",
                    help="solve each power-of-two size bucket as one "
                         "lockstep batch")
    ap.add_argument("--repeat", type=int, default=1,
                    help="solve each instance/bucket this many times in "
                         "all (value-perturbed) and record the best warm "
                         "wall as warm_time")
    ap.add_argument("--out", default="")
    ap.add_argument("--resume", action="store_true",
                    help="skip instances already recorded in --out and "
                         "append the new records")
    ap.add_argument("--exclude", default="", help="comma-separated instance names")
    ap.add_argument("--families", default="",
                    help="restrict --suite structured:* to these comma-"
                         "separated family names")
    ap.add_argument("--quiet-load", action="store_true",
                    help="wait (up to 10 min) for the 1-min host load to "
                         "drop below 1.0 before every timed solve")
    ap.add_argument("--exclude-preset", default="", choices=["", "netlib", "mm"],
                    help="the reference's exclusion list of a real suite")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    _require_ported(args.backend)
    options = solve_options(args)
    excluded = set(filter(None, args.exclude.split(",")))
    excluded |= set(EXCLUSIONS[args.exclude_preset])

    if args.dir:
        instances = read_dir(args.dir, excluded)
    else:
        sizes = [int(s) for s in args.sizes.split(",")]
        families = tuple(filter(None, args.families.split(",")))
        if families and not args.suite.startswith("structured"):
            ap.error(f"--families only applies to --suite structured:*, "
                     f"not {args.suite!r}")
        instances = [(nm, qp) for nm, qp in generated_suite(args.suite, sizes, families)
                     if nm not in excluded]

    results = []
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {r["name"] for r in results}
        instances = [(nm, qp) for nm, qp in instances if nm not in done]
        print(f"# resume: {len(done)} done, {len(instances)} remaining", file=sys.stderr)

    def checkpoint():
        if args.out:
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=2)
            os.replace(tmp, args.out)

    if args.batched:
        records = run_batched(instances, options, args.repeat, args.quiet_load)
    else:
        records = (run_instance(nm, qp, options, repeat=args.repeat,
                                quiet_load=args.quiet_load) for nm, qp in instances)
    for rec in records:
        results.append(rec)
        print(json.dumps(rec), flush=True)
        checkpoint()  # per record: a killed run resumes with --resume
    checkpoint()
    solved = sum(1 for r in results if r["status"] == 1)
    print(f"# solved {solved}/{len(results)}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
