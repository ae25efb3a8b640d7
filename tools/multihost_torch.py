#!/usr/bin/env python3
"""Multi-card launcher for the port's sharded solvers (the counterpart of
benchmarks/multihost.py): one process per card, `torch.distributed` with
NCCL on the cards and gloo on the CPU, a 1-D DeviceMesh over all ranks.

Run from the root of a checkout:

    python3 tools/multihost_torch.py --mode schur            # one rank per card, spawned here
    torchrun --nproc-per-node 4 tools/multihost_torch.py --mode batched
    python3 tools/multihost_torch.py --coordinator host0:1234 \\
        --num-processes 2 --process-id 0 --mode schur          # one process per host
    python3 tools/multihost_torch.py --device cpu --backend gloo \\
        --num-processes 2 --mode batched schur                 # the CPU rehearsal
    python3 tools/multihost_torch.py --mode all --out multihost.json

Modes, flags, defaults and print lines are the JAX script's: ``batched``
solves 2 x dense_dummy_qp(32, 16) per rank (--n-instances) with the lanes
sharded over the mesh (`BatchedMPCSolver.from_problems(mesh=...)`),
``schur`` random_two_stage(n0=16, ns=12, ms=8, m0=4, seed=0) with 4
scenarios per rank (--scenarios) through `solve_two_stage(mesh=...)`;
several modes may be given.  At the JAX package's own sizes (16 instances,
16 scenarios: the `mesh` entry of madqp_tpu_torch/testdata/jax_reference.json,
its sharded solves over 4 CPU devices) each result is held to the
reference: status and iterations equal, objective within 1e-8 relative.

``all`` is the program across cards (BASELINE configs #4 and #5):
  0. both modes at the reference's sizes, against it;
  a. 1024 x dense_dummy_qp(32, 16) per card with the smoke's
     batched options (float32 factorization, one refinement step,
     endgame "f64", linear_solver "pallas"): set-up, first and warm walls
     per rank; each rank's lanes solved alone on its card, and every lane
     on rank 0's card alone: every lane's status and iterations equal and
     objective within 1e-10 relative of the one-card runs';
  b. two_stage_1024 under "pallas" over the mesh against the JAX record
     (iterations equal, objective 1e-8, x0 1e-7) and on rank 0's card
     alone; random_two_stage(n0=128, ns=96, ms=48, m0=16, N=4096)
     over the mesh against the same problem on rank 0's card (iterations
     equal, objective 1e-8, x 1e-7), each problem built on every rank's
     card first, with one torch.profiler pass of the sharded solve on rank
     0 and one of the same problem on its card alone: NCCL kernels' share
     of the device time and of the wall, per iteration;
  c. 16 x banded_sparse_lp(2000, 1000, band=5) per card
     (float64) over the mesh against each rank's lanes on its card alone
     (status and iterations equal, objective 1e-10) and the first 16 lanes
     against the JAX record of the smoke's phase 18 (objective 1e-8).
Each run records per rank its walls, iterations and the hand kernels'
launches (K1 by route, K2-batched, K8), and whether every rank returned
the same stats.  With --out the record is written as JSON; the launcher
(or rank 0) prints the card's name and power limit.  Any failed check, or
a rank that fails, exits non-zero.

With device "cuda" the launcher builds the four kernel libraries (and the
native LDL) before the ranks start, so that they do not build them four
times over.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REF_PATH = REPO / "madqp_tpu_torch" / "testdata" / "jax_reference.json"
# the smoke's batched options (chip_smoke.py phase 10), the step rule apart
BATCHED = dict(tol=1e-8, print_level=40, factorization_dtype="float32",
               max_refine_steps=1, endgame="f64", linear_solver="pallas")
BIG_TWO_STAGE = dict(n0=128, ns=96, ms=48, m0=16, seed=0, qp=True)
SPARSE = ("banded_sparse_lp", dict(n=2000, m=1000, band=5))
LANES_PER_CARD, BIG_SCENARIOS, SPARSE_PER_CARD = 1024, 4096, 16   # runs (a), (b), (c)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default="", help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=0,
                    help="ranks (default: one per card, 1 on the CPU)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--mode", nargs="+", choices=["batched", "schur", "all"],
                    default=["schur"])
    ap.add_argument("--n-instances", type=int, default=0,
                    help="batched mode: QP instances (default 2/device)")
    ap.add_argument("--scenarios", type=int, default=0,
                    help="schur mode: scenario count (default 4/device)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default="", help="write the JSON record here")
    return ap.parse_args(argv)


# -- on every rank ----------------------------------------------------------


def _counters():
    from madqp_tpu_torch.ops import ldl_batched as k2
    from madqp_tpu_torch.ops import pallas_chol as k1
    from madqp_tpu_torch.ops import syrk as k8

    return k1.cholesky_lower, k8.syrk_update, k2.ldl_lower_batched


def reset_counts():
    k1, k8, k2 = _counters()
    k1.launches = 0
    k1.routes.clear()
    k8.launches = k2.launches = 0


def read_counts() -> dict:
    k1, k8, k2 = _counters()
    return {"K1": k1.launches, "K1_routes": dict(k1.routes), "K2-batched": k2.launches,
            "K8": k8.launches}


def digest(stats) -> str:
    """A hash of what a solve returned (status, iterations, objective and
    iterates of every instance), the walls apart."""
    import numpy as np

    h = hashlib.sha1()
    for s in stats if isinstance(stats, list) else [stats]:
        h.update(f"{int(s.status)} {s.iter} {s.objective!r}".encode())
        for v in (s.solution, s.multipliers, s.multipliers_L, s.multipliers_U):
            h.update(np.ascontiguousarray(v, dtype=np.float64).tobytes())
    return h.hexdigest()


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def compare(got, want, rtol, x_atol=None) -> dict:
    """Lane by lane: status and iterations equal, objective within rtol
    relative (and the solution within x_atol)."""
    import numpy as np

    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    bad, worst, worst_x = [], 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        r = rel(g.objective, w.objective)
        dx = float(np.abs(g.solution - w.solution).max())
        worst, worst_x = max(worst, r), max(worst_x, dx)
        if (int(g.status) != int(w.status) or g.iter != w.iter or r > rtol
                or (x_atol is not None and dx > x_atol)):
            bad.append(i)
    return {"lanes": len(got), "n_mismatched": len(bad) + abs(len(got) - len(want)),
            "mismatched": bad[:20], "worst_objective_rel": worst, "worst_x_abs": worst_x}


def compare_record(stats, rec, rtol=1e-8) -> dict:
    """Against the JAX package's per-lane lists (status, iter, objective)."""
    stats = stats if isinstance(stats, list) else [stats]
    as_list = lambda v: v if isinstance(v, list) else [v]  # noqa: E731
    status, iters, objs = (as_list(rec[k]) for k in ("status", "iter", "objective"))
    bad = [i for i, s in enumerate(stats)
           if int(s.status) != status[i] or s.iter != iters[i] or rel(s.objective, objs[i]) > rtol]
    return {"lanes": len(stats), "n_mismatched": len(bad) + abs(len(stats) - len(status)),
            "mismatched": bad[:20],
            "worst_objective_rel": max(rel(s.objective, o) for s, o in zip(stats, objs))}


def profile(solve, iters) -> dict:
    """One torch.profiler pass of `solve` (`utils/profiling.py::
    device_profile`): the wall, the device's busy time and idle share, the
    NCCL kernels' time and launches, and the host's CUDA runtime calls, in
    all and per iteration.  The profiler also lists NCCL's own ranges
    ("nccl:<op>") among the device events; they span the NCCL kernels and
    are left out of the busy time."""
    from madqp_tpu_torch.utils import profiling

    _, prof = profiling.device_profile(solve)
    by_name = prof["kernel_ms_by_name"]
    ranges = sum(v for k, v in by_name.items() if k.startswith("nccl:"))
    nccl = {k: v for k, v in by_name.items() if k.startswith("ncclDevKernel")
            or k.startswith("ncclKernel")}
    busy = prof["kernel_ms"] - ranges
    nccl_ms, wall_ms = sum(nccl.values()), prof["wall_s"] * 1e3
    return {"wall_s": prof["wall_s"], "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "nccl_kernel_ms": nccl_ms, "nccl_ranges_ms": ranges,
            "nccl_launches": sum(prof["launches_by_name"].get(k, 0) for k in nccl),
            "nccl_share_of_device": nccl_ms / max(busy, 1e-12),
            "nccl_share_of_wall": nccl_ms / wall_ms,
            "iterations": iters, "nccl_ms_per_iteration": nccl_ms / max(iters, 1),
            "busy_ms_per_iteration": busy / max(iters, 1),
            "wall_ms_per_iteration": wall_ms / max(iters, 1),
            "nccl_kernels": nccl,
            "top_kernels": {k: v for k, v in list(by_name.items())[:12]
                            if not k.startswith("nccl:")},
            "runtime_ms": dict(list(prof["runtime_ms_by_name"].items())[:8])}


class Rank:
    """What one rank runs, and its record."""

    def __init__(self, args, world, rank):
        import torch
        from torch.distributed.device_mesh import init_device_mesh

        self.torch, self.args, self.world, self.rank = torch, args, world, rank
        self.device = args.device
        self.mesh = {axis: init_device_mesh(args.device, (world,), mesh_dim_names=(axis,))
                     for axis in ("batch", "scen")}
        self.ref = json.loads(REF_PATH.read_text())
        self.record = {"rank": rank, "runs": {}}
        self.failures = []

    def say(self, msg):
        if self.rank == 0:
            print(msg, flush=True)

    def sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def barrier(self):
        import torch.distributed as dist

        dist.barrier()

    def timed(self, fn):
        self.sync()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0, read_counts()

    def check(self, name, result):
        if result["n_mismatched"]:
            self.failures.append(f"rank {self.rank} {name}: {result}")
        return result

    # -- the JAX script's modes --------------------------------------------

    def batched(self, k=None):
        import madqp_tpu_torch as mt

        k = k or self.args.n_instances or 2 * self.world
        qps = [mt.dense_dummy_qp(32, 16, seed=i) for i in range(k)]
        t0 = time.perf_counter()
        solver = mt.BatchedMPCSolver.from_problems(qps, mesh=self.mesh["batch"],
                                                   device=self.device, print_level=40)
        setup = time.perf_counter() - t0
        stats, wall, launches = self.timed(solver.solve_all)
        ok = sum(s.status == mt.Status.SOLVE_SUCCEEDED for s in stats)
        self.say(f"batched: {ok}/{len(stats)} solved in {wall:.2f}s")
        run = {"instances": k, "setup_s": setup, "wall_s": wall, "launches": launches,
               "iterations": [s.iter for s in stats], "digest": digest(stats)}
        want = self.ref["mesh"]["batched"]
        if k == len(want["iter"]):
            run["reference"] = self.check("batched against the JAX record",
                                          compare_record(stats, want))
            self.say(f"batched: {k} instances against the JAX package's sharded solve: "
                     f"{run['reference']['n_mismatched']} mismatched, objective within "
                     f"{run['reference']['worst_objective_rel']:.2e}")
        self.record["runs"]["batched"] = run

    def schur(self, N=None):
        import madqp_tpu_torch as mt

        N = N or self.args.scenarios or 4 * self.world
        prob, lb, ub = mt.random_two_stage(n0=16, ns=12, ms=8, m0=4, N=N, seed=0, qp=True,
                                           device="cpu")
        st, wall, launches = self.timed(lambda: mt.solve_two_stage(
            prob, lb, ub, mesh=self.mesh["scen"], device=self.device, print_level=40))
        self.say(f"schur: {st.status.name} iter {st.iter} obj {st.objective:.6f} "
                 f"({N} scenarios over {self.world} devices, {st.counters.total_time:.2f}s)")
        run = {"scenarios": N, "wall_s": wall, "launches": launches, "iterations": st.iter,
               "objective": st.objective, "digest": digest(st)}
        want = self.ref["mesh"]["schur"]
        if N == want["problem"]["N"]:
            run["reference"] = self.check("schur against the JAX record",
                                          compare_record(st, want))
            self.say(f"schur: against the JAX package's sharded solve: "
                     f"{run['reference']['n_mismatched']} mismatched, objective within "
                     f"{run['reference']['worst_objective_rel']:.2e}")
        self.record["runs"]["schur"] = run

    # -- the program across cards ------------------------------------------

    def all(self):
        self.batched(len(self.ref["mesh"]["batched"]["iter"]))
        self.schur(self.ref["mesh"]["schur"]["problem"]["N"])
        self.lanes()
        self.two_stage()
        self.sparse()

    def lanes(self):
        """(a) BASELINE #4: lanes per card, sharded; against one card."""
        import madqp_tpu_torch as mt

        per = LANES_PER_CARD
        total = per * self.world
        qps = [mt.dense_dummy_qp(32, 16, seed=i) for i in range(total)]
        opts = dict(BATCHED, step_rule=mt.AdaptiveStep(0.995),
                    regularization=mt.FixedRegularization(1e-8, -1e-8))
        run = {"lanes": total, "per_card": per}
        t0 = time.perf_counter()
        solver = mt.BatchedMPCSolver.from_problems(qps, mesh=self.mesh["batch"],
                                                   device=self.device, **opts)
        run["setup_s"] = time.perf_counter() - t0
        stats, run["first_s"], run["launches"] = self.timed(solver.solve_all)
        run["warm_s"] = [self.timed(solver.solve_batch)[1] for _ in range(2)]
        run["iterations"] = [min(s.iter for s in stats), max(s.iter for s in stats)]
        run["digest"] = digest(stats)
        own = qps[self.rank * per:(self.rank + 1) * per]
        t0 = time.perf_counter()
        alone = mt.BatchedMPCSolver.from_problems(own, device=self.device, **opts)
        run["one_card_setup_s"] = time.perf_counter() - t0
        got, run["one_card_first_s"], run["one_card_launches"] = self.timed(alone.solve_all)
        run["one_card_warm_s"] = [self.timed(alone.solve_batch)[1] for _ in range(2)]
        run["against_own_lanes_on_one_card"] = self.check(
            "lanes against one card", compare(stats[self.rank * per:(self.rank + 1) * per],
                                              got, 1e-10))
        del alone
        if self.rank == 0:
            t0 = time.perf_counter()
            whole = mt.BatchedMPCSolver.from_problems(qps, device=self.device, **opts)
            run["all_on_one_card_setup_s"] = time.perf_counter() - t0
            got, run["all_on_one_card_first_s"], run["all_on_one_card_launches"] = \
                self.timed(whole.solve_all)
            run["all_on_one_card_warm_s"] = [self.timed(whole.solve_batch)[1]
                                             for _ in range(2)]
            run["against_all_lanes_on_one_card"] = self.check(
                "lanes against all on one card", compare(stats, got, 1e-10))
            del whole
        self.barrier()
        self.say(f"(a) {total} lanes over {self.world} cards: set-up "
                 f"{run['setup_s']:.2f} s, first {run['first_s']:.3f} s, warm "
                 f"{min(run['warm_s']):.3f} s on rank 0; its {per} lanes alone "
                 f"{min(run['one_card_warm_s']):.3f} s warm; all {total} on one card "
                 f"{min(run.get('all_on_one_card_warm_s', [float('nan')])):.3f} s warm")
        self.record["runs"]["lanes"] = run

    def two_stage(self):
        """(b) BASELINE #5: two_stage_1024 and N = big over the mesh."""
        import madqp_tpu_torch as mt

        entry = self.ref["two_stage_1024"]
        want = entry["solves"]["pallas"]
        opts = dict(want["options"], print_level=40)
        out = {}
        for name, spec in (("two_stage_1024", entry["problem"]),
                           (f"two_stage_{BIG_SCENARIOS}", dict(BIG_TWO_STAGE, N=BIG_SCENARIOS))):
            t0 = time.perf_counter()
            # built on every rank's card, so that no solve uploads it
            prob, lb, ub = mt.random_two_stage(**spec, device=self.device)
            self.sync()
            run = {"problem": spec, "build_s": time.perf_counter() - t0}
            solve = lambda: mt.solve_two_stage(prob, lb, ub, mesh=self.mesh["scen"],  # noqa: E731
                                               device=self.device, **opts)
            st, run["first_s"], run["launches"] = self.timed(solve)
            run["warm_s"] = [self.timed(solve)[1] for _ in range(2)]
            run.update(iterations=st.iter, factorizations=st.counters.factorizations,
                       objective=st.objective, digest=digest(st))
            if name == "two_stage_1024":
                got = compare_record(st, want)
                got["x0_abs"] = float(abs(st.solution[:spec["n0"]] - want["x0"]).max())
                got["n_mismatched"] += got["x0_abs"] > 1e-7
                run["reference"] = self.check("two_stage_1024 against the JAX record", got)
            profiled = self.device == "cuda" and name != "two_stage_1024"
            if profiled and self.rank == 0:
                run["profile"] = profile(solve, st.iter)
            elif profiled:
                solve()   # the other ranks join the profiled solve's collectives
            if self.rank == 0:
                alone = lambda: mt.solve_two_stage(prob, lb, ub, device=self.device,  # noqa: E731
                                                   **opts)
                ref1, run["one_card_first_s"], run["one_card_launches"] = self.timed(alone)
                run["one_card_warm_s"] = [self.timed(alone)[1] for _ in range(2)]
                run["against_one_card"] = self.check(f"{name} against one card",
                                                     compare(st, ref1, 1e-8, 1e-7))
                if profiled:
                    run["one_card_profile"] = profile(alone, ref1.iter)
            self.barrier()
            self.say(f"(b) {name} over {self.world} cards: {st.status.name} iter {st.iter}, "
                     f"first {run['first_s']:.3f} s, warm {min(run['warm_s']):.4f} s on rank 0"
                     + (f"; one card {min(run['one_card_warm_s']):.4f} s warm"
                        if self.rank == 0 else ""))
            out[name] = run
            del prob, lb, ub
        self.record["runs"]["two_stage"] = out

    def sparse(self):
        """(c) sparse_per_card banded LPs per card against one card."""
        import madqp_tpu_torch as mt

        per = SPARSE_PER_CARD
        gen, kwargs = SPARSE
        qps = [getattr(mt, gen)(seed=s, **kwargs) for s in range(per * self.world)]
        opts = dict(tol=1e-8, print_level=40)
        run = {"instances": len(qps), "per_card": per}
        solve = lambda: mt.solve_sparse_batched(qps, mesh=self.mesh["batch"],  # noqa: E731
                                                device=self.device, **opts)
        stats, run["first_s"], run["launches"] = self.timed(solve)
        warm = [self.timed(solve) for _ in range(2)]
        run["warm_s"] = [w for _, w, _ in warm]
        run["iterations"] = [s.iter for s in stats]
        run["digest"] = digest(stats)
        own = qps[self.rank * per:(self.rank + 1) * per]
        alone = lambda: mt.solve_sparse_batched(own, device=self.device, **opts)  # noqa: E731
        got, run["one_card_first_s"], run["one_card_launches"] = self.timed(alone)
        run["one_card_warm_s"] = [self.timed(alone)[1] for _ in range(2)]
        run["against_one_card"] = self.check(
            "sparse against one card", compare(stats[self.rank * per:(self.rank + 1) * per],
                                               got, 1e-10))
        rec = self.ref["sparse_batched"]["bandedlp_f64"]
        n = min(len(rec["iter"]), len(stats))
        run["reference"] = self.check("sparse against the JAX record", compare_record(
            stats[:n], {k: rec[k][:n] for k in ("status", "iter", "objective")}))
        self.barrier()
        self.say(f"(c) {len(qps)} x {gen}{tuple(kwargs.values())} over {self.world} cards: "
                 f"first {run['first_s']:.3f} s, warm {min(run['warm_s']):.3f} s on rank 0; "
                 f"its {per} alone {min(run['one_card_warm_s']):.3f} s warm")
        self.record["runs"]["sparse"] = run


def rank_main(args):
    """One rank's run (the process group is up); returns its record."""
    import torch
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    r = Rank(args, world, rank)
    r.say(f"mesh over {world} devices across {world} process(es)")
    for mode in args.mode:
        getattr(r, mode)()
    r.record["failures"] = r.failures
    if args.device == "cuda":
        r.record["device"] = torch.cuda.get_device_name()
        r.record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return r.record


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def build_kernels():
    """The four kernel libraries and the native LDL, in parallel, before
    any rank starts."""
    from concurrent.futures import ThreadPoolExecutor

    from madqp_tpu_torch import native
    from madqp_tpu_torch.ops import _build, ldl_batched, pallas_chol, syrk

    sources = (pallas_chol.SOURCE, pallas_chol.SOURCE_BATCHED, syrk.SOURCE,
               ldl_batched.SOURCE, native.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    return time.perf_counter() - t0


def summarize(args, records, build_s) -> dict:
    digests = {}
    for rec in records:
        for name, run in rec["runs"].items():
            for key, sub in ([(name, run)] if "digest" in run else run.items()):
                digests.setdefault(key, set()).add(sub["digest"])
    failures = [f for rec in records for f in rec["failures"]]
    same = {k: len(v) == 1 for k, v in digests.items()}
    failures += [f"{k}: the ranks returned different stats" for k, v in same.items() if not v]
    return {"card": card() if args.device == "cuda" else "cpu", "world": len(records),
            "backend": args.backend, "device": args.device, "modes": args.mode,
            "build_s": build_s, "identical_stats_on_every_rank": same,
            "failures": failures, "ok": not failures, "ranks": records}


def write(args, summary):
    text = json.dumps(summary, indent=1, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(summary["card"])
    for f in summary["failures"]:
        print(f"FAIL {f}")
    print(f"identical stats on every rank: {summary['identical_stats_on_every_rank']}")


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multihost_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.backend == "nccl" and args.device == "cpu":
        print("multihost_torch: NCCL needs --device cuda", file=sys.stderr)
        return 1
    if args.coordinator:
        # one process per host, process 0 at the coordinator's address
        host, port = args.coordinator.rsplit(":", 1)
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(args.process_id),
                          WORLD_SIZE=str(args.num_processes))
    if "RANK" in os.environ:
        # under torchrun, or --coordinator: env:// rendezvous
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(args.backend)
        build_s = None
        if args.device == "cuda":
            if dist.get_rank() == 0:
                build_s = build_kernels()
            dist.barrier()   # the other ranks load what rank 0 built
        record = rank_main(args)
        records = [None] * dist.get_world_size()
        dist.all_gather_object(records, record)
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank != 0:
            return 0 if not record["failures"] else 1
        summary = summarize(args, records, build_s)
    else:
        from madqp_tpu_torch.parallel import mesh

        world = args.num_processes or (torch.cuda.device_count() if args.device == "cuda"
                                       else 1)
        build_s = build_kernels() if args.device == "cuda" else None
        records = mesh.spawn(rank_main, world, args, backend=args.backend,
                             device=args.device)
        summary = summarize(args, records, build_s)
    write(args, summary)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
