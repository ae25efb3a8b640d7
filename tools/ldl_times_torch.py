#!/usr/bin/env python3
"""K2-batched's device time per stack on one CUDA card, beside its bound
and beside `torch.linalg.cholesky_ex` on an SPD stack of the same shape;
optionally beside a second build of a K2-batched source, in the same
process.

Run from the root of a checkout (the K2-batched of that checkout is timed):

    python3 tools/ldl_times_torch.py TAG [--shapes BxN ...]
        [--stacks FILE.pt ...] [--baseline-source PATH]

`--shapes` (default: chip_smoke.py's LDL_TIMED and the front stacks of the
sparse QP members, (438, 128) of chainqp_50000 and (256, 128) of
cvxqp_20000) are timed on quasi-definite stacks made from a seed
(chip_smoke.quasi_definite), in float32 and float64.  `--stacks` loads
front stacks that `chip_smoke.py --save-fronts DIR` wrote (a list of
tensors per file) and times each in its own dtype.
`--baseline-source PATH` builds another `ldl_batched.cu` (for example an
earlier commit's, written to a scratch path) through `ops/_build.py` and
times it on the same stacks, in turns: kernel, baseline, baseline, kernel;
the two kernels' L and d are compared on every stack.  A time is
chip_smoke.py's `cuda_median_ms`: the median of 20 samples, each a burst of
5 calls between two CUDA events, queued while the stream spins for about
a millisecond.  The bound is chip_smoke.ldl_bound_ms.  Prints a line per
stack and then one line, "LDLTIMES <TAG> <json>".
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

SHAPES = ("128x128", "1024x128", "128x32", "1024x8", "438x128", "256x128")


def smoke_module():
    """chip_smoke.py of the checkout that holds this script, loaded by path."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def baseline_launcher(torch, k2, source):
    """A function F -> (L, d) that launches the K2-batched kernel built from
    `source`, as ldl_lower_batched launches its own (no floor)."""
    from madqp_tpu_torch.ops import _build

    names = ("madqp_ldl_batched_f32", "madqp_ldl_batched_f64", "madqp_ldl_batched_max_n")
    lib = _build.load(Path(source).resolve(), {n: k2._SIGNATURES[n] for n in names})

    def launch(F):
        B, n = F.shape[0], F.shape[-1]
        L = torch.empty((B, n, n), dtype=F.dtype, device=F.device)
        d = torch.empty((B, n), dtype=F.dtype, device=F.device)
        fn = lib.madqp_ldl_batched_f32 if F.dtype == torch.float32 else lib.madqp_ldl_batched_f64
        err = fn(F.data_ptr(), L.data_ptr(), d.data_ptr(), None, 0.0, B, n, F.stride(0),
                 F.stride(1), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline K2-batched launch failed: CUDA error {err}")
        return L, d
    return launch


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag", nargs="?", default="")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--stacks", nargs="*", default=[])
    ap.add_argument("--baseline-source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ldl_times_torch: no CUDA device", file=sys.stderr)
        return 1
    smoke = smoke_module()
    sys.path.insert(0, str(Path.cwd()))  # the checkout whose K2-batched is timed
    from madqp_tpu_torch.ops import ldl_batched as k2

    base = baseline_launcher(torch, k2, args.baseline_source) if args.baseline_source else None
    stacks = []
    for dname in ("float32", "float64"):
        for shape in args.shapes:
            B, n = (int(v) for v in shape.split("x"))
            F, _ = smoke.quasi_definite(torch, B, n, getattr(torch, dname), seed=B * n)
            stacks.append((f"{dname} {B}x{n}", F))
    for path in args.stacks:
        for F in torch.load(path):
            F = F.cuda()
            dname = str(F.dtype).split(".")[-1]
            stacks.append((f"{Path(path).stem} {dname} {F.shape[0]}x{F.shape[-1]}", F))

    out = {}
    for label, F in stacks:
        dname = str(F.dtype).split(".")[-1]
        S = torch.tril(F) + torch.tril(F, -1).mT
        S = S @ S.mT / F.shape[-1] + torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
        t = {"bound": smoke.ldl_bound_ms(F.shape[0], F.shape[-1], F.element_size(), dname)[0]}

        def kernel():
            return k2.ldl_lower_batched(F)
        runs = [("kernel", kernel)]
        if base is not None:
            runs += [("baseline", lambda: base(F)), ("baseline", lambda: base(F))]
            (L0, d0), (L1, d1) = kernel(), base(F)
            t["vs_baseline_rel"] = max(
                float(((L0 - L1).abs().amax(dim=(-2, -1)) / L1.abs().amax(dim=(-2, -1))).max()),
                float(((d0 - d1).abs().amax(-1) / d1.abs().amax(-1)).max()))
        runs += [("kernel", kernel)]
        for name, fn in runs:
            t.setdefault(name, []).append(smoke.cuda_median_ms(torch, fn))
        t["cholesky_ex"] = smoke.cuda_median_ms(torch, lambda: torch.linalg.cholesky_ex(S))
        out[label] = t
        ratio = (f", kernel / baseline {sum(t['kernel']) / sum(t['baseline']):.3f} "
                 f"(L, d within {t['vs_baseline_rel']:.1e})") if base else ""
        print(f"  {label}: kernel {t['kernel']} ms, baseline {t.get('baseline', '-')} ms, "
              f"bound {t['bound']:.4f} ms, cholesky_ex (SPD) {t['cholesky_ex']:.4f} ms{ratio}",
              flush=True)
    print("LDLTIMES", args.tag, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
