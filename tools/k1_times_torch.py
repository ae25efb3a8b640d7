#!/usr/bin/env python3
"""K1's device time per call at the shapes the solver paths give it, on
one CUDA card, for comparing two checkouts in one call.

Run from the root of a checkout (the K1 of that checkout is timed):

    python3 tools/k1_times_torch.py TAG

Times `cholesky_lower` on one matrix (n = 600 and 2500: W of the n = 500
and n = 2000 solves) and on stacks (B, n, n): (512, 42) and (512, 16), W
and S of the batched-512 solve; (64, 32) and (64, 8), the qp_layer batch;
(4, 200) and (4, 600), S and W of the n = 500 QPs as one batch; (512, 100)
and (256, 160), large stacks of mid-size matrices (one CTA per matrix);
(1024, 96) and (1024, 48), U and S of the two-stage cell; the supernodal
fronts' F11 stacks (ops/sparse_chol.py): (128, 128) of bandedlp_30000,
(351, 8), (85, 32), (25, 128) and (5, 128) of gridlp_100's schedule, and a
chain step's front as a stack of one (1, 128) beside the same matrix on
one launch of the persistent kernel (single 128);
each stack beside `torch.linalg.cholesky_ex` on it; float32 and float64.
A time is chip_smoke.py's (`cuda_median_ms`, the script beside this
one's folder, whichever checkout is timed): the median of 20 samples,
each a burst of 5 calls between two CUDA events, queued while the stream
spins for about a millisecond.  Prints one line, "K1TIMES <TAG> <json>".
To compare a parent with a change, unpack the parent with `git archive`
into a directory that .gitignore lists and run, in one call, parent,
change, change, parent:

    (cd PARENT && python3 $OLDPWD/tools/k1_times_torch.py parent)
"""

import importlib.util
import json
import sys
from pathlib import Path

SINGLE = (128, 600, 2500)
STACKS = ((512, 42), (512, 16), (64, 32), (64, 8), (4, 200), (4, 600), (512, 100),
          (256, 160), (1024, 96), (1024, 48), (128, 128), (351, 8), (85, 32), (25, 128),
          (5, 128), (1, 128))


def smoke_module():
    """chip_smoke.py of the checkout that holds this script, loaded by path."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    import torch

    if not torch.cuda.is_available():
        print("k1_times_torch: no CUDA device", file=sys.stderr)
        return 1
    smoke = smoke_module()
    sys.path.insert(0, str(Path.cwd()))  # the checkout whose K1 is timed
    from madqp_tpu_torch.ops import pallas_chol as k1

    out = {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for n in SINGLE:
            A = smoke.spd_stack(torch, 1, n, dtype, n)[0].contiguous()
            out[f"{dname} single {n}"] = smoke.cuda_median_ms(
                torch, lambda: k1.cholesky_lower(A))
        for batch, n in STACKS:
            A = smoke.spd_stack(torch, batch, n, dtype, n)
            out[f"{dname} stack {batch}x{n}"] = smoke.cuda_median_ms(
                torch, lambda: k1.cholesky_lower(A))
            out[f"{dname} stack {batch}x{n} cholesky_ex"] = smoke.cuda_median_ms(
                torch, lambda: torch.linalg.cholesky_ex(A))
    print("K1TIMES", sys.argv[1] if len(sys.argv) > 1 else "", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
