#!/usr/bin/env python3
"""The parts of K1's step timed alone on one CUDA card.

Run from the root of a checkout:

    python3 tools/kernel_parts.py [--out parts.json]

Builds tools/kernel_parts.cu (which includes madqp_tpu_torch/csrc/
cholesky.cu and its tile header) with the kernels' nvcc flags and times,
with CUDA events around launches that repeat the part `reps` times inside
one kernel (the difference of 11 and 1 repetitions, over 10):
  * the diagonal factor of one 64 x 64 block (factor_diag) on one CTA,
    float32 and float64, checked against torch.linalg.cholesky;
  * one tile product (tile_product) of K8's and K1's tile configurations,
    at k = 64 (K1's trailing update) and 256 (K8's in-stripe updates), on
    one CTA (its latency) and on a full card (its throughput);
  * the grid barrier (cooperative_groups grid.sync) of a cooperative
    launch, at the grid sizes K1 uses.
Prints the card's name and power limit first and the JSON record last.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="JSON file to write")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from madqp_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "kernel_parts.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
           str(REPO / "tools" / "kernel_parts.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.parts_diag.argtypes = [I, P, P, P, I, I, P]
    lib.parts_tile.argtypes = [I, P, I, I, P, I, I, P]
    lib.parts_sync.argtypes = [I, I, I, P]
    nb = lib.parts_tile_edge()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def elapsed_ms(launch):
        err = launch()  # warm-up, and the launch's own error
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def per_rep_us(launch):
        """Microseconds of one repetition: (11 reps - 1 rep) / 10."""
        return (elapsed_ms(lambda: launch(11)) - elapsed_ms(lambda: launch(1))) / 10 * 1e3

    record = {"card": card, "diag_us": {}, "tile": [], "grid_sync_us": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for f64, dtype in ((0, torch.float32), (1, torch.float64)):
        n = 2 * nb
        M = torch.randn((n, n), generator=gen, dtype=dtype, device="cuda")
        A = M @ M.T / n + torch.eye(n, dtype=dtype, device="cuda")
        L = torch.zeros_like(A)
        D = torch.zeros((nb, nb), dtype=dtype, device="cuda")
        us = per_rep_us(lambda reps: lib.parts_diag(
            f64, A.data_ptr(), L.data_ptr(), D.data_ptr(), n, reps, stream))
        want = torch.linalg.cholesky(A[:nb, :nb])
        err = float((torch.tril(L[:nb, :nb]) - want).abs().max() / want.abs().max())
        inv_err = float((D @ want - torch.eye(nb, dtype=dtype, device="cuda")).abs().max())
        record["diag_us"][str(dtype)] = us
        print(f"{dtype} diagonal factor of one {nb} x {nb} block: {us:.2f} us "
              f"(factor rel err {err:.1e}, |Dinv L - I| {inv_err:.1e})")
        if err > (1e-5 if f64 == 0 else 1e-12):
            raise RuntimeError("the diagonal factor differs from torch.linalg.cholesky")

    configs = ((0, "K8 float32", torch.float32, 3), (1, "K1 float32", torch.float32, 2),
               (2, "K8 float64", torch.float64, 3), (3, "K1 float64", torch.float64, 2))
    for which, name, dtype, per_sm in configs:
        ctas_full = per_sm * sms
        X = torch.randn((ctas_full * nb, 256), generator=gen, dtype=dtype, device="cuda")
        out = torch.empty(ctas_full * nb * nb, dtype=dtype, device="cuda")
        for k in (64, 256):
            for ctas in (1, ctas_full):
                us = per_rep_us(lambda reps: lib.parts_tile(
                    which, X.data_ptr(), X.shape[1], k, out.data_ptr(), ctas, reps, stream))
                tflops = 2 * nb * nb * k * ctas / us / 1e6
                record["tile"].append({"config": name, "k": k, "ctas": ctas,
                                       "us": us, "tflops": tflops})
                print(f"{name} tile product {nb} x {nb} x {k} on {ctas} CTAs: "
                      f"{us:.2f} us, {tflops:.2f} TFLOP/s")
    for ctas, threads in ((45, 256), (2 * sms, 256), (2 * sms, 128)):
        us = per_rep_us(lambda reps: lib.parts_sync(ctas, threads, reps, stream))
        record["grid_sync_us"][f"{ctas}x{threads}"] = us
        print(f"grid barrier, {ctas} CTAs of {threads} threads: {us:.2f} us")
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
