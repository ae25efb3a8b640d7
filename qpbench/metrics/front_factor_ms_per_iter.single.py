"""Device milliseconds of the sparse fronts' factorization kernels
(K2-batched, `madqp_ldl_batched_*`, and K1, `madqp_cholesky_*`) per
iteration of the solves of the device-traced block."""

from qpbench.trace import kernel_stats


def read(run):
    if not run.trace:
        return None
    count, seconds = kernel_stats(run.trace, "madqp_ldl_batched", "madqp_cholesky")
    iters = sum(sum(c.iters) for c in run.traced_calls)
    return 1e3 * seconds / iters if count and iters else None
