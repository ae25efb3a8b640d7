"""One call: one SAA replication through `solve_two_stage(prob, lb, ub,
...)`, its problem assembled by `build_two_stage` from the blocks the
generator made on the card (kept there, not copied)."""

from __future__ import annotations

from qpbench import port


def prepare(instances):
    from madqp_tpu_torch import build_two_stage

    out = []
    for p in instances:
        b = p.blocks
        out.append(build_two_stage(b["c0"], b["A0"], b["b0"], b["lb0"], b["ub0"], b["c_s"],
                                   b["T_s"], b["W_s"], b["b_s"], b["lb_s"], b["ub_s"],
                                   device=b["W_s"].device))
    return out


def call(problems, options, device):
    from madqp_tpu_torch import solve_two_stage

    return [solve_two_stage(prob, lb, ub, device=device, **options)
            for prob, lb, ub in problems], {}


def answers(stats):
    return [port.answer(s) for s in stats]
