"""Batched solving (port of `madqp_tpu/parallel`).

Only `pad_standard` is ported so far: the single-instance shape bucketing
of `pad_mode="bucket"` uses it.  `BatchedMPCSolver` and `solve_batched`
are ROADMAP.md Queue 1, item 9.
"""

from .batched import pad_standard

__all__ = ["pad_standard"]
